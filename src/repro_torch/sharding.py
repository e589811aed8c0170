"""Logical-axis sharding on ``DeviceMesh``/DTensor, port of
``repro.sharding``: declarative rules resolved against the bound mesh.

Models annotate tensors with *logical* axes ("batch", "heads", "mlp", ...);
the launcher binds a mesh and a rule table (``use_mesh``), and every
annotation resolves to a spec: one entry per tensor dim, each None
(replicated), a mesh axis name, or a tuple of mesh axis names (the dim split
over all of them, the first the major one). ``placements`` turns a spec into
DTensor placements, one ``Shard(dim)``/``Replicate()`` per mesh dim.
Outside a bound mesh the annotations are no-ops (``shard(x) is x``), so the
one-device paths, the unit tests and the DSE plane never touch
``torch.distributed``.

Rules follow the reference's MaxText conventions: fsdp-style weight
sharding over the ("pod", "data") axes, tensor parallelism over "model",
MoE dispatch buffers split on their capacity dim over the batch axes,
sequence sharding of long KV caches over "data". Specs equal the
reference's ``PartitionSpec`` entry for entry (a 1-tuple collapses to the
bare name), so tests compare the two directly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

# logical axis -> mesh axis (or tuple of mesh axes, or None=replicated)
DEFAULT_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),       # data parallel over pod x data
    "seq": None,                    # sequence replicated by default
    "kv_seq": "data",               # long-context decode: shard cache sequence
    "embed": None,                  # activations' feature dim replicated
    "fsdp": ("pod", "data"),        # weight matrices' input dim (ZeRO-3 style)
    "tensor": "model",              # Megatron column/row parallel dim
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    # Experts replicated across the mesh by default: each expert's (D,F)
    # weight is already 512-way sharded via fsdp x tensor, and 8 experts on a
    # 16-way axis would pad 2x. Expert parallelism (expert -> "model") is a
    # per-run rule override (see EXPERIMENTS.md §Perf hillclimb: jamba/grok).
    "expert": None,
    # MoE dispatch buffers (E, C, D): shard the CAPACITY dim over the batch
    # axes. Leaving it unsharded replicates the whole dispatch buffer and
    # all-reduces it in the backward pass — measured 2x86 GB/device/step on
    # mixtral train_4k (§Perf cell B, iteration B1).
    "expert_cap": ("pod", "data"),
    "layer": None,                  # stacked-layer leading dim
    "conv": None,
}

_TLS = threading.local()


def _ctx():
    return getattr(_TLS, "ctx", None)


def current_mesh():
    """The bound ``DeviceMesh``, or None outside ``use_mesh``."""
    ctx = _ctx()
    return None if ctx is None else ctx[0]


def _filter(a: Axes, names) -> Axes:
    """Drop mesh axes the mesh does not have (the single-pod mesh has no
    "pod")."""
    if a is None:
        return None
    if isinstance(a, str):
        return a if a in names else None
    kept = tuple(x for x in a if x in names)
    return kept if kept else None


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axes]] = None):
    """Bind ``mesh`` (a ``DeviceMesh`` with named dims) and the default
    rules updated by ``rules``; inside, ``shard`` redistributes, and a
    plain tensor that meets a DTensor in an op (positions, masks, 0-dim
    constants: the same on every rank) is taken as replicated
    (``implicit_replication``)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    names = set(mesh.mesh_dim_names or ())
    merged = {k: _filter(v, names) for k, v in merged.items()}
    prev = _ctx()
    _TLS.ctx = (mesh, merged)
    try:
        with _implicit_replication():
            yield mesh
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def unbound():
    """No mesh bound inside (the body of a ``local_map``, which runs on
    plain local shards)."""
    prev = _ctx()
    _TLS.ctx = None
    try:
        yield
    finally:
        _TLS.ctx = prev


def resolve_spec(logical: Sequence[Optional[str]]) -> Spec:
    """The spec of a tensor whose dims carry ``logical`` axes, under the
    bound rules (all None outside a mesh). One mesh axis is used once: a
    later dim that asks for an axis already taken gets none of it."""
    ctx = _ctx()
    if ctx is None:
        return tuple([None] * len(logical))
    _, rules = ctx
    out, used = [], set()
    for ax in logical:
        m = rules.get(ax) if ax else None
        if m is None:
            out.append(None)
        elif isinstance(m, str):
            out.append(None if m in used else m)
            used.add(m)
        else:
            kept = tuple(x for x in m if x not in used)
            used.update(kept)
            out.append(kept[0] if len(kept) == 1 else (kept if kept else None))
    return tuple(out)


def _parts(part: Axes) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if tensor dim d is split over it, else ``Replicate()``. A
    dim split over two mesh axes (("pod", "data")) is ``Shard(d)`` on both,
    the first the major one, which is DTensor's order when the axes are in
    the mesh's order; any other order raises. A mesh dim of size 1 is
    ``Replicate()`` whatever the spec splits over it: a split over one
    rank is no split, and DTensor refuses to view away a sharded dim (a
    size-1 kv-head dim the divisibility rule keeps on a 1-way "model")."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = _parts(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} is split over {axes}, "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def fix_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """The reference's divisibility rule for one tensor: a mesh axis is
    kept on a dim only if the dim divides by the product of the axes kept
    so far times its size (an 8-kv-head cache drops a 16-way "model")."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for d, part in enumerate(spec):
        if part is None or d >= len(shape):
            out.append(part)
            continue
        kept, size = [], 1
        for a in _parts(part):
            n = int(sizes[a])
            if shape[d] % (size * n) == 0:
                kept.append(a)
                size *= n
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, (str, tuple)) for a in x) and all(
        not isinstance(a, tuple) or all(isinstance(b, str) for b in a)
        for a in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts, NamedTuples, lists and
    tuples (``is_leaf`` decides where a leaf stops the descent)."""
    if (is_leaf is not None and is_leaf(tree)) or not isinstance(
            tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    vals = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def spec_tree(axes_tree, mesh, rules: Optional[Dict[str, Axes]] = None):
    """Resolve a tree of logical-axis tuples into specs on ``mesh``."""
    with use_mesh(mesh, rules):
        return tree_map(resolve_spec, axes_tree, is_leaf=_is_axes)


def fix_divisibility(specs, like_tree, mesh):
    """Apply ``fix_spec`` over a tree of specs and a tree of the same
    structure whose leaves have ``.shape`` (tensors, meta tensors,
    ``ParamDef``s). DTensor allows uneven shards; the port keeps the
    reference's exact specs all the same."""
    return tree_map(lambda s, like: None if s is None
                    else fix_spec(s, tuple(like.shape), mesh),
                    specs, like_tree, is_leaf=_is_spec)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate ``x`` with logical axes: ``x`` itself outside a bound mesh;
    inside one, ``x`` redistributed to the resolved spec, with the
    reference's divisibility rule applied (DTensor's views refuse uneven
    shards where the reference would pad). A plain tensor there (a
    constant, the same on every rank) is taken as replicated first."""
    ctx = _ctx()
    if ctx is None:
        return x
    mesh, _ = ctx
    from torch.distributed.tensor import DTensor
    pl = placements(fix_spec(resolve_spec(logical), tuple(x.shape), mesh),
                    mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, placements((), mesh),
                               run_check=False)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with tensor dim ``dim`` split over no mesh axis (its other
    placements kept); ``x`` itself if it is not a DTensor or ``dim`` is
    not split."""
    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def heads_split(n: int, axis: str) -> bool:
    """Whether ``n`` heads (logical axis ``axis``) are split over the bound
    mesh's axes after the divisibility rule."""
    mesh = current_mesh()
    return mesh is not None and fix_spec(resolve_spec((axis,)), (n,),
                                         mesh)[0] is not None


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``distribute_tensor`` of a whole tensor by ``spec``; every rank
    holds the same ``t`` (drawn from one seed), and keeps its shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def is_dtensor(x: Any) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def _implicit_replication():
    """torch's ``implicit_replication()``, nestable: the torch context
    clears its flag on exit even when an outer one had set it, so only the
    outermost of these enters it."""
    depth = getattr(_TLS, "implicit", 0)
    _TLS.implicit = depth + 1
    try:
        if depth:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
    finally:
        _TLS.implicit = depth


def replicating(tensors):
    """Implicit replication if any of ``tensors`` is a DTensor (a plain
    0-dim constant beside it is the same on every rank), else a null
    context."""
    if any(is_dtensor(t) for t in tensors):
        return _implicit_replication()
    return contextlib.nullcontext()


def whole(x: torch.Tensor) -> torch.Tensor:
    """The whole value of ``x``: a DTensor gathered (``full_tensor``, a
    collective every rank calls), a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x
