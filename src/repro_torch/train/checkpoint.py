"""Fault-tolerant checkpointing, port of ``repro.train.checkpoint``: the
same files, keys and commit protocol, so a checkpoint written by either
package restores in the other.

Layout:  <dir>/step_<N>/arrays.npz  + manifest.json
Commit protocol: write into ``step_<N>.tmp`` then ``os.replace``; a crash
mid-write never leaves a half checkpoint that restore would pick up.
Keys: each leaf's path, its parts ``k:<name>`` for a dict key or a
NamedTuple field and ``i:<index>`` for a list or tuple entry, joined by
``\\x1f`` (the reference's ``jax.tree_util`` paths print so). A tree is
nested dicts, NamedTuples, lists and tuples of tensors or numpy arrays;
arrays are stored as they are given, so a caller that wants the
reference's layouts converts first (``models.params.xr_train_to_jax``).
bfloat16: numpy has no bfloat16 of its own, and an ``ml_dtypes`` bfloat16
array (what a JAX array converts to) is written by ``np.savez`` as raw
2-byte voids, which the reference's restore cannot cast back ("No cast
function available"). So a bfloat16 tensor is stored widened to float32,
exactly, which both packages restore bit for bit into a bfloat16 leaf; a
2-byte void entry (a bfloat16 checkpoint the reference wrote) is read back
as its bits.

Sharded trees (DTensor leaves): ``save`` gathers each leaf whole
(``full_tensor``, on every rank) and rank 0 alone writes, so the files are
the same bytes whatever the mesh; ``restore(..., shardings=)`` puts each
leaf back as a DTensor on a mesh of the caller's choosing (an elastic
restart on another mesh), as the reference ``device_put``s its leaves onto
``NamedSharding``s.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding

_SEP = "\x1f"          # flat-key separator (never appears in field names)


def _items(node) -> Iterator[Tuple[str, Any]]:
    """(key part, child) of one inner node, in the reference's order:
    sorted dict keys, NamedTuple fields and sequence entries in order."""
    if isinstance(node, dict):
        return ((f"k:{k}", node[k]) for k in sorted(node))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ((f"k:{f}", getattr(node, f)) for f in node._fields)
    return ((f"i:{i}", v) for i, v in enumerate(node))


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple))


def _paths(tree, prefix=()) -> Iterator[Tuple[str, Any]]:
    if _is_leaf(tree):
        yield _SEP.join(prefix), tree
        return
    for part, child in _items(tree):
        yield from _paths(child, prefix + (part,))


def _host(leaf) -> np.ndarray:
    """A numpy copy of a leaf (a CUDA tensor is copied to the host; a
    bfloat16 tensor widened to float32, exactly)."""
    if torch.is_tensor(leaf):
        leaf = sharding.whole(leaf)
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           extra: Optional[Dict], keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if _rank() != 0:                  # one writer; every rank gathered
        return final
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic commit
    _prune(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; prune to ``keep``
    newest. In a process group every rank calls it (the gathers are
    collectives); rank 0 writes, and the ranks leave together."""
    final = _write(ckpt_dir, step, _flatten(tree), extra, keep)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    return final


def save_async(ckpt_dir: str, step: int, tree, extra=None, keep: int = 3
               ) -> threading.Thread:
    """Checkpoint on a writer thread. The host snapshot (every leaf copied
    off the card) is taken before the thread starts, so the next steps may
    update the tensors in place; only the file writing overlaps them."""
    flat = _flatten(tree)
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, extra,
                                              keep), daemon=True)
    t.start()
    return t


def _prune(ckpt_dir: str, keep: int):
    for s in sorted(_list_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(ckpt_dir))
            if m]


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def _rebuild(like, prefix, data):
    if _is_leaf(like):
        arr = np.array(data[_SEP.join(prefix)])
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dtype = like.dtype if torch.is_tensor(like) else t.dtype
        return t.to(dtype)
    kids = {part: _rebuild(child, prefix + (part,), data)
            for part, child in _items(like)}
    if isinstance(like, dict):
        return {k: kids[f"k:{k}"] for k in like}
    vals = list(kids.values())
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _is_sharding(x) -> bool:
    """A ``shardings`` leaf: None, a tuple of placements, or (mesh,
    placements)."""
    if x is None:
        return True
    if not isinstance(x, tuple) or hasattr(x, "_fields"):
        return False
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Placement
    if len(x) == 2 and isinstance(x[0], DeviceMesh):
        return True
    return len(x) > 0 and all(isinstance(p, Placement) for p in x)


def _reshard(t, sh):
    if sh is None:
        return t
    from torch.distributed.tensor import Placement, distribute_tensor
    mesh, pl = (None, sh) if isinstance(sh[0], Placement) else sh
    mesh = mesh if mesh is not None else sharding.current_mesh()
    if mesh is None:
        raise ValueError("restore: placements without a mesh; pass "
                         "(mesh, placements) or bind one (use_mesh)")
    return distribute_tensor(t.to(mesh.device_type), mesh, pl,
                             src_data_rank=None)


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None,
            shardings=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (leaves: tensors, whose
    dtypes are kept, or numpy arrays): CPU tensors, the latest step unless
    ``step`` is given. Returns (tree, step, extra).

    ``shardings``: a tree of ``tree_like``'s structure whose leaves are
    None (a plain CPU tensor), a tuple of DTensor placements (on the bound
    mesh) or (mesh, placements): each such leaf comes back a DTensor on
    that mesh's device, every rank keeping its shard of the whole array it
    read. None: today's plain CPU tensors."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        tree = _rebuild(tree_like, (), data)
    if shardings is not None:
        tree = sharding.tree_map(lambda sh, t: _reshard(t, sh), shardings,
                                 tree, is_leaf=_is_sharding)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return tree, step, manifest["extra"]
