"""Multi-pod dry-run: trace every (architecture x input shape) step on the
production mesh WITHOUT allocating a single parameter, port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--out results.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The reference lowers and compiles each cell for 512 fake host devices and
reads XLA's cost and memory analyses. The port runs the step itself, as a
DTensor program, on ``torch.distributed``'s fake process group (256 or 512
ranks in this one process; collectives are no-ops) over the production
mesh, with parameters, optimizer state, caches and inputs on the ``meta``
device. For each cell it reports, per device:

- FLOPs: the aten ops each rank runs on its shards
  (``torch.utils.flop_counter``'s formulas) plus the kernels' own work
  (``kernels.meta``: the causal or windowed pairs flash visits);
- bytes: each aten op's inputs and outputs, unfused (an upper bound on
  what a fused program moves), plus the kernels' inputs and outputs;
- collective bytes by kind (the result of each collective on a rank);
- the exact bytes of parameters, gradients and AdamW moments (train), or of
  the decode cache, from the local shard shapes of the FULL config;
- the activation peak (``temp_bytes_per_device``): the most bytes of live
  tensors on one rank (local shards) at any point of the step that are
  neither inputs (parameters, optimizer state, cache, batch) nor outputs
  of it, from ``LivePeak``, which adds each new storage's bytes when an op
  makes it and takes them off when it dies. It plays the role of XLA's
  ``temp_size_in_bytes`` in the reference, but is not the same number: XLA
  counts the buffers of the fused, scheduled program after buffer
  assignment; this counts eager aten ops' outputs, unfused, in the order
  the step runs them (gradients are temporaries here, as there).

Costs are linear in the period repeats R (homogeneous layer stacks), so as
in the reference two traces, at R=1 and R=2 (plus a second encoder layer
for whisper), price the full depth exactly; a cell traces at most three
period blocks. The activation peak is extrapolated the same way (held to a
full-depth trace by the tests). Every term is a modelled H100 roofline
figure (``core.roofline``), not a measurement. The fake group is
process-global: run the dry-run as its own process wherever a real group
may exist.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding
from repro_torch.configs import LM_ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.core import roofline as rl
from repro_torch.kernels import meta
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.params import abstract, flatten, logical_axes
from repro_torch.train import optim

f32 = torch.float32


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process (this
    rank 0), destroyed on exit. Raises if a group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already: run the "
                           "dry-run as its own process (python -m "
                           "repro_torch.launch.dryrun)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class LivePeak(TorchDispatchMode):
    """Peak bytes of the tensors that the ops run inside it make, per rank.

    Each op's output storages that are new (not an input's, not seen
    before) add their bytes when the op returns them and take them off when
    the storage dies (a weakref finalizer; storages keep their Python
    object while they live). DTensor's ops reach it as the local ops of
    this rank (it declines the DTensor level), and the ops DTensor's
    sharding propagation runs on FakeTensors of the global shapes are not
    counted. ``exclude`` registers the inputs before the step; after it,
    ``peak`` is the most bytes of new storages live at once and
    ``phase_peaks(outputs)`` the same without the storages of ``outputs``,
    one peak for each phase of the step: a phase ends where autograd's
    backward starts or ends (a train step: forward, backward, optimizer).
    Each phase's peak is linear in the period repeats where the whole
    step's, their maximum, is not. Works alike on meta, CPU and CUDA
    tensors."""

    def __init__(self):
        super().__init__()
        # live storage address -> [bytes, serial, finalizer]; an address is
        # reused once its storage dies, a serial never
        self._known: Dict[int, list] = {}
        self._events = []                   # (serial, byte change, phase)
        self._phase, self._backward = 0, False
        self._live = 0
        self.peak = 0
        self._open = False
        self._dtensor = None
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor

    def _storages(self, tree):
        for leaf in _leaves(tree):
            if torch.is_tensor(leaf):
                t = leaf.to_local() if sharding.is_dtensor(leaf) else leaf
                yield t.untyped_storage()

    def exclude(self, tree) -> None:
        """Mark the storages of ``tree`` (the step's inputs) as not new."""
        for st in self._storages(tree):
            self._known.setdefault(st._cdata, [0, -1, None])

    def _change(self, serial: int, delta: int) -> None:
        backward = torch._C._current_graph_task_id() != -1
        if backward != self._backward:
            self._backward = backward
            self._phase += 1
        self._live += delta
        self._events.append((serial, delta, self._phase))
        self.peak = max(self.peak, self._live)

    def _freed(self, key: int) -> None:
        entry = self._known.pop(key, None)
        if entry is not None and self._open:
            self._change(entry[1], -entry[0])

    def _track(self, st) -> None:
        key, n = st._cdata, st.nbytes()
        entry = self._known.get(key)
        if entry is None:
            serial = len(self._events)
            self._known[key] = [n, serial,
                                weakref.finalize(st, self._freed, key)]
            self._change(serial, n)
        elif entry[2] is not None and entry[0] != n:    # resized in place
            self._change(entry[1], n - entry[0])
            entry[0] = n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not (rl._fake(args) or rl._fake(out if isinstance(
                out, (list, tuple)) else (out,))):
            for st in self._storages(out):
                self._track(st)
        return out

    def __enter__(self):
        self._open = True
        return super().__enter__()

    def __exit__(self, *exc):
        self._open = False
        for entry in self._known.values():
            if entry[2] is not None:
                entry[2].detach()
        return super().__exit__(*exc)

    def phase_peaks(self, outputs) -> list:
        """The peak of each phase without the storages of ``outputs``."""
        skip = {self._known[st._cdata][1] for st in self._storages(outputs)
                if st._cdata in self._known}
        live, peaks = 0, [0] * (self._phase + 1)
        for serial, delta, phase in self._events:
            if serial not in skip:
                live += delta
                peaks[phase] = max(peaks[phase], live)
        return peaks


def _opt_state_abstract(params_abs: Dict) -> optim.AdamWState:
    zeros = {k: torch.empty(p.shape, dtype=f32, device="meta")
             for k, p in flatten(params_abs).items()}
    return optim.AdamWState(zeros, dict(zeros),
                            torch.zeros((), dtype=torch.int32))


def build_step(cfg, shape_name: str):
    """(step_fn, abstract args dict, logical-axes dict) for the cell; the
    step takes the args as keywords. Train: loss, ``backward()``,
    global-norm clipping and AdamW; prefill: the forward's logits; decode:
    one ``decode_step`` over the cache."""
    _, _, kind = SHAPES[shape_name]
    pdefs = lm.param_defs(cfg)
    params_abs, params_ax = abstract(pdefs), logical_axes(pdefs)
    batch_abs = mesh_mod.input_specs(cfg, shape_name)
    batch_ax = mesh_mod.input_axes(cfg, shape_name)

    if kind == "train":
        lr_fn = optim.cosine_schedule(3e-4, 100, 10_000)

        def train_step(params, opt_state, batch, step):
            flat = flatten(params)
            for p in flat.values():
                p.requires_grad_(True)
            loss, _ = lm.lm_loss(cfg, params, batch)
            loss.backward()
            grads = {k: p.grad for k, p in flat.items()}
            with torch.no_grad():
                grads, _ = optim.clip_by_global_norm(grads, 1.0)
                new_p, opt_state = optim.adamw_update(
                    grads, opt_state, flat, lr=float(lr_fn(step)))
            return new_p, opt_state, loss

        flat_ax = flatten(params_ax)
        args = dict(params=params_abs, opt_state=_opt_state_abstract(
            params_abs), batch=batch_abs, step=0)
        axes = dict(params=params_ax, opt_state=optim.AdamWState(
            flat_ax, dict(flat_ax), None), batch=batch_ax, step=None)
        return train_step, args, axes

    if kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                logits, _ = lm.forward(
                    cfg, params, batch["tokens"],
                    image_embeds=batch.get("image_embeds"),
                    encoder_frames=batch.get("encoder_frames"))
            return logits

        return (prefill_step, dict(params=params_abs, batch=batch_abs),
                dict(params=params_ax, batch=batch_ax))

    def serve_step(params, cache, batch):
        with torch.no_grad():
            return lm.decode_step(cfg, params, cache, batch["tokens"],
                                  batch["position"])

    cache_abs, cache_ax = mesh_mod.decode_state_specs(cfg, shape_name)
    return (serve_step, dict(params=params_abs, cache=cache_abs,
                             batch=batch_abs),
            dict(params=params_ax, cache=cache_ax, batch=batch_ax))


def place(args: Dict, axes: Dict, mesh, rules=None) -> Dict:
    """Every tensor of ``args`` with logical axes in ``axes`` distributed
    over ``mesh`` by its resolved, divisibility-fixed spec (meta stays
    meta); the rest as it is."""
    def one(ax, a):
        if ax is None or not torch.is_tensor(a):
            return a
        spec = sharding.fix_spec(sharding.spec_tree(ax, mesh, rules),
                                 tuple(a.shape), mesh)
        return sharding.distribute(a, spec, mesh)
    return sharding.tree_map(one, axes, args, is_leaf=lambda x: x is None
                             or sharding._is_axes(x))


def _local_bytes(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            t = leaf.to_local() if sharding.is_dtensor(leaf) else leaf
            total += t.numel() * t.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def trace(cfg, shape_name: str, mesh, rules=None):
    """One traced step of ``cfg`` on ``mesh``: (cost tally, outputs,
    placed args). The tally holds the per-device costs, in ``temp_phases``
    the activation peak of each phase of the step on one rank
    (``LivePeak``) and in ``temp_bytes`` their maximum."""
    step_fn, args, axes = build_step(cfg, shape_name)
    placed = place(args, axes, mesh, rules)
    tally = rl.cost_tally()
    peak = LivePeak()
    peak.exclude(placed)
    meta.counter = tally.kernel
    try:
        with sharding.use_mesh(mesh, rules), tally, peak:
            out = step_fn(**placed)
    finally:
        meta.counter = None
    tally.temp_phases = peak.phase_peaks(out)
    tally.temp_bytes = max(tally.temp_phases)
    return tally, out, placed


def _costs(tally):
    return (tally.flops, tally.bytes, float(sum(tally.coll.values())),
            dict(tally.coll))


def scaled_cfg(cfg, repeats: int, enc_layers=None):
    """Same block pattern, ``repeats`` copies of the period block."""
    kw = dict(num_layers=lm.block_period(cfg) * repeats)
    if cfg.encoder_layers:
        kw["encoder_layers"] = (enc_layers if enc_layers is not None
                                else cfg.encoder_layers)
    return dataclasses.replace(cfg, **kw)


def memory_per_device(cfg, shape_name: str, mesh, rules=None) -> Dict:
    """Exact per-device bytes of the full config's state, from the local
    shard shapes of its meta DTensors: parameters, gradients (the
    parameters' placements and dtype) and AdamW's two f32 moments for
    train; the decode cache for decode."""
    _, _, kind = SHAPES[shape_name]
    pdefs = lm.param_defs(cfg)
    params = place(abstract(pdefs), logical_axes(pdefs), mesh, rules)
    p = _local_bytes(params)
    local = [t.to_local() for t in _leaves(params)]
    out = dict(param_bytes_per_device=p,
               grad_bytes_per_device=p if kind == "train" else 0,
               opt_bytes_per_device=(sum(2 * 4 * t.numel() for t in local)
                                     if kind == "train" else 0),
               cache_bytes_per_device=0)
    if kind == "decode":
        cache_abs, cache_ax = mesh_mod.decode_state_specs(cfg, shape_name)
        out["cache_bytes_per_device"] = _local_bytes(
            place(cache_abs, cache_ax, mesh, rules))
    out["state_bytes_per_device"] = sum(out.values())
    return out


def extrapolated(cfg, shape_name: str, mesh, rules=None):
    """Per-device (flops, bytes, collective bytes, collectives by kind,
    the R=2 trace's kernel tally and byte table, activation peak bytes) of
    the full depth, from traces at R=1 and R=2 (and a second encoder layer
    for whisper)."""
    R_full = lm.num_repeats(cfg)
    t1, _, _ = trace(scaled_cfg(cfg, 1, enc_layers=1), shape_name, mesh,
                     rules)
    t2, _, _ = trace(scaled_cfg(cfg, 2, enc_layers=1), shape_name, mesh,
                     rules)
    c1, c2 = _costs(t1), _costs(t2)
    cost = [c1[i] + (c2[i] - c1[i]) * (R_full - 1) for i in range(3)]
    coll = {k: c1[3][k] + (c2[3][k] - c1[3][k]) * (R_full - 1)
            for k in c1[3]}
    temp = [a + (b - a) * (R_full - 1)
            for a, b in zip(t1.temp_phases, t2.temp_phases, strict=True)]
    if cfg.encoder_layers > 1:                # whisper: the encoder's term
        te, _, _ = trace(scaled_cfg(cfg, 1, enc_layers=2), shape_name, mesh,
                         rules)
        ce = _costs(te)
        for i in range(3):
            cost[i] += (ce[i] - c1[i]) * (cfg.encoder_layers - 1)
        for k in coll:
            coll[k] += (ce[3][k] - c1[3][k]) * (cfg.encoder_layers - 1)
        temp = [t + (c - a) * (cfg.encoder_layers - 1) for t, a, c in
                zip(temp, t1.temp_phases, te.temp_phases, strict=True)]
    return cost[0], cost[1], cost[2], coll, t2, max(temp)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, mesh=None) -> Dict:
    """The dry-run row of one cell: the roofline terms of the full depth,
    the per-device state bytes, the trace time. Needs a (fake) process
    group of the mesh's size; ``mesh`` defaults to the production one."""
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        return dict(arch=arch, shape=shape_name, skipped=why)
    cfg = get_config(arch)
    if mesh is None:
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
    chips = mesh.size()
    mesh_name = "x".join(str(n) for n in mesh.shape)
    rules = mesh_mod.shape_rules(cfg, shape_name)

    t0 = time.monotonic()
    flops, byts, coll, by_kind, t2, temp = extrapolated(cfg, shape_name,
                                                        mesh, rules)
    mem = memory_per_device(cfg, shape_name, mesh, rules)
    t_trace = time.monotonic() - t0
    r = rl.Roofline(arch, shape_name, mesh_name, chips, flops * chips,
                    byts * chips, coll * chips, by_kind,
                    mesh_mod.model_flops(cfg, shape_name))
    row = r.row()
    _, _, kind = SHAPES[shape_name]
    state_out = (mem["param_bytes_per_device"] + mem["opt_bytes_per_device"]
                 if kind == "train" else mem["cache_bytes_per_device"])
    row.update(mem)
    row.update(
        output_bytes_per_device=state_out, temp_bytes_per_device=temp,
        coll_by_kind_gb={k: v / 1e9 for k, v in by_kind.items() if v},
        kernels_r2={k: v[0] for k, v in t2.kernels.items()},
        bytes_basis="unfused aten inputs+outputs",
        compile_s=round(t_trace, 1), multi_pod=multi_pod)
    if verbose:
        print(f"[{arch} x {shape_name} @ {mesh_name}] "
              f"trace={t_trace:.1f}s "
              f"flops/dev={flops/1e9:.1f}G bytes/dev={byts/1e9:.2f}GB "
              f"coll/dev={coll/1e9:.3f}GB "
              f"state/dev={mem['state_bytes_per_device']/2**30:.2f}GiB "
              f"temp/dev={temp/2**30:.2f}GiB "
              f"bottleneck={r.bottleneck} "
              f"useful={r.useful_flop_frac:.2f} "
              f"roofline_frac={r.roofline_frac:.3f}", flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    archs = LM_ARCHS if (a.all or not a.arch) else [a.arch]
    shapes = list(SHAPES) if (a.all or not a.shape) else [a.shape]
    meshes = [False, True] if a.both_meshes else [a.multi_pod]
    rows = []
    for mp in meshes:
        shape, _ = mesh_mod.production_shape(mp)
        with fake_group(int(torch.tensor(shape).prod())):
            for arch in archs:
                for shp in shapes:
                    try:
                        rows.append(run_cell(arch, shp, mp))
                    except Exception as e:
                        rows.append(dict(arch=arch, shape=shp, multi_pod=mp,
                                         error=repr(e)[:500]))
                        print(f"[{arch} x {shp}] FAILED: {e!r}",
                              file=sys.stderr)
                    if a.out:
                        with open(a.out, "w") as f:
                            for r in rows:
                                f.write(json.dumps(r) + "\n")
    n_err = sum(1 for r in rows if "error" in r)
    print(f"\n{len(rows)} cells, {n_err} errors")
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
