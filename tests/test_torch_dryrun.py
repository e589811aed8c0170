"""The port's dry-run (repro_torch.launch.dryrun) on torch's fake process
group: meta tensors, per-device costs, the R=1/R=2 extrapolation, exact
per-device state bytes, the activation peak (``LivePeak``), the kernels'
meta route and the roofline probe.

Each test that makes a fake group destroys it (``dryrun.fake_group``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import sharding as jsh
from repro.configs import get_config as j_config
from repro.models import lm as jlm
from repro.models.params import logical_axes as j_axes
from repro_torch import configs as C
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import meta, ops, ref
from repro_torch.launch import dryrun
from repro_torch.models.params import flatten
from tools import mesh_sweep

TINY = {"train_4k": (64, 4, "train"), "prefill_32k": (64, 4, "prefill"),
        "decode_32k": (64, 4, "decode")}


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


@pytest.fixture
def tiny_shapes(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(C.SHAPES, k, v)


def test_smoke_train_cell_counts_every_rank_s_share(tiny_shapes):
    """A smoke Llama train step on a (4, 1) fake mesh: FLOPs > 0; the
    kernels' work (4 flash launches forward and backward a step, the
    visible pairs) splits over the batch exactly, chips x per-device equal
    to the (1, 1) count; the step's whole work at least the unsharded
    count (DTensor may replicate a small matmul on every rank rather than
    move its operands, never drop work), and each op counted on local
    shards, not on DTensor's global-shape propagation."""
    cfg = get_smoke("llama3.2-1b")
    with dryrun.fake_group(1):
        one, _, _ = dryrun.trace(cfg, "train_4k", _mesh((1, 1)))
    with dryrun.fake_group(4):
        four, _, placed = dryrun.trace(cfg, "train_4k", _mesh((4, 1)))
    assert four.flops > 0 and four.bytes > 0
    layers = cfg.num_layers
    for name in ("flash_attention", "flash_attention_bwd"):
        n, ops_, _ = four.kernels[name]
        assert n == layers and one.kernels[name][0] == layers
        assert 4 * ops_ == one.kernels[name][1]
    B, S = TINY["train_4k"][1], TINY["train_4k"][0]
    pairs = B * cfg.num_heads * meta.visible_pairs(S, 0, True)
    assert one.kernels["flash_attention"][1] == \
        4 * cfg.head_dim * pairs * layers
    assert 4 * four.flops >= one.flops
    assert sum(four.coll.values()) > 0 and sum(one.coll.values()) >= 0
    # the activation peak: forward, backward and optimizer phases, each
    # rank holding less than the whole step's temporaries
    assert len(four.temp_phases) == len(one.temp_phases) == 3
    assert 0 < four.temp_bytes < one.temp_bytes
    tok = placed["batch"]["tokens"]
    assert tok.device.type == "meta" and tuple(tok.shape) == (B, S)
    assert tok.to_local().shape[0] == B // 4


# the bytes' extrapolation misses what is not linear in the repeats:
# DTensor reassembles gathered shards with ``cat`` in layouts that depend
# on R (a stacked leaf's gradient), 0.8% of the smoke step's bytes at R=4
BYTES_RTOL = 0.02


def test_extrapolation_equals_a_full_depth_trace(tiny_shapes):
    """cost(R) = a + R b: the R=1/R=2 traces price a four-repeat smoke
    Llama's operations and collectives as tracing it whole does, and its
    bytes within BYTES_RTOL. The activation peak, extrapolated phase by
    phase (each phase's peak is linear in R, their maximum is not: the
    optimizer's peak overtakes the backward's between R=2 and R=4 here),
    equals the whole trace's."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), num_layers=4)
    with dryrun.fake_group(4):
        mesh = _mesh((2, 2))
        flops, byts, coll, by_kind, _, temp = dryrun.extrapolated(
            cfg, "train_4k", mesh)
        direct, _, _ = dryrun.trace(cfg, "train_4k", mesh)
    assert temp == direct.temp_bytes > 0
    assert direct.temp_phases.index(temp) == 2
    assert flops == pytest.approx(direct.flops, rel=1e-12)
    assert coll == pytest.approx(sum(direct.coll.values()), rel=1e-12)
    assert by_kind == pytest.approx(direct.coll, rel=1e-12)
    assert byts == pytest.approx(direct.bytes, rel=BYTES_RTOL)


def test_rows_carry_the_activation_peak(monkeypatch, tiny_shapes):
    """``run_cell``'s rows of a smoke Llama's prefill and decode cells on
    a (2, 2) fake mesh: a positive ``temp_bytes_per_device``, which is
    what one traced step of the cell holds (one phase, no R term)."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke)
    cfg = get_smoke("llama3.2-1b")
    with dryrun.fake_group(4):
        mesh = _mesh((2, 2))
        for shape in ("prefill_32k", "decode_32k"):
            row = dryrun.run_cell("llama3.2-1b", shape, False,
                                  verbose=False, mesh=mesh)
            t, _, _ = dryrun.trace(cfg, shape, mesh)
            assert isinstance(row["temp_bytes_per_device"], int)
            assert row["temp_bytes_per_device"] == t.temp_bytes > 0, shape
            assert len(t.temp_phases) == 1


CELLS = mesh_sweep.cells()


@pytest.mark.parametrize("arch,mesh_shape,shape", CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}-{s}" for a, m, s in CELLS])
def test_every_smoke_cell_traces_on_every_small_mesh(arch, mesh_shape,
                                                     shape, tiny_shapes):
    """``dryrun.trace`` of a train, prefill and decode step of each smoke
    architecture on the (1, 1), (4, 1), (2, 2) and (1, 4) fake meshes:
    the step runs, its costs are positive, and its loss or logits are a
    DTensor of their shape on the mesh. A kv-head dim of size 1 keeps its
    split over a 1-way "model" axis (the reference's rule, ``fix_spec``),
    and ``placements`` makes that split ``Replicate()``: a ``Shard`` there
    made DTensor refuse the decode's score product its view (F3). The
    decode and cross-attention tile runs per shard of batch and kv heads:
    torch 2.11's DTensor refused its flatten of a split kv-head dim on the
    (2, 2) and (1, 4) meshes (F4; ``tools/mesh_sweep.py`` runs these cells
    without JAX under any torch)."""
    t, out, mesh = mesh_sweep.trace_cell(arch, mesh_shape, shape)
    assert t.flops > 0 and t.bytes > 0 and t.temp_bytes > 0
    S, B, _ = TINY[shape]
    V = mesh_sweep.smoke_cfg(arch).vocab_size
    if shape == "train_4k":
        leaf, want = out[2], ()
    elif shape == "prefill_32k":
        leaf, want = out, (B, S, V)
    else:
        leaf, want = out[0], (B, V)
    assert leaf.device_mesh == mesh and tuple(leaf.shape) == want


def test_one_rank_mesh_decode_step_is_the_unsharded_step(tiny_shapes):
    """A smoke Llama (one kv head) ``decode_step`` on a one-rank gloo CPU
    mesh (a ``file://`` store, as tests/test_torch_sharded_lm.py makes its
    group), its parameters, cache (random rows) and batch placed by
    ``dryrun.place``: the logits and every cache leaf equal the unsharded
    step's bit for bit (``tools/mesh_sweep.one_rank_decode``)."""
    assert mesh_sweep.one_rank_decode(TINY)


def _real(tree, gen):
    """Real CPU tensors of the meta tree's shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _real(v, gen) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_real(v, gen) for v in tree))
    if not torch.is_tensor(tree):
        return tree
    if tree.dtype.is_floating_point:
        return torch.randn(tree.shape, generator=gen).to(tree.dtype)
    return torch.randint(0, 64, tree.shape, generator=gen, dtype=tree.dtype)


def test_live_peak_is_the_same_on_meta_and_real_cpu_tensors(tiny_shapes,
                                                           monkeypatch):
    """One unsharded smoke Llama train step, its inputs on the meta device
    and then real CPU tensors: every phase's peak to the byte. On the CPU
    the kernels' calls take their meta twins (which allocate what the
    card's wrappers do), not the plain versions' dense scores, so both
    runs take the card's route. The peak of all new storages is at least
    the temporaries' (outputs add to it)."""
    monkeypatch.setattr(ref, "flash_attention", meta.flash_attention)
    monkeypatch.setattr(ref, "ssd_chunk_scan", meta.ssd_chunk_scan)
    cfg = get_smoke("llama3.2-1b")
    got = []
    for real in (False, True):
        step_fn, args, _ = dryrun.build_step(cfg, "train_4k")
        if real:
            args = _real(args, torch.Generator().manual_seed(0))
        peak = dryrun.LivePeak()
        peak.exclude(args)
        with peak:
            out = step_fn(**args)
        got.append((peak.phase_peaks(out), peak.peak))
        assert out[2].device.type == ("cpu" if real else "meta")
    assert got[0] == got[1]
    phases, whole = got[0]
    assert len(phases) == 3 and 0 < max(phases) <= whole


def _ref_local_bytes(arch):
    """Parameter bytes on one device of the (16, 16) mesh under the
    reference's resolved and fixed specs: each leaf's shape divided by
    the mesh sizes its spec names."""
    jdefs = jlm.param_defs(j_config(arch))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    names = jax.make_mesh((1, 1), ("data", "model"))
    specs = jax.tree.map(lambda s: NamedSharding(amesh, s.spec),
                         jsh.spec_tree(j_axes(jdefs), names),
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    fixed = flatten(jsh.fix_divisibility(specs, jdefs))
    total = 0
    for k, d in flatten(jdefs).items():
        n = 1
        for dim, part in zip(d.shape, tuple(fixed[k].spec) + (None,) * 8):
            axes = () if part is None else (
                (part,) if isinstance(part, str) else tuple(part))
            div = int(np.prod([16 for _ in axes])) if axes else 1
            n *= dim // div
        total += n * np.dtype(d.dtype).itemsize
    return total


def test_state_bytes_equal_the_local_shards_of_the_reference_specs():
    """Per-device parameter, gradient and AdamW bytes of every LM config
    on the production mesh: the local shard sizes under the reference's
    specs (parameters and gradients in bf16, two f32 moments)."""
    with dryrun.fake_group(256):
        from repro_torch.launch import mesh as mesh_mod
        mesh = mesh_mod.make_production_mesh(device_type="cpu")
        for arch in C.LM_ARCHS:
            mem = dryrun.memory_per_device(get_config(arch), "train_4k",
                                           mesh)
            want = _ref_local_bytes(arch)
            assert mem["param_bytes_per_device"] == want, arch
            assert mem["grad_bytes_per_device"] == want, arch
            assert mem["opt_bytes_per_device"] == 4 * want, arch
            assert mem["state_bytes_per_device"] == 6 * want, arch


def test_kernels_take_a_meta_route_for_meta_tensors_only():
    """On meta tensors the flash and scan wrappers return their kernels'
    output shapes and report the kernels' own work; CPU tensors still run
    the plain versions."""
    seen = []
    meta.counter = lambda *a: seen.append(a)
    try:
        q = torch.empty(2, 4, 64, 32, device="meta", requires_grad=True)
        k = torch.empty(2, 2, 64, 32, device="meta", requires_grad=True)
        v = torch.empty(2, 2, 64, 32, device="meta", requires_grad=True)
        o = ops.flash_attention(q, k, v, True, 16, 0.0)
        assert o.device.type == "meta" and o.shape == q.shape
        o.sum().backward()
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        pairs = 2 * 4 * meta.visible_pairs(64, 16, True)
        assert seen[0][:2] == ("flash_attention", 4 * 32 * pairs)
        assert seen[1][:2] == ("flash_attention_bwd", 10 * 32 * pairs)
        st = torch.empty(1, 4, 2, 8, 16, device="meta")
        dec = torch.empty(1, 4, 2, device="meta")
        assert ops.ssd_chunk_scan(st, dec).shape == st.shape
        assert seen[2] == ("ssd_chunk_scan", 2.0 * st.numel(),
                           float(2 * st.numel() * 4 + dec.numel() * 4))
    finally:
        meta.counter = None
    assert meta.visible_pairs(8, 0, True) == 36
    assert meta.visible_pairs(8, 3, True) == 6 + 5 * 3
    assert meta.visible_pairs(8, 0, False) == 64
    g = torch.Generator().manual_seed(0)
    qc, kc, vc = (torch.randn(1, 2, 16, 32, generator=g) for _ in range(3))
    torch.testing.assert_close(ops.flash_attention(qc, kc, vc),
                               ref.flash_attention(qc, kc, vc, True, 0, 0.0),
                               rtol=0, atol=0)


def test_hillclimb_prints_its_roofline_terms(capsys):
    from repro_torch.launch import hillclimb
    r = hillclimb.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--profile"])
    out = capsys.readouterr().out
    assert "=== llama3.2-1b x decode_32k" in out
    for term in ("t_compute=", "t_memory=", "t_collective=", "bound=",
                 "useful=", "roofline_frac=", "bytes by op"):
        assert term in out, term
    assert r.chips == 256 and r.hlo_flops > 0
    assert not torch.distributed.is_initialized()
