"""Logical-axis sharding of the port (repro_torch.sharding, launch/mesh,
core/roofline) held to the reference's rule resolution.

The reference's resolution is pure: ``resolve_spec`` under a (1, 1) mesh of
the production axis names gives the production specs, and
``fix_divisibility`` reads only the mesh's sizes, which an ``AbstractMesh``
of the production shape supplies, so no 256-device host is needed. The
port's side runs on real ``DeviceMesh``es of torch's fake process group
(256 and 512 ranks in this process), destroyed after each test.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import sharding as jsh
from repro.configs import LM_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import cell_is_runnable as j_runnable
from repro.configs import get_config as j_config
from repro.core import roofline as jrl
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.models.params import logical_axes as j_axes
from repro_torch import sharding as sh
from repro_torch.configs import (LM_ARCHS, SHAPES, cell_is_runnable,
                                 get_config)
from repro_torch.core import roofline as rl
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.params import logical_axes, flatten

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _port_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.fixture
def fake_mesh():
    """fake_mesh(shape, names): a DeviceMesh over a fake group of that
    many ranks; the group is destroyed after the test."""
    stack = []

    def make(shape, names):
        cm = dryrun.fake_group(int(np.prod(shape)))
        cm.__enter__()
        stack.append(cm)
        return _port_mesh(shape, names)
    yield make
    while stack:
        stack.pop().__exit__(None, None, None)


def _jax_specs(axes_tree, shapes_tree, multi_pod, rules=None):
    """The reference's resolved and divisibility-fixed specs, as tuples
    padded to each leaf's rank."""
    shape, names = MESHES[multi_pod]
    mesh = jax.make_mesh((1,) * len(names), names)
    amesh = AbstractMesh(shape, names)
    resolved = jsh.spec_tree(axes_tree, mesh, rules)
    resolved = jax.tree.map(lambda s: NamedSharding(amesh, s.spec), resolved,
                            is_leaf=lambda x: isinstance(x, NamedSharding))
    fixed = jsh.fix_divisibility(resolved, shapes_tree)
    shapes = flatten(shapes_tree)
    return {k: _pad(tuple(v.spec), len(shapes[k].shape))
            for k, v in flatten(fixed).items()}


def _pad(spec, n):
    """A spec as plain tuples (a 1-tuple as its bare name), padded with
    None to rank n."""
    def one(a):
        if not isinstance(a, (list, tuple)):
            return a
        return tuple(a) if len(a) > 1 else (a[0] if a else None)
    return tuple(one(a) for a in spec) + (None,) * (n - len(spec))


def _port_specs(axes_tree, like_tree, mesh, rules=None):
    fixed = sh.fix_divisibility(sh.spec_tree(axes_tree, mesh, rules),
                                like_tree, mesh)
    return {k: _pad(v, len(flatten(like_tree)[k].shape))
            for k, v in flatten(fixed).items()}


def test_registry_shapes_and_skip_rule_equal_the_reference():
    assert LM_ARCHS == J_ARCHS
    assert SHAPES == J_SHAPES
    for arch in LM_ARCHS + ["detnet"]:
        for shape in SHAPES:
            assert cell_is_runnable(arch, shape) == j_runnable(arch, shape)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_parameter_specs_equal_the_reference(multi_pod, fake_mesh):
    """Every parameter leaf of all ten LM configs: the port's resolved,
    divisibility-fixed spec equals the reference's, and its placements
    split the leaf as the spec says."""
    mesh = fake_mesh(*MESHES[multi_pod])
    n = 0
    for arch in LM_ARCHS:
        jdefs = jlm.param_defs(j_config(arch))
        defs = lm.param_defs(get_config(arch))
        want = _jax_specs(j_axes(jdefs), jdefs, multi_pod)
        got = _port_specs(logical_axes(defs), defs, mesh)
        assert sorted(got) == sorted(want), arch
        for k in want:
            assert got[k] == want[k], (arch, k, got[k], want[k])
            pl = sh.placements(got[k], mesh)
            assert len(pl) == mesh.ndim
            n += 1
    assert n > 200


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_decode_cache_specs_equal_the_reference(multi_pod, fake_mesh):
    """Every cache leaf of the runnable decode shapes, under the shapes'
    rule overrides (``shape_rules``)."""
    mesh = fake_mesh(*MESHES[multi_pod])
    n = 0
    for arch in LM_ARCHS:
        for shape in ("decode_32k", "long_500k"):
            if not cell_is_runnable(arch, shape)[0]:
                continue
            jcfg, cfg = j_config(arch), get_config(arch)
            jab, jax_ax = jmesh.decode_state_specs(jcfg, shape)
            tab, tax = mesh_mod.decode_state_specs(cfg, shape)
            rules = mesh_mod.shape_rules(cfg, shape)
            assert rules == jmesh.shape_rules(jcfg, shape)
            want = _jax_specs(jax_ax, jab, multi_pod, rules)
            got = _port_specs(tax, tab, mesh, rules)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k] == want[k], (arch, shape, k, got[k], want[k])
                assert tuple(flatten(tab)[k].shape) == tuple(
                    flatten(jab)[k].shape)
                n += 1
    assert n > 50


def test_resolve_spec_dedup(fake_mesh):
    mesh = fake_mesh((1,), ("data",))
    with sh.use_mesh(mesh, {"batch": "data", "kv_seq": "data"}):
        assert sh.resolve_spec(("batch", "kv_seq", None)) == ("data", None,
                                                              None)
    jm = jax.make_mesh((1,), ("data",))
    with jsh.use_mesh(jm, {"batch": "data", "kv_seq": "data"}):
        assert jsh.resolve_spec(("batch", "kv_seq", None)) == P("data", None,
                                                                None)


def test_rules_filter_missing_axes(fake_mesh):
    mesh = fake_mesh((1,), ("data",))
    with sh.use_mesh(mesh):                    # no "pod"/"model" axes
        assert sh.resolve_spec(("batch", "tensor")) == ("data", None)
    assert sh.resolve_spec(("batch", "tensor")) == (None, None)


def test_fix_divisibility_drops_the_axis_that_does_not_divide(fake_mesh):
    mesh = fake_mesh((2, 4), ("data", "model"))
    assert sh.fix_spec(("model", "data"), (6, 4), mesh) == (None, "data")
    assert sh.fix_spec((("data", "model"), None), (16, 3), mesh) == (
        ("data", "model"), None)
    assert sh.fix_spec((("data", "model"), None), (6, 3), mesh) == (
        "data", None)
    pl = sh.placements((("data", "model"), None), mesh)
    assert [p.is_shard(0) for p in pl] == [True, True]


def test_shard_is_the_same_object_outside_a_mesh():
    x = torch.ones(4, 4)
    assert sh.shard(x, "batch", "embed") is x
    assert sh.current_mesh() is None


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_inputs_rules_and_model_flops_equal_the_reference(arch):
    jcfg, cfg = j_config(arch), get_config(arch)
    for shape in SHAPES:
        want = jmesh.input_specs(jcfg, shape)
        got = mesh_mod.input_specs(cfg, shape)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (shape, k)
            assert str(got[k].dtype).replace("torch.", "") == str(v.dtype)
            assert got[k].device.type == "meta"
        assert mesh_mod.input_axes(cfg, shape) == jmesh.input_axes(jcfg,
                                                                   shape)
        assert mesh_mod.shape_rules(cfg, shape) == jmesh.shape_rules(jcfg,
                                                                     shape)
        assert mesh_mod.model_flops(cfg, shape) == jmesh.model_flops(jcfg,
                                                                     shape)


def test_elastic_mesh_shapes_follow_the_gcd_rule(fake_mesh):
    """The reference's ``make_mesh_from_devices``: model = gcd(16, n),
    data = n / model, for every n up to 512; and one mesh built so."""
    for n in range(1, 513):
        mp = math.gcd(16, n)
        assert mesh_mod.mesh_shape_from_ranks(n) == (n // mp, mp)
        assert mesh_mod.mesh_shape_from_ranks(n, 4) == (
            n // math.gcd(4, n), math.gcd(4, n))
    fake_mesh((24,), ("x",))
    mesh = mesh_mod.make_mesh_from_ranks(device_type="cpu")
    assert tuple(mesh.shape) == (3, 8)
    assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="24"):
        mesh_mod.make_mesh_from_ranks(16, device_type="cpu")


def test_roofline_terms_with_h100_constants():
    """The twin of the reference's ``test_roofline_terms``, with the H100
    SXM's figures."""
    assert (rl.PEAK_FLOPS_BF16, rl.HBM_BW, rl.NVLINK_BW) == (989e12, 3.35e12,
                                                             900e9)
    r = rl.Roofline("a", "s", "m", chips=4, hlo_flops=4 * 989e12,
                    hlo_bytes=4 * 3.35e12, coll_bytes=4 * 900e9 * 0.5,
                    coll_by_kind={}, model_flops=2 * 989e12)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9
    assert r.bottleneck in ("compute", "memory")
    assert abs(r.useful_flop_frac - 0.5) < 1e-9
    assert abs(r.roofline_frac - 0.5) < 1e-9
    j = jrl.Roofline("a", "s", "m", chips=4, hlo_flops=4 * 197e12,
                     hlo_bytes=4 * 819e9, coll_bytes=0.0, coll_by_kind={},
                     model_flops=2 * 197e12)
    assert sorted(j.row()) == sorted(r.row())


def test_collective_tally_counts_result_bytes_by_kind(fake_mesh):
    """On a 4-rank fake mesh: an all-gather, a reduce-scatter and an
    all-reduce of an (8, 16) f32 tensor, each counted by the bytes of its
    result on one rank (512, 128 and 512)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = fake_mesh((4,), ("data",))
    sharded = distribute_tensor(torch.zeros(8, 16), mesh, [Shard(0)],
                                src_data_rank=None)
    part = DTensor.from_local(torch.zeros(8, 16), mesh, [Partial()],
                              run_check=False)
    tally = rl.cost_tally()
    with tally:
        sharded.redistribute(mesh, [Replicate()])
        part.redistribute(mesh, [Shard(0)])
        part.redistribute(mesh, [Replicate()])
    assert tally.coll == {"all-gather": 512, "reduce-scatter": 128,
                          "all-reduce": 512, "all-to-all": 0,
                          "collective-permute": 0}
    assert rl.collective_kind("_c10d_functional.all_gather_into_tensor") \
        == "all-gather"
    assert rl.collective_kind("aten.mm") is None


def test_mesh_launch_needs_torchrun_and_keeps_the_unsharded_path(
        monkeypatch):
    """``--mesh`` outside a torchrun launch raises (nothing falls back to
    one device); without ``--mesh`` and outside torchrun the one-device
    path runs as before."""
    from repro_torch.launch import train as launch_train
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                           "cpu", "--mesh", "auto", "--steps", "1"])
    res = launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                             "cpu", "--steps", "1", "--batch", "2", "--seq",
                             "16"])
    assert len(res.losses) == 1
    assert not any(sh.is_dtensor(p) for p in flatten(res.params).values())
