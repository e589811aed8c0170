"""The backward of the LM kernels, on the CPU: the plain versions of the
flash-attention and SSD-scan backward against ``jax.vjp`` of the JAX
package's oracles, the autograd ``Function``s with their CUDA launches
swapped for the plain versions, and the head dims the attention kernels
take against every config in the repo. The kernels themselves are held to
their plain versions on the card in tests/test_torch_cuda.py and
chip_smoke.py."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sc

# f32 against XLA's f32 autodiff of the oracle: sums in other orders over
# S (and over the query heads of a group for dk, dv)
BWD_TOL = 1e-4
SCAN_TOL = 1e-5


def _qkv(rng, b, h, kv, s, d):
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def _jax_attention_vjp(q, k, v, do, causal):
    """dq, dk, dv of the reference oracle, k/v repeated per group of query
    heads (its vjp sums the group)."""
    g = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jref.flash_attention(q, jnp.repeat(k, g, axis=1),
                                    jnp.repeat(v, g, axis=1), causal=causal)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_backward_matches_jax_vjp(rng, d, h, kv, causal):
    q, k, v = _qkv(rng, 2, h, kv, 40, d)
    do = rng.normal(size=q.shape).astype(np.float32)
    out, want = _jax_attention_vjp(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = ref.flash_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), out, rtol=BWD_TOL, atol=BWD_TOL)
    lse = ref.flash_attention_lse(tq, tk, causal)
    got = ops.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_plain_attention_lse_is_the_softmax_normalizer(rng):
    q, k, _ = _qkv(rng, 1, 2, 1, 33, 32)
    tq, tk = torch.from_numpy(q).double(), torch.from_numpy(k).double()
    for causal in (True, False):
        s = ref._scores(tq, tk, causal)
        p = torch.exp(s - ref.flash_attention_lse(tq, tk, causal)[..., None])
        torch.testing.assert_close(p.sum(-1), torch.ones(1, 2, 33,
                                                         dtype=p.dtype))


def test_plain_attention_backward_bf16_within_its_bound(rng):
    """bf16 inputs: the plain backward (f32 arithmetic, outputs rounded to
    bf16) against the f32 one on the upcast inputs, within
    ``ref.flash_bwd_limit`` (its 2^-8 |want| term is the output rounding)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, 2, 8, 2, 70, 64))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)
                          ).bfloat16()
    o = ref.flash_attention(q, k, v, True)
    lse = ref.flash_attention_lse(q, k, True)
    got = ref.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), True)
    lims = ref.flash_bwd_limit(want, q, k, v, o, lse, do, True, 3e-5, True)
    for g, w, lim in zip(got, want, lims):
        assert g.dtype == torch.bfloat16
        assert bool(((g.float() - w).abs() <= lim).all())


def _tensor_core_bwd(q, k, v, o, lse, do, causal, fault=None):
    """The bf16 tensor-core backward's numerics, written out in plain f32:
    S, dP, delta and every sum in f32, P and dS rounded to bf16 as the
    operands of the dV, dK and dQ products, dK and dV summed over the
    group in f32, the outputs rounded to bf16. ``fault`` wires in one
    mistake: "swap" (dK and dV exchanged), "scale" (dK without its scale)
    or "mask" (the causal mask shifted by one, dropping the diagonal)."""
    B, H, S, D = q.shape
    K = k.shape[1]
    G = H // K
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    kr, vr = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    scale = 1.0 / math.sqrt(D)
    s = qf @ kr.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril(
            -1 if fault == "mask" else 0)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vr.transpose(-1, -2) - (dof * of).sum(-1, keepdim=True))

    def operand(t):
        return t.bfloat16().float()
    dq = operand(ds) @ kr * scale
    dk = (operand(ds).transpose(-1, -2) @ qf
          * (1.0 if fault == "scale" else scale)).reshape(B, K, G, S, D)
    dv = (operand(p).transpose(-1, -2) @ dof).reshape(B, K, G, S, D)
    dk, dv = dk.sum(2), dv.sum(2)
    if fault == "swap":
        dk, dv = dv, dk
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def _bf16_case(rng, h, kv, s, d, causal):
    """bf16 inputs, the plain forward's o and lse, the f32 plain backward
    on the upcast inputs and its ``ref.flash_bwd_limit`` for bf16."""
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, n, s, d)).astype(
        np.float32)).bfloat16() for n in (h, kv, kv, h))
    o = ref.flash_attention(q, k, v, causal)
    lse = ref.flash_attention_lse(q, k, causal)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal)
    lims = ref.flash_bwd_limit(want, q, k, v, o, lse, do, causal, 3e-5, True)
    return (q, k, v, o, lse, do), want, lims


def _worst(got, want, lims):
    """The largest |got - want| over its bound, over dq, dk and dv."""
    return max(float(((g.float() - w).abs() / lim).max())
               for g, w, lim in zip(got, want, lims))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_bwd_numerics_within_the_bf16_bound(rng, d, h, kv,
                                                        causal):
    """P and dS rounded to bf16 before their products (the bf16 kernels'
    numerics, emulated) stay within ``ref.flash_bwd_limit``'s bf16 bound
    at every kernel head dim, grouped heads or not, S ragged for the
    64-row tiles."""
    args, want, lims = _bf16_case(rng, h, kv, 70, d, causal)
    got = _tensor_core_bwd(*args, causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert _worst(got, want, lims) <= 1.0


@pytest.mark.parametrize("fault", ["swap", "scale", "mask"])
@pytest.mark.parametrize("d", [32, 256])
def test_tensor_core_bwd_wiring_faults_fail_the_bf16_bound(rng, fault, d):
    """The bf16 bound still sees a wiring fault: dK and dV swapped, dK's
    scale dropped, or the causal mask shifted by one each put an element
    over 50 times its bound (the faultless emulation stays under it)."""
    args, want, lims = _bf16_case(rng, 8, 2, 70, d, True)
    assert _worst(_tensor_core_bwd(*args, True), want, lims) <= 1.0
    assert _worst(_tensor_core_bwd(*args, True, fault), want, lims) > 50.0


@pytest.mark.parametrize("shape", [(2, 8, 4, 8, 16), (1, 1, 3, 5, 7),
                                   (2, 9, 2, 33, 17)])
def test_plain_scan_backward_matches_jax_vjp(rng, shape):
    st = rng.normal(size=shape).astype(np.float32)
    dc = rng.uniform(0.2, 1.0, size=shape[:3]).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    out, vjp = jax.vjp(jref.ssd_chunk_scan, jnp.asarray(st), jnp.asarray(dc))
    want_s, want_d = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tout = ref.ssd_chunk_scan(torch.from_numpy(st), torch.from_numpy(dc))
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    ds, dd = ops.ssd_chunk_scan_bwd(torch.from_numpy(g), tout,
                                    torch.from_numpy(dc))
    assert ds.dtype == torch.float32 and dd.dtype == torch.float32
    np.testing.assert_allclose(ds.numpy(), want_s, rtol=SCAN_TOL,
                               atol=SCAN_TOL * np.abs(want_s).max())
    np.testing.assert_allclose(dd.numpy(), want_d, rtol=SCAN_TOL,
                               atol=SCAN_TOL * np.abs(want_d).max())


def test_plain_scan_backward_last_chunk_gets_nothing(rng):
    """s_NC is never output, so states_{NC-1} and decay_{NC-1} reach no
    output: their gradients are exactly 0."""
    g = torch.from_numpy(rng.normal(size=(1, 4, 2, 3, 5)).astype(np.float32))
    st = torch.from_numpy(rng.normal(size=g.shape).astype(np.float32))
    dc = torch.rand(1, 4, 2)
    ds, dd = ref.ssd_chunk_scan_bwd(g, ref.ssd_chunk_scan(st, dc), dc)
    assert bool((ds[:, -1] == 0).all()) and bool((dd[:, -1] == 0).all())
    assert bool((ds[:, :-1] != 0).any())


# -- the Functions, their launches swapped for the plain versions -----------

@pytest.fixture
def plain_launches(monkeypatch):
    """Route ``ops`` to the CUDA branch for CPU tensors and the kernel
    launches to their plain versions, counting them."""
    count = {"fwd": 0, "bwd": 0, "scan": 0, "scan_bwd": 0}

    def fwd(q, k, v, causal=True, with_lse=False, window=0, softcap=0.0):
        fa.check_args(q, k, v, window, softcap)
        count["fwd"] += 1
        o = ref.flash_attention(q, k, v, causal, window, softcap)
        return ((o, ref.flash_attention_lse(q, k, causal, window, softcap))
                if with_lse else o)

    def bwd(q, k, v, o, lse, do, causal=True, window=0, softcap=0.0):
        fa.check_bwd_args(q, k, v, o, lse, do, window, softcap)
        count["bwd"] += 1
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                       softcap)

    def scan(states, decay):
        count["scan"] += 1
        return ref.ssd_chunk_scan(states, decay).contiguous()

    def scan_bwd(g, out, decay):
        sc.check_bwd_args(g, out, decay)
        count["scan_bwd"] += 1
        return ref.ssd_chunk_scan_bwd(g, out, decay)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(sc, "ssd_chunk_scan", scan)
    monkeypatch.setattr(sc, "ssd_chunk_scan_bwd", scan_bwd)
    return count


@pytest.mark.parametrize("h,kv,causal", [(4, 4, True), (8, 2, True),
                                         (4, 1, False)])
def test_attention_function_equals_autograd_of_plain(rng, plain_launches, h,
                                                     kv, causal):
    """Seq-major views as the model hands them over; the gradients come
    back in the inputs' shapes."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               .transpose(1, 2) for a in _qkv(rng, 2, h, kv, 37, 32))
    r = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    y = ops.flash_attention(*a, causal)
    assert y.grad_fn is not None
    (y * r).sum().backward()
    assert plain_launches == {"fwd": 1, "bwd": 1, "scan": 0, "scan_bwd": 0}
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    (ref.flash_attention(*b, causal) * r).sum().backward()
    for ta, tb in zip(a, b):
        assert ta.grad.shape == tb.grad.shape
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-5)


def test_attention_function_takes_a_strided_gradient(rng, plain_launches):
    """An output gradient whose head dim is not contiguous (the kernels
    read its rows) is copied before the backward."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 2, 8, 32))
    g = torch.from_numpy(rng.normal(size=(1, 2, 32, 8)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*a).backward(g.transpose(-1, -2))
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention(*b).backward(g.transpose(-1, -2).contiguous())
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-5)


def test_no_graph_means_no_function(rng, plain_launches):
    """Without autograd the forward runs alone, writing no log-sum-exp."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 2, 8, 32))
    with torch.no_grad():
        y = ops.flash_attention(q.requires_grad_(), k, v)
    assert y.grad_fn is None and plain_launches["fwd"] == 1


def test_scan_function_equals_autograd_of_plain(rng, plain_launches):
    shape = (2, 5, 3, 4, 6)
    st = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    dc = torch.from_numpy(rng.uniform(0.2, 1, size=shape[:3])
                          .astype(np.float32))
    r = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    a = [st.clone().requires_grad_(), dc.clone().requires_grad_()]
    (ops.ssd_chunk_scan(*a) * r).sum().backward()
    assert plain_launches["scan"] == 1 and plain_launches["scan_bwd"] == 1
    b = [st.clone().requires_grad_(), dc.clone().requires_grad_()]
    (ref.ssd_chunk_scan(*b) * r).sum().backward()
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-5)
    st2 = st.clone().requires_grad_()
    (ops.ssd_chunk_scan(st2, dc) * r).sum().backward()   # decay without grad
    torch.testing.assert_close(st2.grad, b[0].grad, rtol=1e-5, atol=1e-5)


# -- head dims ----------------------------------------------------------------

def _head_dims(configs):
    dims = {}
    for n in configs.LM_ARCHS:
        for cfg in (configs.get_config(n), configs.get_smoke(n)):
            if cfg.num_heads and cfg.head_dim:
                dims[f"{cfg.name}{' smoke' * cfg.is_smoke}"] = cfg.head_dim
    return dims


def test_every_configured_head_dim_is_a_kernel_head_dim():
    dims = {**_head_dims(jconfigs), **_head_dims(tconfigs)}
    assert set(dims.values()) == {32, 64, 96, 128, 256}
    for name, d in dims.items():
        assert d in fa.HEAD_DIMS, name


@pytest.mark.parametrize("d", [16, 48, 80, 96, 128, 256])
def test_plain_path_takes_any_head_dim(rng, d):
    """The CPU path (and its argument checks) takes any D, as the
    reference does; the kernels' set is checked only for CUDA tensors."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 1, 9, d))
    out = ops.flash_attention(q, k, v)
    want = jref.flash_attention(*(jnp.asarray(np.repeat(a, g, axis=1))
                                  for a, g in ((q.numpy(), 1),
                                               (k.numpy(), 2),
                                               (v.numpy(), 2))))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
    with pytest.raises(ValueError, match="not in the kernels'"
                       if d not in fa.HEAD_DIMS else "CUDA tensors"):
        fa.check_kernel_args(q, k, v)


def test_attention_of_every_head_dim_config_runs_on_the_plain_path():
    """One full-width repeat of a head-dim-128 and a head-dim-96 attention
    layer (the shapes of deepseek/yi and phi-3-vision), short sequence."""
    from repro_torch.models import layers as L
    from repro_torch.models.params import materialize
    base = tconfigs.get_config("llama3.2-1b")
    for hd, heads, kv in ((128, 32, 32), (96, 32, 32)):
        cfg = dataclasses.replace(base, head_dim=hd, num_heads=heads,
                                  num_kv_heads=kv, d_model=1024,
                                  dtype="float32")
        p = materialize(L.attn_param_defs(cfg), torch.Generator()
                        .manual_seed(hd), "cpu")
        p = {k: t.float() for k, t in p.items()}
        x = torch.randn(1, 5, 1024, generator=torch.Generator().manual_seed(1))
        pos = torch.arange(5)[None]
        y = L.attention(cfg, p, x, pos)
        assert y.shape == (1, 5, 1024) and bool(torch.isfinite(y).all())


def test_plain_path_takes_f64_and_the_kernels_refuse_it(rng):
    """The CPU path computes in f64 for f64 inputs (the yardstick of the f32
    evaluations: forward, and backward through autograd); the kernels'
    checks refuse f64 before they look at the device."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True)
               for a in _qkv(rng, 1, 4, 2, 11, 32))
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.float64
    out.square().sum().backward()
    assert all(t.grad.dtype == torch.float64 for t in (q, k, v))
    want = ref.flash_attention(q.detach().float(), k.detach().float(),
                               v.detach().float())
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(TypeError, match="kernels take float32 or bfloat16"):
        fa.check_kernel_args(q, k, v)
    st = torch.from_numpy(rng.normal(size=(1, 3, 2, 4, 5))).double()
    dc = torch.from_numpy(rng.uniform(0.5, 1.0, (1, 3, 2)))
    got = ops.ssd_chunk_scan(st, dc)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref.ssd_chunk_scan(
        st.float(), dc.float()).numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="kernels take float32 or bfloat16"):
        sc.check_kernel_args(st, dc)
    with pytest.raises(TypeError):            # f64 decay with f32 states
        ops.ssd_chunk_scan(st.float(), dc)
