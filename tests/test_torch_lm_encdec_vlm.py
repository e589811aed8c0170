"""repro_torch's LM stack against repro's for the two architectures of the
port's tenth slice: phi-3-vision-4.2b (256 precomputed image embeddings
written over the first positions, head dim 96) and whisper-small (a
bidirectional encoder over precomputed frames, cross-attention from every
decoder layer, sinusoidal positions, the ungated GeLU MLP, tied
embeddings). Smoke configs; the same numpy-seeded parameters, tokens,
images and frames go through both packages (``lm_from_jax``): configs and
trees, forward, the encoder and its cross K/V, the loss and every gradient,
bf16, decode with a filled cross-attention cache, sinusoidal decode
positions, the engines token for token (the cross cache zero, as the
reference leaves it), the launchers, and the pieces no config uses
(layernorm, qk-norm).

Random-init nets amplify f32 rounding, whisper's most: its logits are
0.9 in scale and its residual stream grows to a few hundred over six
layers, so two correct f32 sum orders (XLA's dot, MKL's sgemm) part by up
to 1e-3 of the logits. Where a comparison in f32 misses the tight
tolerance, the port is held to the f64 evaluation of both packages (x64
on, their f32 accumulation type set to f64; they agree within F64_TOL):
its distance from it at most F64_K times the reference's own.
"""
import contextlib
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.params import (flatten, lm_from_jax, lm_to_jax,
                                       unflatten)
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import loop, optim

ARCHS = ["phi-3-vision-4.2b", "whisper-small"]
ROOT = Path(__file__).resolve().parents[1]

# f32: logits within FWD_TOL of their scale (max(1, max|logit|)); else the
# port's distance from the f64 evaluation at most F64_K times the
# reference's (+ FWD_TOL of the scale). The two distances are two samples
# of amplified rounding (PyTorch's CPU matmuls round otherwise than XLA's):
# their ratio moves with the seed of these random nets, the port closer on
# some and the reference on others, while the pieces alone (attention,
# cross-attention, MLP) are as close as the reference's; so F64_K is 8
FWD_TOL, F64_K, F64_TOL = 1e-4, 8.0, 1e-8
# one training step: the loss within LOSS_RTOL; each gradient leaf within
# GRAD_TOL of the largest entry, else held to f64 as above with GRAD_K, as
# tests/test_torch_lm_archs.py holds the slice-9 configs. Whisper's encoder
# leaves and frames are ill-conditioned: the reference's f32 gradients sit
# up to 8.4e-3 of the largest entry off f64, the port's 0.36-0.39 times
# that
LOSS_RTOL, GRAD_TOL, GRAD_K = 1e-5, 1e-4, 2.0
# bf16: the port's median row error from the reference's f32 logits at most
# BF16_FACTOR x the reference's own bf16 error + BF16_FLOOR
BF16_FACTOR, BF16_FLOOR = 2.0, 1e-2
# pieces alone (layernorm, qk-norm attention, the ungated MLP), f32
PIECE_TOL = 1e-5


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype, **kw))


def _trees(jcfg, dtype="float32", seed=0):
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(seed))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, lm_from_jax(jp)


def _batch(cfg, B=2, S=32, seed=2, dtype=np.float32):
    """tokens/labels (next-token), and the config's image embeddings or
    encoder frames, N(0, 1), from a numpy seed."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.num_image_tokens:
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model)).astype(dtype)
    if cfg.encoder_layers:
        batch["encoder_frames"] = rng.normal(
            size=(B, cfg.num_encoder_frames, cfg.d_model)).astype(dtype)
    return batch


def _extras(batch):
    return {k: v for k, v in batch.items()
            if k in ("image_embeds", "encoder_frames")}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d, dtype=None):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    return {k: (v.to(dtype) if dtype is not None and v.is_floating_point()
                else v) for k, v in out.items()}


def _scale(want):
    return max(1.0, float(np.max(np.abs(want))))


def _hold(got, want, want64, what, tol=FWD_TOL, k=F64_K):
    """got (the port's f32) within tol of the reference's f32 ``want``
    (times the scale), else no further from the f64 evaluation ``want64``
    than k times the reference (+ tol of the scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = _scale(want)
    diff = float(np.abs(got - want).max())
    if diff <= tol * scale:
        return diff
    ref_off = float(np.abs(want - want64).max())
    port_off = float(np.abs(got - want64).max())
    assert port_off <= k * ref_off + tol * scale, (what, diff, port_off,
                                                  ref_off, scale)
    return diff


def _row_err(got, want_f32):
    want_f32 = np.asarray(want_f32, np.float32)
    want_f32 = want_f32.reshape(-1, want_f32.shape[-1])
    d = np.asarray(got, np.float32).reshape(want_f32.shape) - want_f32
    return float(np.median(np.sqrt(np.mean(d ** 2, axis=-1)))) / float(
        np.sqrt(np.mean(want_f32 ** 2)))


@pytest.fixture
def x64(monkeypatch):
    """A context manager for the reference in f64: x64 on and its f32
    accumulation type (``f32`` of ``lm`` and ``layers``) set to f64 inside
    it. It yields a function that casts a tree of arrays to f64 jnp
    arrays."""
    @contextlib.contextmanager
    def on():
        with monkeypatch.context() as m, jax.enable_x64(True):
            m.setattr(jlm, "f32", jnp.float64)
            m.setattr(JL, "f32", jnp.float64)
            yield lambda tree: jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
    return on


def _port64(tp):
    return unflatten({k: v.detach().double() for k, v in flatten(tp).items()})


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

def _flat_defs(defs, prefix=""):
    out = {}
    for k in sorted(defs):
        v = defs[k]
        out.update(_flat_defs(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: dataclasses.astuple(v)})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_defs_equal_the_reference(arch):
    """CONFIG and SMOKE field for field, the parameter trees (the encoder,
    ``xattn``) and the cache trees (``xk``/``xv`` over the frames)."""
    for j, t in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                 (jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert _flat_defs(jlm.param_defs(j)) == _flat_defs(lm.param_defs(t))
        for s_max in (8, 40):
            assert _flat_defs(jlm.cache_defs(j, 2, s_max)) == \
                _flat_defs(lm.cache_defs(t, 2, s_max))
    defs = _flat_defs(lm.cache_defs(tconfigs.get_config(arch), 4, 64))
    if arch == "whisper-small":
        assert defs["blk0.xk"][0] == (12, 4, 1500, 12, 64)
        assert "encoder.layers.attn.wq" in _flat_defs(
            lm.param_defs(tconfigs.get_config(arch)))
    else:
        assert not any("xk" in k for k in defs)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_from_jax_carries_every_leaf(arch):
    """The bridge carries the encoder's, ``xattn``'s and the cache's
    ``xk``/``xv`` leaves bit for bit, both ways, in the port's own shapes."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16", seed=3)
    jflat, tflat = flatten(jp), flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    mine = flatten(lm.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu"))
    back = flatten(lm_to_jax(tp))
    for k, t in tflat.items():
        assert t.dtype == torch.bfloat16 and t.shape == mine[k].shape, k
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(jflat[k]).view(np.int16),
            k)
        np.testing.assert_array_equal(back[k].view(np.int16),
                                      np.asarray(jflat[k]).view(np.int16), k)
    if arch == "whisper-small":
        assert {k for k in tflat if k.startswith("encoder.")} == {
            "encoder.final_norm", *(f"encoder.layers.{s}.{w}"
                                    for s, ws in (("attn", ("norm", "wq",
                                                            "wk", "wv",
                                                            "wo")),
                                                  ("mlp", ("norm", "wi_gate",
                                                           "wo")))
                                    for w in ws)}
        assert "blocks.blk0.xattn.wk" in tflat and "head" not in tflat
        jc = jmaterialize(jlm.cache_defs(jcfg, 2, 8), jax.random.key(1))
        jc["blk0"]["xk"] = jax.random.normal(jax.random.key(2),
                                             jc["blk0"]["xk"].shape,
                                             jnp.bfloat16)
        tc = lm_from_jax(jc)
        np.testing.assert_array_equal(
            tc["blk0"]["xk"].view(torch.int16).numpy(),
            np.asarray(jc["blk0"]["xk"]).view(np.int16))
    else:
        assert "head" in tflat and not any("xattn" in k for k in tflat)


# ---------------------------------------------------------------------------
# forward, encoder, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch, x64):
    """Logits with image embeddings (phi-3) or encoder frames (whisper),
    f32 (``_hold``), and in f64 within F64_TOL of the reference's f64."""
    batch = _batch(jconfigs.get_smoke(arch), seed=1)
    tok = batch["tokens"]
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    want = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok),
                                  **_jnp(_extras(batch)))[0])
    got, aux = lm.forward(tcfg, tp, torch.from_numpy(tok),
                          **_torch(_extras(batch)))
    assert got.shape == (2, 32, tcfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    j64, t64 = _cfgs(arch, "float64")
    with x64() as c64:
        want64 = np.asarray(jlm.forward(j64, c64(jp), jnp.asarray(tok),
                                        **c64(_extras(batch)))[0])
    got64 = lm.forward(t64, _port64(tp), torch.from_numpy(tok),
                       **_torch(_extras(batch), torch.float64))[0].numpy()
    assert float(np.abs(got64 - want64).max()) <= F64_TOL * _scale(want64)
    _hold(got.numpy(), want, want64, arch)


def test_image_embeds_replace_the_first_positions():
    """phi-3: the image embeddings replace the token rows at positions
    0..N-1 (the tokens there change nothing), a batch of fewer rows or
    positions writes only those, as ``lax.dynamic_update_slice`` does, and
    embeddings that do not fit raise; without them the forward is
    text-only, as the reference's."""
    jcfg, tcfg = _cfgs("phi-3-vision-4.2b")
    jp, tp = _trees(jcfg, seed=4)
    batch = _batch(tcfg, seed=4)
    N = tcfg.num_image_tokens
    tok, img = torch.from_numpy(batch["tokens"]), torch.from_numpy(
        batch["image_embeds"])
    other = tok.clone()
    other[:, :N] = (other[:, :N] + 7) % tcfg.vocab_size
    x = lm._embed(tcfg, tp, tok, img)
    assert torch.equal(x, lm._embed(tcfg, tp, other, img))
    assert torch.equal(x[:, :N], img) and torch.equal(
        x[:, N:], tp["embed"][tok[:, N:].long()])
    part = lm._embed(tcfg, tp, tok, img[:1, :3])
    want = np.asarray(jlm._embed(jcfg, jp, jnp.asarray(tok.numpy()),
                                 jnp.asarray(img[:1, :3].numpy())))
    np.testing.assert_array_equal(part.numpy(), want)
    for bad in (torch.zeros(3, N, tcfg.d_model), torch.zeros(2, 40,
                                                             tcfg.d_model),
                torch.zeros(N, tcfg.d_model)):
        with pytest.raises(ValueError, match="do not fit"):
            lm._embed(tcfg, tp, tok, bad)
    text = lm.forward(tcfg, tp, tok)[0].numpy()
    want = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok.numpy()))[0])
    np.testing.assert_allclose(text, want, rtol=FWD_TOL,
                               atol=FWD_TOL * _scale(want))


def test_encode_and_encoder_kv_match_the_reference(x64):
    """whisper: the encoder's output (frames + sinusoidal positions,
    non-causal attention, the ungated GeLU MLP, final norm) and the
    stacked cross K/V (R, B, F, K, hd), f32 and f64."""
    arch = "whisper-small"
    fr = _batch(jconfigs.get_smoke(arch), seed=5)["encoder_frames"]
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg, seed=5)
    we = jlm.encode(jcfg, jp, jnp.asarray(fr))
    wkv = jlm.encoder_kv(jcfg, jp, we)
    we, wkv = np.asarray(we), jax.tree.map(np.asarray, wkv)
    ge = lm.encode(tcfg, tp, torch.from_numpy(fr))
    gkv = lm.encoder_kv(tcfg, tp, ge)
    j64, t64 = _cfgs(arch, "float64")
    with x64() as c64:
        we64 = jlm.encode(j64, c64(jp), c64(fr))
        wkv64 = jax.tree.map(np.asarray, jlm.encoder_kv(j64, c64(jp), we64))
        we64 = np.array(we64)
    ge64 = lm.encode(t64, _port64(tp), torch.from_numpy(fr).double())
    gkv64 = lm.encoder_kv(t64, _port64(tp), ge64)
    assert float((ge64 - torch.from_numpy(we64)).abs().max()) \
        <= F64_TOL * _scale(we64)
    _hold(ge.numpy(), we, we64, "encode")
    R, B, F_ = tcfg.num_layers, 2, tcfg.num_encoder_frames
    for kv in ("k", "v"):
        assert len(gkv[kv]) == 1
        assert gkv[kv][0].shape == (R, B, F_, tcfg.num_kv_heads,
                                    tcfg.head_dim)
        np.testing.assert_allclose(gkv64[kv][0].numpy(), wkv64[kv][0],
                                   atol=F64_TOL * _scale(wkv64[kv][0]))
        _hold(gkv[kv][0].numpy(), wkv[kv][0], wkv64[kv][0], f"xattn {kv}")


def _jax_loss_grads(jcfg, jp, batch):
    """The reference's loss and gradients w.r.t. every parameter and the
    batch's image embeddings or frames."""
    extra = _extras(batch)
    (key, val), = extra.items()

    def f(params, e):
        b = {**_jnp({k: v for k, v in batch.items() if k != key}), key: e}
        return jlm.lm_loss(jcfg, params, b)
    (loss, _), (g, ge) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(val))
    return float(loss), {**{k: np.asarray(v, np.float64)
                            for k, v in flatten(g).items()},
                         key: np.asarray(ge, np.float64)}


def _port_loss_grads(tcfg, tp, batch, dtype=None):
    flat = flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    b = _torch(batch, dtype)
    (key, val), = _extras(b).items()
    val.requires_grad_(True)
    loss, _ = lm.lm_loss(tcfg, tp, b)
    loss.backward()
    return float(loss.detach()), {**{k: p.grad.double().numpy()
                                     for k, p in flat.items()},
                                  key: val.grad.double().numpy()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, x64):
    """One training step's loss and the gradient of every parameter (the
    encoder's and the cross-attention's included) and of the image
    embeddings or frames, in f32: each within GRAD_TOL of the largest
    entry, else no further from the f64 evaluation than GRAD_K times the
    reference's own; in f64 the two packages agree within F64_TOL."""
    batch = _batch(jconfigs.get_smoke(arch))
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    lj, gj = _jax_loss_grads(jcfg, jp, batch)
    lt, gt = _port_loss_grads(tcfg, tp, batch)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    j64, t64 = _cfgs(arch, "float64")
    with x64() as c64:
        l64, g64 = _jax_loss_grads(j64, c64(jp), {
            k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in batch.items()})
    lp64, gp64 = _port_loss_grads(t64, _port64(tp), batch, torch.float64)
    np.testing.assert_allclose(lp64, l64, rtol=1e-12)
    assert sorted(gj) == sorted(gt) == sorted(g64) == sorted(gp64)
    gmax = max(float(np.abs(v).max()) for v in gj.values())
    for k in g64:
        assert float(np.abs(gp64[k] - g64[k]).max()) <= F64_TOL * gmax, k
    for k in gj:
        assert gt[k].shape == gj[k].shape, k
        assert float(np.abs(gt[k]).max()) > 0 or float(np.abs(
            g64[k]).max()) == 0, f"{k}: no gradient"
        if float(np.abs(gt[k] - gj[k]).max()) <= GRAD_TOL * gmax:
            continue
        ref_off = float(np.abs(gj[k] - g64[k]).max())
        port_off = float(np.abs(gt[k] - g64[k]).max())
        assert port_off <= GRAD_K * ref_off + GRAD_TOL * gmax, (
            k, port_off, ref_off, gmax)
    if arch == "whisper-small":
        assert any(k.startswith("encoder.") for k in gt)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_as_close_as_the_reference(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16")
    batch = _batch(tcfg, seed=1)
    tok, ex = batch["tokens"], _extras(batch)
    want = np.asarray(jlm.forward(
        jcfg, jp, jnp.asarray(tok), **{k: jnp.asarray(v, jnp.bfloat16)
                                       for k, v in ex.items()})[0])
    want32 = np.asarray(jlm.forward(
        dataclasses.replace(jcfg, dtype="float32"),
        jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        jnp.asarray(tok), **_jnp(ex))[0])
    got = lm.forward(tcfg, tp, torch.from_numpy(tok),
                     **_torch(ex, torch.bfloat16))[0].numpy()
    port, refe = _row_err(got, want32), _row_err(want, want32)
    assert port <= BF16_FACTOR * refe + BF16_FLOOR, (arch, port, refe)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _whisper_decode(jcfg, tcfg, jp, tp, tok, kv_j, kv_t, jc_dtype=None):
    """Teacher-forced decode of tok (B, S) in both packages, the
    cross-attention caches filled with the given K/V (R, B, F, K, hd):
    (S, B, V) logits of each."""
    B, S = tok.shape
    jc = jax.tree.map(jnp.zeros_like, jmaterialize(
        jlm.cache_defs(jcfg, B, S), jax.random.key(1)))
    jc = jax.tree.map(lambda a: a.astype(jc_dtype) if jc_dtype else a, jc)
    jc["blk0"]["xk"], jc["blk0"]["xv"] = kv_j
    tc = lm.init_cache(tcfg, B, S, device="cpu")
    if kv_t is not None:
        tc["blk0"]["xk"].copy_(kv_t[0])
        tc["blk0"]["xv"].copy_(kv_t[1])
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    want, got = [], []
    with torch.no_grad():
        for s in range(S):
            lj, jc = step(jp, jc, jnp.asarray(tok[:, s:s + 1]),
                          jnp.full((B,), s, jnp.int32))
            lt, tc = lm.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(tok[:, s:s + 1]),
                                    torch.full((B,), s, dtype=torch.int32))
            want.append(np.asarray(lj))
            got.append(lt.numpy())
    return np.stack(got), np.stack(want), tc


def test_decode_with_filled_cross_cache_matches_the_reference(x64):
    """whisper: 20 teacher-forced decode steps of a batch of 2 whose
    ``xk``/``xv`` hold ``encoder_kv`` of real frames, each step's logits
    against the reference's ``decode_step`` on the same cache (``_hold``,
    the f64 decode of both packages the yardstick); the cache's cross
    K/V come out unchanged."""
    arch = "whisper-small"
    b = _batch(jconfigs.get_smoke(arch), S=20, seed=6)
    tok, fr = b["tokens"], b["encoder_frames"]
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg, seed=6)
    kv = jlm.encoder_kv(jcfg, jp, jlm.encode(jcfg, jp, jnp.asarray(fr)))
    kvj = (kv["k"][0], kv["v"][0])
    kvt = tuple(torch.from_numpy(np.array(a)) for a in kvj)
    got, want, tc = _whisper_decode(jcfg, tcfg, jp, tp, tok, kvj, kvt)
    assert torch.equal(tc["blk0"]["xk"], kvt[0])
    j64, t64 = _cfgs(arch, "float64")
    with x64() as c64:
        got64, want64, _ = _whisper_decode(
            j64, t64, c64(jp), _port64(tp), tok, c64(kvj),
            tuple(a.double() for a in kvt), jnp.float64)
    assert float(np.abs(got64 - want64).max()) <= F64_TOL * _scale(want64)
    for s in range(tok.shape[1]):
        _hold(got[s], want[s], want64[s], f"decode step {s}")
    # the frames reach the logits: a zero cross cache decodes otherwise
    with torch.no_grad():
        zero = lm.decode_step(tcfg, tp, lm.init_cache(tcfg, 2, 4, "cpu"),
                              torch.from_numpy(tok[:, :1]),
                              torch.zeros(2, dtype=torch.int32))[0]
    assert float(np.abs(zero.numpy() - got[0]).max()) > 1e-3


def test_sinusoidal_decode_positions_match_the_forward_rows():
    """whisper: a decode step's sinusoidal row at position p (its own f32
    angles) is the prefill table's row p, in both packages, for positions
    past 0; and batch-1 teacher-forced decode with the frames' cross K/V
    reproduces the forward's logits row for row."""
    jcfg, tcfg = _cfgs("whisper-small")
    jp, tp = _trees(jcfg, seed=7)
    b = _batch(tcfg, B=1, S=24, seed=7)
    tok = torch.from_numpy(b["tokens"])
    table = lm._embed(tcfg, tp, tok)
    for p in (1, 5, 23):
        row = lm._embed(tcfg, tp, tok[:, p:p + 1], None,
                        position=torch.tensor([p]))
        np.testing.assert_allclose(row[:, 0].numpy(), table[:, p].numpy(),
                                   rtol=0, atol=1e-6)
        want = np.asarray(jlm._embed(jcfg, jp, jnp.asarray(b["tokens"][:,
                                                                    p:p + 1]),
                                     None, position=jnp.asarray([p])))
        np.testing.assert_allclose(row.numpy(), want, rtol=0, atol=1e-6)
    fr = torch.from_numpy(b["encoder_frames"])
    with torch.no_grad():
        full = lm.forward(tcfg, tp, tok, encoder_frames=fr)[0][0].numpy()
        kv = lm.encoder_kv(tcfg, tp, lm.encode(tcfg, tp, fr))
        cache = lm.init_cache(tcfg, 1, 24, device="cpu")
        cache["blk0"]["xk"].copy_(kv["k"][0])
        cache["blk0"]["xv"].copy_(kv["v"][0])
        for s in range(24):
            got, cache = lm.decode_step(tcfg, tp, cache, tok[:, s:s + 1],
                                        torch.tensor([s]))
            np.testing.assert_allclose(got[0].numpy(), full[s], rtol=0,
                                       atol=FWD_TOL * _scale(full[s]),
                                       err_msg=f"position {s}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _ar(lo, hi):
    return np.arange(lo, hi, dtype=np.int32)


def _engines(arch, reqs, **kw):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    je = JServeEngine(jcfg, jp, **kw)
    te = ServeEngine(tcfg, tp, device="cpu", **kw)
    for uid, prompt, n in reqs:
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n))
        te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    return ({r.uid: r.out_tokens for r in je.run()},
            {r.uid: r.out_tokens for r in te.run()}, je, te)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_reference_engine(arch):
    """Three requests in a batch of 2 (a freed slot refilled), token for
    token the reference's engine. The server is text-only: whisper's cross
    cache stays zero, as the reference's does (so its cross-attention adds
    exactly 0), and phi-3 decodes without images."""
    reqs = [(0, _ar(1, 6), 5), (1, _ar(9, 12), 7), (2, _ar(30, 39), 4)]
    want, got, je, te = _engines(arch, reqs, batch_size=2, max_seq=32)
    assert sorted(got) == [0, 1, 2] and got == want
    if arch == "whisper-small":
        for leaf in ("xk", "xv"):
            assert not bool(te.cache["blk0"][leaf].any())
            assert not bool(jnp.any(je.cache["blk0"][leaf]))


def test_engine_reset_reaches_the_cross_cache():
    """``_reset_slot`` zeroes a slot's rows of ``xk``/``xv`` and of the
    self-attention cache, and no other slot's."""
    _, tcfg = _cfgs("whisper-small")
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(tcfg, tp, batch_size=2, max_seq=16, device="cpu")
    for blk in eng.cache.values():
        for t in blk.values():
            t.fill_(1.0)
    eng._reset_slot(1)
    for name, t in eng.cache["blk0"].items():
        assert bool((t[:, 0] == 1).all()) and not bool(t[:, 1].any()), name
    assert set(eng.cache["blk0"]) == {"k", "v", "xk", "xv"}


def _example_lm_serve():
    spec = importlib.util.spec_from_file_location(
        "example_lm_serve", ROOT / "examples" / "lm_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_serve_launcher_matches_the_example(arch):
    """``launch.lm_serve.run`` against ``examples/lm_serve.py``'s ``run``
    on the same f32 weights, with and without INT8 PTQ: the same requests
    and the same tokens, request for request; and its ``main`` on the
    CPU."""
    from repro_torch.launch import lm_serve
    example = _example_lm_serve()
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    for quantize in (False, True):
        want, _ = example.run(jcfg, jp, quantize=quantize)
        got, rate = lm_serve.run(tcfg, tp, quantize, device="cpu")
        assert rate > 0 and len(got) == lm_serve.REQUESTS
        want = {r.uid: (r.prompt.tolist(), r.out_tokens) for r in want}
        assert {r.uid: (r.prompt.tolist(), r.out_tokens) for r in got} \
            == want
        assert all(len(r.out_tokens) == lm_serve.NEW for r in got)
    fp, q = lm_serve.main(["--arch", arch, "--device", "cpu"])
    assert 0 <= lm_serve.agreement(fp, q) <= len(fp) == lm_serve.REQUESTS


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch):
    from repro_torch.launch import serve
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "4"])
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_reduces_the_loss(arch):
    """The twin of tests/test_smoke_archs.py::
    test_one_train_step_reduces_loss_direction: the smoke config in bf16,
    labels = tokens, zero image embeddings (phi-3) or random frames
    (whisper), bf16; ``make_lm_step`` (AdamW at 1e-3, clipping) twice on
    the same batch: the loss is finite and drops, and every parameter (the
    encoder's too) gets a gradient."""
    cfg = tconfigs.get_smoke(arch)
    tp = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": tok, "labels": tok}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.zeros(2, cfg.num_image_tokens,
                                            cfg.d_model, dtype=torch.bfloat16)
    if cfg.encoder_layers:
        batch["encoder_frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.num_encoder_frames, cfg.d_model))).bfloat16()
    step = loop.make_lm_step(cfg, tp, lambda s: 1e-3)
    opt = optim.adamw_init(flatten(tp))
    opt, m0 = step(opt, batch, 0)
    opt, m1 = step(opt, batch, 1)
    assert math.isfinite(float(m0["loss"]))
    assert float(m1["loss"]) < float(m0["loss"])


def test_train_launcher_phi3_and_the_whisper_error():
    """``launch.train --smoke --device cpu``: phi-3-vision trains text-only
    (as the reference's launcher feeds tokens only); whisper-small raises a
    ValueError naming the frames its batch needs, before any step."""
    from repro_torch.launch import train as ltrain
    res = ltrain.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--steps",
                       "3", "--batch", "2", "--seq", "24", "--device",
                       "cpu"])
    assert len(res.losses) == 3 and all(map(math.isfinite, res.losses))
    with pytest.raises(ValueError, match="encoder_frames"):
        ltrain.main(["--arch", "whisper-small", "--smoke", "--steps", "1",
                     "--device", "cpu"])
    _, tcfg = _cfgs("whisper-small")
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="encoder_frames"):
        lm.forward(tcfg, tp, torch.zeros(1, 4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# pieces no config uses: layernorm, qk-norm; and the ungated MLP
# ---------------------------------------------------------------------------

def _piece_grads(jfn, tfn, arrays):
    """Value and gradients (of the sum of out * a fixed cotangent) of a
    piece in both packages on the same f32 arrays."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    ct = np.random.default_rng(11).normal(size=want.shape).astype(np.float32)
    wg = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = tfn(*ts)
    got.backward(torch.from_numpy(ct))
    return (np.asarray(want), got.detach().numpy(),
            [np.asarray(g) for g in wg], [t.grad.numpy() for t in ts])


def _assert_piece(want, got, wg, gg, what):
    np.testing.assert_allclose(got, want, rtol=PIECE_TOL,
                               atol=PIECE_TOL * _scale(want), err_msg=what)
    for i, (a, b) in enumerate(zip(wg, gg)):
        np.testing.assert_allclose(b, a, rtol=PIECE_TOL,
                                   atol=PIECE_TOL * _scale(a),
                                   err_msg=f"{what} grad {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype):
    """``layers.layernorm`` (population variance, fp32 inside) against the
    reference's, forward and gradients in f32; in bf16 its output to the
    bit."""
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    if dtype == "bfloat16":
        want = np.asarray(JL.layernorm(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16),
                                       jnp.asarray(b, jnp.bfloat16), 1e-6),
                          np.float32)
        got = L.layernorm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(w).bfloat16(),
                          torch.from_numpy(b).bfloat16(), 1e-6).float()
        assert float(np.abs(got.numpy() - want).max()) <= 2 ** -8 * _scale(
            want)
        return
    _assert_piece(*_piece_grads(
        lambda a, c, d: JL.layernorm(a, c, d, 1e-6),
        lambda a, c, d: L.layernorm(a, c, d, 1e-6), (x, w, b)), "layernorm")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi-3-vision-4.2b"])
def test_qk_norm_attention_matches_the_reference(arch):
    """A smoke config with ``qk_norm=True`` (``dataclasses.replace``): the
    ``q_norm``/``k_norm`` defs, ``_qkv`` (rmsnorm of q and k per head,
    before RoPE) and the whole causal attention, forward and gradients of
    x and every weight, against the reference in f32."""
    jcfg, tcfg = _cfgs(arch, qk_norm=True)
    jd = _flat_defs(JL.attn_param_defs(jcfg, (1,)))
    assert jd == _flat_defs(L.attn_param_defs(tcfg, (1,)))
    assert jd["q_norm"][0] == (1, tcfg.head_dim)
    rng = np.random.default_rng(13)
    D, Q, KV, hd = tcfg.d_model, tcfg.q_dim, tcfg.kv_dim, tcfg.head_dim
    names = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
    shapes = ((D, Q), (D, KV), (D, KV), (Q, D), (hd,), (hd,))
    ws = [(rng.normal(size=s) / math.sqrt(s[0] if len(s) > 1 else 4))
          .astype(np.float32) for s in shapes]
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))

    def jfn(x_, *w):
        return JL.attention(jcfg, dict(zip(names, w)), x_, jnp.asarray(pos))

    def tfn(x_, *w):
        return L.attention(tcfg, dict(zip(names, w)), x_,
                           torch.from_numpy(pos.copy()))
    _assert_piece(*_piece_grads(jfn, tfn, (x, *ws)),
                  f"{arch} qk-norm attention")
    want = JL._qkv(jcfg, dict(zip(names, map(jnp.asarray, ws))),
                   jnp.asarray(x), jnp.asarray(pos))
    got = L._qkv(tcfg, dict(zip(names, map(torch.from_numpy, ws))),
                 torch.from_numpy(x), torch.from_numpy(pos.copy()))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=PIECE_TOL,
                                   atol=PIECE_TOL * _scale(w), err_msg=name)


def test_ungated_mlp_matches_the_reference():
    """whisper's MLP, act(x wi_gate) wo with the tanh GeLU and no
    ``wi_up``: defs, forward and gradients against the reference."""
    jcfg, tcfg = _cfgs("whisper-small")
    assert "wi_up" not in L.mlp_param_defs(tcfg)
    assert _flat_defs(JL.mlp_param_defs(jcfg)) == \
        _flat_defs(L.mlp_param_defs(tcfg))
    rng = np.random.default_rng(14)
    D, Fd = tcfg.d_model, tcfg.d_ff
    wi = (rng.normal(size=(D, Fd)) / math.sqrt(D)).astype(np.float32)
    wo = (rng.normal(size=(Fd, D)) / math.sqrt(Fd)).astype(np.float32)
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    _assert_piece(*_piece_grads(
        lambda a, b, c: JL.mlp(jcfg, {"wi_gate": b, "wo": c}, a),
        lambda a, b, c: L.mlp(tcfg, {"wi_gate": b, "wo": c}, a),
        (x, wi, wo)), "ungated mlp")


def test_cross_attention_matches_the_reference():
    """``layers.cross_attention`` over (B, F, K, hd) encoder K/V with F
    other than the query length, forward and gradients of x, wq, wo and
    the K/V against the reference, f32."""
    jcfg, tcfg = _cfgs("whisper-small")
    rng = np.random.default_rng(15)
    D, Q, K, hd = tcfg.d_model, tcfg.q_dim, tcfg.num_kv_heads, tcfg.head_dim
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    wq = (rng.normal(size=(D, Q)) / math.sqrt(D)).astype(np.float32)
    wo = (rng.normal(size=(Q, D)) / math.sqrt(Q)).astype(np.float32)
    ek, ev = (rng.normal(size=(2, 24, K, hd)).astype(np.float32)
              for _ in range(2))
    _assert_piece(*_piece_grads(
        lambda a, b, c, d, e: JL.cross_attention(jcfg, {"wq": b, "wo": c},
                                                 a, d, e),
        lambda a, b, c, d, e: L.cross_attention(tcfg, {"wq": b, "wo": c},
                                                a, d, e),
        (x, wq, wo, ek, ev)), "cross-attention")


def test_sinusoidal_embedding_matches_the_reference():
    """The f32 table of the prefill (whisper's 1500 frames and 448 text
    positions at width 768) against the reference's, and its f64 form
    against numpy."""
    for n, d in ((1500, 768), (448, 768), (24, 128)):
        want = np.asarray(JL.sinusoidal_embedding(n, d))
        got = L.sinusoidal_embedding(n, d).numpy()
        assert got.dtype == np.float32 and got.shape == (n, d)
        # the angle n * div rounds in f32; sin/cos of it agree to ~ulp(n)
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-7 * n)
    pos = np.arange(448, dtype=np.float64)[:, None]
    div = np.exp(-math.log(10_000.0) * np.arange(0, 768, 2) / 768)
    exact = np.concatenate([np.sin(pos * div), np.cos(pos * div)], -1)
    np.testing.assert_allclose(
        L.sinusoidal_embedding(448, 768, dtype=torch.float64).numpy(), exact,
        rtol=0, atol=1e-12)
