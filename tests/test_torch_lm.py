"""repro_torch's LM stack against repro's on the same parameters and
inputs: configs, the token stream, the parameter bridge, every ported layer
and ``lm.forward`` / ``lm.decode_step`` of Llama-3.2-1B and Mamba-2-1.3B
(smoke configs), in float32 for tight checks and in bf16 once each."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsynth
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.params import (ParamDef, lm_from_jax, lm_to_jax,
                                       materialize)

ARCHS = ["llama3.2-1b", "mamba2-1.3b"]

# float32 forward: XLA and PyTorch sum in other orders, and these random
# nets amplify rounding: on these inputs the reference's own logits move
# by a few 1e-5 (Llama) and most of 1e-3 (Mamba) of their scale when its
# embedding is scaled by (1 + 1e-7). The tolerance is that sensitivity's
# order, times the scale.
FWD_TOL = {"llama3.2-1b": 1e-4, "mamba2-1.3b": 1e-3}
DECODE_TOL = 1e-4              # one token per step: no S-long sums
LAYER_TOL = 1e-5               # one layer, f32
SSD_TOL = 1e-4                 # chunked einsums in another order
# bf16: both packages round to bf16 where the model says, but XLA and
# PyTorch sum in other orders and round some intermediates at other points,
# and these random nets amplify a one-ulp difference (2^-8 relative) into
# O(1) logit changes at a few hypersensitive positions, in the reference
# itself as much as in the port (in the Mamba decode below, one step's bf16
# logits are several times further from f32 than the other steps', in both
# packages, by amounts that differ). So the port in bf16 is held to
# be as close to the float32 answer as the reference in bf16 is, position
# by position: the median over output rows of the relative RMS error from
# the reference's f32 output is at most BF16_FACTOR times the reference's
# own bf16 median, plus BF16_FLOOR. A rounding fault on every row moves
# the median; an isolated hypersensitive row does not.
BF16_FACTOR, BF16_FLOOR = 2.0, 1e-2
BF16_CHAIN_TOL = 5e-2          # the decode score chain runs in bf16


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype))


def _trees(jcfg, dtype="float32", seed=0):
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(seed))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, lm_from_jax(jp)


def _scale(want):
    return max(1.0, float(np.max(np.abs(want))))


def assert_close(got, want, tol, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * _scale(want), err_msg=err_msg)


def assert_bf16_like_reference(got, want_bf16, want_f32, what=""):
    want_f32 = np.asarray(want_f32, np.float32)
    want_f32 = want_f32.reshape(-1, want_f32.shape[-1])
    norm = np.sqrt(np.mean(want_f32 ** 2))

    def err(a):
        d = np.asarray(a, np.float32).reshape(want_f32.shape) - want_f32
        return float(np.median(np.sqrt(np.mean(d ** 2, axis=-1)))) / norm
    port, ref = err(got), err(want_bf16)
    assert port <= BF16_FACTOR * ref + BF16_FLOOR, \
        f"{what}: median bf16 error from f32 {port} (port) vs {ref} " \
        "(reference)"


def _bf16_round(x):
    """float32 numpy -> the bf16 values it rounds to (as float32)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# configs, data, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for j, t in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                 (jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert jlm.block_period(j) == lm.block_period(t)
        assert [jlm.sublayer_kind(j, i) for i in range(4)] == \
            [lm.sublayer_kind(t, i) for i in range(4)]
    # the ported LM architectures, in the reference registry's order
    assert tconfigs.LM_ARCHS == [a for a in jconfigs.LM_ARCHS
                                 if a in tconfigs._MODULES]
    assert set(ARCHS) <= set(tconfigs.LM_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_defs_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)

    def flat(defs, prefix=""):
        out = {}
        for k in sorted(defs):
            v = defs[k]
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = dataclasses.astuple(v)
        return out
    assert flat(jlm.param_defs(jcfg)) == flat(lm.param_defs(tcfg))
    assert flat(jlm.cache_defs(jcfg, 3, 40)) == flat(lm.cache_defs(tcfg, 3,
                                                                   40))


@pytest.mark.parametrize("vocab,seq", [(512, 64), (128_256, 33),
                                       (50_280, 17)])
def test_token_batches_bit_equal(vocab, seq):
    a = jsynth.token_batches(3, seq, vocab, seed=4, start_idx=2)
    b = synthetic.token_batches(3, seq, vocab, seed=4, start_idx=2)
    for _ in range(2):
        (ja, ia), (tb, ib) = next(a), next(b)
        assert ia == ib
        for k in ("tokens", "labels"):
            assert ja[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(ja[k], tb[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bridge_round_trips_bf16_bit_exact(arch):
    jcfg, _ = _cfgs(arch)
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(3))
    tp = lm_from_jax(jp)
    back = lm_to_jax(tp)
    for (path, a), (_, t), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jp),
            jax.tree_util.tree_leaves_with_path(tp),
            jax.tree_util.tree_leaves_with_path(back)):
        assert t.dtype == torch.bfloat16, path
        assert tuple(t.shape) == a.shape, path      # the JAX layout, kept
        a = np.asarray(a)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), a.view(np.int16))
    # the tree goes straight back into the reference
    tok = np.arange(8, dtype=np.int32)[None]
    np.testing.assert_array_equal(
        np.asarray(jlm.forward(jcfg, jax.tree.map(jnp.asarray, back), tok)[0]),
        np.asarray(jlm.forward(jcfg, jp, tok)[0]))


@pytest.mark.parametrize("n", [16, 64])
def test_materialize_arange_neg_equals_reference(n):
    defs = {"A_log": ParamDef((3, n), ("layer", None), "arange_neg")}
    want = jmaterialize(defs, jax.random.key(0))["A_log"]
    got = materialize(defs, torch.Generator(), device="cpu")["A_log"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    got32 = materialize({"a": dataclasses.replace(defs["A_log"],
                                                  dtype="float32")},
                        torch.Generator(), device="cpu")["a"]
    np.testing.assert_allclose(got32[1].numpy(), np.log(np.arange(1, n + 1)),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_the_reference_init(arch):
    jcfg, tcfg = _cfgs(arch)
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(0))
    for (path, a), (_, t) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                 jax.tree_util.tree_leaves_with_path(tp)):
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16, path
        a, tf = np.asarray(a, np.float32), _np(t)
        if a.std() == 0:                                  # constant inits
            np.testing.assert_array_equal(tf, a, err_msg=str(path))
        else:                                             # same spread
            assert abs(tf.std() / a.std() - 1) < 0.1, path


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer(jp, tp, kind):
    j = jax.tree.map(lambda a: a[0], jp["blocks"]["blk0"][kind])
    t = {k: v[0] for k, v in tp["blocks"]["blk0"][kind].items()}
    return j, t


def test_rmsnorm_and_rope_match(rng):
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    assert_close(_np(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                               1e-6)),
                 JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6), LAYER_TOL)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1)) * 37
    for theta in (10_000.0, 500_000.0):
        assert_close(_np(L.apply_rope(torch.from_numpy(x),
                                      torch.from_numpy(pos), theta)),
                     JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
                     LAYER_TOL)


@pytest.mark.parametrize("S", [64, 100])
def test_attention_matches_model_attention(rng, S):
    """The flash-attention prefill against the reference's block-triangular
    ``layers.attention`` itself (its kernel test compares only with the
    kernel's oracle). S=100 is one ragged block in the reference."""
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jp, tp = _trees(jcfg)
    jattn, tattn = _layer(jp, tp, "attn")
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want = JL.attention(jcfg, jattn, jnp.asarray(x), jnp.asarray(pos),
                        q_block=32 if S == 64 else 1024)
    before = ops.KERNELS["flash_attention"].launches
    got = L.attention(tcfg, tattn, torch.from_numpy(x), torch.from_numpy(pos))
    assert ops.KERNELS["flash_attention"].launches == before  # CPU: plain
    assert_close(_np(got), want, LAYER_TOL)


def test_attention_bf16(rng):
    jcfg, tcfg = _cfgs("llama3.2-1b", "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16")
    jattn, tattn = _layer(jp, tp, "attn")
    x = _bf16_round(rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32))
    pos = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    want = JL.attention(jcfg, jattn, jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(pos))
    want32 = JL.attention(jcfg, jax.tree.map(lambda a: a.astype(jnp.float32),
                                             jattn), jnp.asarray(x),
                          jnp.asarray(pos))
    got = L.attention(tcfg, tattn, torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    assert_bf16_like_reference(_np(got), want, want32, "attention")


@pytest.mark.parametrize("variant", ["plain", "bf16_chain", "int8_kv",
                                     "ring"])
def test_attention_decode_matches(rng, variant):
    """Eight decode steps into a cache, every branch of the reference's
    ``attention_decode``; the port updates its cache in place."""
    jcfg, tcfg = _cfgs("llama3.2-1b")
    if variant == "bf16_chain":
        jcfg = dataclasses.replace(jcfg, decode_bf16_scores=True)
        tcfg = dataclasses.replace(tcfg, decode_bf16_scores=True)
    jp, tp = _trees(jcfg)
    jattn, tattn = _layer(jp, tp, "attn")
    B, S_len, K, hd = 2, 6 if variant == "ring" else 16, 1, 32
    int8 = variant == "int8_kv"
    jk = jv = jnp.zeros((B, S_len, K, hd), jnp.int8 if int8 else jnp.float32)
    tk, tv = (torch.zeros((B, S_len, K, hd),
                          dtype=torch.int8 if int8 else torch.float32)
              for _ in range(2))
    jsc = tsc = None
    if int8:
        jsc = (jnp.zeros((B, S_len, K), jnp.bfloat16),) * 2
        tsc = tuple(torch.zeros((B, S_len, K), dtype=torch.bfloat16)
                    for _ in range(2))
    tol = BF16_CHAIN_TOL if variant == "bf16_chain" else LAYER_TOL
    for step in range(8):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        pos = np.array([step, step + 1], np.int32)
        wo, jk, jv, jsc = JL.attention_decode(
            jcfg, jattn, jnp.asarray(x), jk, jv, jnp.asarray(pos),
            ring=variant == "ring", scales=jsc)
        go, _, _, _ = L.attention_decode(
            tcfg, tattn, torch.from_numpy(x), tk, tv, torch.from_numpy(pos),
            ring=variant == "ring", scales=tsc)
        assert_close(_np(go), wo, tol, f"{variant} step {step}")
        if int8:
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        else:
            assert_close(tk.numpy(), jk, LAYER_TOL)


def test_mlp_matches(rng):
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jp, tp = _trees(jcfg)
    jm, tm = _layer(jp, tp, "mlp")
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    assert_close(_np(L.mlp(tcfg, tm, torch.from_numpy(x))),
                 JL.mlp(jcfg, jm, jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("S", [32, 96])
def test_ssd_matches_model_ssd(rng, S):
    """The chunk scan in place of the reference's segsum einsum, over one
    and three chunks."""
    jcfg, tcfg = _cfgs("mamba2-1.3b")
    jp, tp = _trees(jcfg)
    js, ts = _layer(jp, tp, "ssm")
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: JL.ssd(jcfg, p, x))(js, jnp.asarray(x))
    got = L.ssd(tcfg, ts, torch.from_numpy(x))
    assert_close(_np(got), want, SSD_TOL)


def test_ssd_bf16(rng):
    jcfg, tcfg = _cfgs("mamba2-1.3b", "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16")
    js, ts = _layer(jp, tp, "ssm")
    x = _bf16_round(rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32))
    ssd = jax.jit(lambda p, x: JL.ssd(jcfg, p, x))
    want = ssd(js, jnp.asarray(x, jnp.bfloat16))
    want32 = ssd(jax.tree.map(lambda a: a.astype(jnp.float32), js),
                 jnp.asarray(x))
    got = L.ssd(tcfg, ts, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_bf16_like_reference(_np(got), want, want32, "ssd")


def test_ssd_decode_matches(rng):
    jcfg, tcfg = _cfgs("mamba2-1.3b")
    jp, tp = _trees(jcfg)
    js, ts = _layer(jp, tp, "ssm")
    conv_dim = jcfg.d_inner + 2 * jcfg.ssm_state
    jconv = np.zeros((2, jcfg.ssm_conv_width - 1, conv_dim), np.float32)
    jssm = np.zeros((2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state),
                    np.float32)
    tconv, tssm = torch.from_numpy(jconv), torch.from_numpy(jssm)
    for step in range(5):
        x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        wo, jconv, jssm = JL.ssd_decode(jcfg, js, jnp.asarray(x), jconv, jssm)
        go, tconv, tssm = L.ssd_decode(tcfg, ts, torch.from_numpy(x), tconv,
                                       tssm)
        assert_close(_np(go), wo, LAYER_TOL, f"step {step}")
        assert_close(tssm.numpy(), jssm, LAYER_TOL)
        assert_close(tconv.numpy(), jconv, LAYER_TOL)


def test_ssd_refuses_a_ragged_chunk(rng):
    _, tcfg = _cfgs("mamba2-1.3b")
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ts = {k: v[0] for k, v in tp["blocks"]["blk0"]["ssm"].items()}
    with pytest.raises(ValueError, match="chunk"):
        L.ssd(tcfg, ts, torch.zeros(1, 40, tcfg.d_model, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    batch, _ = next(synthetic.token_batches(2, 64, jcfg.vocab_size, seed=1))
    tok = batch["tokens"]
    want, jaux = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
        jp, jnp.asarray(tok))
    ops.reset_launches()
    got, aux = lm.forward(tcfg, tp, torch.from_numpy(tok))
    assert ops.launches()["flash_attention"] == 0       # the CPU runs plain
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(jaux) == 0.0
    assert_close(got.numpy(), want, FWD_TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16")
    batch, _ = next(synthetic.token_batches(2, 64, jcfg.vocab_size, seed=1))
    tok = batch["tokens"]
    want, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
        jp, jnp.asarray(tok))
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    want32, _ = jax.jit(lambda p, t: jlm.forward(jcfg32, p, t))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), jnp.asarray(tok))
    got, _ = lm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.dtype == torch.float32
    # the reference rounds the logits to bf16 before the fp32 cast
    assert torch.equal(got, got.bfloat16().float())
    assert_bf16_like_reference(got.numpy(), want, want32, arch)


def _jax_decode(jcfg, jp, tok, positions):
    """The reference's logits over a run of decode steps, (steps, B, V)."""
    jc = jax.tree.map(jnp.zeros_like, jmaterialize(
        jlm.cache_defs(jcfg, tok.shape[0], 24), jax.random.key(1)))
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    out = []
    for s, pos in enumerate(positions):
        logits, jc = step(jp, jc, jnp.asarray(tok[:, s:s + 1]),
                          jnp.asarray(pos))
        out.append(np.asarray(logits))
    return np.stack(out), jc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches(arch, dtype):
    """Ten decode steps over two rows at different positions; the port's
    cache, updated in place, stays equal to the reference's."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _trees(jcfg, dtype)
    tok = next(synthetic.token_batches(2, 12, jcfg.vocab_size, seed=5))[0][
        "tokens"]
    positions = [np.array([s, s + 2], np.int32) for s in range(10)]
    want, jc = _jax_decode(jcfg, jp, tok, positions)
    tc = lm.init_cache(tcfg, 2, 24, device="cpu")
    got = []
    for s, pos in enumerate(positions):
        logits, tc2 = lm.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(tok[:, s:s + 1]),
                                     torch.from_numpy(pos))
        assert tc2 is tc and logits.shape == want.shape[1:]
        got.append(logits.numpy())
    got = np.stack(got)
    if dtype == "float32":
        assert_close(got, want, DECODE_TOL)
        for (path, a), (_, t) in zip(jax.tree_util.tree_leaves_with_path(jc),
                                     jax.tree_util.tree_leaves_with_path(tc)):
            assert_close(_np(t), a, DECODE_TOL, str(path))
    else:
        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        want32, _ = _jax_decode(jcfg32, jax.tree.map(
            lambda a: a.astype(jnp.float32), jp), tok, positions)
        assert_bf16_like_reference(got, want, want32, f"{arch} decode")


def test_prefill_and_decode_agree_in_the_port():
    """Teacher-forced decode reproduces the forward's logits (the
    reference's test_prefill_decode_consistency_dense, on the port)."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        _, tp = _trees(jcfg, seed=2)
        tok = torch.from_numpy(next(synthetic.token_batches(
            1, 32, tcfg.vocab_size, seed=2))[0]["tokens"])
        full, _ = lm.forward(tcfg, tp, tok)
        cache = lm.init_cache(tcfg, 1, 32, device="cpu")
        for s in range(32):
            got, _ = lm.decode_step(tcfg, tp, cache, tok[:, s:s + 1],
                                    torch.tensor([s]))
            assert_close(got.numpy(), full[:, s].numpy(), FWD_TOL[arch],
                         f"{arch} position {s}")


@pytest.mark.parametrize("arch,what", [
    ("whisper-small", "sinusoidal"), ("whisper-small", "ungated"),
    ("whisper-small", "encoder"), ("phi-3-vision-4.2b", "image")])
def test_unported_model_features_raise(arch, what):
    """The model features the port once refused by name (sinusoidal
    positions, the ungated MLP, the encoder, image tokens) now run: a
    config built from the reference's fields gets the reference's
    parameter and cache trees, a finite forward, and the feature itself;
    only a forward that lacks the encoder's frames raises, by name."""
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jconfigs.get_smoke(arch)))
    jcfg = jconfigs.get_smoke(arch)

    def flat(defs, prefix=""):
        out = {}
        for k in sorted(defs):
            v = defs[k]
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: dataclasses.astuple(v)})
        return out
    assert flat(lm.param_defs(cfg)) == flat(jlm.param_defs(jcfg))
    assert flat(lm.cache_defs(cfg, 1, 8)) == flat(jlm.cache_defs(jcfg, 1, 8))
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.arange(1, 17, dtype=torch.int32)[None]
    kw = {}
    if cfg.encoder_layers:
        kw["encoder_frames"] = torch.randn(
            1, cfg.num_encoder_frames, cfg.d_model,
            generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    logits, _ = lm.forward(cfg, p, tok, **kw)
    assert logits.shape == (1, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    if what == "sinusoidal":
        table = L.sinusoidal_embedding(16, cfg.d_model).to(torch.bfloat16)
        assert torch.equal(lm._embed(cfg, p, tok),
                           p["embed"][tok.long()] + table[None])
    elif what == "ungated":
        assert "wi_up" not in p["blocks"]["blk0"]["mlp"]
    elif what == "encoder":
        assert set(p["encoder"]) == {"layers", "final_norm"}
        with pytest.raises(ValueError, match="encoder_frames"):
            lm.forward(cfg, p, tok)
    else:
        img = torch.ones(1, cfg.num_image_tokens, cfg.d_model,
                         dtype=torch.bfloat16)
        assert not torch.equal(lm.forward(cfg, p, tok, image_embeds=img)[0],
                               logits)
