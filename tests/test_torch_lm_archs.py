"""repro_torch's LM stack against repro's for the five architectures of the
port's ninth slice: DeepSeek-7B and Yi-34B (dense), Gemma-2-9B (sliding
windows on alternate layers with the ring-buffer cache, attention and final
logit softcaps, sandwich norms, embedding scaling, GeGLU, tied embeddings),
Mixtral-8x7B (top-2 of 8 MoE, a window on every layer) and Grok-1-314B
(MoE, softcap, GeGLU); and Jamba-1.5-Large, whose period block mixes SSD,
attention and MoE sublayers over a cache of KV, conv windows and SSM
states. Smoke configs; the same numpy-seeded parameters and
tokens go through both packages (``lm_from_jax``): forward logits, one
training step's loss and gradients, decode, prefill-decode consistency past
the smoke window, the MoE dispatch index for index, the GeGLU activation,
and the plain flash attention with window and softcap against ``jax.vjp``
of the reference's ``_sdpa_block`` math."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.params import flatten, lm_from_jax
from repro_torch.train import loop, optim

ARCHS = ["deepseek-7b", "yi-34b", "gemma2-9b", "mixtral-8x7b", "grok-1-314b",
         "jamba-1.5-large-398b"]
MOE = ["mixtral-8x7b", "grok-1-314b", "jamba-1.5-large-398b"]
JAMBA = "jamba-1.5-large-398b"
# the forward and the prefill-decode checks at FWD_TOL / CONSIST_TOL; Jamba
# has its own (test_jamba_*), its f32 logits being further from f64 in the
# reference itself than FWD_TOL of their scale
NOT_HYBRID = [a for a in ARCHS if a != JAMBA]
WINDOWED = ["gemma2-9b", "mixtral-8x7b"]

# float32: XLA and PyTorch sum in other orders and these random nets amplify
# rounding (the test_torch_lm.py tolerances: logits within FWD_TOL of their
# scale; one token a decode step, DECODE_TOL); the loss within LOSS_RTOL and
# each gradient leaf within GRAD_TOL of the largest gradient entry
FWD_TOL, DECODE_TOL = 1e-4, 1e-4
# Where these random nets amplify f32 rounding on the way back (dense: the
# input embedding; MoE: any leaf, the routed FFNs make them chaotic), a leaf
# may miss the reference's f32 gradient by more, and is then held to the f64
# evaluation of both packages (which agree within F64_TOL): its distance
# from it at most GRAD_K times the reference's own (+ GRAD_TOL). Measured
# (port / reference distance from f64, of the largest entry): Gemma-2's
# embed 8.8e-5 / 9.2e-5; Mixtral's embed 7.3e-2 / 8.7e-2 and its first
# attention leaves 0.8-1.8e-3 / 1.0-2.1e-3; Grok-1's embed 1.0e-3 / 3.5e-4,
# so GRAD_K is 4 for the MoE configs, 2 (as for Llama) for the dense ones
LOSS_RTOL, GRAD_TOL, F64_TOL = 1e-5, 1e-4, 1e-8
GRAD_K = {"dense": 2.0, "moe": 4.0}
ILL_CONDITIONED = {"embed"}
# bf16: the port as close to the reference's f32 logits as the reference's
# own bf16 logits are (median row error), as test_torch_lm.py holds it
BF16_FACTOR, BF16_FLOOR = 2.0, 1e-2
# plain attention against the reference's _sdpa_block math, f32
ATTN_TOL = 1e-5
# the prefill-decode gap of the port, f32, past the smoke window
CONSIST_TOL = 1e-4


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype))


def _trees(jcfg, dtype="float32", seed=0):
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(seed))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, lm_from_jax(jp)


def _tokens(vocab, B, S, seed):
    return next(synthetic.token_batches(B, S, vocab, seed=seed))[0]["tokens"]


def _scale(want):
    return max(1.0, float(np.max(np.abs(want))))


def _assert_close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * _scale(want), err_msg=what)


def _row_err(got, want_f32):
    want_f32 = np.asarray(want_f32, np.float32)
    want_f32 = want_f32.reshape(-1, want_f32.shape[-1])
    d = np.asarray(got, np.float32).reshape(want_f32.shape) - want_f32
    return float(np.median(np.sqrt(np.mean(d ** 2, axis=-1)))) / float(
        np.sqrt(np.mean(want_f32 ** 2)))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_defs_equal_the_reference(arch):
    """CONFIG and SMOKE field for field, and the parameter and cache trees
    (ring caches on the local layers of a windowed config)."""
    for j, t in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                 (jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()

        def flat(defs, prefix=""):
            out = {}
            for k in sorted(defs):
                v = defs[k]
                out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                           else {prefix + k: dataclasses.astuple(v)})
            return out
        assert flat(jlm.param_defs(j)) == flat(lm.param_defs(t))
        for s_max in (8, 40, 5000):
            assert flat(jlm.cache_defs(j, 2, s_max)) == \
                flat(lm.cache_defs(t, 2, s_max))


def test_unported_configs_are_still_refused():
    """The registry holds every LM architecture of the reference, jamba
    included, in the reference's order; a name the reference does not know
    raises ``KeyError``, and ``lm`` no longer has a ``check_ported`` that
    refuses features."""
    assert tconfigs.LM_ARCHS == jconfigs.LM_ARCHS
    for get in (tconfigs.get_config, tconfigs.get_smoke):
        assert get(JAMBA).name == JAMBA
    with pytest.raises(KeyError, match="no such architecture"):
        tconfigs.get_config("gpt-17")
    assert not hasattr(lm, "check_ported") and not hasattr(L, "unported")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_from_jax_carries_every_leaf(arch):
    """The bridge carries the new leaves (router, we_gate/we_up/we_down,
    post_norm) bit for bit, and their shapes are the port's own defs'."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16", seed=3)
    jflat, tflat = flatten(jp), flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    mine = flatten(lm.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu"))
    for k, t in tflat.items():
        assert t.dtype == torch.bfloat16 and t.shape == mine[k].shape, k
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(jflat[k]).view(np.int16), k)
    names = {k.rsplit(".", 1)[-1] for k in tflat}
    if arch in MOE:
        assert {"router", "we_gate", "we_up", "we_down"} <= names
    if arch == "gemma2-9b":
        assert "post_norm" in names and "head" not in names


# ---------------------------------------------------------------------------
# forward, training step, decode (twins of tests/test_smoke_archs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NOT_HYBRID)
def test_forward_matches_the_reference(arch):
    """Logits and the MoE aux loss in f32 (S = 32, B = 2)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    tok = _tokens(jcfg.vocab_size, 2, 32, seed=1)
    want, waux = jlm.forward(jcfg, jp, jnp.asarray(tok))
    got, gaux = lm.forward(tcfg, tp, torch.from_numpy(tok))
    assert got.shape == (2, 32, tcfg.vocab_size) and got.dtype == torch.float32
    _assert_close(got.numpy(), want, FWD_TOL, arch)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5,
                               atol=1e-7)
    assert (float(gaux) > 0) == (arch in MOE)
    if tcfg.final_logit_softcap:
        assert float(got.abs().max()) < tcfg.final_logit_softcap


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_as_close_as_the_reference(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16")
    tok = _tokens(jcfg.vocab_size, 2, 32, seed=1)
    want = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok))[0])
    want32 = np.asarray(jlm.forward(
        dataclasses.replace(jcfg, dtype="float32"),
        jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        jnp.asarray(tok))[0])
    got = lm.forward(tcfg, tp, torch.from_numpy(tok))[0].numpy()
    port, refe = _row_err(got, want32), _row_err(want, want32)
    assert port <= BF16_FACTOR * refe + BF16_FLOOR, (arch, port, refe)


def _jax_grads(jcfg, jp, batch):
    (loss, aux), g = jax.value_and_grad(jlm.lm_loss, has_aux=True, argnums=1)(
        jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(aux["moe_aux"]), {
        k: np.asarray(v, np.float32) for k, v in flatten(g).items()}


def _batch(vocab, B=2, S=32, seed=2):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(
        np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _port_grads(tcfg, tp, batch):
    flat = flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(tcfg, tp, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    loss.backward()
    return (float(loss.detach()), float(metrics["moe_aux"].detach()),
            {k: p.grad.double().numpy() for k, p in flat.items()})


def _f64_grads(arch, jp, batch, monkeypatch):
    """Both packages' loss and gradients in f64: the reference with x64 on
    and its f32 accumulation type (``f32`` of both modules) set to f64, the
    port on f64 parameters (its plain versions compute in the inputs'
    dtype)."""
    jcfg, tcfg = _cfgs(arch, "float64")
    monkeypatch.setattr(jlm, "f32", jnp.float64)
    monkeypatch.setattr(JL, "f32", jnp.float64)
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                            jp)
        (loss, _), g = jax.value_and_grad(jlm.lm_loss, has_aux=True,
                                          argnums=1)(
            jcfg, jp64, {k: jnp.asarray(v) for k, v in batch.items()})
        g = {k: np.asarray(v) for k, v in flatten(g).items()}
    tp = {k: torch.from_numpy(np.asarray(a, np.float64))
          for k, a in flatten(jp).items()}
    from repro_torch.models.params import unflatten
    lp, _, gp = _port_grads(tcfg, unflatten(tp), batch)
    return float(loss), g, lp, gp


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, monkeypatch):
    """One training step's loss (cross entropy + 0.01 x the MoE aux loss)
    and every parameter's gradient in f32, through the MoE dispatch, the
    softcaps and the sandwich norms: each leaf within GRAD_TOL of the
    largest entry of the reference's, or (see GRAD_K) no further from the
    f64 evaluation than GRAD_K times the reference's own distance, as
    tests/test_torch_lm_train.py holds Llama and Mamba; in f64 the two
    packages agree within F64_TOL, every leaf."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg)
    batch = _batch(jcfg.vocab_size)
    lj, auxj, gj = _jax_grads(jcfg, jp, batch)
    lt, auxt, gt = _port_grads(tcfg, tp, batch)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    np.testing.assert_allclose(auxt, auxj, rtol=1e-5, atol=1e-7)
    assert (auxt > 0) == (arch in MOE)
    gmax = max(float(np.abs(v).max()) for v in gj.values())
    l64, g64, lp64, gp64 = _f64_grads(arch, jp, batch, monkeypatch)
    np.testing.assert_allclose(lp64, l64, rtol=1e-12)
    assert sorted(gj) == sorted(gt) == sorted(g64)
    for k in g64:
        assert float(np.abs(gp64[k] - g64[k]).max()) <= F64_TOL * gmax, k
    k_f64 = GRAD_K["moe" if arch in MOE else "dense"]
    for k in gj:
        assert gt[k].shape == gj[k].shape, k
        if float(np.abs(gt[k] - gj[k]).max()) <= GRAD_TOL * gmax:
            continue
        assert k in ILL_CONDITIONED or arch in MOE, (
            k, float(np.abs(gt[k] - gj[k]).max()), gmax)
        ref_off = float(np.abs(gj[k] - g64[k]).max())
        port_off = float(np.abs(gt[k] - g64[k]).max())
        assert port_off <= k_f64 * ref_off + GRAD_TOL * gmax, (k, port_off,
                                                               ref_off)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_reduces_the_loss(arch):
    """``train.loop.make_lm_step`` (AdamW, clipping) twice on the same
    batch: the loss drops, as tests/test_smoke_archs.py asks of the
    reference."""
    _, tcfg = _cfgs(arch)
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    step = loop.make_lm_step(tcfg, tp, lambda s: 1e-3)
    opt = optim.adamw_init(flatten(tp))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size)
             .items()}
    opt, m0 = step(opt, batch, 0)
    opt, m1 = step(opt, batch, 1)
    assert math.isfinite(float(m0["loss"]))
    assert float(m1["loss"]) < float(m0["loss"])


def _jax_decode(jcfg, jp, tok, s_max):
    """The reference's teacher-forced decode logits, (S, B, V)."""
    B, S = tok.shape
    jc = jax.tree.map(jnp.zeros_like, jmaterialize(
        jlm.cache_defs(jcfg, B, s_max), jax.random.key(1)))
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    out = []
    for s in range(S):
        logits, jc = step(jp, jc, jnp.asarray(tok[:, s:s + 1]),
                          jnp.full((B,), s, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out)


def _port_decode(tcfg, tp, tok, s_max):
    B, S = tok.shape
    cache = lm.init_cache(tcfg, B, s_max, device="cpu")
    out = []
    with torch.no_grad():
        for s in range(S):
            logits, cache = lm.decode_step(
                tcfg, tp, cache, torch.from_numpy(tok[:, s:s + 1]),
                torch.full((B,), s, dtype=torch.int32))
            out.append(logits.numpy())
    return np.stack(out), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference_past_the_window(arch):
    """40 teacher-forced decode steps of a batch of 2 (past the smoke
    window of 16: the ring caches of Gemma-2's local layers and all of
    Mixtral's wrap twice), each step's logits against the reference's."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _trees(jcfg, seed=4)
    tok = _tokens(jcfg.vocab_size, 2, 40, seed=4)
    want = _jax_decode(jcfg, jp, tok, 40)
    got, cache = _port_decode(tcfg, tp, tok, 40)
    for s in range(40):
        _assert_close(got[s], want[s], DECODE_TOL, f"{arch} step {s}")
    if arch in WINDOWED:                 # the ring is the window long
        ring = cache["blk0"]["k"]
        assert ring.shape[2] == tcfg.sliding_window < 40


@pytest.fixture
def moe_drops(monkeypatch):
    """Record, for every ``moe_route`` call, which tokens had an
    assignment dropped (slot at or past the capacity)."""
    seen = []
    route = L.moe_route

    def recorded(cfg, logits):
        out = route(cfg, logits)
        pos, C = out[3], out[4]
        seen.append((pos >= C).reshape(-1, cfg.experts_per_token).any(-1))
        return out
    monkeypatch.setattr(L, "moe_route", recorded)
    return seen


@pytest.mark.parametrize("arch", NOT_HYBRID)
def test_prefill_and_decode_agree_past_the_window(arch, moe_drops):
    """Batch-1 teacher-forced decode reproduces the forward's logits at
    S = 40 > the smoke window (the window masks in the prefill kernel's
    plain version, the ring in decode). For the MoE configs, only at the
    positions where no MoE layer of the forward dropped an assignment:
    the forward's capacity counts all 40 tokens, a decode step's one
    (``L.moe_capacity``), so a token the forward drops is computed in
    full in decode, in the reference too."""
    jcfg, tcfg = _cfgs(arch)
    _, tp = _trees(jcfg, seed=5)
    tok = _tokens(tcfg.vocab_size, 1, 40, seed=5)
    with torch.no_grad():
        full = lm.forward(tcfg, tp, torch.from_numpy(tok))[0][0].numpy()
    dropped = np.zeros(40, bool)
    for d in moe_drops:
        dropped |= d.numpy()
    moe_drops.clear()
    got, _ = _port_decode(tcfg, tp, tok, 40)
    assert not moe_drops or not any(d.any() for d in moe_drops)
    checked = [s for s in range(40) if not dropped[s]]
    assert len(checked) >= 20
    for s in checked:
        _assert_close(got[s, 0], full[s], CONSIST_TOL, f"{arch} position {s}")


# ---------------------------------------------------------------------------
# MoE dispatch, index for index
# ---------------------------------------------------------------------------

def _jax_route(logits, E, topk, cf):
    """The reference's dispatch lines (layers.py:325-346), on logits."""
    T = logits.shape[0]
    C = max(1, int(math.ceil(T * topk * cf / E)))
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, eidx = lax.top_k(probs, topk)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    flat_e = eidx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return (np.asarray(probs), np.asarray(gates), np.asarray(eidx),
            np.asarray(pos), C)


def _moe_case(kind, T, D, E, rng):
    """Token activations and a router: "random"; "tie" (experts 1 and 3
    share a router column, so their bf16 logits tie exactly for every
    token); "crowd" (every token prefers expert 0, past its capacity)."""
    x = rng.normal(size=(T, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32)
    if kind == "tie":
        router[:, 3] = router[:, 1]
        router[:, 1] += 0.0                       # same bits
    if kind == "crowd":
        x[:, 0] = np.abs(x[:, 0]) + 2.0
        router[0, 0] = 3.0
    return x, router


@pytest.mark.parametrize("kind", ["random", "tie", "crowd"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_dispatch_equals_the_reference(arch, kind):
    """Expert order, slot indices, dropped assignments and gates of
    ``moe_route`` equal the reference's ``lax.top_k`` and exclusive
    cumsum; then the whole ``moe`` layer (bf16 router product, expert
    FFNs, combine) and its aux loss against ``layers.moe`` in f32."""
    cfg = tconfigs.get_smoke(arch)
    E, topk = cfg.num_experts, cfg.experts_per_token
    rng = np.random.default_rng(7)
    T, D = 48, cfg.d_model
    x, router = _moe_case(kind, T, D, E, rng)
    # bf16 product, as the model computes its router logits
    logits = (torch.from_numpy(x).bfloat16() @ torch.from_numpy(router)
              .bfloat16()).float()
    jprobs, jgates, jeidx, jpos, jC = _jax_route(logits.numpy(), E, topk,
                                                 cfg.capacity_factor)
    probs, gates, eidx, pos, C = L.moe_route(cfg, logits)
    assert C == jC == L.moe_capacity(cfg, T)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal((pos >= C).numpy(), jpos >= jC)
    np.testing.assert_allclose(gates.numpy(), jgates, rtol=1e-6)
    if kind == "tie":       # the lower index first, on every token
        both = (jeidx == 1).any(-1) & (jeidx == 3).any(-1)
        assert both.any()
        first = np.where(jeidx[both][:, 0] == 1)[0]
        assert len(first) == int(both.sum())
        assert int((probs[:, 1] == probs[:, 3]).sum()) == T
    if kind == "crowd":
        assert int((pos >= C).sum()) > 0
    # the whole layer, f32 weights
    p = {"router": router,
         "we_gate": (rng.normal(size=(E, D, cfg.d_ff)) / np.sqrt(D))
         .astype(np.float32),
         "we_up": (rng.normal(size=(E, D, cfg.d_ff)) / np.sqrt(D))
         .astype(np.float32),
         "we_down": (rng.normal(size=(E, cfg.d_ff, D)) / np.sqrt(cfg.d_ff))
         .astype(np.float32)}
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    xb = x.reshape(2, T // 2, D)
    wy, waux = JL.moe(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(xb))
    y, aux = L.moe(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(xb))
    _assert_close(y.numpy(), wy, 1e-5, f"{arch} {kind} moe output")
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_moe_capacity_depends_on_the_batch():
    """Mixtral's capacity at a decode step of B tokens: ceil(2.5 B / 8),
    2 at B = 4 (so one of 4 tokens loses an expert that three pick), 1 at
    B = 1 (a token's two experts differ, so nothing drops)."""
    cfg = tconfigs.get_config("mixtral-8x7b")
    assert [L.moe_capacity(cfg, b) for b in (1, 4, 8)] == [1, 2, 3]
    logits = torch.zeros(4, 8)
    logits[:, 5] = 2.0                            # every token picks 5 ...
    logits[:, 0] = torch.tensor([1.0, 0.9, 0.8, 0.7])   # ... then 0
    _, _, eidx, pos, C = L.moe_route(cfg, logits)
    assert eidx[:, 0].tolist() == [5] * 4 and eidx[:, 1].tolist() == [0] * 4
    assert (pos >= C).reshape(4, 2).tolist() == [[False, False]] * 2 + \
        [[True, True]] * 2
    _, _, _, pos1, C1 = L.moe_route(cfg, logits[:1])
    assert C1 == 1 and not bool((pos1 >= C1).any())


# ---------------------------------------------------------------------------
# GeGLU and the plain attention with window and softcap
# ---------------------------------------------------------------------------

def test_geglu_activation_is_jax_gelu():
    """``jax.nn.gelu`` defaults to the tanh form; so does the port's."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = L._act(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(erf - want).max()) > 1e-4      # not the erf form
    xb = torch.from_numpy(x).bfloat16()
    wantb = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)),
                       np.float32)
    gotb = L._act(xb, "gelu").float().numpy()
    assert float(np.abs(gotb - wantb).max()) <= 2 ** -7 * (
        1 + float(np.abs(wantb).max()))


def _sdpa_ref(q, k, v, window, softcap):
    """The reference model's causal prefill attention math on (B,H,S,D)
    f32 arrays: ``_sdpa_block`` on the grouped query, the mask of
    ``layers.attention`` (kpos <= qpos, and > qpos - window)."""
    B, H, S, D = q.shape
    K = k.shape[1]
    qg = jnp.transpose(q, (0, 2, 1, 3)).reshape(B, S, K, H // K, D)
    kk, vv = (jnp.transpose(t, (0, 2, 1, 3)) for t in (k, v))
    qpos, kpos = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    out = JL._sdpa_block(qg, kk, vv, mask[None, None, None], softcap,
                         1.0 / math.sqrt(D))
    return jnp.transpose(out.reshape(B, S, H, D), (0, 2, 1, 3))


@pytest.mark.parametrize("D,H,K", [(128, 4, 1), (128, 6, 1), (256, 4, 2)])
@pytest.mark.parametrize("window,softcap", [(16, 50.0), (16, 0.0), (0, 30.0),
                                            (1, 5.0), (100, 50.0)])
def test_plain_flash_window_softcap_matches_jax(D, H, K, window, softcap):
    """Forward, log-sum-exp, the written-out backward and autograd of the
    plain version against ``jax.vjp`` of the reference's math, S = 40."""
    rng = np.random.default_rng(D + H + window)
    S = 40
    q, k, v, g = (rng.normal(size=s).astype(np.float32)
                  for s in ((1, H, S, D), (1, K, S, D), (1, K, S, D),
                            (1, H, S, D)))
    want, vjp = jax.vjp(lambda a, b, c: _sdpa_ref(a, b, c, window, softcap),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, True, window, softcap)
    _assert_close(out.detach().numpy(), want, ATTN_TOL)
    out.backward(torch.from_numpy(g))
    lse = ref.flash_attention_lse(tq.detach(), tk.detach(), True, window,
                                  softcap)
    written = ops.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                      out.detach(), lse,
                                      torch.from_numpy(g), True, window,
                                      softcap)
    for t, w, wg in zip((tq, tk, tv), written, wgrads):
        _assert_close(t.grad.numpy(), wg, ATTN_TOL)
        _assert_close(w.numpy(), wg, ATTN_TOL)


def test_windowed_attention_rows_see_only_their_window():
    """A local layer of the smoke Gemma-2: changing a token outside every
    later row's window leaves those rows of the attention output."""
    jcfg, tcfg = _cfgs("gemma2-9b")
    _, tp = _trees(jcfg, seed=1)
    p = lm._at(tp["blocks"], 0)["blk0"]["attn"]
    x = torch.randn(1, 40, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(40)[None]
    a = L.attention(tcfg, p, x, pos, is_local=True)
    x2 = x.clone()
    x2[:, 3] += 1.0
    b = L.attention(tcfg, p, x2, pos, is_local=True)
    W = tcfg.sliding_window
    assert torch.equal(a[:, 3 + W:], b[:, 3 + W:])
    assert not torch.equal(a[:, 3:3 + W], b[:, 3:3 + W])
    g = L.attention(tcfg, p, x2, pos, is_local=False)      # global layer
    assert not torch.equal(a[:, 3 + W:], g[:, 3 + W:])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_on_the_cpu(arch):
    """``launch.train --smoke --device cpu`` takes each of the five names
    and trains three finite steps."""
    from repro_torch.launch import train as ltrain
    res = ltrain.main(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                       "2", "--seq", "24", "--device", "cpu"])
    assert len(res.losses) == 3 and all(map(math.isfinite, res.losses))


# ---------------------------------------------------------------------------
# Jamba: SSD, attention and MoE sublayers in one period block
# ---------------------------------------------------------------------------

def test_jamba_period_block_equals_the_reference():
    """One period is lcm(attn_period, moe_period) layers: 8 of 72 in the
    full config (SSD + MLP at j = 0, 2, 6, SSD + MoE at 1, 3, 5, 7,
    attention + MLP at 4), 4 in the smoke config (attention + MoE at 3),
    repeated twice; every sublayer's kind is the reference's, and so is the
    mixed cache: K/V on the attention sublayer, a conv window and an f32
    SSM state on each SSD sublayer."""
    kinds = {}
    for name, j, t in (("full", jconfigs.get_config(JAMBA),
                        tconfigs.get_config(JAMBA)),
                       ("smoke", jconfigs.get_smoke(JAMBA),
                        tconfigs.get_smoke(JAMBA))):
        P = lm.block_period(t)
        assert P == jlm.block_period(j) and lm.num_repeats(t) == \
            jlm.num_repeats(j)
        kinds[name] = [lm.sublayer_kind(t, i) for i in range(P)]
        assert kinds[name] == [jlm.sublayer_kind(j, i) for i in range(P)]
        cache = lm.cache_defs(t, 2, 64)
        for i, kind in enumerate(kinds[name]):
            keys = {"k", "v"} if kind["attn"] else {"conv", "ssm"}
            assert set(cache[f"blk{i}"]) == keys, (name, i)
            if kind["ssm"]:
                assert cache[f"blk{i}"]["ssm"].dtype == "float32"
    assert lm.block_period(tconfigs.get_config(JAMBA)) == 8
    assert lm.num_repeats(tconfigs.get_smoke(JAMBA)) == 2

    def pattern(ks):
        return ["attn" if k["attn"] else "ssm" for k in ks], \
            ["moe" if k["moe"] else "mlp" for k in ks]
    assert pattern(kinds["full"]) == (
        ["ssm"] * 4 + ["attn"] + ["ssm"] * 3, ["mlp", "moe"] * 4)
    assert pattern(kinds["smoke"]) == (
        ["ssm"] * 3 + ["attn"], ["mlp", "moe"] * 2)


def _f64_forward(jcfg, jp, tok, monkeypatch):
    """The reference's logits with x64 on and its f32 accumulation type set
    to f64 (as ``_f64_grads``), and the port's on f64 parameters."""
    j64, t64 = (dataclasses.replace(c, dtype="float64")
                for c in (jcfg, tconfigs.get_smoke(JAMBA)))
    monkeypatch.setattr(jlm, "f32", jnp.float64)
    monkeypatch.setattr(JL, "f32", jnp.float64)
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                            jp)
        want = np.asarray(jlm.forward(j64, jp64, jnp.asarray(tok))[0])
    from repro_torch.models.params import unflatten
    tp64 = unflatten({k: torch.from_numpy(np.asarray(a, np.float64))
                      for k, a in flatten(jp).items()})
    with torch.no_grad():
        got = lm.forward(t64, tp64, torch.from_numpy(tok))[0].numpy()
    return want, got


def test_jamba_forward_matches_the_reference(monkeypatch):
    """Logits and the MoE aux loss (S = 32, B = 2). In f64 the two packages
    agree within F64_TOL of the logits' scale. In f32 this random hybrid is
    sensitive enough that the reference's own logits sit up to 1.7e-4 of
    their scale off f64 (the port's 2.7e-4), beyond FWD_TOL; so, as the MoE
    gradients are held, the port's f32 logits are within FWD_TOL of the
    reference's or no further from f64 than GRAD_K["moe"] times the
    reference's own distance (+ FWD_TOL of the scale), row by row."""
    jcfg, tcfg = _cfgs(JAMBA)
    jp, tp = _trees(jcfg)
    tok = _tokens(jcfg.vocab_size, 2, 32, seed=1)
    want, waux = jlm.forward(jcfg, jp, jnp.asarray(tok))
    want = np.asarray(want)
    with torch.no_grad():
        got, gaux = lm.forward(tcfg, tp, torch.from_numpy(tok))
    got = got.numpy()
    assert got.shape == (2, 32, tcfg.vocab_size)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5,
                               atol=1e-7)
    assert float(gaux) > 0
    w64, g64 = _f64_forward(jcfg, jp, tok, monkeypatch)
    scale = _scale(w64)
    assert float(np.abs(g64 - w64).max()) <= F64_TOL * scale
    near = np.abs(got - want).max(-1) <= FWD_TOL * scale
    ref_off = np.abs(want - w64).max(-1)
    port_off = np.abs(got - w64).max(-1)
    ok = near | (port_off <= GRAD_K["moe"] * ref_off + FWD_TOL * scale)
    assert ok.all(), (port_off[~ok], ref_off[~ok])
    assert near.mean() >= 0.5


def test_jamba_decode_cache_equals_the_reference():
    """24 teacher-forced decode steps of a batch of 2 through the mixed
    cache: every leaf (the attention sublayer's K/V rows, the SSD
    sublayers' conv windows and SSM states) equals the reference's cache
    after the same steps within DECODE_TOL of its scale, the K/V rows past
    the last position are still zero, and the states are not."""
    jcfg, tcfg = _cfgs(JAMBA)
    jp, tp = _trees(jcfg, seed=6)
    S, s_max = 24, 32
    tok = _tokens(jcfg.vocab_size, 2, S, seed=6)
    jc = jax.tree.map(jnp.zeros_like, jmaterialize(
        jlm.cache_defs(jcfg, 2, s_max), jax.random.key(1)))
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    for s in range(S):
        _, jc = step(jp, jc, jnp.asarray(tok[:, s:s + 1]),
                     jnp.full((2,), s, jnp.int32))
    _, cache = _port_decode(tcfg, tp, tok, s_max)
    jflat, tflat = flatten(jc), flatten(cache)
    assert sorted(jflat) == sorted(tflat)
    for k, want in jflat.items():
        got = tflat[k].numpy()
        _assert_close(got, np.asarray(want), DECODE_TOL, k)
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("k", "v"):
            assert not got[:, :, S:].any() and got[:, :, :S].any(), k
        else:
            assert got.any(), k


def test_jamba_prefill_and_decode_agree(moe_drops):
    """Batch-1 teacher-forced decode against the forward at S = 64 (two
    SSD chunks of the smoke config), at the positions where no MoE layer of
    the forward dropped an assignment (see
    ``test_prefill_and_decode_agree_past_the_window``), within the forward
    check's rows: FWD_TOL of the scale, or no further from the forward
    than the reference's own decode is (+ FWD_TOL)."""
    jcfg, tcfg = _cfgs(JAMBA)
    jp, tp = _trees(jcfg, seed=5)
    S = 64
    tok = _tokens(tcfg.vocab_size, 1, S, seed=5)
    with torch.no_grad():
        full = lm.forward(tcfg, tp, torch.from_numpy(tok))[0][0].numpy()
    dropped = np.zeros(S, bool)
    for d in moe_drops:
        dropped |= d.numpy()
    moe_drops.clear()
    got, _ = _port_decode(tcfg, tp, tok, S)
    assert not moe_drops or not any(d.any() for d in moe_drops)
    jfull = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok))[0][0])
    jdec = _jax_decode(jcfg, jp, tok, S)
    checked = [s for s in range(S) if not dropped[s]]
    assert len(checked) >= S // 2
    scale = _scale(full)
    for s in checked:
        gap = float(np.abs(got[s, 0] - full[s]).max())
        ref_gap = float(np.abs(jdec[s, 0] - jfull[s]).max())
        assert gap <= max(CONSIST_TOL * scale,
                          GRAD_K["moe"] * ref_gap + CONSIST_TOL * scale), (
            s, gap, ref_gap)
