"""repro_torch's serving path against repro's: INT8 weight PTQ of the LM
tree, the continuous-batching engine (twins of tests/test_serve.py, each
also held token for token to the JAX engine on the same parameters) and the
serve launcher, on the smoke configs of Llama-3.2-1B and Mamba-2-1.3B, of
the ninth slice's DeepSeek-7B, Yi-34B, Gemma-2-9B, Mixtral-8x7B and
Grok-1-314B (ring caches past the window, MoE decode batches) and of
Jamba-1.5-Large (KV, conv-window and SSM-state caches in one tree)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro.quant import ptq as jptq
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.models.params import lm_from_jax
from repro_torch.quant import ptq
from repro_torch.serve import Request, ServeEngine

# bf16 engine: a generated token may differ from the reference's only where
# the port's own logits there have a near-tie, a top-2 margin under TIE.
# The logits are O(1); each package's bf16 logits stray from the f32 ones
# by a few 1e-2 at typical positions of these random nets and by more at
# hypersensitive ones (see test_torch_lm.py's bf16 checks), so a margin of
# a quarter is within the bf16 noise of either package.
TIE = 0.25


def _setup(arch, dtype="float32"):
    """Reference and port configs and parameter trees (float32 trees for
    exact token equality: argmax flips need a near-tie within f32
    rounding)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(0))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jcfg, tcfg, jp, lm_from_jax(jp)


def _both(jcfg, tcfg, jp, tp, reqs, **kw):
    """Run the same requests through the reference and the port engine;
    returns {uid: out_tokens} of each."""
    je = JServeEngine(jcfg, jp, **kw)
    te = ServeEngine(tcfg, tp, device="cpu", **kw)
    for uid, prompt, n in reqs:
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n))
        te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    jdone, tdone = je.run(), te.run()
    return ({r.uid: r.out_tokens for r in jdone},
            {r.uid: r.out_tokens for r in tdone})


def _ar(lo, hi):
    return np.arange(lo, hi, dtype=np.int32)


NEW_ARCHS = ["deepseek-7b", "yi-34b", "gemma2-9b", "mixtral-8x7b",
             "grok-1-314b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b", *NEW_ARCHS])
def test_engine_completes_requests_as_the_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    reqs = [(u, _ar(1, 5 + u), 4) for u in range(3)]
    want, got = _both(jcfg, tcfg, jp, tp, reqs, batch_size=2, max_seq=32)
    assert len(got) == 3 and all(len(t) == 4 for t in got.values())
    assert got == want


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "deepseek-7b", "yi-34b", "gemma2-9b"])
def test_continuous_batching_matches_solo(arch):
    """A request's tokens are identical alone or interleaved with another
    (the SSM state is not idempotent), and equal to the reference's."""
    jcfg, tcfg, jp, tp = _setup(arch)
    prompt = _ar(1, 6)
    want_solo, solo = _both(jcfg, tcfg, jp, tp, [(0, prompt, 5)],
                            batch_size=1, max_seq=32)
    want_b, batched = _both(jcfg, tcfg, jp, tp,
                            [(0, prompt, 5), (1, _ar(9, 12), 8)],
                            batch_size=3, max_seq=32)
    assert solo[0] == batched[0]
    assert solo == want_solo and batched == want_b


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "grok-1-314b",
                                  "jamba-1.5-large-398b"])
def test_moe_batched_decode_matches_the_reference(arch):
    """A MoE layer's capacity counts the tokens of the whole decode batch
    (``layers.moe_capacity``: 1 slot an expert at 1 to 3 tokens, 2 at 4),
    so a request's tokens alone and in a batch may differ, in the
    reference as much as in the port. What must hold is the reference's
    batched decode, token for token: three requests interleaved in a batch
    of 4 (with an idle slot's pad token in the batch) and alone."""
    jcfg, tcfg, jp, tp = _setup(arch)
    reqs = [(0, _ar(1, 6), 6), (1, _ar(9, 12), 8), (2, _ar(30, 39), 5)]
    want, got = _both(jcfg, tcfg, jp, tp, reqs, batch_size=4, max_seq=32)
    assert sorted(got) == [0, 1, 2] and got == want
    want1, got1 = _both(jcfg, tcfg, jp, tp, reqs[:1], batch_size=1,
                        max_seq=32)
    assert got1 == want1


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x7b"])
def test_ring_cache_engine_matches_the_reference(arch):
    """Requests that run past the smoke window of 16 positions, so that the
    ring caches of the local layers wrap, in a batch of 2 with a third
    request refilling a freed slot (``_reset_slot`` zeroes its ring rows):
    token for token the reference's engine."""
    jcfg, tcfg, jp, tp = _setup(arch)
    assert tcfg.swa_ring_buffer and tcfg.sliding_window == 16
    reqs = [(0, _ar(1, 15), 12), (1, _ar(40, 48), 14), (2, _ar(60, 78), 6)]
    want, got = _both(jcfg, tcfg, jp, tp, reqs, batch_size=2, max_seq=40)
    assert sorted(got) == [0, 1, 2] and got == want
    eng = ServeEngine(tcfg, tp, batch_size=2, max_seq=40, device="cpu")
    assert eng.cache["blk0"]["k"].shape[2] == 16      # a ring, not 40


def test_slot_reuse_no_state_leak():
    """The same prompt through the same slot before and after another
    request gives the same tokens (the slot's cache rows are zeroed)."""
    jcfg, tcfg, jp, tp = _setup("mamba2-1.3b")
    eng = ServeEngine(tcfg, tp, batch_size=1, max_seq=32, device="cpu")
    prompt = _ar(2, 8)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    first = eng.run()[0].out_tokens
    eng.submit(Request(uid=1, prompt=_ar(10, 14), max_new_tokens=3))
    eng.run()
    assert all(float(t[:, 0].abs().max()) > 0
               for blk in eng.cache.values() for t in blk.values())
    eng.submit(Request(uid=2, prompt=prompt, max_new_tokens=4))
    again = eng.run()[0].out_tokens
    assert first == again
    want, _ = _both(jcfg, tcfg, jp, tp, [(0, prompt, 4)], batch_size=1,
                    max_seq=32)
    assert first == want[0]


def test_jamba_slot_reuse_zeroes_every_cache_kind():
    """Admitting a request zeroes the slot's SSM state and conv window as
    well as its K/V rows (the reference's ``engine.py:129-134``): in a
    batch of 2, the same prompt through slot 0 before and after another
    request gives the same tokens, and the reference's, while slot 1 keeps
    its request's state; right after the refill, slot 0's rows of every
    leaf are zero."""
    jcfg, tcfg, jp, tp = _setup("jamba-1.5-large-398b")
    reqs = [(0, _ar(2, 8), 4), (1, _ar(20, 31), 12), (2, _ar(40, 43), 2),
            (3, _ar(2, 8), 4)]
    want, got = _both(jcfg, tcfg, jp, tp, reqs, batch_size=2, max_seq=32)
    assert got == want and got[0] == got[3]
    eng = ServeEngine(tcfg, tp, batch_size=2, max_seq=32, device="cpu")
    for uid, prompt, n in reqs[:2]:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    while eng.slots[0] is not None or not eng.slots[1]:
        eng.step()
    kinds = {k: float(t[:, 0].abs().max()) for blk in eng.cache.values()
             for k, t in blk.items()}
    assert set(kinds) == {"k", "v", "conv", "ssm"} and min(kinds.values()) > 0
    eng.submit(Request(uid=2, prompt=_ar(40, 43), max_new_tokens=2))
    eng._refill()
    for blk in eng.cache.values():
        for k, t in blk.items():
            assert not t[:, 0].any() and t[:, 1].any(), k


def test_engine_respects_max_seq_and_eos():
    jcfg, tcfg, jp, tp = _setup("llama3.2-1b")
    want, got = _both(jcfg, tcfg, jp, tp, [(0, _ar(1, 7), 50)],
                      batch_size=2, max_seq=12)
    assert len(got[0]) == 12 - 1 - 6 + 1 and got == want
    eos = got[0][2]
    eng = ServeEngine(tcfg, tp, batch_size=1, max_seq=32, eos_id=eos,
                      device="cpu")
    eng.submit(Request(uid=0, prompt=_ar(1, 7), max_new_tokens=50))
    out = eng.run()[0].out_tokens
    assert out[-1] == eos and len(out) == got[0].index(eos) + 1


def test_int8_engine_matches_the_reference():
    jcfg, tcfg, jp, tp = _setup("llama3.2-1b")
    want, got = _both(jcfg, tcfg, jp, tp, [(0, _ar(1, 6), 4),
                                           (1, _ar(3, 9), 6)],
                      batch_size=2, max_seq=32, quantize=True)
    assert len(got[0]) == 4 and got == want


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_engine_bf16_matches_the_reference_up_to_near_ties(arch):
    """In bf16 both engines pick the same token at every step up to the
    first one where the port's logits hold a near-tie; there the two may
    part, and nothing after is compared."""
    jcfg, tcfg, jp, tp = _setup(arch, "bfloat16")
    reqs = [(0, _ar(1, 6), 8), (1, _ar(7, 16), 8), (2, _ar(20, 24), 8)]
    want, got = _both(jcfg, tcfg, jp, tp, reqs, batch_size=2, max_seq=32)
    assert sorted(got) == [0, 1, 2]
    for uid, prompt, _ in reqs:
        g, w = got[uid], want[uid]
        same = next((i for i in range(len(w)) if g[i] != w[i]), len(w))
        if same == len(w):
            continue
        ctx = np.concatenate([prompt, np.asarray(g[:same], np.int32)])
        logits, _ = lm.forward(tcfg, tp, torch.from_numpy(ctx)[None])
        top2 = torch.topk(logits[0, -1], 2).values
        assert float(top2[0] - top2[1]) < TIE, \
            f"request {uid} parts from the reference at token {same} " \
            f"without a near-tie"


# ---------------------------------------------------------------------------
# PTQ of the LM tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_picks_the_reference_leaves(arch, dtype):
    """Exactly the leaves the reference's ``_is_weight`` picks are
    fake-quantized (attention and MLP weights; not Mamba's in/out
    projections, the embedding or the norms), with one scale per output
    column shared across the stacked layers, bit-equal to the reference."""
    _, _, jp, tp = _setup(arch, dtype)
    jq = jptq.quantize_params(jp)
    tq = ptq.quantize_params(tp, channel_axis=-1)
    changed = set()
    for (path, a), (_, t), (_, a0) in zip(
            jax.tree_util.tree_leaves_with_path(jq),
            jax.tree_util.tree_leaves_with_path(tq),
            jax.tree_util.tree_leaves_with_path(jp)):
        name = "/".join(k.key for k in path)
        assert t.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32), name)
        if not np.array_equal(np.asarray(a), np.asarray(a0)):
            changed.add(name.rsplit("/", 1)[-1])
    picked = ({"wq", "wk", "wv", "wo", "wi_gate", "wi_up"}
              if arch == "llama3.2-1b" else set())
    assert changed == picked
    if arch == "llama3.2-1b":                     # R stacked layers, 1 scale
        w = tq["blocks"]["blk0"]["mlp"]["wo"].float()
        cols = w.abs().amax(dim=(0, 1))
        steps = {(w[r, :, 0] / (cols[0] / 127)).round().abs().max().item()
                 for r in range(w.shape[0])}
        assert max(steps) == 127 and len(steps) > 1


# ---------------------------------------------------------------------------
# the launcher and the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b", *NEW_ARCHS])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    done = tserve.main(["--arch", arch, "--requests", "3", "--batch", "2",
                        "--max-new", "4", "--device", "cpu"])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 4 for r in done)
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    reqs = tserve.make_requests(tconfigs.get_smoke(arch), 8, 16)
    assert all(4 <= len(r.prompt) < 12 for r in reqs)


def test_serving_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    cfg = tconfigs.get_smoke("llama3.2-1b")
    g = torch.Generator().manual_seed(0)
    tp = lm.init_params(cfg, g, device="cpu")
    for call in (lambda: lm.init_params(cfg, g),
                 lambda: lm.init_cache(cfg, 1, 8),
                 lambda: ServeEngine(cfg, tp),
                 lambda: tserve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
