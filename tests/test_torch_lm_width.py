"""Decode against prefill at the published widths of Llama-3.2-1B and
Mamba-2-1.3B, in the reference and in the port, on the same weights.

The smoke configs of test_torch_lm.py are narrow; the served models are not.
Here each model has its full width (d_model 2048; 32 query heads over 8 kv
heads of 64; 64 SSM heads of 64 x 128 state, chunk 256) and one repeat of
its layers, with the vocabulary cut to VOCAB (the head's width does not
enter the decode or prefill arithmetic). For each model and dtype the
logits of the prefill forward and of a teacher-forced decode of the same
tokens differ by rounding only; how far is the decode-vs-prefill gap. The
port's gap is held to the reference's, and the gaps of both at serving
lengths to REF_GAP, the bound chip_smoke.py's served-token check builds its
near-tie threshold on. In float32 the port's decode is also held to the
reference's decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.models.params import lm_from_jax

VOCAB = 4096
BATCH = 2
SERVE_LEN = 32          # chip_smoke.py serves prompts of 4-12 + 16 tokens
# the reference's largest |forward - decode| logit at serving lengths, in
# either model: measured a few 1e-3 (f32) and a few 1e-2 (bf16) on these
# inputs, Mamba's the larger (its chunked segsum form rounds otherwise
# than its step-by-step recurrence)
REF_GAP = {"float32": 1e-2, "bfloat16": 1e-1}
# the port's gap may be twice the reference's plus a floor: where the
# reference's gap is 0 (XLA rounds Llama's prefill and decode alike), the
# port's sums in another order still differ. In f32 the floor is SENS_K
# times the reference's own sensitivity, the change of its logits when its
# embedding is scaled by (1 + 1e-7), as chip_smoke.py's twin checks; in
# bf16 (which that scaling does not reach) one bf16 rounding of the logits.
SENS_K = 10
BF16_FLOOR = 2.0 ** -7
# port vs reference decode, f32: times the scale, plus the floor above
DECODE_TOL = 1e-4


def one_repeat(arch, dtype, **cuts):
    """(reference config, port config): one repeat of ``arch``'s layers,
    vocabulary VOCAB, ``cuts`` on top."""
    full = jconfigs.get_config(arch)
    jcfg = dataclasses.replace(full, num_layers=jlm.block_period(full),
                               vocab_size=VOCAB, dtype=dtype, **cuts)
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def reference(jcfg, jp, tok, frames=None, images=None, decode=True):
    """(forward logits, teacher-forced decode logits or None, the jitted
    forward), each (B,S,V) f32; whisper's decode with its cross cache
    from ``encoder_kv``."""
    B, S = tok.shape
    kw = {}
    if frames is not None:
        kw["encoder_frames"] = jnp.asarray(frames, jcfg.dtype)
    if images is not None:
        kw["image_embeds"] = jnp.asarray(images, jcfg.dtype)
    fwd_fn = jax.jit(lambda p, t: jlm.forward(jcfg, p, t, **kw)[0])
    fwd = np.asarray(fwd_fn(jp, jnp.asarray(tok)), np.float32)
    if not decode:
        return fwd, None, fwd_fn
    cache = jax.tree.map(jnp.zeros_like, jmaterialize(
        jlm.cache_defs(jcfg, B, S), jax.random.key(1)))
    if frames is not None:
        enc = jax.jit(lambda p, f: jlm.encoder_kv(
            jcfg, p, jlm.encode(jcfg, p, f)))(jp, kw["encoder_frames"])
        for j, (k, v) in enumerate(zip(enc["k"], enc["v"])):
            cache[f"blk{j}"]["xk"], cache[f"blk{j}"]["xv"] = k, v
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    rows = []
    for s in range(S):
        logits, cache = step(jp, cache, jnp.asarray(tok[:, s:s + 1]),
                             jnp.full((B,), s, jnp.int32))
        rows.append(np.asarray(logits, np.float32))
    return fwd, np.stack(rows, 1), fwd_fn


def port(tcfg, tp, tok, frames=None, images=None, decode=True):
    """The port's (forward logits, teacher-forced decode logits or None),
    as ``reference``, in ``tcfg``'s dtype (f64 for an f64 evaluation)."""
    B, S = tok.shape
    dt = getattr(torch, tcfg.dtype)
    t = torch.from_numpy(tok)
    kw = {}
    if frames is not None:
        kw["encoder_frames"] = torch.from_numpy(frames).to(dt)
    if images is not None:
        kw["image_embeds"] = torch.from_numpy(images).to(dt)
    with torch.no_grad():
        fwd = lm.forward(tcfg, tp, t, **kw)[0].numpy()
        if not decode:
            return fwd, None
        cache = lm.init_cache(tcfg, B, S, device="cpu")
        if frames is not None:
            enc = lm.encoder_kv(tcfg, tp, lm.encode(tcfg, tp,
                                                    kw["encoder_frames"]))
            for j, (k, v) in enumerate(zip(enc["k"], enc["v"])):
                cache[f"blk{j}"]["xk"], cache[f"blk{j}"]["xv"] = k, v
        rows = [lm.decode_step(tcfg, tp, cache, t[:, s:s + 1],
                               torch.full((B,), s))[0].numpy()
                for s in range(S)]
    return fwd, np.stack(rows, 1)


@pytest.mark.parametrize("arch,dtype,S", [
    ("llama3.2-1b", "float32", SERVE_LEN),
    ("llama3.2-1b", "bfloat16", SERVE_LEN),
    ("mamba2-1.3b", "float32", SERVE_LEN),
    ("mamba2-1.3b", "bfloat16", SERVE_LEN),
    ("mamba2-1.3b", "float32", 512)])     # two chunks: the inter-chunk scan
def test_decode_prefill_gap_at_full_width_matches_reference(arch, dtype, S):
    jcfg, tcfg = one_repeat(arch, dtype)
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(0))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    tok = next(synthetic.token_batches(BATCH, S, VOCAB, seed=1))[0]["tokens"]
    ref_fwd, ref_dec, fwd_fn = reference(jcfg, jp, tok)
    port_fwd, port_dec = port(tcfg, lm_from_jax(jp), tok)
    scale = max(1.0, float(np.abs(ref_fwd).max()))
    ref_gap = float(np.abs(ref_fwd - ref_dec).max())
    port_gap = float(np.abs(port_fwd - port_dec).max())
    if dtype == "float32":
        nudged = dict(jp, embed=jp["embed"] * (1 + 1e-7))
        floor = SENS_K * float(np.abs(np.asarray(
            fwd_fn(nudged, jnp.asarray(tok)), np.float32) - ref_fwd).max())
    else:
        floor = BF16_FLOOR * scale
    print(f"{arch} {dtype} S={S}: decode-vs-prefill gap reference "
          f"{ref_gap:.4g}, port {port_gap:.4g} (floor {floor:.4g}, logit "
          f"scale {scale:.3g})")
    assert port_gap <= 2 * ref_gap + floor, \
        f"port gap {port_gap} vs reference gap {ref_gap}, floor {floor}"
    if S <= SERVE_LEN:
        assert max(ref_gap, port_gap) <= REF_GAP[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(port_dec, ref_dec, rtol=DECODE_TOL,
                                   atol=DECODE_TOL * scale + floor)
