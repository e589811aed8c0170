"""Decode against prefill at the published widths of the dense LM
architectures that tests/test_torch_lm_width.py does not cover
(deepseek-7b, yi-34b, gemma2-9b, phi-3-vision-4.2b, whisper-small), in the
reference and in the port, on the same weights. The MoE and hybrid
architectures are in tests/test_torch_lm_width_moe.py, on these helpers.

Each model keeps every attention and SSM dimension of its published config
(d_model, query and kv heads, head dim, the SSM's head dim, state and
chunk, the logit softcaps) and has one repeat of its layers
(``block_period``). What is cut, as in tests/test_torch_lm_width.py:
- the vocabulary, to VOCAB (the head's width enters neither the decode nor
  the prefill arithmetic);
- whisper's encoder, to one of its 12 layers (one repeat, as the
  decoder's), over its published 1500 frames;
- for the MoE configs, the cuts their file names.

The rules are tests/test_torch_lm_width.py's f32 rules, with its
constants (every case here runs in f32):
- the port's decode-vs-prefill gap is at most 2 x the reference's gap +
  the floor (SENS_K x the reference's sensitivity);
- the port's decode is within DECODE_TOL x scale + the floor of the
  reference's decode, position by position. At a position where it is
  not, the position's logits are ill-conditioned: random-init weights of
  std 1 (one repeat) saturate the attention, and rounding moves such a
  position far more than the sensitivity (an embedding scaled by
  1 + 1e-7, which the first rmsnorm nearly cancels) shows. There the port
  is held to the reference's f64 evaluation (x64 on, its f32
  accumulation type set to f64), the truth both packages round: the
  port's own f64 forward within F64_TOL of it, and the port's f32
  distance from it at most F64_K times the reference's own, + the
  tolerance. At most F64_MAX positions of a case are held so.
  tests/test_torch_lm_encdec_vlm.py and test_torch_lm_archs.py hold
  random-init nets the same way;
- at serving lengths (S <= SERVE_LEN) both gaps are at most REF_GAP, the
  bound chip_smoke.py's served-token check builds its near-tie threshold
  on.

Per architecture:
- gemma2-9b runs its local and its global layer (window 4096, softcaps
  50 and 30, sandwich norms, GeGLU). No published config turns on
  ``decode_bf16_scores``, so no case takes the bf16 score chain (the
  smoke configs hold it: tests/test_torch_lm.py);
- phi-3-vision decodes without images in both packages (the reference's
  ``decode_step`` takes none), so a decode cannot follow a prefill with
  images: its gap is taken on text, and its prefill with 256 image
  embeddings over the first positions (+ text after them) is held to the
  reference's prefill by the decode rule above;
- whisper decodes with its cross-attention cache filled from
  ``lm.encoder_kv`` of an encoder run over 1500 frames, in each package
  from its own encoder.

Each case prints its gaps, floor and scale, the position where the
port's decode is farthest from the reference's, and for each position held
to f64 both packages' distance from the reference's f64 evaluation.
"""
import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro_torch.data import synthetic
from repro_torch.models.params import flatten, lm_from_jax, unflatten
from test_torch_lm_width import (BATCH, DECODE_TOL, REF_GAP, SENS_K,
                                 SERVE_LEN, VOCAB, one_repeat, port,
                                 reference)

# a position that misses the tight decode rule: the port's distance from
# the reference's f64 evaluation at most F64_K times the reference's own
# (the gap rule's factor); the two packages' f64 logits within F64_TOL of
# their scale (tests/test_torch_lm_encdec_vlm.py's); at most F64_MAX
# positions of a case held so
F64_K, F64_TOL, F64_MAX = 2.0, 1e-8, 2
FRAMES_SEED, IMAGES_SEED = 2, 3
# torch's threads in these cases (and tests/test_torch_lm_width_moe.py's).
# Beside the suite's other workers (one thread per core in every process)
# each product waits on its slowest thread, and the one-token decode steps
# are many products: on a few threads the cases run several times faster
# under that load (Jamba's thousands of small ones by far the most) and
# leave the other workers their cores; alone, the large configs'
# memory-bound steps run slower on fewer. The count sets MKL's split of
# the sums and so the port's f32 rounding: Yi's port gap is 0 on 2
# threads, 1.27e-4 on 4 and 1.85e-4 on 6, over its floor of 1.75e-4 (the
# reference's gap is 0), at its ill-conditioned position (b0, s25)
TORCH_THREADS = 4


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def both(ref_fn, port_fn):
    """``(*ref_fn(), port_fn())``, the port's run on a thread of its own
    (TORCH_THREADS torch threads) beside the reference's: each package
    spends much of a case in its own compiled code and thread pool (XLA's
    compiles and steps, the port's ATen ops), so the two overlap."""
    def on_thread():
        torch.set_num_threads(TORCH_THREADS)
        return port_fn()
    with ThreadPoolExecutor(1) as ex:
        got = ex.submit(on_thread)
        return (*ref_fn(), got.result())


def f32_weights(jcfg):
    """The reference's f32 parameters of ``jcfg`` (key 0)."""
    return jax.jit(lambda key: jax.tree.map(
        lambda a: a.astype("float32"),
        jmaterialize(jlm.param_defs(jcfg), key)))(jax.random.key(0))


def inputs(jcfg, B, S):
    tok = next(synthetic.token_batches(B, S, VOCAB, seed=1))[0]["tokens"]
    frames = None
    if jcfg.encoder_layers:
        frames = np.random.default_rng(FRAMES_SEED).standard_normal(
            (B, jcfg.num_encoder_frames, jcfg.d_model)).astype(np.float32)
    return tok, frames


def _f64(jcfg, tcfg, jp, tok, frames=None, images=None):
    """(the reference's f64 forward logits, the port's): x64 on and the
    reference's f32 accumulation type (``f32`` of ``lm`` and ``layers``)
    set to f64, the port on the same parameters in f64."""
    j64 = dataclasses.replace(jcfg, dtype="float64")
    with pytest.MonkeyPatch.context() as m, jax.enable_x64(True):
        m.setattr(jlm, "f32", jnp.float64)
        m.setattr(JL, "f32", jnp.float64)
        kw = {k: jnp.asarray(v, jnp.float64) for k, v in (
            ("encoder_frames", frames), ("image_embeds", images))
            if v is not None}
        jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        want = np.asarray(jlm.forward(j64, jp64, jnp.asarray(tok),
                                      **kw)[0])
        del jp64
    with warnings.catch_warnings():     # read-only views, only read
        warnings.simplefilter("ignore", UserWarning)
        tp = unflatten({k: torch.from_numpy(np.asarray(v)).double()
                        for k, v in flatten(jp).items()})
    got = port(dataclasses.replace(tcfg, dtype="float64"), tp, tok,
               None if frames is None else frames.astype(np.float64),
               None if images is None else images.astype(np.float64),
               decode=False)[0]
    return want, got


def _sensitivity(jp, fwd_fn, tok, ref_fwd):
    """The change of the reference's logits when its embedding is scaled
    by (1 + 1e-7), as tests/test_torch_lm_width.py's floor."""
    nudged = dict(jp, embed=jp["embed"] * (1 + 1e-7))
    return float(np.abs(np.asarray(fwd_fn(nudged, jnp.asarray(tok)),
                                   np.float32) - ref_fwd).max())


def hold_to_reference(name, got, want, scale, floor, jcfg, tcfg, jp, tok,
                      frames=None, images=None, explain=False):
    """f32: ``got`` (B,S,V) within DECODE_TOL x scale + floor of ``want``,
    position by position (``np.testing.assert_allclose``'s rule); each
    position that misses, at most F64_MAX, held to the reference's f64
    evaluation instead (F64_K), on the batch rows it is read at, where
    the port's f64 is within F64_TOL of the reference's. ``explain``:
    also print both packages' distance from f64 at the farthest
    position."""
    atol = DECODE_TOL * scale + floor
    over = np.abs(got - want) - DECODE_TOL * np.abs(want)
    miss = over.max(-1) > atol                                    # (B,S)
    b, s = np.unravel_index(np.abs(got - want).max(-1).argmax(), miss.shape)
    print(f"  {name}: farthest position (b={b}, s={s}): port vs reference "
          f"{np.abs(got - want)[b, s].max():.4g} (tolerance {atol:.4g}); "
          f"{int(miss.sum())} of {miss.size} positions held to f64")
    assert miss.sum() <= F64_MAX, (
        f"{name}: {int(miss.sum())} positions miss the decode rule "
        f"(at most {F64_MAX} may be held to f64): "
        f"{np.argwhere(miss).tolist()[:8]}")
    read = miss.copy()
    read[b, s] |= explain
    if not read.any():
        return
    rows = np.nonzero(read.any(1))[0]
    want64, got64 = _f64(jcfg, tcfg, jp, tok[rows],
                         None if frames is None else frames[rows],
                         None if images is None else images[rows])
    scale64 = max(1.0, float(np.abs(want64).max()))
    off64 = float(np.abs(got64 - want64).max())
    assert off64 <= F64_TOL * scale64, (
        f"{name}: port f64 vs reference f64 {off64} (scale {scale64})")
    port_off = np.abs(got[rows] - want64).max(-1)
    ref_off = np.abs(want[rows] - want64).max(-1)
    held = miss[rows]
    for (i, j) in np.argwhere(read[rows]):
        print(f"  {name}: (b={rows[i]}, s={j}) from the reference's f64: "
              f"reference {ref_off[i, j]:.4g}, port {port_off[i, j]:.4g} "
              f"(port f64 vs reference f64 {off64:.3g})")
    bad = held & (port_off > F64_K * ref_off + DECODE_TOL * scale)
    assert not bad.any(), (
        f"{name}: positions {np.argwhere(bad).tolist()} of rows "
        f"{rows.tolist()} miss both the decode rule and the f64 rule: port "
        f"{port_off[bad]}, reference {ref_off[bad]} from f64")


def hold_gap(label, jcfg, tcfg, jp, tok, frames=None, explain=False):
    """The width rules of tests/test_torch_lm_width.py for one f32
    case (``explain``: as ``hold_to_reference``'s)."""
    S = tok.shape[1]
    ref_fwd, ref_dec, fwd_fn, (port_fwd, port_dec) = both(
        lambda: reference(jcfg, jp, tok, frames),
        lambda: port(tcfg, lm_from_jax(jp), tok, frames))
    scale = max(1.0, float(np.abs(ref_fwd).max()))
    ref_gap = float(np.abs(ref_fwd - ref_dec).max())
    port_gap = float(np.abs(port_fwd - port_dec).max())
    floor = SENS_K * _sensitivity(jp, fwd_fn, tok, ref_fwd)
    print(f"{label} float32 S={S}: decode-vs-prefill gap reference "
          f"{ref_gap:.4g}, port {port_gap:.4g} (floor {floor:.4g}, logit "
          f"scale {scale:.3g})")
    assert port_gap <= 2 * ref_gap + floor, \
        f"port gap {port_gap} vs reference gap {ref_gap}, floor {floor}"
    if S <= SERVE_LEN:
        assert max(ref_gap, port_gap) <= REF_GAP["float32"]
    hold_to_reference(f"{label} decode", port_dec, ref_dec, scale, floor,
                      jcfg, tcfg, jp, tok, frames, explain=explain)


@pytest.mark.parametrize("arch,cuts", [
    ("deepseek-7b", {}), ("yi-34b", {}), ("gemma2-9b", {}),
    ("whisper-small", {"encoder_layers": 1})],
    ids=["deepseek-7b", "yi-34b", "gemma2-9b", "whisper-small"])
def test_decode_prefill_gap_at_full_width_matches_reference(arch, cuts):
    jcfg, tcfg = one_repeat(arch, "float32", **cuts)
    tok, frames = inputs(jcfg, BATCH, SERVE_LEN)
    hold_gap(arch, jcfg, tcfg, f32_weights(jcfg), tok, frames)


def test_phi3_gap_on_text_and_prefill_with_images_match_reference():
    """phi-3-vision at full width: the gap rules on text (decode takes no
    images), then the prefill with its 256 image embeddings over the first
    positions and SERVE_LEN text positions after them, one batch row, held
    to the reference's prefill by the decode rule (its floor from the
    sensitivity of that prefill)."""
    jcfg, tcfg = one_repeat("phi-3-vision-4.2b", "float32")
    jp = f32_weights(jcfg)
    tok, _ = inputs(jcfg, BATCH, SERVE_LEN)
    hold_gap("phi-3-vision-4.2b", jcfg, tcfg, jp, tok)

    N = jcfg.num_image_tokens
    tok = next(synthetic.token_batches(1, N + SERVE_LEN, VOCAB,
                                       seed=1))[0]["tokens"]
    images = np.random.default_rng(IMAGES_SEED).standard_normal(
        (1, N, jcfg.d_model)).astype(np.float32)
    ref_fwd, _, fwd_fn = reference(jcfg, jp, tok, images=images,
                                   decode=False)
    port_fwd, _ = port(tcfg, lm_from_jax(jp), tok, images=images,
                       decode=False)
    scale = max(1.0, float(np.abs(ref_fwd).max()))
    floor = SENS_K * _sensitivity(jp, fwd_fn, tok, ref_fwd)
    print(f"phi-3-vision-4.2b prefill with {N} image embeddings, "
          f"S={N + SERVE_LEN}: port vs reference "
          f"{np.abs(port_fwd - ref_fwd).max():.4g} (floor {floor:.4g}, "
          f"logit scale {scale:.3g})")
    hold_to_reference("phi-3-vision-4.2b prefill with images", port_fwd,
                      ref_fwd, scale, floor, jcfg, tcfg, jp, tok,
                      images=images)
