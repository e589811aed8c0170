"""Decode against prefill at the published widths of the MoE and hybrid
LM architectures (mixtral-8x7b, grok-1-314b, jamba-1.5-large-398b), in the
reference and in the port, on the same weights, by the rules and helpers
of tests/test_torch_lm_width_archs.py (which say what is held and how).

Cuts beyond one repeat of the layers and a vocabulary of VOCAB:
- the experts, to top-k = E = 2 at a capacity factor of 1, so every token
  goes to every expert and none is dropped: routing near-ties and drops
  part a decode from its prefill by design (capacity depends on the
  batch). Routing and dropping stay held at the smoke width by
  tests/test_torch_lm_archs.py (``test_prefill_and_decode_agree_past_the_
  window`` and its ``moe_drops`` fixture);
- grok-1's expert d_ff, to GROK_D_FF of 32768 (two experts at 32768 are
  1.2 B parameters a package, over the case's time budget);
- jamba's width, to JAMBA_WIDTH (d_model, attention heads of its published
  head dim 128, d_ff), its SSD at its published dimensions (head dim 64,
  state 128, chunk 256, conv 4) over two chunks (S = 512, one batch row):
  one period, 7 SSD layers, an attention layer and 4 MoE layers, decoded
  step by step for 512 positions in each package.

Mixtral's case also prints both packages' distance from the reference's
f64 evaluation at the position where the port's decode is farthest from
the reference's (one token, where the reference's f32 is the farther).
"""
import pytest

from test_torch_lm_width import BATCH, SERVE_LEN, one_repeat
from test_torch_lm_width_archs import (f32_weights, few_threads,  # noqa: F401
                                       hold_gap, inputs)

MOE = dict(num_experts=2, experts_per_token=2, capacity_factor=1.0)
GROK_D_FF = 4096
JAMBA_WIDTH = dict(d_model=256, num_heads=8, num_kv_heads=8, d_ff=256)
JAMBA_B, JAMBA_S = 1, 512


@pytest.mark.parametrize("arch,cuts,B,S", [
    ("mixtral-8x7b", MOE, BATCH, SERVE_LEN),
    ("grok-1-314b", dict(MOE, d_ff=GROK_D_FF), BATCH, SERVE_LEN),
    ("jamba-1.5-large-398b", dict(MOE, **JAMBA_WIDTH), JAMBA_B, JAMBA_S)],
    ids=["mixtral-8x7b", "grok-1-314b", "jamba-1.5-large-398b"])
def test_decode_prefill_gap_at_full_width_matches_reference(arch, cuts, B,
                                                            S):
    jcfg, tcfg = one_repeat(arch, "float32", **cuts)
    tok, _ = inputs(jcfg, B, S)
    hold_gap(arch, jcfg, tcfg, f32_weights(jcfg), tok,
             explain=arch == "mixtral-8x7b")
