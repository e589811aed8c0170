"""The port's plain versions of the LM kernels (flash attention, SSD chunk
scan; the CPU path of repro_torch.kernels.ops) against the JAX package's
oracles and its Pallas kernels in interpret mode, on the same numpy inputs.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jscan
from repro.models.layers import _sdpa_block, _segsum
from repro_torch.kernels import ops, ref

# the reference's own kernel-test tolerances (tests/test_kernels.py)
FLASH_TOL, SCAN_TOL = 3e-5, 1e-5


def _qkv(rng, b, h, kv, s, d):
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    return q, k, v


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,d,causal", [(64, 32, True), (128, 64, True),
                                        (128, 64, False), (256, 32, True),
                                        (192, 64, True)])
def test_flash_attention_matches_reference_and_pallas(rng, s, d, causal):
    q, k, v = _qkv(rng, 2, 2, 2, s, d)
    got = ops.flash_attention(*_port(q, k, v), causal=causal).numpy()
    want = np.asarray(jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal))
    np.testing.assert_allclose(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
    pallas = np.asarray(jflash.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, bq=s // 2, bk=s // 4,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("h,kv", [(4, 1), (8, 2), (32, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grouped_heads(rng, h, kv, causal):
    """Fewer kv heads than query heads: the reference kernel takes equal
    heads, so its inputs get k/v repeated per group (head h reads kv head
    h // (H/K))."""
    q, k, v = _qkv(rng, 2, h, kv, 64, 32)
    got = ops.flash_attention(*_port(q, k, v), causal=causal).numpy()
    g = h // kv
    kr, vr = (np.repeat(t, g, axis=1) for t in (k, v))
    want = np.asarray(jref.flash_attention(*map(jnp.asarray, (q, kr, vr)),
                                           causal=causal))
    np.testing.assert_allclose(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("s", [1, 37, 100, 1000])
def test_flash_attention_ragged_sequence(rng, s):
    """Any S: the Pallas kernel needs S % bq == 0 (its ops fall back to the
    oracle otherwise); the port's plain version and kernel take every S."""
    q, k, v = _qkv(rng, 1, 4, 2, s, 32)
    got = ops.flash_attention(*_port(q, k, v)).numpy()
    kr, vr = (np.repeat(t, 2, axis=1) for t in (k, v))
    want = np.asarray(jref.flash_attention(*map(jnp.asarray, (q, kr, vr))))
    np.testing.assert_allclose(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_attention_reads_strided_views(rng):
    """The model hands over transposes of seq-major (B,S,H,D) tensors."""
    q, k, v = (rng.normal(size=(2, 48, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    got = ops.flash_attention(*(t.transpose(1, 2) for t in _port(q, k, v)))
    want = ops.flash_attention(*(torch.from_numpy(
        np.ascontiguousarray(t.transpose(0, 2, 1, 3))) for t in (q, k, v)))
    assert torch.equal(got, want)


def test_flash_attention_bf16_in_bf16_out(rng):
    q, k, v = _qkv(rng, 1, 4, 4, 64, 64)
    qb, kb, vb = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    got = ops.flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (qb, kb, vb))))
    # f32 sums, then one rounding of the output: half a bf16 ulp (2^-8 of
    # the value) on top of the f32 tolerance, element by element
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=FLASH_TOL + 2.0 ** -8, atol=FLASH_TOL)


@pytest.mark.parametrize("s,h,kv,causal", [(256, 4, 2, True),
                                          (200, 4, 4, False),
                                          (512, 8, 2, True)])
def test_model_bf16_attention_meets_the_bf16_kernel_bound(rng, s, h, kv,
                                                          causal):
    """The bound the card's bf16 flash kernel is held to
    (``ref.flash_bf16_limit``) is the reference model's own rounding, not a
    loosening: the JAX model's bf16 attention tile (``_sdpa_block``, which
    casts the probabilities to bf16 before the PV product) meets it
    against the plain f32 attention on the same inputs, where the bound
    for the output's rounding alone does not hold it."""
    d = 64
    q, k, v = _qkv(rng, 2, h, kv, s, d)
    qb, kb, vb = (torch.from_numpy(t).bfloat16() for t in (q, k, v))

    def seq_major(t):                        # (B,H,S,D) -> (B,S,H,D)
        return jnp.asarray(t.float().numpy(), jnp.bfloat16).transpose(
            0, 2, 1, 3)
    jq = seq_major(qb).reshape(2, s, kv, h // kv, d)     # (B,S,K,G,hd)
    mask = None
    if causal:
        pos = jnp.arange(s)
        mask = (pos[None, :] <= pos[:, None])[None, None, None]
    out = _sdpa_block(jq, seq_major(kb), seq_major(vb), mask, 0.0,
                      1.0 / math.sqrt(d))
    assert out.dtype == jnp.bfloat16
    got = torch.from_numpy(np.array(out.astype(jnp.float32))).reshape(
        2, s, h, d).transpose(1, 2)
    want = ref.flash_attention(qb.float(), kb.float(), vb.float(), causal)
    err = (got - want).abs()
    lim = ref.flash_bf16_limit(want, qb, kb, vb, causal, FLASH_TOL)
    assert float((err - lim).max()) <= 0
    output_only = FLASH_TOL * (1 + want.abs()) + ref.BF16_ULP * want.abs()
    assert bool((err > output_only).any())


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError):           # head dim not contiguous
        t = torch.zeros(1, 4, 32, 8).transpose(-1, -2)
        ops.flash_attention(q, t, t)
    # the plain path takes any head dim, as the reference does (the
    # kernels' set is checked for CUDA tensors: tests/test_torch_lm_grad.py)
    for d in (24, 128):
        qd = torch.zeros(1, 4, 8, d)
        assert ops.flash_attention(qd, qd, qd).shape == qd.shape


@pytest.mark.parametrize("b,nc,h,p,n", [(1, 4, 2, 8, 16), (2, 8, 4, 16, 8),
                                        (1, 12, 8, 64, 16), (2, 3, 3, 5, 7)])
def test_ssd_scan_matches_reference_and_pallas(rng, b, nc, h, p, n):
    st = rng.normal(size=(b, nc, h, p, n)).astype(np.float32)
    dc = rng.uniform(0.2, 1.0, (b, nc, h)).astype(np.float32)
    got = ops.ssd_chunk_scan(*_port(st, dc)).numpy()
    want = np.asarray(jref.ssd_chunk_scan(jnp.asarray(st), jnp.asarray(dc)))
    np.testing.assert_allclose(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)
    pallas = np.asarray(jscan.ssd_chunk_scan(jnp.asarray(st), jnp.asarray(dc),
                                             interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_ssd_scan_matches_model_segsum_form(rng):
    """The recurrence equals the reference model's segsum einsum, which the
    port's ``ssd`` replaces with the scan (as tests/test_kernels.py:94)."""
    B, NC, H, P, N = 2, 6, 3, 4, 8
    states = rng.normal(size=(B, NC, H, P, N)).astype(np.float32)
    chunk_sum = rng.uniform(-1.0, 0.0, (B, H, NC)).astype(np.float32)
    pad = jnp.pad(jnp.asarray(chunk_sum), ((0, 0), (0, 0), (1, 0)))
    all_states = jnp.concatenate([jnp.zeros((B, 1, H, P, N)),
                                  jnp.asarray(states)], axis=1)
    want = np.asarray(jnp.einsum("bhzc,bchpn->bzhpn", jnp.exp(_segsum(pad)),
                                 all_states)[:, :-1])
    decay = torch.exp(torch.from_numpy(chunk_sum)).transpose(1, 2)
    got = ops.ssd_chunk_scan(torch.from_numpy(states), decay).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ssd_scan_bf16_states_keep_an_fp32_carry(rng):
    st = torch.from_numpy(rng.normal(size=(1, 16, 2, 4, 4)).astype(
        np.float32)).bfloat16()
    dc = torch.full((1, 16, 2), 0.999)
    got = ops.ssd_chunk_scan(st, dc)
    assert got.dtype == torch.bfloat16
    want = ref.ssd_chunk_scan(st.float(), dc).bfloat16()
    assert torch.equal(got, want)


def test_ssd_scan_rejects_bad_operands():
    st = torch.zeros(1, 2, 3, 4, 5)
    with pytest.raises(ValueError):
        ops.ssd_chunk_scan(st, torch.zeros(1, 3, 2))
    with pytest.raises(ValueError):
        ops.ssd_chunk_scan(st[0], torch.zeros(2, 3))
    with pytest.raises(TypeError):
        ops.ssd_chunk_scan(st.half(), torch.zeros(1, 2, 3))
    with pytest.raises(TypeError):             # decay is float32 only
        ops.ssd_chunk_scan(st, torch.zeros(1, 2, 3, dtype=torch.bfloat16))
