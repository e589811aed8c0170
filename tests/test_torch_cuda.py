"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the card and skips
without one (a skip is not a pass). This file imports no JAX, so it runs on
a machine with the card and PyTorch alone:

    python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (depthwise_conv, flash_attention, int8_matmul,
                                 ops, quantize, ref, ssd_scan)

pytestmark = pytest.mark.cuda

# stride-1 depthwise (C, H, W) of full-width DetNet (128x128) and EDSNet
# (384x640), as their conv_layer_specs give them
DW_SHAPES = [(32, 64, 64), (144, 32, 32), (192, 16, 16), (384, 8, 8),
             (576, 8, 8), (960, 4, 4), (32, 192, 320), (144, 96, 160),
             (192, 48, 80), (384, 24, 40), (576, 24, 40), (960, 12, 20)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("c,h,w", DW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_matches_plain(cuda, c, h, w, dtype):
    g = _gen(c * h + w)
    x = torch.randn(2, h, w, c, generator=g).to(cuda, dtype)
    wt = torch.randn(c, 1, 3, 3, generator=g).to(cuda, dtype)
    before = depthwise_conv.depthwise_conv3x3.launches
    got = ops.depthwise_conv3x3(x, wt)
    torch.cuda.synchronize()
    assert depthwise_conv.depthwise_conv3x3.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ref.depthwise_conv3x3(x, wt)
    tol = 1e-5 if dtype == torch.float32 else 5e-2   # FMA contraction
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the tile plan's branches (kernels/depthwise_conv.plan): C not a multiple
# of 4 (element-masked loads), C=1 (one channel group, 128 columns a
# block), a 1x1 and a 3x5 map (rows and columns past the map), 4x4 maps of
# C=960 (30 channel chunks) at B=1 and B=8, and 17 channel groups (3
# chunks of 6, the last one short)
DW_EDGE_SHAPES = [(2, 5, 3, 30), (2, 4, 4, 1), (1, 1, 1, 1), (2, 1, 1, 30),
                  (2, 3, 5, 8), (2, 3, 5, 1), (1, 4, 4, 960), (8, 4, 4, 960),
                  (2, 9, 7, 68)]


@pytest.mark.parametrize("shape", DW_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_tile_edges(cuda, shape, dtype):
    g = _gen(sum(shape))
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    wt = torch.randn(shape[-1], 1, 3, 3, generator=g).to(cuda, dtype)
    got = ops.depthwise_conv3x3(x, wt)
    torch.cuda.synchronize()
    want = ref.depthwise_conv3x3(x, wt)
    tol = 1e-5 if dtype == torch.float32 else 5e-2   # FMA contraction
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_depthwise_kernel_unaligned_view(cuda):
    """A contiguous tensor whose storage starts mid-vector: the wrapper
    takes the element-wise path, not the 16-byte loads."""
    g = _gen(5)
    base = torch.randn(1 + 2 * 6 * 6 * 16, generator=g).to(cuda)
    x = base[1:].view(2, 6, 6, 16)
    wt = torch.randn(16, 1, 3, 3, generator=g).to(cuda)
    torch.testing.assert_close(ops.depthwise_conv3x3(x, wt),
                               ref.depthwise_conv3x3(x, wt), rtol=1e-5,
                               atol=1e-5)


def _mm_inputs(m, k, n):
    rng = np.random.default_rng(m + k + n)
    return (torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)),
            torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)),
            torch.from_numpy(rng.random(m, dtype=np.float32)),
            torch.from_numpy(rng.random(n, dtype=np.float32)))


# the tile plan's branches (kernels/int8_matmul.plan): the corner, ragged
# M, N and K, K = 24 (8-byte A copies) and N = 24 (8-byte B loads), XR
# shapes with K up to 960 (a ring of up to four stages) and N = 320 (two
# column tiles), and sizes of 1
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (37, 45, 29),
                                   (32768, 96, 24), (8192, 144, 24),
                                   (2048, 384, 64), (128, 960, 320),
                                   (30720, 24, 144), (100, 24, 40),
                                   (100, 40, 24), (122880, 16, 96),
                                   (1, 1, 1), (3, 257, 300), (70, 130, 1000)])
def test_int8_matmul_kernel_bit_equal(cuda, m, k, n):
    a, b, sa, sb = _mm_inputs(m, k, n)
    args = [t.to(cuda) for t in (a, b, sa, sb)]
    before = int8_matmul.int8_matmul.launches
    got = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    assert int8_matmul.int8_matmul.launches == before + 1
    assert torch.equal(got, ref.int8_matmul(*args))
    assert torch.equal(got.cpu(), ref.int8_matmul(a, b, sa, sb))


def test_int8_matmul_kernel_lm_shape(cuda):
    """Llama-3.2-1B's MLP projection at prefill B x S = 4096: (4096, 2048)
    x (2048, 8192), a ring of four stages and 256-wide tiles."""
    args = [t.to(cuda) for t in _mm_inputs(4096, 2048, 8192)]
    got = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul(*args))


def test_int8_matmul_kernel_beyond_the_old_grid(cuda):
    """M past 65535 blocks of 64 rows, the y-dimension cap of the first
    kernel: M runs on the grid's x dimension now."""
    m = 65535 * 64 + 1
    args = [t.to(cuda) for t in _mm_inputs(m, 8, 8)]
    got = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul(*args))


def test_int8_matmul_kernel_unaligned_views(cuda):
    """Operands whose storage starts at an odd byte: the wrapper narrows
    the copies to bytes."""
    a, b, sa, sb = (t.to(cuda) for t in _mm_inputs(96, 64, 48))
    ab = torch.zeros(1 + a.numel(), dtype=torch.int8, device=cuda)
    bb = torch.zeros(1 + b.numel(), dtype=torch.int8, device=cuda)
    ab[1:] = a.flatten()
    bb[1:] = b.flatten()
    got = ops.int8_matmul(ab[1:].view(a.shape), bb[1:].view(b.shape), sa, sb)
    assert torch.equal(got, ref.int8_matmul(a, b, sa, sb))


@pytest.mark.parametrize("k", [128, int8_matmul.MAX_K])
def test_int8_matmul_kernel_exact_accumulation(cuda, k):
    """127 x -127 summed K times: at K = MAX_K the int32 sum is within
    2^31 of zero by 33 million, and every partial sum is exact."""
    a = torch.full((128, k), 127, dtype=torch.int8, device=cuda)
    b = torch.full((k, 128), -127, dtype=torch.int8, device=cuda)
    one = torch.ones(128, device=cuda)
    out = ops.int8_matmul(a, b, one, one)
    assert torch.all(out == float(127 * -127 * k))
    assert torch.equal(out, ref.int8_matmul(a, b, one, one))


# the lane plan's branches (kernels/quantize.plan): groups of 4, 8 and 16
# lanes per row (N = 16, 24, 33; 33 takes element loads), a warp per row
# with 1 to 16 slots a lane (N = 144 .. 2048), a block per row (N = 100000,
# 2049), and N = 1 and 5
@pytest.mark.parametrize("m,n", [(256, 512), (32768, 24), (5, 33),
                                 (8192, 144), (3, 100000), (122880, 16),
                                 (7680, 24), (1000, 33), (4096, 2048),
                                 (9, 2049), (7, 1), (7, 5)])
def test_quantize_kernel_bit_equal(cuda, m, n):
    x = (torch.randn(m, n, generator=_gen(m + n)) * 3).to(cuda)
    before = quantize.quantize_rows.launches
    q, s = ops.quantize_rows(x)
    assert quantize.quantize_rows.launches == before + 1
    rq, rs = ref.quantize_rows(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    cq, cs = ref.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)


@pytest.mark.parametrize("n", [16, 2048])
def test_quantize_kernel_unaligned_view(cuda, n):
    """Rows whose base is not 16-byte aligned (a view at offset 1): element
    loads and byte stores instead of the vectors."""
    base = (torch.randn(1 + 64 * n, generator=_gen(n)) * 3).to(cuda)
    x = base[1:].view(64, n)
    q, s = ops.quantize_rows(x)
    rq, rs = ref.quantize_rows(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)


def test_quantize_kernel_half_ties(cuda):
    row = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]
    x = torch.tensor([row, [v / 2 for v in row]], device=cuda)
    q, s = ops.quantize_rows(x)
    assert q[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]
    assert torch.equal(q, ref.quantize_rows(x)[0])


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda)
    w = torch.randn(16, 1, 3, 3, device=cuda)
    with pytest.raises(ValueError):          # NCHW-contiguous, not NHWC
        depthwise_conv.depthwise_conv3x3(
            x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), w)
    with pytest.raises(TypeError):
        depthwise_conv.depthwise_conv3x3(x.half(), w.half())
    with pytest.raises(ValueError):          # mixed devices
        depthwise_conv.depthwise_conv3x3(x, w.cpu())
    a = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        int8_matmul.int8_matmul(a, a.t().float(), torch.ones(4, device=cuda),
                                torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        int8_matmul.int8_matmul(a, a.t(), torch.ones(4, device=cuda),
                                torch.ones(4, device=cuda))
    with pytest.raises(TypeError):
        quantize.quantize_rows(torch.zeros((4, 4), dtype=torch.bfloat16,
                                           device=cuda))
    with pytest.raises(ValueError):
        quantize.quantize_rows(torch.zeros(16, 8, device=cuda).t())


# attention: Llama-3.2-1B's 32 query heads over 8 kv heads at D=64, ragged
# S, every grouping from one kv head per query head (the Pallas kernel's
# case) to one kv head for all. Each element is held to the plain version
# in f32 on the same (upcast) inputs: within ATTN_TOL (the online softmax
# sums in another order), and in bf16 within ref.flash_bf16_limit, which
# adds 2^-8 (|value| + A(q, k, |v|)) for the bf16 kernel's three roundings
# (the probabilities before the PV product, as the model's reference
# rounds them, their denominator, the output; A is the plain f32 attention
# applied to |v|).
ATTN_TOL = 3e-5


def _assert_attention_close(got, q, k, v, causal):
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal)
    if got.dtype == torch.bfloat16:
        over = (got.float() - want).abs() - ref.flash_bf16_limit(
            want, q, k, v, causal, ATTN_TOL)
        assert float(over.max()) <= 0, (
            f"{int((over > 0).sum())} elements over the bf16 bound, the "
            f"worst by {float(over.max())}")
    else:
        torch.testing.assert_close(got.float(), want, rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


def _attn_inputs(g, B, H, K, S, D, dtype, device, seq_major=False):
    def one(heads):
        if seq_major:                     # the model's (B,S,H,D) projection
            t = torch.randn(B, S, heads, D, generator=g)
            return t.to(device, dtype).transpose(1, 2)
        return torch.randn(B, heads, S, D, generator=g).to(device, dtype)
    return one(H), one(K), one(K)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1000, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, S, dtype, causal):
    q, k, v = _attn_inputs(_gen(S), 2, 32, 8, S, 64, dtype, cuda,
                           seq_major=True)
    before = flash_attention.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, q, k, v, causal)


@pytest.mark.parametrize("H,K", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_heads_and_dims(cuda, H, K, D, dtype):
    S = 130
    q, k, v = _attn_inputs(_gen(H * D + K), 3, H, K, S, D, dtype, cuda)
    for causal in (True, False):
        _assert_attention_close(ops.flash_attention(q, k, v, causal), q, k,
                                v, causal)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_attention_bf16_kernel_tile_edges(cuda, S, D, G):
    """The bf16 (wgmma) kernel around its 64-key tiles and 128-row blocks
    (one warpgroup's 64 rows past S, a lone ragged key), every query-head
    group size, every head dim (its 64- and 32-column swizzled regions)."""
    H = 8
    q, k, v = _attn_inputs(_gen(S * D + G), 2, H, H // G, S, D,
                           torch.bfloat16, cuda, seq_major=True)
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        _assert_attention_close(got, q, k, v, causal)


def test_flash_attention_kernel_causal_rows_see_only_their_past(cuda):
    """Changing the keys and values after position t leaves rows <= t."""
    q, k, v = _attn_inputs(_gen(7), 1, 4, 4, 300, 64, torch.float32, cuda)
    a = ops.flash_attention(q, k, v, True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] += 5.0
    v2[:, :, 100:] -= 5.0
    b = ops.flash_attention(q, k2, v2, True)
    assert torch.equal(a[:, :, :100], b[:, :, :100])
    assert not torch.equal(a[:, :, 100:], b[:, :, 100:])


@pytest.mark.parametrize("B,NC,H,P,N", [(2, 8, 64, 64, 128), (1, 1, 3, 5, 7),
                                        (2, 9, 4, 33, 17), (3, 4, 2, 64, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_bit_equal(cuda, B, NC, H, P, N, dtype):
    """(2,8,64,64,128) is a Mamba-2-1.3B layer at B=2, S=2048."""
    g = _gen(B * NC + H * P + N)
    st = torch.randn(B, NC, H, P, N, generator=g).to(cuda, dtype)
    dc = torch.rand(B, NC, H, generator=g).to(cuda)
    before = ssd_scan.ssd_chunk_scan.launches
    got = ops.ssd_chunk_scan(st, dc)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk_scan.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, ref.ssd_chunk_scan(st, dc))


def test_ssd_scan_kernel_strided_inputs(cuda):
    """The model's chunk states come out of an einsum in any layout and
    its decay is a transposed (B,H,NC) tensor: read through strides."""
    g = _gen(3)
    st = torch.randn(2, 64, 8, 32, 16, generator=g).to(cuda)   # (B,H,NC,N,P)
    st = st.permute(0, 2, 1, 4, 3)                             # (B,NC,H,P,N)
    dc = torch.rand(2, 64, 8, generator=g).to(cuda).transpose(1, 2)
    got = ops.ssd_chunk_scan(st, dc)
    assert torch.equal(got, ref.ssd_chunk_scan(st.contiguous(),
                                               dc.contiguous()))


def test_lm_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.randn(1, 4, 16, 64, device=cuda)
    with pytest.raises(ValueError):          # head dim 48
        flash_attention.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    q80 = torch.randn(1, 4, 16, 80, device=cuda)
    with pytest.raises(ValueError, match="not in the kernels'"):  # no instance
        flash_attention.flash_attention(q80, q80, q80)
    with pytest.raises(ValueError):          # 3 kv heads for 4 query heads
        flash_attention.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):          # head dim not contiguous
        t = torch.randn(1, 4, 64, 16, device=cuda).transpose(-1, -2)
        flash_attention.flash_attention(q, t, t)
    with pytest.raises(ValueError):          # mixed devices
        flash_attention.flash_attention(q, q.cpu(), q)
    t = torch.randn(1, 4, 16, 72, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # bf16 rows not 16-byte aligned
        flash_attention.flash_attention(t[..., 4:68], t[..., 4:68],
                                        t[..., 4:68])
    st = torch.randn(1, 2, 3, 4, 5, device=cuda)
    with pytest.raises(ValueError):
        ssd_scan.ssd_chunk_scan(st, torch.rand(1, 3, 2, device=cuda))
    with pytest.raises(TypeError):
        ssd_scan.ssd_chunk_scan(st.half(), torch.rand(1, 2, 3, device=cuda))
    with pytest.raises(TypeError):           # decay is float32 only
        ssd_scan.ssd_chunk_scan(st, torch.rand(1, 2, 3, device=cuda,
                                               dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ssd_scan.ssd_chunk_scan(st, torch.rand(1, 2, 3))


# ---------------------------------------------------------------------------
# training: the depthwise backward on kernels, and no detached results
# ---------------------------------------------------------------------------

# stride-1 depthwise (B, H, W, C) of the training batches: DetNet b8 at
# 128x128 and EDSNet b4 at 384x640 (distinct shapes)
TRAIN_DW_SHAPES = [(8, 64, 64, 32), (8, 32, 32, 144), (8, 16, 16, 192),
                   (8, 8, 8, 384), (8, 8, 8, 576), (8, 4, 4, 960),
                   (4, 192, 320, 32), (4, 96, 160, 144), (4, 48, 80, 192),
                   (4, 24, 40, 384), (4, 24, 40, 576), (4, 12, 20, 960)]
# the wgrad plan's branches: C not a multiple of 4, C = 1, 1x1 and 3x5
# maps (th = 1, 2), H = 12 (a short last strip), 17 channel groups
WGRAD_EDGE_SHAPES = [(2, 5, 3, 30), (2, 4, 4, 1), (1, 1, 1, 1),
                     (2, 3, 5, 8), (2, 12, 20, 68), (3, 9, 7, 13)]


def _wgrad_bound(x, g):
    """The f64 weight gradient and the kernel's rounding bound around it:
    depth x 2^-24 x sum|x g| per tap (kernels/depthwise_conv.wgrad_plan)."""
    exact = ref.depthwise_conv3x3_wgrad(x.double(), g.double())
    mag = ref.depthwise_conv3x3_wgrad(x.double().abs(), g.double().abs())
    depth = depthwise_conv.wgrad_plan(*x.shape).depth
    return exact, depth * 2.0 ** -24 * mag


@pytest.mark.parametrize("shape", TRAIN_DW_SHAPES + WGRAD_EDGE_SHAPES)
def test_depthwise_wgrad_kernel_within_its_rounding_bound(cuda, shape):
    g = _gen(sum(shape))
    x = torch.randn(shape, generator=g).to(cuda)
    dy = torch.randn(shape, generator=g).to(cuda)
    before = depthwise_conv.depthwise_conv3x3_wgrad.launches
    got = ops.depthwise_conv3x3_wgrad(x, dy)
    again = ops.depthwise_conv3x3_wgrad(x, dy)
    torch.cuda.synchronize()
    assert depthwise_conv.depthwise_conv3x3_wgrad.launches == before + 2
    assert got.shape == (shape[-1], 1, 3, 3) and got.dtype == torch.float32
    assert torch.equal(got, again)            # fixed order: the same bits
    exact, bound = _wgrad_bound(x, dy)
    assert bool(((got.double() - exact).abs() <= bound).all())


def test_depthwise_wgrad_kernel_unaligned_view(cuda):
    """Storage starting mid-vector: the element-wise loads."""
    g = _gen(6)
    base = torch.randn(2 * (1 + 2 * 6 * 6 * 16), generator=g).to(cuda)
    x = base[1:1 + 2 * 6 * 6 * 16].view(2, 6, 6, 16)
    dy = base[-2 * 6 * 6 * 16:].view(2, 6, 6, 16)
    exact, bound = _wgrad_bound(x, dy)
    got = ops.depthwise_conv3x3_wgrad(x, dy)
    assert bool(((got.double() - exact).abs() <= bound).all())


def _wgrad_checked(x, dy):
    """One kernel call, held to its rounding bound; returns dw."""
    got = ops.depthwise_conv3x3_wgrad(x, dy)
    exact, bound = _wgrad_bound(x, dy)
    assert bool(((got.double() - exact).abs() <= bound).all())
    return got


def _tickets_zero():
    torch.cuda.synchronize()
    return all(bool((t == 0).all())
               for t, _ in depthwise_conv._WORKSPACE.values())


@pytest.mark.parametrize("shape,clusters", [((8, 8, 8, 576), 1),
                                            ((4, 192, 320, 32), 30)])
def test_depthwise_wgrad_kernel_cluster_layouts(cuda, shape, clusters):
    """A map that one cluster a chunk covers (no scratch, no ticket) and
    one whose chunk spans 30 clusters (rows summed by the last to take a
    ticket): the same bits twice, within the bound, tickets back at 0."""
    assert depthwise_conv.wgrad_plan(*shape).n_clusters == clusters
    g = _gen(sum(shape) + 1)
    x = torch.randn(shape, generator=g).to(cuda)
    dy = torch.randn(shape, generator=g).to(cuda)
    first = _wgrad_checked(x, dy)
    assert torch.equal(first, ops.depthwise_conv3x3_wgrad(x, dy))
    assert _tickets_zero()


def test_depthwise_wgrad_kernel_tickets_reset_across_calls_and_streams(
        cuda):
    """Back-to-back calls on one stream at shapes of 4, 1, 32 and 6
    clusters a chunk, and the first call again, with no synchronization
    between them, then the same calls on a second stream: every result
    within its bound and equal in bits to the first stream's and to the
    first call's, every ticket back at 0 (a ticket left dirty would make a
    later launch sum its rows before they are written, or never)."""
    shapes = [(8, 16, 16, 192), (8, 8, 8, 384), (8, 64, 64, 32),
              (4, 96, 160, 144), (8, 16, 16, 192)]
    assert [depthwise_conv.wgrad_plan(*s).n_clusters for s in shapes] == \
        [4, 1, 32, 6, 4]
    g = _gen(17)
    inputs = [(torch.randn(s, generator=g).to(cuda),
               torch.randn(s, generator=g).to(cuda)) for s in shapes[:-1]]
    inputs.append(inputs[0])
    main = [ops.depthwise_conv3x3_wgrad(x, dy) for x, dy in inputs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = [ops.depthwise_conv3x3_wgrad(x, dy) for x, dy in inputs]
    torch.cuda.current_stream().wait_stream(side)
    assert _tickets_zero()
    for (x, dy), a, b in zip(inputs, main, other):
        exact, bound = _wgrad_bound(x, dy)
        assert bool(((a.double() - exact).abs() <= bound).all())
        assert torch.equal(a, b)
    assert torch.equal(main[0], main[-1])


@pytest.mark.parametrize("shape", [(8, 16, 16, 192), (4, 24, 40, 384),
                                   (2, 5, 3, 30)])
def test_depthwise_function_gradients_match_plain_autograd(cuda, shape):
    """The Function's dx (forward kernel, turned weights) and dw (wgrad
    kernel) against autograd of the plain forward."""
    g = _gen(shape[-1])
    x = torch.randn(shape, generator=g).to(cuda)
    w = torch.randn(shape[-1], 1, 3, 3, generator=g).to(cuda)
    r = torch.randn(shape, generator=g).to(cuda)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ops.depthwise_conv3x3(xa, wa) * r).sum().backward()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ref.depthwise_conv3x3(xb, wb) * r).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    mag = ref.depthwise_conv3x3_wgrad(x.abs(), r.abs())
    assert bool(((wa.grad - wb.grad).abs() <= 1e-5 * mag).all())


@pytest.fixture
def full_f32():
    """cuDNN convolutions in full f32 (TF32 is its default), as training
    and chip_smoke.py run them."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = flags


def test_xrnet_gradients_reach_every_parameter(cuda, full_f32):
    """A smoke XRNet trained on the card: every parameter gets a finite
    gradient, the depthwise weights and the stem a nonzero one, all within
    1e-4 of the largest entry of the same step on the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import xr
    cfg = get_smoke("detnet")
    net = xr.XRNet(cfg, _gen(3), device=cuda)
    twin = xr.XRNet(cfg, device="cpu")
    twin.load_state_dict(net.state_dict())
    rng = np.random.default_rng(3)
    batch = {"image": rng.random((4, *cfg.input_hw, 3), dtype=np.float32),
             "center": rng.random((4, 2, 2), dtype=np.float32),
             "radius": rng.random((4, 2), dtype=np.float32),
             "label": rng.integers(0, 2, 4).astype(np.int32)}
    grads = {}
    for m, dev in ((net, cuda), (twin, torch.device("cpu"))):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        outs, _ = m(b["image"], train=True)
        xr.circle_loss(outs, b)[0].backward()
        grads[dev.type] = {k: p.grad for k, p in m.named_parameters()}
    gmax = max(float(t.abs().max()) for t in grads["cpu"].values())
    for k, gc in grads["cuda"].items():
        assert gc is not None and bool(torch.isfinite(gc).all()), k
        assert float((gc.cpu() - grads["cpu"][k]).abs().max()) <= 1e-4 * gmax
    for st in net.plan:
        if xr.uses_depthwise_kernel(st) or st.name == "stem":
            assert bool((getattr(net, st.name).w.grad != 0).any()), st.name


def test_kernels_without_backward_refuse_autograd(cuda):
    """quantize_rows and int8_matmul raise under autograd instead of
    returning a detached result; under no_grad they run. (flash_attention
    and ssd_chunk_scan have their backward since the LM-training slice.)"""
    xq = torch.randn(8, 16, device=cuda, requires_grad=True)
    a = torch.zeros(4, 4, dtype=torch.int8, device=cuda)
    s = torch.ones(4, device=cuda, requires_grad=True)
    calls = [lambda: ops.quantize_rows(xq),
             lambda: ops.int8_matmul(a, a, s, s)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward kernel"):
            call()
    with torch.no_grad():
        for call in calls:
            call()
    xb = torch.randn(1, 4, 4, 8, device=cuda, dtype=torch.bfloat16,
                     requires_grad=True)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.depthwise_conv3x3(xb, torch.randn(8, 1, 3, 3, device=cuda,
                                              dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# LM training: the attention and scan backward on kernels
# ---------------------------------------------------------------------------

def _attn_case(cuda, B, H, K, S, D, dtype, causal, seed):
    g = _gen(seed)
    q, k, v = _attn_inputs(g, B, H, K, S, D, dtype, cuda, seq_major=True)
    o, lse = flash_attention.flash_attention(q, k, v, causal, with_lse=True)
    do = torch.randn(B, S, H, D, generator=g).to(cuda, dtype).transpose(1, 2)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,K,S", [(8, 2, 130), (4, 4, 64), (8, 1, 1)])
def test_flash_attention_backward_kernel_matches_plain(cuda, D, dtype, causal,
                                                       H, K, S):
    """dq, dk, dv against the plain backward in f32 on the same (upcast)
    inputs, within ref.flash_bwd_limit (ATTN_TOL times each gradient's
    magnitude, + in bf16 2^-8 (|value| + magnitude) for the output rounding
    and the tensor-core route's P and dS rounded to bf16 as operands), the
    same bits on a second call, and the forward's log-sum-exp against the
    plain one."""
    q, k, v, o, lse, do = _attn_case(cuda, 2, H, K, S, D, dtype, causal,
                                     D + S + H)
    before = flash_attention.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd.launches == before + 2
    torch.testing.assert_close(lse, ref.flash_attention_lse(
        q.float(), k.float(), causal), rtol=1e-5, atol=1e-5)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal)
    lims = ref.flash_bwd_limit(want, q, k, v, o, lse, do, causal, ATTN_TOL,
                               dtype == torch.bfloat16)
    for g, a, w, lim, t in zip(got, again, want, lims, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g, a)
        assert bool(((g.float() - w).abs() <= lim).all())


def test_flash_attention_backward_at_the_llama_shape(cuda):
    """B=2, S=2048, 32 query heads over 8 kv heads of 64, causal, bf16: the
    main path's call, on the tensor cores, within the bf16 bound."""
    q, k, v, o, lse, do = _attn_case(cuda, 2, 32, 8, 2048, 64,
                                     torch.bfloat16, True, 5)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), True)
    lims = ref.flash_bwd_limit(want, q, k, v, o, lse, do, True, ATTN_TOL,
                               True)
    for g, w, lim in zip(got, want, lims):
        assert bool(((g.float() - w).abs() <= lim).all())


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_bf16_at_large_head_dims(cuda, D, causal):
    """The tensor-core backward where its registers are tightest (dK and
    dV of 64 keys at D=128; at D=256 each warpgroup sums half the head
    dim): several key blocks, a ragged S, grouped heads, within the bf16
    bound and the same bits on a second call."""
    q, k, v, o, lse, do = _attn_case(cuda, 2, 8, 2, 1000, D,
                                     torch.bfloat16, causal, D + 7)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal)
    lims = ref.flash_bwd_limit(want, q, k, v, o, lse, do, causal, ATTN_TOL,
                               True)
    for g, a, w, lim in zip(got, again, want, lims):
        assert torch.equal(g, a)
        assert bool(((g.float() - w).abs() <= lim).all())


def test_flash_attention_backward_bf16_refuses_misaligned_rows(cuda):
    """The bf16 backward loads 16-byte rows: a seq stride that is not a
    multiple of 8 elements raises, as in the forward, and the Function
    copies such an output gradient instead."""
    q, k, v, o, lse, do = _attn_case(cuda, 1, 2, 2, 10, 64, torch.bfloat16,
                                     True, 3)
    wide = torch.randn(1, 2, 10, 68, generator=_gen(4)).to(cuda,
                                                           torch.bfloat16)
    bad = wide[..., :64]                  # seq stride 68: 136-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention_bwd(q, k, v, o, lse, bad, True)
    a = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*a, True).backward(bad)
    want = ops.flash_attention_bwd(q, k, v, o, lse, bad.contiguous(), True)
    for t, w in zip(a, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_matches_plain_autograd(cuda, dtype):
    """Through ops under autograd: the Function's gradients against
    autograd of the plain forward on the upcast inputs."""
    q, k, v = _attn_inputs(_gen(11), 2, 8, 2, 100, 64, dtype, cuda,
                           seq_major=True)
    r = torch.randn(2, 8, 100, 64, generator=_gen(12)).to(cuda)
    a = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    y = ops.flash_attention(*a, True)
    assert type(y.grad_fn).__name__ == "FlashAttentionBackward"
    (y.float() * r).sum().backward()
    b = [t.detach().float().requires_grad_() for t in (q, k, v)]
    (ref.flash_attention(*b, True) * r).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for ta, tb in zip(a, b):
        assert ta.grad.dtype == dtype
        scale = float(tb.grad.abs().max())
        assert float((ta.grad.float() - tb.grad).abs().max()) <= tol * scale


@pytest.mark.parametrize("B,NC,H,P,N", [(2, 8, 64, 64, 128), (1, 1, 3, 5, 7),
                                        (2, 9, 4, 33, 17), (3, 4, 2, 64, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_kernel(cuda, B, NC, H, P, N, dtype):
    """dstates bit-equal to the plain reverse scan; ddecay within 1e-6 of
    its magnitude (sum of |lam s|) off the f64 sum; the same bits twice."""
    g = _gen(B + NC + H + P + N)
    st = torch.randn(B, NC, H, P, N, generator=g).to(cuda, dtype)
    dc = torch.rand(B, NC, H, generator=g).to(cuda)
    out = ops.ssd_chunk_scan(st, dc)
    gr = torch.randn(B, NC, H, P, N, generator=g).to(cuda, dtype)
    before = ssd_scan.ssd_chunk_scan_bwd.launches
    ds, dd = ops.ssd_chunk_scan_bwd(gr, out, dc)
    ds2, dd2 = ops.ssd_chunk_scan_bwd(gr, out, dc)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk_scan_bwd.launches == before + 2
    assert torch.equal(ds, ds2) and torch.equal(dd, dd2)
    assert ds.dtype == dtype and dd.dtype == torch.float32
    assert torch.equal(ds, ref.ssd_chunk_scan_bwd(gr, out, dc)[0])
    exact = ref.ssd_chunk_scan_bwd(gr.double(), out.double(), dc.double())[1]
    mag = ref.ssd_chunk_scan_bwd(gr.double().abs(), out.double().abs(),
                                 dc.double())[1]
    assert bool(((dd.double() - exact).abs() <= 1e-6 * mag).all())


def test_ssd_scan_function_matches_plain_autograd(cuda):
    g = _gen(21)
    st = torch.randn(2, 6, 4, 8, 16, generator=g).to(cuda)
    dc = torch.rand(2, 6, 4, generator=g).to(cuda)
    r = torch.randn(2, 6, 4, 8, 16, generator=g).to(cuda)
    a = [st.clone().requires_grad_(), dc.clone().requires_grad_()]
    y = ops.ssd_chunk_scan(*a)
    assert type(y.grad_fn).__name__ == "SsdChunkScanBackward"
    (y * r).sum().backward()
    b = [st.clone().requires_grad_(), dc.clone().requires_grad_()]
    (ref.ssd_chunk_scan(*b) * r).sum().backward()
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-5)


def test_lm_backward_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, o, lse, do = _attn_case(cuda, 1, 4, 2, 16, 64, torch.float32,
                                     True, 3)
    with pytest.raises(ValueError):          # lse of another shape
        flash_attention.flash_attention_bwd(q, k, v, o, lse[:, :2], do)
    with pytest.raises(ValueError):          # do in another dtype
        flash_attention.flash_attention_bwd(q, k, v, o, lse, do.double())
    st = torch.randn(1, 2, 3, 4, 5, device=cuda)
    dc = torch.rand(1, 2, 3, device=cuda)
    with pytest.raises(ValueError):          # out not contiguous
        ssd_scan.ssd_chunk_scan_bwd(st, st.transpose(-1, -2).contiguous()
                                    .transpose(-1, -2), dc)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_lm_step_gradients_on_the_card_match_the_cpu(cuda, full_f32, arch):
    """One smoke-config step in f32 through the kernels forward and
    backward: one launch of each kernel and its backward per layer, and
    every parameter a finite gradient, held against the same step on the
    CPU (the plain versions) and in f64 there: within 1e-4 of the largest
    entry of the CPU's, or, where these random nets amplify rounding, at
    most twice the CPU's own distance from f64 (+ 1e-4 of the largest
    entry), as chip_smoke.py's LT3 holds the full-width step."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (2, 65)).astype(np.int32)
    grads = {}
    for dev, dt in ((cuda, "float32"), (torch.device("cpu"), "float32"),
                    (torch.device("cpu"), "float64")):
        c = dataclasses.replace(cfg, dtype=dt)
        params = lm.init_params(cfg, _gen(4), dev)
        flat = flatten(params)
        for p in flat.values():
            p.data = p.data.to(getattr(torch, dt))
            p.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
                 "labels": torch.from_numpy(tok[:, 1:]).to(dev)}
        before = dict(ops.launches())
        lm.lm_loss(c, params, batch)[0].backward()
        if dev.type == "cuda":
            n = ops.launches()
            key = "flash_attention" if arch.startswith("llama") \
                else "ssd_chunk_scan"
            assert n[key] - before[key] == cfg.num_layers
            assert n[key + "_bwd"] - before[key + "_bwd"] == cfg.num_layers
        grads[dev.type, dt] = {k: p.grad.double().cpu()
                               for k, p in flat.items()}
    card, cpu, f64 = (grads[k] for k in (("cuda", "float32"),
                                         ("cpu", "float32"),
                                         ("cpu", "float64")))
    gmax = max(float(t.abs().max()) for t in cpu.values())
    for k, gc in card.items():
        assert bool(torch.isfinite(gc).all()), k
        if float((gc - cpu[k]).abs().max()) <= 1e-4 * gmax:
            continue
        off_card = float((gc - f64[k]).abs().max())
        off_cpu = float((cpu[k] - f64[k]).abs().max())
        assert off_card <= 2 * off_cpu + 1e-4 * gmax, (k, off_card, off_cpu)


# ---------------------------------------------------------------------------
# sliding windows and the logit softcap (Gemma-2, Mixtral, Grok-1)
# ---------------------------------------------------------------------------

# (D, G) of the configs' attention: DeepSeek (G 1), Mixtral (4), Grok-1 (6),
# Yi (7) at head dim 128, Gemma-2 (2) at 256
ARCH_ATTN = [(128, 1), (128, 4), (128, 6), (128, 7), (256, 2)]
# (window, softcap): Gemma-2's local and global layers, Mixtral's, Grok-1's
ARCH_MASKS = [(4096, 50.0), (0, 50.0), (4096, 0.0), (0, 30.0)]


def _masked_case(cuda, H, K, S, D, dtype, window, cap, seed, causal=True,
                 B=1):
    """Forward (through ops), its lse and the backward kernel against the
    plain forward and autograd of it in f32 on the same (upcast) inputs,
    within the bounds of ref (flash_limit / flash_bf16_limit and
    flash_bwd_limit, each with its stated tanh term); the backward the same
    bits on a second call."""
    q, k, v, o, lse, do = _attn_case(cuda, B, H, K, S, D, dtype, causal,
                                     seed)
    o, lse = flash_attention.flash_attention(q, k, v, causal, with_lse=True,
                                             window=window, softcap=cap)
    got_o = ops.flash_attention(q, k, v, causal, window, cap)
    assert torch.equal(o, got_o)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = ref.flash_attention(qf, kf, vf, causal, window, cap)
    want.backward(do.float())
    want = want.detach()
    if dtype == torch.bfloat16:
        lim = ref.flash_bf16_limit(want, q, k, v, causal, ATTN_TOL, window,
                                   cap)
    else:
        lim = ref.flash_limit(want, q, k, v, causal, ATTN_TOL, window, cap)
    assert float(((o.float() - want).abs() - lim).max()) <= 0
    torch.testing.assert_close(lse, ref.flash_attention_lse(
        q.float(), k.float(), causal, window, cap), rtol=1e-5, atol=1e-5)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
    torch.cuda.synchronize()
    wg = (qf.grad, kf.grad, vf.grad)
    lims = ref.flash_bwd_limit(wg, q, k, v, o, lse, do, causal, ATTN_TOL,
                               dtype == torch.bfloat16, window, cap)
    for g, a, w, lm_, t in zip(got, again, wg, lims, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g, a)
        assert float(((g.float() - w).abs() - lm_).max()) <= 0


@pytest.mark.parametrize("D,G", ARCH_ATTN)
@pytest.mark.parametrize("S", [2048, 4096, 4097, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_softcap_at_the_configs_shapes(cuda, D, G, S, dtype):
    """S below, at and above Gemma-2's and Mixtral's 4096 window, ragged
    (4097) and twice it; every (window, softcap) pair the configs use."""
    for i, (window, cap) in enumerate(ARCH_MASKS):
        _masked_case(cuda, 2 * G, 2, S, D, dtype, window, cap, S + D + G + i)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 333])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_tile_edges(cuda, S, D, dtype):
    """Windows that start and end inside the 64-key tiles and 128-row
    blocks, a window of one key (each row sees itself alone), and a cap
    small enough that tanh saturates, at every head dim."""
    for i, (window, cap) in enumerate([(1, 0.0), (16, 5.0), (64, 0.0),
                                       (100, 1.0), (129, 30.0)]):
        _masked_case(cuda, 4, 2, S, D, dtype, window, cap, S * D + i)


@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_past_s_and_no_cap_change_no_bit(cuda, D, dtype):
    """A window of S or more and a softcap of 0 give the bits of the plain
    causal kernel, forward, log-sum-exp and backward."""
    S = 300
    q, k, v, o, lse, do = _attn_case(cuda, 2, 8, 2, S, D, dtype, True, D)
    base = ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    for window in (S, S + 1, 10 * S):
        o2, lse2 = flash_attention.flash_attention(
            q, k, v, True, with_lse=True, window=window, softcap=0.0)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        for a, b in zip(base, ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                      True, window, 0.0)):
            assert torch.equal(a, b)


def test_flash_window_rows_see_only_their_window(cuda):
    """Changing keys and values outside row t's window leaves row t."""
    q, k, v = _attn_inputs(_gen(8), 1, 4, 4, 300, 128, torch.float32, cuda)
    a = ops.flash_attention(q, k, v, True, 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :100] += 5.0                  # keys 0-99: outside rows 149..
    v2[:, :, :100] -= 5.0
    b = ops.flash_attention(q, k2, v2, True, 50)
    assert torch.equal(a[:, :, 149:], b[:, :, 149:])
    assert not torch.equal(a[:, :, 100:149], b[:, :, 100:149])


def test_flash_function_window_softcap_matches_plain_autograd(cuda):
    """Through ops under autograd (the FlashAttention Function) with
    Gemma-2's local-layer masks at a small S."""
    q, k, v = _attn_inputs(_gen(13), 1, 4, 2, 150, 256, torch.float32, cuda,
                           seq_major=True)
    r = torch.randn(1, 4, 150, 256, generator=_gen(14)).to(cuda)
    a = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    y = ops.flash_attention(*a, True, 40, 50.0)
    assert type(y.grad_fn).__name__ == "FlashAttentionBackward"
    (y * r).sum().backward()
    b = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (ref.flash_attention(*b, True, 40, 50.0) * r).sum().backward()
    for ta, tb in zip(a, b):
        scale = float(tb.grad.abs().max())
        assert float((ta.grad - tb.grad).abs().max()) <= 1e-4 * scale


def test_flash_refuses_bad_window_and_softcap(cuda):
    q = torch.randn(1, 4, 16, 64, device=cuda)
    for bad in (-1, 2.0, True):
        with pytest.raises(ValueError, match="window"):
            flash_attention.flash_attention(q, q, q, window=bad)
    for bad in (-1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            flash_attention.flash_attention(q, q, q, softcap=bad)


# ---------------------------------------------------------------------------
# phi-3-vision and whisper-small: non-causal flash at a ragged S, G = 1
# ---------------------------------------------------------------------------

# (D, G, causal, S) of the slice-10 main path, at 2 heads: whisper's
# encoder (non-causal, 1500 frames, ragged for every tile) and decoder
# (448 text positions), phi-3's causal D=96 at G=1; and S around the
# forward's 64/128-row and the backward's tiles
ENCDEC_ATTN = [(64, 1, False, 1500), (64, 1, True, 448),
               (96, 1, True, 2048), (96, 1, True, 1000)]


@pytest.mark.parametrize("D,G,causal,S", ENCDEC_ATTN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_encdec_and_vlm_shapes(cuda, D, G, causal, S, dtype):
    """Forward, log-sum-exp and the three backward launches at the
    slice-10 shapes (B=2, 2 query heads of G=1), against autograd of the
    plain version, the backward the same bits twice."""
    _masked_case(cuda, 2 * G, 2, S, D, dtype, 0, 0.0, S + D, causal, B=2)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 333, 1500])
@pytest.mark.parametrize("D", [64, 96])
def test_flash_non_causal_tile_edges_bf16(cuda, S, D):
    """The non-causal tensor-core forward and backward where the last key
    tile of every row is ragged (masked past S in ``flash_bwd_delta_tc``,
    ``flash_bwd_dkdv_tc`` and ``flash_bwd_dq_tc``), at whisper's and
    phi-3's head dims with one query head per kv head."""
    _masked_case(cuda, 3, 3, S, D, torch.bfloat16, 0, 0.0, S * D + 1,
                 False, B=2)


ENCDEC_GRAD_K = 4.0


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-small"])
def test_encdec_vlm_step_on_the_card_matches_the_cpu(cuda, full_f32, arch):
    """One smoke-config step in f32 with image embeddings (phi-3) or
    encoder frames (whisper), through the kernels forward and backward:
    one flash launch and one backward a layer (whisper: its encoder's
    non-causal ones too), every parameter and the image embeddings or
    frames a finite gradient, held to the same step on the CPU as
    ``test_lm_step_gradients_on_the_card_match_the_cpu`` holds it, but
    with ENCDEC_GRAD_K for twice: whisper's cross-attention norm is the
    worst-conditioned leaf (its f32 gradient 1.4e-3 of the largest entry
    off f64 on the CPU, 3.0e-3 on the card, 2.08 times)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    key, n = (("image_embeds", cfg.num_image_tokens) if cfg.num_image_tokens
              else ("encoder_frames", cfg.num_encoder_frames))
    extra = rng.normal(size=(2, n, cfg.d_model)).astype(np.float32)
    grads = {}
    for dev, dt in ((cuda, "float32"), (torch.device("cpu"), "float32"),
                    (torch.device("cpu"), "float64")):
        c = dataclasses.replace(cfg, dtype=dt)
        params = lm.init_params(cfg, _gen(5), dev)
        flat = flatten(params)
        for p in flat.values():
            p.data = p.data.to(getattr(torch, dt))
            p.requires_grad_(True)
        x = torch.from_numpy(extra).to(dev, getattr(torch, dt))
        x.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
                 "labels": torch.from_numpy(tok[:, 1:]).to(dev), key: x}
        before = dict(ops.launches())
        lm.lm_loss(c, params, batch)[0].backward()
        if dev.type == "cuda":
            now = ops.launches()
            n_attn = cfg.num_layers + cfg.encoder_layers
            assert now["flash_attention"] - before["flash_attention"] \
                == n_attn
            assert now["flash_attention_bwd"] \
                - before["flash_attention_bwd"] == n_attn
        grads[dev.type, dt] = {**{k: p.grad.double().cpu()
                                  for k, p in flat.items()},
                               key: x.grad.double().cpu()}
    card, cpu, f64 = (grads[k] for k in (("cuda", "float32"),
                                         ("cpu", "float32"),
                                         ("cpu", "float64")))
    gmax = max(float(t.abs().max()) for t in cpu.values())
    for k, gc in card.items():
        assert bool(torch.isfinite(gc).all()), k
        if float((gc - cpu[k]).abs().max()) <= 1e-4 * gmax:
            continue
        off_card = float((gc - f64[k]).abs().max())
        off_cpu = float((cpu[k] - f64[k]).abs().max())
        assert off_card <= ENCDEC_GRAD_K * off_cpu + 1e-4 * gmax, (
            k, off_card, off_cpu)
