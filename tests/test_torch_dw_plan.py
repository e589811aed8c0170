"""The depthwise kernel's tile plan (``repro_torch.kernels.depthwise_conv.
plan``), on the CPU: the plan is Python, so what it promises the CUDA kernel
is checked here, with the kernel's thread-to-output mapping written out in
numpy. The kernel itself is held to its plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

from repro_torch.kernels import depthwise_conv as dw

# the 26 stride-1 depthwise steps of the main path, as (B, H, W, C): DetNet
# at batch 8 (128x128 input) and EDSNet at batch 2 (384x640)
DETNET_B8 = [(8, 64, 64, 32), (8, 32, 32, 144), (8, 16, 16, 192),
             (8, 16, 16, 192), (8, 8, 8, 384), (8, 8, 8, 384),
             (8, 8, 8, 384), (8, 8, 8, 384), (8, 8, 8, 576), (8, 8, 8, 576),
             (8, 4, 4, 960), (8, 4, 4, 960), (8, 4, 4, 960)]
EDSNET_B2 = [(2, 192, 320, 32), (2, 96, 160, 144), (2, 48, 80, 192),
             (2, 48, 80, 192), (2, 24, 40, 384), (2, 24, 40, 384),
             (2, 24, 40, 384), (2, 24, 40, 384), (2, 24, 40, 576),
             (2, 24, 40, 576), (2, 12, 20, 960), (2, 12, 20, 960),
             (2, 12, 20, 960)]
MAIN = sorted(set(DETNET_B8 + EDSNET_B2))
EDGES = [(2, 5, 3, 30), (2, 4, 4, 1), (1, 1, 1, 1), (2, 1, 1, 30),
         (2, 3, 5, 8), (2, 3, 5, 1), (1, 4, 4, 960), (2, 9, 7, 68),
         (3, 17, 2, 2049)]


def _threads(p):
    return p.cg_blk * p.upb


def _idle_share(p, B, H, W, C):
    """Share of launched thread lanes (whole warps) that compute no output
    channel: channel groups past C, columns past the batch, rows past H."""
    lanes = p.blocks * -(-_threads(p) // 32) * 32 * p.th
    return 1.0 - B * H * W * -(-C // 4) / lanes


def _coverage(B, H, W, C):
    """How many times the kernel, launched on ``plan(B, H, W, C)``, writes
    each output element: the mapping of dw3x3_kernel (csrc/depthwise_conv.cu)
    from (block, thread) to channels, column and rows."""
    p = dw.plan(B, H, W, C)
    n_strips = -(-H // p.th)
    tid = np.arange(_threads(p))
    bx = np.arange(-(-p.n_units // p.upb))[:, None, None]
    by = np.arange(p.n_chunks)[None, :, None]
    c = (by * p.cg_blk + tid % p.cg_blk) * 4
    unit = bx * p.upb + tid // p.cg_blk
    c, unit = np.broadcast_arrays(c, unit)
    live = (c < C) & (unit < p.n_units)
    c, unit = c[live], unit[live]
    col, strip, b = unit % W, unit // W % n_strips, unit // W // n_strips
    hits = np.zeros((B, H, W, C), np.int32)
    for i in range(p.th):
        h = strip * p.th + i
        for e in range(4):
            ok = (h < H) & (c + e < C)
            np.add.at(hits, (b[ok], h[ok], col[ok], c[ok] + e), 1)
    return hits


@pytest.mark.parametrize("shape", MAIN + EDGES)
def test_plan_writes_every_output_once(shape):
    assert np.all(_coverage(*shape) == 1)


@pytest.mark.parametrize("shape", MAIN + EDGES)
def test_plan_fits_the_kernel(shape):
    p = dw.plan(*shape)
    assert 1 <= _threads(p) <= dw.MAX_THREADS
    assert p.th in (2, 4, 8) and p.cg_blk <= dw.MAX_CG_BLK
    assert p.n_chunks * p.cg_blk * 4 >= shape[-1]


@pytest.mark.parametrize("shape", MAIN)
def test_plan_idles_at_most_a_quarter_on_the_main_path(shape):
    """Whole blocks of many images' columns on DetNet's 4x4 and 8x8 maps,
    where a fixed 8x16 spatial tile idled 87.5% or 50% of its threads (144
    channels, 36 groups in 5 chunks of 8, idle 10% of the lanes)."""
    assert _idle_share(dw.plan(*shape), *shape) <= 0.25


@pytest.mark.parametrize("shape", MAIN)
def test_plan_large_maps_fill_two_waves(shape):
    """Rows per thread shrink (to 2 at least) until the grid has two waves
    of blocks on the card's SMs."""
    p = dw.plan(*shape)
    assert p.blocks >= 2 * dw.SMS or p.th == 2
