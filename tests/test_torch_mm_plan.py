"""The tile plans of the int8_matmul and quantize_rows kernels
(``repro_torch.kernels.int8_matmul.plan``, ``repro_torch.kernels.quantize.
plan``), on the CPU: the plans and the layout arithmetic are Python, so what
they promise the CUDA kernels is checked here, with the kernels' mappings
from threads to data written out in numpy. The kernels themselves are held
to their plain versions on the card in tests/test_torch_cuda.py and
chip_smoke.py."""
import numpy as np
import pytest

from repro_torch.kernels import int8_matmul as mm
from repro_torch.kernels import quantize as qz

# (M, K, N): the calibration corner; every expand and project 1x1 GEMM of
# DetNet at batch 8 (128x128 input) and EDSNet at batch 2 (384x640); and
# Llama-3.2-1B's MLP projection at prefill B x S = 2 x 2048
CORNER = [(128, 128, 128)]
DETNET_B8 = [(128, 160, 960), (128, 576, 160), (128, 960, 160),
             (128, 960, 320), (512, 64, 384), (512, 96, 576), (512, 192, 64),
             (512, 384, 64), (512, 384, 96), (512, 576, 96), (2048, 32, 192),
             (2048, 144, 32), (2048, 192, 32), (8192, 24, 144),
             (8192, 96, 24), (8192, 144, 24), (32768, 16, 96),
             (32768, 32, 16)]
EDSNET_B2 = [(480, 160, 960), (480, 576, 160), (480, 960, 160),
             (480, 960, 320), (1920, 64, 384), (1920, 96, 576),
             (1920, 192, 64), (1920, 384, 64), (1920, 384, 96),
             (1920, 576, 96), (7680, 32, 192), (7680, 144, 32),
             (7680, 192, 32), (30720, 24, 144), (30720, 96, 24),
             (30720, 144, 24), (122880, 16, 96), (122880, 32, 16)]
LM = [(4096, 2048, 8192)]
# ragged edges: M, N or K of 1; odd sizes; K = 24 and N = 24 (8-byte
# copies); an M beyond 65535 blocks of 64 rows; K = MAX_K
EDGES = [(1, 1, 1), (1, 128, 128), (128, 1, 128), (128, 128, 1),
         (37, 45, 29), (100, 24, 40), (100, 40, 24), (65535 * 64 + 1, 8, 8),
         (3, 257, 300), (70, 130, 1000), (5, mm.MAX_K, 7)]
MM_SHAPES = CORNER + DETNET_B8 + EDSNET_B2 + LM + EDGES

# (M, N) of quantize_rows: the corner, the (M, out_ch) of the layers above,
# Llama's (B S, d_model) and edges (N of 1, 5, 33, past the register plan)
Q_SHAPES = sorted({(256, 512)} | {(m, n) for m, _, n in DETNET_B8 + EDSNET_B2}
                  | {(4096, 2048), (1, 1), (7, 5), (5, 33), (3, 100000),
                     (9, 129), (2, 2049), (33, 2048), (65, 24)})


def _plan(shape):
    M, K, N = shape
    return mm.plan(M, N, K)


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_mm_plan_writes_every_output_once(shape):
    """The epilogue's copy-out (csrc/int8_matmul.cu): block (bx, by) owns
    rows [bx bm, +bm) x columns [by bn, +bn) clipped to the output, and its
    threads' flat index i covers that region once (4 floats at a time where
    copy_widths gives 4)."""
    M, K, N = shape
    p = _plan(shape)
    v = mm.copy_widths(p.bn, K, N)[2]
    hits = np.zeros((M, N), np.uint8)
    seen = {}
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            rows = min(p.bm, M - bx * p.bm)
            cols = min(p.bn, N - by * p.bn)
            assert rows > 0 and cols > 0
            hits[bx * p.bm:bx * p.bm + rows, by * p.bn:by * p.bn + cols] += 1
            seen[rows, cols] = True
    assert np.all(hits == 1)
    for rows, cols in seen:                  # the flat copy loop
        cover = np.zeros((rows, cols), np.int32)
        assert cols % v == 0
        n = rows * (cols // v)
        i = np.arange(n)
        r, c = i // (cols // v), (i % (cols // v)) * v
        for e in range(v):
            np.add.at(cover, (r, c + e), 1)
        assert np.all(cover == 1)


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_mm_plan_fits_the_card(shape):
    M, K, N = shape
    p = _plan(shape)
    assert p.threads in (128, 256) and p.bm == p.threads // 2
    assert p.threads == 128 or -(-M // 128) * p.grid[1] >= mm.SMS
    assert 1 <= p.grid[0] <= mm.MAX_GRID_X and 1 <= p.grid[1] <= mm.MAX_GRID_Y
    assert p.smem <= mm.SMEM_MAX
    nkt = -(-K // mm.BK)
    slot = (p.bm + mm.raw_pitch(p.bn)) * mm.BK
    kmajor = min(2, nkt) * p.bn * mm.BK
    assert p.smem >= 1024 + p.stages * slot + kmajor             # the ring
    assert p.smem >= 1024 + p.bm * mm.epilogue_ld(p.bn) * 4     # f32 tile
    # the ring holds all of K, or at least 3 slots (two tiles ahead)
    assert p.stages == nkt or 3 <= p.stages <= mm.MAX_STAGES < nkt
    # every tile the descriptors name starts on the 1024-byte swizzle repeat
    for off in ([s * slot for s in range(p.stages)]
                + [p.stages * slot + b * p.bn * mm.BK for b in range(2)]):
        assert off % 1024 == 0


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_mm_plan_meets_wgmma_n_rule(shape):
    """int8 wgmma (m64nNk32 .s32.s8.s8) takes N = 8, 16, 24 or a multiple
    of 16 from 32 to 256; N <= 256 is rounded up to the nearest."""
    M, K, N = shape
    bn = _plan(shape).bn
    assert bn in mm.WGMMA_N
    assert bn in (8, 16, 24) or (bn % 16 == 0 and 32 <= bn <= 256)
    if N <= 256:
        assert bn >= N and not [w for w in mm.WGMMA_N if N <= w < bn]
    assert mm.epilogue_ld(bn) % 32 == 8 and mm.epilogue_ld(bn) >= bn


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_mm_plan_copies_only_where_aligned(shape):
    M, K, N = shape
    p = _plan(shape)
    a_vec, b_vec, out_vec = mm.copy_widths(p.bn, K, N)
    assert a_vec in (16, 8, 4, 1) and b_vec in (16, 8, 4, 1)
    assert K % a_vec == 0 and N % b_vec == 0
    assert b_vec <= mm.unit_n(p.bn) and p.bn % mm.unit_n(p.bn) == 0
    assert out_vec == (4 if N % 4 == 0 else 1)
    if K % 16 == 0:
        assert a_vec == 16
    if N % 16 == 0 and p.bn % 16 == 0:
        assert b_vec == 16
    if K == 24:
        assert a_vec == 8
    if N == 24:
        assert b_vec == 8
    # a base pointer narrows every width to what it is aligned to
    for ptr in (1, 2, 4, 8):
        got = mm.copy_widths(p.bn, K, N, ptr, ptr, ptr)
        assert got[0] <= a_vec and got[1] <= b_vec and got[2] == 1
        assert ptr % got[0] == 0 and ptr % got[1] == 0


def test_copy_widths_narrow_to_the_base_pointer():
    assert mm.copy_bytes(96) == 16
    assert mm.copy_bytes(96, ptr=8) == 8
    assert mm.copy_bytes(96, ptr=4) == 4
    assert mm.copy_bytes(96, ptr=1) == 1      # a view at an odd offset
    assert mm.copy_bytes(24) == 8 and mm.copy_bytes(45) == 1
    assert mm.copy_bytes(96, widest=8) == 8


def _swz(r, c):
    """csrc/int8_matmul.cu swz: 16-byte chunk c of row r, 128-byte swizzle."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def _raw_off(bn, k, n):
    """csrc/int8_matmul.cu raw_off: n-byte n of row k of the raw B tile."""
    c = n >> 4
    return k * mm.raw_pitch(bn) + (((c ^ (k >> 2)) & 7) << 4) + \
        ((c & ~7) << 4) + (n & 15)


@pytest.mark.parametrize("bn,vec", [(bn, v) for bn in mm.WGMMA_N
                                    for v in (16, 8, 4, 1)
                                    if v <= mm.unit_n(bn)])
def test_b_staging_transposes_every_byte_once(bn, vec):
    """The B path of csrc/int8_matmul.cu on one k-tile, in numpy: b_copy
    puts row k's n-bytes at raw_off(k, n), VEC at a time; b_transpose's
    unit u reads rows 4 kq .. + 3 (kq = u % 32) of UN n-bytes, transposes
    4 x 4 blocks with transpose4's byte permutes and stores word (n, kq) at
    swz(n, kq / 4) + 4 (kq % 4) of the K-major tile. That tile then holds
    B[k, n] at (n, k) for every n < BN and k < 128, no copy or store lands
    twice, and the 32 lanes of a warp (consecutive k-quads) read distinct
    16-byte bank groups (8 lanes a phase, UN = 16) and store to 32 distinct
    banks."""
    rng = np.random.default_rng(bn)
    b = rng.integers(0, 256, (mm.BK, bn)).astype(np.uint8)
    raw = np.full(mm.BK * mm.raw_pitch(bn), -1, np.int64)
    for k in range(mm.BK):
        for n0 in range(0, bn, vec):
            off = _raw_off(bn, k, n0)
            assert _raw_off(bn, k, n0 + vec - 1) == off + vec - 1
            assert np.all(raw[off:off + vec] == -1)
            raw[off:off + vec] = b[k, n0:n0 + vec]
    un = mm.unit_n(bn)
    kmaj = np.full(bn * 128, -1, np.int64)
    units = 32 * (bn // un)
    for u in range(units):
        kq, nb = u % 32, (u // 32) * un
        words = [[int(sum(int(raw[_raw_off(bn, 4 * kq + r, nb + 4 * g) + e])
                          << (8 * e) for e in range(4)))
                  for g in range(un // 4)] for r in range(4)]
        for g in range(un // 4):
            r0, r1, r2, r3 = (words[r][g] for r in range(4))
            t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
            t2, t3 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
            c = [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                 _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
            for e in range(4):
                addr = _swz(nb + 4 * g + e, kq >> 2) + (kq & 3) * 4
                assert np.all(kmaj[addr:addr + 4] == -1)
                kmaj[addr:addr + 4] = [(c[e] >> (8 * i)) & 0xFF
                                       for i in range(4)]
    got = np.array([[kmaj[_swz(n, k >> 4) + (k & 15)] for k in range(128)]
                    for n in range(bn)])
    assert np.array_equal(got, b.T)
    for w0 in range(0, units, 32):             # one warp: kq = 0..31
        nb = (w0 // 32) * un
        reads = [_raw_off(bn, 4 * kq, nb) // 16 % 8 for kq in range(8)]
        assert len(set(reads)) == 8 or un == 8
        writes = {(_swz(nb, kq >> 2) + (kq & 3) * 4) // 4 % 32
                  for kq in range(32)}
        assert len(writes) == 32


@pytest.mark.parametrize("vec", [16, 8, 4, 1])
def test_a_staging_fills_each_tile_byte_once(vec):
    """a_load: copy i of row r = i / (BK / vec) covers k-bytes c .. c + vec
    - 1, c = (i % (BK / vec)) vec, at swz(r, c / 16) + c % 16: a copy never
    straddles a 16-byte chunk and every byte of the tile is written once."""
    bm = 64
    per_row = mm.BK // vec
    written = np.zeros(bm * 128, np.int32)
    for i in range(bm * per_row):
        r, c = i // per_row, (i % per_row) * vec
        assert c // 16 == (c + vec - 1) // 16
        off = _swz(r, c >> 4) + (c & 15)
        written[off:off + vec] += 1
    for r in range(bm):
        got = [written[_swz(r, k >> 4) + (k & 15)] for k in range(128)]
        assert got == [1] * 128


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of
    the 8 bytes of (y, x)."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def test_transpose4_byte_permutes():
    """csrc/int8_matmul.cu transpose4: words r0..r3 (byte e of r_k is
    element (k, n = e)) become c[e], the 4 k-bytes of column e."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        blk = rng.integers(0, 256, (4, 4))            # blk[k, n]
        r = [int(sum(int(blk[k, e]) << (8 * e) for e in range(4)))
             for k in range(4)]
        t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
        t2, t3 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
        c = [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
             _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
        for e in range(4):
            assert c[e] == sum(int(blk[k, e]) << (8 * k) for k in range(4))


@pytest.mark.parametrize("shape", Q_SHAPES)
def test_quantize_plan_covers_each_row_once(shape):
    """quantize_rows_kernel: lane l of warp w of block b works on row
    (b 8 + w) (32 / G) + l / G and holds elements 4 (i G + l % G) .. + 3,
    i < VPL; every row is one group's, and its elements are held once. A
    long row (vpl 0) is block b's alone."""
    M, N = shape
    p = qz.plan(M, N)
    assert p.blocks <= qz.MAX_GRID_X
    if p.vpl == 0:
        assert N > qz.MAX_REG_N and p.blocks == M and p.rows_per_block == 1
        return
    G = p.lanes
    assert G & (G - 1) == 0 and 1 <= G <= 32 and 1 <= p.vpl <= qz.MAX_VPL
    assert p.rows_per_block == qz.THREADS // 32 * (32 // G)
    assert p.blocks * p.rows_per_block >= M > (p.blocks - 1) * p.rows_per_block
    if N <= 128:
        assert G == 1 << (-(-N // 4) - 1).bit_length() and p.vpl == 1
    lanes_of = np.zeros(M, np.int32)
    for b in range(p.blocks):
        t = np.arange(qz.THREADS)
        row = (b * 8 + t // 32) * (32 // G) + (t % 32) // G
        live = row < M
        np.add.at(lanes_of, row[live], 1)
    assert np.all(lanes_of == G)
    held = np.zeros(N, np.int32)
    for gl in range(G):
        for i in range(p.vpl):
            j = 4 * (i * G + gl) + np.arange(4)
            np.add.at(held, j[j < N], 1)
    assert np.all(held == 1)
