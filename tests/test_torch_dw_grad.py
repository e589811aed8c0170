"""The depthwise kernel's backward, on the CPU: the autograd ``Function``
with its CUDA launches swapped for their plain versions, the plain weight
gradient against ``jax`` differentiating the reference's convolution, the
weight-gradient kernel's tile plan written out in numpy and its fixed
summation order emulated in f32 against its rounding bound, the CUDA
wrappers that must refuse autograd rather than drop the gradient, and the
LM kernels that reach their autograd ``Function`` instead. The
kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xr as jxr
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import depthwise_conv as dw
from repro_torch.kernels import ops, ref
from repro_torch.models import xr

# the 26 stride-1 depthwise shapes of the training batches, (B, H, W, C):
# DetNet b8 at 128x128 and EDSNet b4 at 384x640
DETNET_B8 = [(8, 64, 64, 32), (8, 32, 32, 144), (8, 16, 16, 192),
             (8, 16, 16, 192), (8, 8, 8, 384), (8, 8, 8, 384),
             (8, 8, 8, 384), (8, 8, 8, 384), (8, 8, 8, 576), (8, 8, 8, 576),
             (8, 4, 4, 960), (8, 4, 4, 960), (8, 4, 4, 960)]
EDSNET_B4 = [(4, 192, 320, 32), (4, 96, 160, 144), (4, 48, 80, 192),
             (4, 48, 80, 192), (4, 24, 40, 384), (4, 24, 40, 384),
             (4, 24, 40, 384), (4, 24, 40, 384), (4, 24, 40, 576),
             (4, 24, 40, 576), (4, 12, 20, 960), (4, 12, 20, 960),
             (4, 12, 20, 960)]
TRAIN = sorted(set(DETNET_B8 + EDSNET_B4))
EDGES = [(2, 5, 3, 30), (2, 4, 4, 1), (1, 1, 1, 1), (2, 3, 5, 8),
         (2, 12, 20, 68), (3, 9, 7, 13), (1, 2, 2, 2049)]
SHAPES = [(1, 8, 8, 8), (2, 7, 5, 12), (2, 6, 6, 30), (1, 3, 4, 1)]


@pytest.fixture
def plain_launches(monkeypatch):
    """Route ``ops`` to the CUDA branch for CPU tensors and the kernel
    launches to their plain versions, counting them."""
    count = {"fwd": 0, "wgrad": 0}

    def fwd(x, w):
        count["fwd"] += 1
        return ref.depthwise_conv3x3(x, w)

    def wgrad(x, g):
        dw.check_wgrad_args(x, g)
        count["wgrad"] += 1
        return ref.depthwise_conv3x3_wgrad(x, g)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(dw, "depthwise_conv3x3", fwd)
    monkeypatch.setattr(dw, "depthwise_conv3x3_wgrad", wgrad)
    monkeypatch.setattr(dw.DepthwiseConv3x3, "copies", 0)
    return count


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    x, r = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((shape[-1], 1, 3, 3),
                                             dtype=np.float32))
    return x, w, r


@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_equal_autograd_of_plain(plain_launches, shape):
    """dx from the forward on the output gradient with the weights turned
    180 degrees, dw from the weight gradient: both equal autograd of the
    plain forward (f32 sums in another order: 1e-5)."""
    x, w, r = _inputs(shape)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ops.depthwise_conv3x3(xa, wa)
    assert y.grad_fn is not None
    (y * r).sum().backward()
    assert plain_launches == {"fwd": 2, "wgrad": 1}
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ref.depthwise_conv3x3(xb, wb) * r).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-5, atol=1e-5)


def test_function_computes_only_the_gradients_asked_for(plain_launches):
    x, w, r = _inputs((1, 6, 6, 8))
    (ops.depthwise_conv3x3(x, w.requires_grad_()) * r).sum().backward()
    assert plain_launches == {"fwd": 1, "wgrad": 1}
    (ops.depthwise_conv3x3(x.requires_grad_(), w.detach()) * r).sum() \
        .backward()
    assert plain_launches == {"fwd": 3, "wgrad": 1}
    with torch.no_grad():
        assert ops.depthwise_conv3x3(x, w).grad_fn is None


def test_function_refuses_bf16_under_autograd(plain_launches):
    x = torch.randn(1, 4, 4, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(8, 1, 3, 3, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.depthwise_conv3x3(x, w)
    with torch.no_grad():
        ops.depthwise_conv3x3(x, w)          # inference in bf16 still runs


@pytest.mark.parametrize("shape", SHAPES + [(2, 16, 20, 32)])
def test_plain_gradients_equal_jax_grad_of_the_reference_conv(shape):
    """ref.depthwise_conv3x3_wgrad against jax's transpose of the
    reference's lax.conv (repro.models.xr._conv, groups = C) for w, and the
    forward with turned weights against it for x."""
    x, w, r = _inputs(shape, seed=1)
    C = shape[-1]
    w_hwio = np.transpose(w.numpy(), (2, 3, 1, 0))        # (3, 3, 1, C)
    _, vjp = jax.vjp(lambda a, b: jxr._conv(a, b, 1, C), jnp.asarray(x),
                     jnp.asarray(w_hwio))
    jdx, jdw = vjp(jnp.asarray(r))
    got_dw = ref.depthwise_conv3x3_wgrad(x, r)
    np.testing.assert_allclose(np.transpose(got_dw.numpy(), (2, 3, 1, 0)),
                               np.asarray(jdw), rtol=1e-5, atol=1e-4)
    got_dx = ref.depthwise_conv3x3(r, dw.rotated(w))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)


def test_plain_wgrad_is_exact_in_f64():
    """In f64 the plain weight gradient is the plain sum of products."""
    x, _, r = _inputs((2, 5, 4, 3), seed=2)
    got = ref.depthwise_conv3x3_wgrad(x.double(), r.double())
    xp = np.pad(x.double().numpy(), ((0, 0), (1, 1), (1, 1), (0, 0)))
    g = r.double().numpy()
    for di in range(3):
        for dj in range(3):
            want = (xp[:, di:di + 5, dj:dj + 4, :] * g).sum(axis=(0, 1, 2))
            np.testing.assert_allclose(got[:, 0, di, dj].numpy(), want,
                                       rtol=1e-14)


@pytest.mark.parametrize("name,hw", [("detnet", (128, 128)),
                                     ("edsnet", (64, 96))])
def test_xrnet_hands_the_backward_contiguous_gradients(plain_launches,
                                                       monkeypatch, name, hw):
    """The ops between the kernels stay channels_last, so every one of the
    13 output gradients reaches the depthwise backward contiguous NHWC (no
    copy), and every parameter gets a gradient; the gradients equal those
    of the plain path."""
    cfg = dataclasses.replace(get_config(name), input_hw=hw)
    net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device="cpu")
    img = torch.rand(2, *hw, cfg.in_channels,
                     generator=torch.Generator().manual_seed(1))
    outs, _ = net(img, train=True)
    sum(o.square().mean() for o in outs.values()).backward()
    assert plain_launches == {"fwd": 26, "wgrad": 13}
    assert dw.DepthwiseConv3x3.copies == 0
    got = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: False)  # plain path
    outs, _ = net(img, train=True)
    sum(o.square().mean() for o in outs.values()).backward()
    gmax = max(float(p.grad.abs().max()) for p in net.parameters())
    for k, p in net.named_parameters():
        assert float((got[k] - p.grad).abs().max()) <= 1e-5 * gmax, k


@pytest.mark.parametrize("call", ["quantize_rows", "int8_matmul"])
def test_cuda_branch_refuses_autograd_without_a_backward(monkeypatch, call):
    """On CUDA the kernels without a backward raise under autograd, before
    any launch; under no_grad they reach the kernel wrapper."""
    reached = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    for mod, fn in (("_q", "quantize_rows"), ("_mm", "int8_matmul")):
        monkeypatch.setattr(getattr(ops, mod), fn,
                            lambda *a, fn=fn: reached.append(fn))
    s = torch.ones(4, requires_grad=True)
    a = torch.zeros(4, 4, dtype=torch.int8)
    args = {"quantize_rows": (torch.randn(4, 8, requires_grad=True),),
            "int8_matmul": (a, a, s, s)}[call]
    with pytest.raises(RuntimeError, match="no backward kernel"):
        getattr(ops, call)(*args)
    assert reached == []
    with torch.no_grad():
        getattr(ops, call)(*args)
    assert reached == [call]


@pytest.mark.parametrize("call", ["flash_attention", "ssd_chunk_scan"])
def test_cuda_branch_runs_lm_kernels_through_their_function(monkeypatch,
                                                            call):
    """On CUDA the LM kernels run through their autograd ``Function`` under
    autograd (the result carries its backward) and the forward kernel alone
    under no_grad."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sc
    reached = []

    def fwd(q, k, v, causal=True, with_lse=False, window=0, softcap=0.0):
        reached.append(("flash_attention", with_lse))
        o = ref.flash_attention(q, k, v, causal, window, softcap)
        return ((o, ref.flash_attention_lse(q, k, causal, window, softcap))
                if with_lse else o)

    def scan(states, decay):
        reached.append(("ssd_chunk_scan", None))
        return ref.ssd_chunk_scan(states, decay)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(sc, "ssd_chunk_scan", scan)
    q = torch.randn(1, 4, 8, 32, requires_grad=True)
    args, fn_class = {
        "flash_attention": ((q, q, q), fa.FlashAttention),
        "ssd_chunk_scan": ((torch.randn(1, 2, 3, 4, 5, requires_grad=True),
                            torch.rand(1, 2, 3)), sc.SsdChunkScan)}[call]
    out = getattr(ops, call)(*args)
    assert type(out.grad_fn).__name__ == f"{fn_class.__name__}Backward"
    with torch.no_grad():
        assert getattr(ops, call)(*args).grad_fn is None
    lse = True if call == "flash_attention" else None
    assert reached == [(call, lse), (call, False if lse else None)]


def test_wgrad_checks_its_arguments():
    x = torch.randn(1, 4, 4, 8)
    with pytest.raises(ValueError):
        ops.depthwise_conv3x3_wgrad(x, torch.randn(1, 4, 4, 9))
    with pytest.raises(TypeError):
        ops.depthwise_conv3x3_wgrad(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.depthwise_conv3x3_wgrad(x, x.transpose(1, 2))


# -- the weight-gradient kernel's plan and order, written out ---------------

def _tiles(p):
    """(image, first row, first column) of each tile of a chunk, by tile
    index, as the kernel's stage_tile unravels it."""
    t = np.arange(p.n_tiles)
    return (t // p.n_segs // p.n_strips, t // p.n_segs % p.n_strips * p.th,
            t % p.n_segs * p.tw)


@pytest.mark.parametrize("shape", TRAIN + EDGES)
def test_wgrad_plan_covers_every_product_once(shape):
    """Each (pixel of g, channel group) is summed exactly once: block bx of
    a chunk takes tiles bx, bx + nbx, ..., thread slot s column w0 + s of
    each, all of the tile's rows, and the chunks split the channel
    groups. The layout fits the kernel's limits."""
    B, H, W, C = shape
    p = dw.wgrad_plan(*shape)
    cover = np.zeros((B, p.n_strips * p.th, p.n_segs * p.tw), np.int64)
    b_t, h_t, w_t = _tiles(p)
    longest = 0
    for bx in range(p.nbx):
        mine = np.arange(bx, p.n_tiles, p.nbx)
        longest = max(longest, len(mine))
        for t in mine:
            cover[b_t[t], h_t[t]:h_t[t] + p.th, w_t[t]:w_t[t] + p.tw] += 1
    assert (cover == 1).all()                  # the map and its ragged edge
    assert p.n_strips * p.th >= H and p.n_segs * p.tw >= W
    assert p.n_chunks * p.cg_blk * 4 >= C > (p.n_chunks - 1) * p.cg_blk * 4
    assert p.th <= max(H, 1) and p.th & (p.th - 1) == 0
    assert p.threads <= dw.MAX_THREADS and p.n_chunks <= 65535
    assert p.per_thread == longest and p.stages == min(longest, 2)
    # clusters: one of at most CLUSTER_ONE blocks of one tile each covers
    # its chunk, or several of at most CLUSTER_MANY (portable) share it
    assert p.cluster <= dw.CLUSTER_ONE
    if p.n_clusters > 1 or p.per_thread > 1:
        assert p.cluster <= dw.CLUSTER_MANY
    def lines(floats):                         # 128-byte lines, in floats
        return -(-floats // 32) * 32
    g_off = lines((p.th + 2) * (p.tw + 2) * p.cg_blk * 4)
    smem = p.stages * lines(g_off + p.th * p.tw * p.cg_blk * 4) * 4
    assert smem <= 200 * 1024                  # kWgradMaxSmem
    # the depth the tolerance uses: the thread's chain, then the block's
    # columns, the cluster's ranks and the rows, each summed in order
    assert p.depth == (longest * p.th + p.tw - 1 + p.cluster - 1
                       + p.n_clusters - 1)


@pytest.mark.parametrize("shape", TRAIN)
def test_wgrad_plan_fills_the_card_at_training_shapes(shape):
    """A block for every SM at every training shape (each has the tiles
    for it), at most one wave of two blocks an SM, and a rounding depth far
    below 2^24 (the bound stays meaningful)."""
    p = dw.wgrad_plan(*shape)
    assert dw.SMS <= p.blocks <= dw.WGRAD_BLOCKS
    assert p.depth < 128


def _fma32(a, b, c):
    """fmaf: the f32 product is exact in f64, one rounding to f32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate(x, g, fault=None):
    """The kernel's weight gradient in f32, summed in its fixed order
    (wgrad_plan): each thread's chain of FMAs over its block's tiles and
    their rows, then the block's column slots, the cluster's ranks and the
    chunk's rows, each in order. Channels
    never mix, so all C run side by side. ``fault`` wires one thing wrong:
    "tap" writes tap (di, dj) to (dj, di), "row" drops the chunk's second
    cluster row, "halo" reads x one column to the right."""
    B, H, W, C = x.shape
    p = dw.wgrad_plan(B, H, W, C)
    hp, wp = p.n_strips * p.th, p.n_segs * p.tw
    xp = np.zeros((B, hp + 2, wp + 3, C), np.float32)    # the zero halo
    xp[:, 1:H + 1, 1:W + 1] = x
    gp = np.zeros((B, hp, wp, C), np.float32)
    gp[:, :H, :W] = g
    shift = 1 if fault == "halo" else 0
    b_t, h_t, w_t = _tiles(p)
    acc = np.zeros((p.nbx, p.tw, 9, C), np.float32)
    for k in range(p.per_thread):
        t = np.arange(p.nbx) + k * p.nbx
        live = (t < p.n_tiles)[:, None, None]
        t = np.minimum(t, p.n_tiles - 1)
        b, h0 = b_t[t][:, None], h_t[t][:, None]
        w = w_t[t][:, None] + np.arange(p.tw)                  # (nbx, tw)
        for i in range(p.th + 2):
            row = [xp[b, h0 + i, w + dj + shift] for dj in range(3)]
            for di in range(3):
                if 0 <= i - di < p.th:
                    gv = gp[b, h0 + i - di, w] * live
                    for dj in range(3):
                        acc[:, :, di * 3 + dj] = _fma32(
                            row[dj], gv, acc[:, :, di * 3 + dj])
    block = acc[:, 0]
    for s in range(1, p.tw):
        block = block + acc[:, s]
    part = block.reshape(p.n_clusters, p.cluster, 9, C)
    rows = part[:, 0]
    for r in range(1, p.cluster):
        rows = rows + part[:, r]
    keep = [j for j in range(p.n_clusters) if not (fault == "row" and j == 1)]
    out = rows[keep[0]]
    for j in keep[1:]:
        out = out + rows[j]
    out = out.T.reshape(C, 1, 3, 3)
    return out.transpose(0, 1, 3, 2) if fault == "tap" else out


def _off_bound(shape, fault=None):
    """The emulated kernel's largest distance from the f64 sum, as a share
    of the rounding bound depth x 2^-24 x sum|x g| (per channel and
    tap)."""
    rng = np.random.default_rng(sum(shape))
    x, g = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    xd, gd = torch.from_numpy(x).double(), torch.from_numpy(g).double()
    exact = ref.depthwise_conv3x3_wgrad(xd, gd).numpy()
    mag = ref.depthwise_conv3x3_wgrad(xd.abs(), gd.abs()).numpy()
    bound = dw.wgrad_plan(*shape).depth * 2.0 ** -24 * mag
    off = np.abs(_emulate(x, g, fault) - exact)
    # a tap with no products (outside a 1x1 map) must come out exactly 0
    return float(np.where(bound > 0, off / np.where(bound > 0, bound, 1),
                          np.where(off > 0, np.inf, 0)).max())


@pytest.mark.parametrize("shape", TRAIN + EDGES)
def test_wgrad_order_within_its_rounding_bound(shape):
    """The kernel's summation order, emulated in f32, stays within
    depth x 2^-24 x sum|x g| of the f64 sum: the bound the card's tests and
    chip_smoke.py hold the kernel to."""
    assert _off_bound(shape) <= 1.0


WIRING_SHAPE = (8, 16, 16, 192)          # a chunk of 4 clusters


@pytest.mark.parametrize("fault", ["tap", "row", "halo"])
def test_wgrad_wiring_faults_exceed_the_bound(fault):
    """A transposed tap, a dropped cluster row and a halo shifted by one
    column each land at least 50x over the bound, which so tells a wiring
    fault from rounding."""
    assert dw.wgrad_plan(*WIRING_SHAPE).n_clusters > 1
    assert _off_bound(WIRING_SHAPE) <= 1.0
    assert _off_bound(WIRING_SHAPE, fault) >= 50.0


def test_smoke_nets_have_depthwise_kernel_steps():
    for name in ("detnet", "edsnet"):
        plan = xr.build_plan(get_smoke(name))
        assert sum(map(xr.uses_depthwise_kernel, plan)) >= 1
