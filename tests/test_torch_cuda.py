"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the card and skips
without one (a skip is not a pass). This file imports no JAX, so it runs on
a machine with the card and PyTorch alone:

    python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import depthwise_conv, int8_matmul, ops, quantize, ref

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


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (37, 45, 29),
                                   (32768, 96, 24), (8192, 144, 24),
                                   (2048, 384, 64), (128, 960, 320)])
def test_int8_matmul_kernel_bit_equal(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    sa = torch.from_numpy(rng.random(m, dtype=np.float32))
    sb = torch.from_numpy(rng.random(n, dtype=np.float32))
    args = [t.to(cuda) for t in (a, b, sa, sb)]
    got = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul(*args))
    assert torch.equal(got.cpu(), ref.int8_matmul(a, b, sa, sb))


def test_int8_matmul_kernel_exact_accumulation(cuda):
    a = torch.full((128, 128), 127, dtype=torch.int8, device=cuda)
    b = torch.full((128, 128), -127, dtype=torch.int8, device=cuda)
    one = torch.ones(128, device=cuda)
    out = ops.int8_matmul(a, b, one, one)
    assert torch.all(out == 127 * -127 * 128)


@pytest.mark.parametrize("m,n", [(256, 512), (32768, 24), (5, 33),
                                 (8192, 144), (3, 100000)])
def test_quantize_kernel_bit_equal(cuda, m, n):
    x = (torch.randn(m, n, generator=_gen(m + n)) * 3).to(cuda)
    q, s = ops.quantize_rows(x)
    rq, rs = ref.quantize_rows(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    cq, cs = ref.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)


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
