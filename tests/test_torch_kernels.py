"""The port's plain kernel versions (the CPU path of repro_torch.kernels.ops)
against the JAX package's oracles and its Pallas kernels in interpret mode,
on the same numpy inputs. The CUDA kernels themselves are held against these
plain versions on the card in tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops


def _dw_weight(w33c: np.ndarray) -> torch.Tensor:
    """Reference depthwise weight (3,3,C) -> the port's (C,1,3,3)."""
    return torch.from_numpy(np.ascontiguousarray(
        w33c.transpose(2, 0, 1)[:, None]))


def _int8_inputs(rng, m, k, n):
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sa = rng.uniform(1e-3, 1e-2, (m,)).astype(np.float32)
    sb = rng.uniform(1e-3, 1e-2, (n,)).astype(np.float32)
    return a, b, sa, sb


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 512, 256), (384, 256, 384),
                                   (4096, 144, 24), (37, 45, 29)])
def test_int8_matmul_matches_reference(rng, m, k, n):
    """Bit-equal to the reference oracle: exact int32 sums, then the same
    two f32 multiplies in the same order. (4096,144,24) is a DetNet 1x1
    project at batch 4; (37,45,29) is ragged in every dimension."""
    a, b, sa, sb = _int8_inputs(rng, m, k, n)
    got = ops.int8_matmul(*map(torch.from_numpy, (a, b, sa, sb)))
    want = np.asarray(jref.int8_matmul(*map(jnp.asarray, (a, b, sa, sb))))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128)])
def test_int8_matmul_matches_pallas_interpret(rng, m, k, n):
    a, b, sa, sb = _int8_inputs(rng, m, k, n)
    got = ops.int8_matmul(*map(torch.from_numpy, (a, b, sa, sb)))
    want = np.asarray(jops.int8_matmul(*map(jnp.asarray, (a, b, sa, sb))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_int8_matmul_exact_integer_accumulation():
    # products overflow int16 but not int32: 127 * -127 * 128
    a = torch.full((128, 128), 127, dtype=torch.int8)
    b = torch.full((128, 128), -127, dtype=torch.int8)
    out = ops.int8_matmul(a, b, torch.ones(128), torch.ones(128))
    assert float(out[0, 0]) == 127 * -127 * 128
    assert torch.all(out == 127 * -127 * 128)


def test_int8_matmul_rejects_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 3), dtype=torch.int8)
    s4, s3 = torch.ones(4), torch.ones(3)
    with pytest.raises(TypeError):
        ops.int8_matmul(a.float(), b, s4, s3)
    with pytest.raises(ValueError):
        ops.int8_matmul(a, b.t().contiguous(), s4, s3)
    with pytest.raises(ValueError):
        ops.int8_matmul(a, b, s3, s3)
    with pytest.raises(ValueError):
        ops.int8_matmul(a, b[:, ::2], s4, torch.ones(2))


# ---------------------------------------------------------------------------
# depthwise_conv3x3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 8, 8), (2, 16, 20, 32),
                                   (1, 32, 32, 128), (3, 24, 10, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_matches_pallas_interpret(rng, shape, dtype):
    """Shapes inside the Pallas kernel's tiling contract: the port's plain
    version against the kernel run in interpret mode. Tolerances are the
    reference's own (tests/test_kernels.py): 1e-5 in f32, 5e-2 in bf16."""
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(3, 3, shape[-1])).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.depthwise_conv3x3(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    got = ops.depthwise_conv3x3(torch.from_numpy(x).to(tdt),
                                _dw_weight(w).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(1, 32, 32, 144), (2, 4, 4, 960),
                                   (1, 12, 20, 960), (2, 8, 8, 576),
                                   (1, 7, 5, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_matches_reference_off_contract(rng, shape, dtype):
    """Channel counts the Pallas kernel's TPU tiling refuses (C % 128 != 0;
    144, 192, 576 and 960 are DetNet/EDSNet depthwise widths) and ragged
    H, W: the port takes them all, so hold it against the oracle."""
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(3, 3, shape[-1])).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jref.depthwise_conv3x3(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    got = ops.depthwise_conv3x3(torch.from_numpy(x).to(tdt),
                                _dw_weight(w).to(tdt))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_depthwise_rejects_bad_layouts(rng):
    x = torch.randn(1, 8, 8, 16)
    w = torch.randn(16, 1, 3, 3)
    with pytest.raises(ValueError):            # NCHW-contiguous, not NHWC
        ops.depthwise_conv3x3(x.permute(0, 3, 1, 2).contiguous()
                              .permute(0, 2, 3, 1), w)
    with pytest.raises(ValueError):            # reference (3,3,C) layout
        ops.depthwise_conv3x3(x, torch.randn(3, 3, 16))
    with pytest.raises(TypeError):
        ops.depthwise_conv3x3(x.half(), w.half())
    with pytest.raises(TypeError):
        ops.depthwise_conv3x3(x, w.bfloat16())


# ---------------------------------------------------------------------------
# quantize_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(64, 64), (256, 768), (512, 128), (5, 33)])
def test_quantize_matches_reference(rng, m, n):
    x = (rng.normal(size=(m, n)) * rng.uniform(0.1, 10)).astype(np.float32)
    q1, s1 = ops.quantize_rows(torch.from_numpy(x))
    q2, s2 = jref.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))


def test_quantize_matches_pallas_interpret(rng):
    x = (rng.normal(size=(256, 512)) * 3).astype(np.float32)
    q1, s1 = ops.quantize_rows(torch.from_numpy(x))
    q2, s2 = jops.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    # the jitted interpret-mode kernel turns "/ 127" into a multiply by the
    # reciprocal, one ulp off the oracle; the reference's own test allows it
    np.testing.assert_allclose(s1.numpy(), np.asarray(s2), rtol=1e-6)


def test_quantize_exact_half_ties():
    """Rows whose absmax is 127 have scale exactly 1.0, so x / s lands on
    exact .5 ties: both must round half to even (0.5 -> 0, 2.5 -> 2)."""
    row = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]
    x = np.array([row, [v / 2 for v in row]], np.float32)  # 2nd: s = 0.5
    q1, s1 = ops.quantize_rows(torch.from_numpy(x))
    q2, s2 = jref.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q1.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    assert q1[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]


def test_quantize_rejects_bad_inputs():
    with pytest.raises(TypeError):
        ops.quantize_rows(torch.zeros((4, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.quantize_rows(torch.zeros((4, 4)).t()[:, :2])
    with pytest.raises(ValueError):
        ops.quantize_rows(torch.zeros(4))


def test_cpu_path_launches_no_kernel(rng):
    """A CPU tensor runs the plain version: no kernel launch is counted."""
    before = ops.launches()
    ops.quantize_rows(torch.randn(4, 4))
    ops.depthwise_conv3x3(torch.randn(1, 4, 4, 8), torch.randn(8, 1, 3, 3))
    ops.int8_matmul(torch.zeros((2, 2), dtype=torch.int8),
                    torch.zeros((2, 2), dtype=torch.int8),
                    torch.ones(2), torch.ones(2))
    q = torch.randn(1, 2, 5, 32)
    o = ops.flash_attention(q, q, q)
    ops.flash_attention_bwd(q, q, q, o, torch.zeros(1, 2, 5), q)
    st, dc = torch.randn(1, 2, 3, 4, 5), torch.rand(1, 2, 3)
    ops.ssd_chunk_scan_bwd(st, ops.ssd_chunk_scan(st, dc), dc)
    ops.depthwise_conv3x3_wgrad(torch.randn(1, 4, 4, 8),
                                torch.randn(1, 4, 4, 8))
    assert ops.launches() == before
    assert set(before) == {"depthwise_conv3x3", "depthwise_conv3x3_wgrad",
                           "int8_matmul", "quantize_rows", "flash_attention",
                           "flash_attention_bwd", "ssd_chunk_scan",
                           "ssd_chunk_scan_bwd"}
