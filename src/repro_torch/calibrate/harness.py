"""Run the compute-plane calibration corners through the port's kernels.

Port of ``repro.calibrate.harness``: the same five corners (seed 20260808,
the same numpy inputs, the same ``macs`` and ``analytic_bytes`` formulas),
run through ``kernels.ops`` on ``device``, so on the card they launch the
CUDA kernels:

    int8_matmul     w8  a8    128 x 128 x 128 (the INT8 anchor)
    depthwise_conv  bf16/fp32 (1, 8, 16, 128)
    quantize_rows   w32 a8    256 x 512

XLA's ``cost_analysis()`` has no counterpart for a custom CUDA kernel, so
``flops`` and ``bytes_accessed`` are each kernel's own analytic counts
(``"cost_source": "analytic"`` in the meta): what the port's kernel does and
moves, each operand read once and each result written once. ``max_abs_err``
is the kernel against the port's plain version on the same device.
``fit_constants`` is an own copy of the reference's numpy fit. Nothing here
writes the reference's ``calibrated.json``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref

SEED = 20260808


@dataclasses.dataclass
class CalSample:
    """One measured (kernel, precision) corner."""
    kernel: str
    precision: str
    weight_bits: int
    act_bits: int
    macs: int                  # analytic MAC (or element-op) count
    flops: float               # the kernel's analytic operation count
    bytes_accessed: float      # the kernel's analytic device-memory bytes
    analytic_bytes: float      # operand + result footprint (reference formula)
    max_abs_err: float         # kernel output vs the port's plain version

    @property
    def bytes_per_mac(self) -> float:
        return self.bytes_accessed / self.macs

    @property
    def width_pairs(self) -> float:
        """Operand-pair width in int8-pair units ((w+a)/16; 1.0 at int8)."""
        return (self.weight_bits + self.act_bits) / 16.0


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def run_samples(device: DeviceLike = "cuda") -> List[CalSample]:
    """Execute every calibration corner through the port's kernels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    out: List[CalSample] = []

    def t(a):
        return torch.from_numpy(a).to(dev)

    # --- int8 GEMM: the INT8 anchor corner ---------------------------------
    M = K = N = 128
    a = t(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b = t(rng.integers(-127, 128, (K, N), dtype=np.int8))
    sa = t(rng.random(M, dtype=np.float32))
    sb = t(rng.random(N, dtype=np.float32))
    got = ops.int8_matmul(a, b, sa, sb)
    err = _max_abs(got, ref.int8_matmul(a, b, sa, sb))
    nbytes = M * K + K * N + 4.0 * (M + N) + 4.0 * M * N
    # a multiply and an add per MAC, two epilogue multiplies per output
    out.append(CalSample("int8_matmul", "int8", 8, 8, M * N * K,
                         2.0 * M * N * K + 2.0 * M * N, nbytes, nbytes, err))

    # --- depthwise 3x3 at 16- and 32-bit operands --------------------------
    B, H, W, C = 1, 8, 16, 128
    x = t(rng.random((B, H, W, C), dtype=np.float32))
    w33c = rng.random((3, 3, C), dtype=np.float32)     # reference layout
    w = t(np.ascontiguousarray(w33c.transpose(2, 0, 1)[:, None]))
    for prec, dt, bits in (("bf16", torch.bfloat16, 16),
                           ("fp32", torch.float32, 32)):
        xd, wd = x.to(dt), w.to(dt)
        got = ops.depthwise_conv3x3(xd, wd)
        err = _max_abs(got, ref.depthwise_conv3x3(xd, wd))
        elems = B * (H + 2) * (W + 2) * C + 9 * C + B * H * W * C
        moved = 2 * B * H * W * C + 9 * C     # unpadded input: no padded copy
        out.append(CalSample("depthwise_conv", prec, bits, bits,
                             B * H * W * C * 9, 2.0 * 9 * B * H * W * C,
                             moved * bits / 8.0, elems * bits / 8.0, err))

    # --- quantize (f32 in, int8 codes out) ---------------------------------
    M, N = 256, 512
    q = t(rng.random((M, N), dtype=np.float32))
    codes, scales = ops.quantize_rows(q)
    rc, rs = ref.quantize_rows(q)
    err = max(_max_abs(codes, rc), _max_abs(scales, rs))
    nbytes = 4.0 * M * N + M * N + 4.0 * M
    # per element: abs, max, divide, round, clip (two compares)
    out.append(CalSample("quantize", "w32a8", 32, 8, M * N, 6.0 * M * N,
                         nbytes, nbytes, err))
    return out


def fit_constants(samples: Sequence[CalSample]):
    """Fit (constants, residuals) from the measured corners (numpy; an own
    copy of ``repro.calibrate.harness.fit_constants``)."""
    # delivery: bytes/MAC = k * (w+a)/16 + c over ALL corners
    xs = np.array([s.width_pairs for s in samples])
    ys = np.array([s.bytes_per_mac for s in samples])
    k, c = np.polyfit(xs, ys, 1)
    # degenerate fit (non-positive slope/level) keeps the 0.5 default
    dwf = (float(np.clip(k / (k + c), 0.05, 0.95))
           if k + c > 0 and k > 0 else 0.5)
    pred = k * xs + c
    # scale-free residual: worst corner deviation over the mean level
    fit_rel = float(np.max(np.abs(pred - ys)) / max(np.mean(ys), 1e-12))

    # multiplier share from the int8 GEMM's FLOP mix: one w*a multiply (64
    # bit-products at int8) per MAC; the remaining FLOPs are 32-bit adds
    mm = next(s for s in samples if s.kernel == "int8_matmul")
    muls = float(mm.macs)
    adds = max(mm.flops - muls, muls)      # >= one accumulate per MAC
    share = 64.0 * muls / (64.0 * muls + 32.0 * adds)

    dw = next(s for s in samples if s.kernel == "depthwise_conv"
              and s.precision == "fp32")
    residuals = {
        "delivery_fit_rel_err": fit_rel,
        "matmul_flops_rel_dev": abs(mm.flops / (2.0 * mm.macs) - 1.0),
        "dwconv_flops_rel_dev": abs(dw.flops / (2.0 * dw.macs) - 1.0),
        "kernel_max_abs_err": max(s.max_abs_err for s in samples),
    }
    constants = {"mac_mul_share": float(share),
                 "delivery_width_frac": dwf}
    return constants, residuals


def run_calibration(device: DeviceLike = "cuda") -> Dict:
    dev = resolve_device(device)
    samples = run_samples(dev)
    constants, residuals = fit_constants(samples)
    return {
        "meta": {"generator": "repro_torch.calibrate.harness",
                 "device": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                 "torch": torch.__version__,
                 "cost_source": "analytic",
                 "seed": SEED},
        "constants": constants,
        "residuals": residuals,
        "samples": [dataclasses.asdict(s) for s in samples],
    }
