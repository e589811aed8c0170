"""Post-training quantization (paper §2.2, TensorRT-style), any bit width.

Port of ``repro.quant.ptq``. Calibrated symmetric quantization:
  * weights: per-output-channel scales (minmax) -- the port's layouts keep
    the output channel on axis 0 (OIHW convs, (C,1,3,3) depthwise, (out,in)
    dense), where the JAX package's HWIO/(in,out) keep it on axis -1;
  * activations: per-tensor scales from calibration batches (minmax or
    percentile), applied as fake-quant after each conv/dense.

Fake-quant rounds half to even and clips to [-qmax, qmax], as the reference.
Every scale is computed by a true division (a 0-dim tensor divisor), so
codes match the reference bit for bit on the CPU and on the card.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

def qmax(bits: int = 8) -> float:
    """Largest symmetric code at ``bits``: 2^(bits-1) - 1 (127 for INT8)."""
    return float(2 ** (bits - 1) - 1)


def code_bits(codes) -> int:
    """Smallest signed width that holds every code in ``codes`` under the
    symmetric convention (codes in [-(2^(b-1)-1), 2^(b-1)-1])."""
    if torch.is_tensor(codes):
        codes = codes.detach().cpu().numpy()
    m = int(np.max(np.abs(np.asarray(codes))))
    b = 2
    while qmax(b) < m:
        b += 1
    return b


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def minmax_scale(x: torch.Tensor, axis: Optional[int] = None,
                 bits: int = 8) -> torch.Tensor:
    """Symmetric scale = absmax / qmax (per-channel along ``axis`` if given)."""
    a = x.abs()
    if axis is None:
        m = a.amax()
    else:
        red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
        m = a.amax(dim=red) if red else a
    return torch.clamp_min(m, 1e-8) / _scalar(qmax(bits), x)


def _fma_f32(a: float, b: float, c: float) -> np.float32:
    """f32(a * b + c) rounded once, for f32 values a, b, c. a * b is exact
    in f64 (48 bits); the f64 sum is rounded to odd (TwoSum, then one ulp
    towards the error when it is nonzero and the last bit is even), so the
    cast to f32 rounds as a single rounding would (53 >= 24 + 2)."""
    p = a * b
    s = p + c
    pp = s - c
    err = (p - pp) + (c - (s - pp))
    if err != 0.0 and not int(np.float64(s).view(np.int64)) & 1:
        s = float(np.nextafter(s, np.inf if err > 0 else -np.inf))
    return np.float32(s)


def _percentile(a: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(a, pct)`` called eagerly, bit for bit. There pct
    reaches XLA as a runtime operand, and the compiled position is
    pos = f32(pct) * f32(f32(f32(n) - 1) * f32(0.01)) (``/100`` became
    ``*0.01``, folded with n - 1). The two order statistics around pos,
    clamped to [0, f32(n) - 1] as ``jax._src.numpy.reductions._quantile``
    clamps them, are interpolated as fma(v_hi, w_hi, f32(v_lo * w_lo)),
    w_hi = pos - floor(pos), w_lo = 1 - w_hi. The scalar arithmetic runs in
    numpy f32 on the host, so the card and the CPU give the same bits.
    ``kthvalue`` picks the order statistics, so any size works
    (``torch.quantile`` refuses more than 2^24 elements)."""
    flat = a.reshape(-1)
    f32 = np.float32
    last = f32(f32(flat.numel()) - f32(1))
    pos = f32(f32(pct) * f32(last * f32(0.01)))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = f32(pos - lo)
    w_lo = f32(f32(1) - w_hi)
    lo_i = int(min(max(lo, f32(0)), last))
    hi_i = int(min(max(hi, f32(0)), last))
    v_lo = float(torch.kthvalue(flat, lo_i + 1).values.to(torch.float32))
    v_hi = (v_lo if hi_i == lo_i else
            float(torch.kthvalue(flat, hi_i + 1).values.to(torch.float32)))
    out = _fma_f32(v_hi, float(w_hi), float(f32(v_lo * float(w_lo))))
    return torch.tensor(float(out), dtype=torch.float32,
                        device=a.device).to(a.dtype)


def percentile_scale(x: torch.Tensor, pct: float = 99.9,
                     bits: int = 8) -> torch.Tensor:
    return torch.clamp_min(_percentile(x.abs(), pct), 1e-8) \
        / _scalar(qmax(bits), x)


def quantize_tensor(w: torch.Tensor, axis: int = 0, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (integer codes, per-channel scale along ``axis``). Codes are
    clipped to the symmetric ``bits``-wide range and stored in the narrowest
    standard integer dtype that holds them."""
    s = minmax_scale(w, axis=axis, bits=bits)
    shape = [1] * w.dim()
    shape[axis % w.dim()] = -1
    q = torch.clamp(torch.round(w / s.reshape(shape)), -qmax(bits), qmax(bits))
    dtype = (torch.int8 if bits <= 8 else torch.int16 if bits <= 16
             else torch.int32)
    return q.to(dtype), s


def fake_quant(x: torch.Tensor, scale, axis: Optional[int] = None,
               bits: int = 8) -> torch.Tensor:
    if not torch.is_tensor(scale):
        scale = _scalar(float(scale), x)
    if axis is not None:
        shape = [1] * x.dim()
        shape[axis % x.dim()] = -1
        scale = scale.reshape(shape)
    return torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits)) * scale


_WEIGHT_LEAVES = ("w", "wq", "wk", "wv", "wo")


def _is_weight(key: str, t: torch.Tensor) -> bool:
    leaf = key.rsplit(".", 1)[-1]
    return (leaf in _WEIGHT_LEAVES or leaf.startswith(("wi", "we"))) \
        and t.dim() >= 2


def quantize_params(params: Mapping, channel_axis: int = 0,
                    bits: int = 8) -> Dict:
    """Fake-quantize every conv/dense weight per channel along
    ``channel_axis``; other entries pass through. ``params`` is a
    ``<step>.<leaf>`` state dict (the XR nets, output channel on axis 0) or
    a nested tree (the LM, reference layout: pass ``channel_axis=-1``, which
    shares one scale per output column across the R stacked layers, as the
    reference does). The weights are those the reference's ``_is_weight``
    picks: ``w``, ``wq``/``wk``/``wv``/``wo`` and ``wi*``/``we*`` leaves of
    rank >= 2 (not Mamba's ``in_proj``/``out_proj``, not the embedding)."""
    out: Dict = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = quantize_params(v, channel_axis, bits)
        elif _is_weight(k, v):
            out[k] = fake_quant(v, minmax_scale(v, channel_axis, bits=bits),
                                channel_axis, bits=bits)
        else:
            out[k] = v
    return out


def calibrate_acts(forward_fn, batches: Iterable, pct: Optional[float] = 99.9,
                   bits: int = 8) -> Dict[str, float]:
    """Run calibration batches, collect per-layer post-activation scales.

    ``forward_fn(batch) -> Dict[layer_name, activation]`` (``XRNet``
    exposes its taps with ``collect_acts=True``)."""
    maxes: Dict[str, float] = {}
    for batch in batches:
        acts = forward_fn(batch)
        for name, a in acts.items():
            m = (float(a.abs().amax()) if pct is None
                 else float(_percentile(a.abs(), pct)))
            maxes[name] = max(maxes.get(name, 0.0), m)
    return {k: max(v, 1e-8) / qmax(bits) for k, v in maxes.items()}


def forward_int8(net, images: torch.Tensor, act_scales=None, bits: int = 8):
    """XR inference with fake-quantized weights (+ optional act quant);
    ``bits`` reaches both planes: weight fake-quant here, activation
    saturation inside ``XRNet.forward`` (scales from ``calibrate_acts``
    must use the same width). Runs on the net's device, without autograd."""
    from torch.func import functional_call
    with torch.no_grad():
        qparams = quantize_params(dict(net.named_parameters()), bits=bits)
        return functional_call(net, qparams, (images,),
                               dict(train=False, act_scales=act_scales,
                                    act_bits=bits))


def weight_histogram(params: Mapping[str, torch.Tensor], bins: int = 101,
                     rng=(-0.5, 0.5)) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Fig 1(i): weight-value histogram across all layers."""
    leaves = [v.detach().cpu().to(torch.float32).numpy().ravel()
              for v in params.values() if v.dim() >= 2]
    return np.histogram(np.concatenate(leaves), bins=bins, range=rng)
