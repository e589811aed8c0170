#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and nvcc. It
builds the CUDA kernels from the checkout's sources into build/torch_kernels/,
holds every kernel against its plain PyTorch version at the shapes of the
main path, runs the main path (INT8 PTQ inference of full-width DetNet and
EDSNet, and the kernel-calibration corners) with the kernels' launch counts
set to 0 just before it, checks the results against the same nets run on the
CPU, and times each kernel beside its plain version, a PyTorch library call
for the same function and the card's bound. Any failed phase exits non-zero.

Standard output ends with the card's `nvidia-smi` name and power limit, one
JSON line with the kernels' numbers, and the result line
{"ok": true, "device": {...}}. The per-shape details go to
build/chip_smoke.json.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261017

# H100 SXM published dense peaks (NVIDIA data sheet), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12           # CUDA cores, outside the tensor cores

# tolerances against the plain versions (reasons in CHANGES.md/PERF.md)
DW_TOL = {"float32": 1e-5, "bfloat16": 5e-2}    # FMA contraction, bf16 store
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5                  # cuDNN vs oneDNN sum order
# ... plus SENS_K times the net's own sensitivity: random-weight EDSNet
# turns a 1e-7 relative input change into ~7e-5 of its output scale, so
# two correct sum orders cannot agree closer than that
SENS_K = 10
TIE = 1e-3                                       # near-tie of a flipped code
FLIP_FRAC = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             "(src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")

    from repro_torch.calibrate import harness
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import xr
    from repro_torch.quant import ptq

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda")

    # -- 2. full fp32 on the card: TF32 convolutions would flip codes ------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- 3. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {secs:.1f} s for {len(_build.BUILD_LOG)} nvcc processes "
          f"in parallel ({_build.BUILD_DIR})")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": secs}

    # -- main-path shapes --------------------------------------------------
    det_cfg, eds_cfg = get_config("detnet"), get_config("edsnet")
    det_b, eds_b = 8, 2

    def dw_shapes(cfg, batch):
        hw = {}
        xr._walk(cfg, lambda st, src: hw.setdefault(st.name, src))
        return [(batch, *hw[st.name][:2], hw[st.name][2])
                for st in xr.build_plan(cfg) if xr.uses_depthwise_kernel(st)]

    dw_main = dw_shapes(det_cfg, det_b) + dw_shapes(eds_cfg, eds_b)
    project = [s for s in xr.conv_layer_specs(det_cfg)
               if s.name.endswith("_project")]
    mm_shapes = [(128, 128, 128)] + sorted({
        (det_b * s.in_hw[0] * s.in_hw[1], s.in_ch, s.out_ch)
        for s in project})
    q_shapes = [(256, 512)] + sorted({
        (det_b * s.in_hw[0] * s.in_hw[1], s.out_ch) for s in project})
    gen = torch.Generator().manual_seed(SEED)

    # -- 4. every kernel against its plain version at those shapes --------
    err = {"depthwise_conv3x3": 0.0, "int8_matmul": 0.0, "quantize_rows": 0.0}
    for shape in dw_main:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to(dev, dt)
            w = torch.randn(shape[-1], 1, 3, 3, generator=gen).to(dev, dt)
            got = ops.depthwise_conv3x3(x, w)
            want = ref.depthwise_conv3x3(x, w)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            tol = DW_TOL[str(dt).split(".")[1]]
            lim = tol + tol * float(want.float().abs().max())
            check(got.dtype == dt and e <= lim,
                  f"depthwise {shape} {dt}: max err {e} > {lim}")
            if dt == torch.float32:
                err["depthwise_conv3x3"] = max(err["depthwise_conv3x3"], e)
    rng = np.random.default_rng(SEED)
    for m, k, n in mm_shapes:
        a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
        sa = torch.from_numpy(rng.random(m, dtype=np.float32))
        sb = torch.from_numpy(rng.random(n, dtype=np.float32))
        args = [t.to(dev) for t in (a, b, sa, sb)]
        got = ops.int8_matmul(*args)
        torch.cuda.synchronize()
        e = float((got - ref.int8_matmul(*args)).abs().max())
        check(e == 0.0, f"int8_matmul {m}x{k}x{n}: max err {e}, not exact")
        err["int8_matmul"] = max(err["int8_matmul"], e)
    full = ops.int8_matmul(*[torch.full((128, 128), v, dtype=torch.int8,
                                        device=dev) for v in (127, -127)],
                           torch.ones(128, device=dev),
                           torch.ones(128, device=dev))
    check(bool(torch.all(full == 127 * -127 * 128)),
          "int8_matmul: int32 accumulation is not exact")
    for m, n in q_shapes:
        x = (torch.randn(m, n, generator=gen) * 3).to(dev)
        q, s = ops.quantize_rows(x)
        rq, rs = ref.quantize_rows(x)
        torch.cuda.synchronize()
        check(torch.equal(q, rq) and torch.equal(s, rs),
              f"quantize_rows {m}x{n}: codes or scales differ")
    print(f"kernels vs plain: {len(dw_main)} depthwise shapes x f32/bf16, "
          f"{len(mm_shapes)} int8_matmul shapes, {len(q_shapes)} "
          f"quantize_rows shapes: all within tolerance (max abs err {err})")

    # -- set-up of the main path: nets, data, BN statistics ----------------
    def images(batch):
        return torch.from_numpy(batch["image"]).to(dev)

    det_batches = synthetic.fphab_batches(det_b, det_cfg.input_hw,
                                          det_cfg.in_channels, seed=0)
    det_cal = [images(next(det_batches)[0]) for _ in range(4)]
    det_img = images(next(det_batches)[0])
    eds_img = images(next(synthetic.openeds_batches(eds_b, eds_cfg.input_hw,
                                                    seed=0))[0])
    det = xr.XRNet(det_cfg, torch.Generator().manual_seed(SEED), device=dev)
    eds = xr.XRNet(eds_cfg, torch.Generator().manual_seed(SEED + 1),
                   device=dev)
    det.set_bn_stats(det_cal[0])      # see XRNet.set_bn_stats
    eds.set_bn_stats(eds_img)

    def taps(net):
        def fwd(x):
            with torch.no_grad():
                return net(x, collect_acts=True)[0]["acts"]
        return fwd

    # -- 5-7. the main path, counted ---------------------------------------
    n_dw = {name: sum(map(xr.uses_depthwise_kernel, xr.build_plan(c)))
            for name, c in (("detnet", det_cfg), ("edsnet", eds_cfg))}
    check(n_dw == {"detnet": 13, "edsnet": 13}, f"depthwise steps {n_dw}")
    dwk = ops.KERNELS["depthwise_conv3x3"]
    torch.cuda.synchronize()
    ops.reset_launches()
    t_main = time.perf_counter()
    det_scales = ptq.calibrate_acts(taps(det), det_cal)
    check(dwk.launches == 4 * 13, f"DetNet calibration: {dwk.launches} "
          "depthwise launches, not 13 per forward")
    det_out, _ = ptq.forward_int8(det, det_img, act_scales=det_scales)
    check(dwk.launches == 5 * 13, "DetNet forward_int8: not 13 launches")
    eds_scales = ptq.calibrate_acts(taps(eds), [eds_img])
    eds_out, _ = ptq.forward_int8(eds, eds_img, act_scales=eds_scales)
    check(dwk.launches == 7 * 13, "EDSNet: not 13 launches per forward")
    samples = harness.run_samples(device=dev)
    constants, residuals = harness.fit_constants(samples)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = ops.launches()
    print(f"main path: {t_main:.2f} s, launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(launches["depthwise_conv3x3"] == 7 * 13 + 2,
          "depthwise launches: 13 per forward x 7 forwards + 2 corners")

    # -- checks of what came out -------------------------------------------
    check(set(det_out) == {"center", "radius", "label"}, "DetNet outputs")
    for k, v in det_out.items():
        check(bool(torch.isfinite(v).all()), f"DetNet {k} not finite")
    check(tuple(eds_out["mask"].shape) == (eds_b, *eds_cfg.input_hw, 4),
          f"EDSNet mask shape {tuple(eds_out['mask'].shape)}")
    check(bool(torch.isfinite(eds_out["mask"]).all()), "EDSNet not finite")
    check(set(det_scales) == {s.name for s in xr.conv_layer_specs(det_cfg)},
          "DetNet calibration did not reach every MAC layer")

    def cpu_twin(net):
        twin = xr.XRNet(net.cfg, device="cpu")
        twin.load_state_dict(net.state_dict())
        return twin

    def close(net, x, twin, what):
        """INT8 weights-only outputs of ``net`` on the card and of its CPU
        ``twin``: within FWD_RTOL, FWD_ATOL * scale and SENS_K times the
        output change the card's net shows under a 1e-7 input change."""
        got, _ = ptq.forward_int8(net, x)
        nudged, _ = ptq.forward_int8(net, x * (1 + 1e-7))
        want, _ = ptq.forward_int8(twin, x.cpu())
        for k in want:
            g, w = got[k].cpu(), want[k]
            sens = float((nudged[k].cpu() - g).abs().max())
            scale = max(1.0, float(w.abs().max()))
            diff = float((g - w).abs().max())
            bad = (g - w).abs() > (FWD_ATOL * scale + SENS_K * sens
                                   + FWD_RTOL * w.abs())
            check(not bool(bad.any()), f"{what} {k}: card vs CPU differ by "
                  f"{diff} (scale {scale}, sensitivity {sens})")
            print(f"  {what} {k}: card vs CPU max diff {diff}, scale {scale}"
                  f", sensitivity to a 1e-7 input change {sens}")

    def int8_acts(net, x, scales):
        from torch.func import functional_call
        q = ptq.quantize_params(dict(net.named_parameters()))
        with torch.no_grad():
            return functional_call(net, q, (x,), dict(
                act_scales=scales, collect_acts=True))[0]

    def first_flip(acts_a, acts_b, scales):
        """Codes equal up to the first layer that differs; there every
        flipped code is a near-tie (see tests/test_torch_ptq.py)."""
        for name in acts_a:
            if name not in scales:
                continue
            ra = acts_a[name].cpu() / scales[name]
            rb = acts_b[name].cpu() / scales[name]
            flips = (torch.round(ra).clamp(-127, 127)
                     != torch.round(rb).clamp(-127, 127))
            if bool(flips.any()):
                r = ra[flips]
                frac = ((r - torch.floor(r)).abs() - 0.5).abs()
                check(bool((frac < TIE).all()) and
                      float(flips.float().mean()) <= FLIP_FRAC,
                      f"{name}: {int(flips.sum())} codes differ, not ties")
                return name
        return None

    det_cpu, eds_cpu = cpu_twin(det), cpu_twin(eds)
    close(det, det_img, det_cpu, f"DetNet b{det_b} int8 weights-only")
    close(eds, eds_img, eds_cpu, f"EDSNet b{eds_b} int8 weights-only")
    flip = first_flip(int8_acts(det, det_img, det_scales),
                      int8_acts(det_cpu, det_img.cpu(), det_scales),
                      det_scales)
    print(f"card vs CPU: DetNet act-quant codes equal up to the first "
          f"near-tie layer: {flip}")

    by = {(s.kernel, s.precision): s for s in samples}
    check(by["int8_matmul", "int8"].max_abs_err == 0.0, "harness int8 err")
    check(by["quantize", "w32a8"].max_abs_err == 0.0, "harness quantize err")
    check(by["depthwise_conv", "fp32"].max_abs_err <= 1e-5, "harness dw fp32")
    check(by["depthwise_conv", "bf16"].max_abs_err <= 5e-2, "harness dw bf16")
    for s in samples:
        print(f"  calibration {s.kernel:15s} {s.precision:6s} macs {s.macs} "
              f"flops {s.flops:.0f} bytes {s.bytes_accessed:.0f} "
              f"max_abs_err {s.max_abs_err}")
    print(f"  constants {constants}")
    print(f"  residuals {residuals}")
    report["calibration"] = {"constants": constants, "residuals": residuals}

    # -- 8. times: kernel, plain version, library call, bound --------------
    def median_ms(fn, *args, reps=5, inner=10):
        """Median over ``reps`` of the CUDA-event time of ``inner`` calls."""
        for _ in range(3):
            fn(*args)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn(*args)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return statistics.median(times)

    def row(shape, fns, args, nbytes, op_secs):
        """Times of kernel, plain version and library call (None if there
        is none) on the same inputs, beside the bound: the larger of the
        bytes over the memory rate and the operations over their rate."""
        kernel, plain, library = fns
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = op_secs * 1e3
        return dict(shape=shape, ms=median_ms(kernel, *args),
                    plain_ms=median_ms(plain, *args),
                    library_ms=(None if library is None
                                else median_ms(library, *args)),
                    bytes_ms=bytes_ms, ops_ms=ops_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def conv_dw(x, w):                       # cuDNN/ATen depthwise conv
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1,
                        groups=x.shape[-1])

    def int_mm_scaled(a, b, sa, sb):         # cuBLASLt int8 GEMM + dequant
        return torch._int_mm(a, b).float() * sa[:, None] * sb[None, :]

    rows = {"depthwise_conv3x3": [], "int8_matmul": [], "quantize_rows": []}
    for shape in dw_main:                      # f32, as the forward runs
        B, H, W, C = shape
        x = torch.randn(shape, generator=gen).to(dev)
        w = torch.randn(C, 1, 3, 3, generator=gen).to(dev)
        rows["depthwise_conv3x3"].append(row(
            shape, (ops.depthwise_conv3x3, ref.depthwise_conv3x3, conv_dw),
            (x, w), 4 * (2 * B * H * W * C + 9 * C),
            18 * B * H * W * C / FP32_OPS_PER_S))
    for m, k, n in mm_shapes:
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        b = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        sa, sb = torch.rand(m, device=dev), torch.rand(n, device=dev)
        rows["int8_matmul"].append(row(
            (m, k, n), (ops.int8_matmul, ref.int8_matmul, int_mm_scaled),
            (a, b, sa, sb), m * k + k * n + 4 * (m + n) + 4 * m * n,
            2 * m * n * k / INT8_OPS_PER_S + 2 * m * n / FP32_OPS_PER_S))
    for m, n in q_shapes:
        x = torch.randn(m, n, generator=gen).to(dev)
        rows["quantize_rows"].append(row(
            (m, n), (ops.quantize_rows, ref.quantize_rows, None), (x,),
            5 * m * n + 4 * m, 6 * m * n / FP32_OPS_PER_S))
    # Device time from the profiler: a loop of small calls can be bound by
    # the host (Python wrapper, dispatch), and then the event times above
    # measure the host. Kernel names carry the CUDA function names.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(calls, reps=5):
        """Device-busy microseconds per pass over ``calls`` (sum over every
        kernel, copy and fill that ran), and by kernel name."""
        for fn, args in calls:
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn, args in calls:
                    fn(*args)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / reps)
        return sum(by_name.values()), by_name

    dev_inputs = {
        "depthwise_conv3x3": [
            (torch.randn(sh, generator=gen).to(dev),
             torch.randn(sh[-1], 1, 3, 3, generator=gen).to(dev))
            for sh in dw_main],
        "int8_matmul": [tuple(t.to(dev) for t in (
            torch.randint(-128, 128, (128, 128), generator=gen,
                          dtype=torch.int8),
            torch.randint(-128, 128, (128, 128), generator=gen,
                          dtype=torch.int8),
            torch.rand(128, generator=gen), torch.rand(128, generator=gen)))],
        "quantize_rows": [(torch.randn(256, 512, generator=gen).to(dev),)],
    }
    variants = {"depthwise_conv3x3": (ops.depthwise_conv3x3,
                                      ref.depthwise_conv3x3, conv_dw),
                "int8_matmul": (ops.int8_matmul, ref.int8_matmul,
                                int_mm_scaled),
                "quantize_rows": (ops.quantize_rows, ref.quantize_rows, None)}
    device = {}
    for name, fns in variants.items():
        device[name] = {}
        for label, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            if fn is None:
                device[name][label] = None
                continue
            busy, by_name = device_us([(fn, a) for a in dev_inputs[name]])
            device[name][label] = busy / 1e3 if by_name else None
        print(f"  device time per main-path pass {name}: {device[name]}")
    report["device_ms"] = device

    def forward_profile(net, x, scales):
        """Wall time of one INT8 forward (median of 5, no profiler), the
        device-busy time in it, the idle share and the top kernels."""
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ptq.forward_int8(net, x, act_scales=scales)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        wall = statistics.median(walls[1:])
        busy, by_name = device_us(
            [(lambda: ptq.forward_int8(net, x, act_scales=scales), ())],
            reps=3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
                "idle_share": 1 - busy / 1e3 / wall,
                "top_kernels_us": top}

    for label, net, x, sc in (("DetNet b8", det, det_img, det_scales),
                              ("EDSNet b2", eds, eds_img, eds_scales)):
        fp = forward_profile(net, x, sc)
        report[f"forward {label}"] = fp
        print(f"  forward_int8 {label}: wall {fp['wall_ms']:.3f} ms, device "
              f"busy {fp['device_busy_ms']:.3f} ms, idle share "
              f"{fp['idle_share']:.3f}")
        for kname, us in fp["top_kernels_us"]:
            print(f"    {us:9.1f} us  {kname[:90]}")

    for name, rs in rows.items():
        for r in rs:
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            print(f"  time {name:17s} {str(r['shape']):22s} kernel "
                  f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f}  library "
                  f"{lib}  bound {r['bound_ms']:.5f} ({r['bound_by']})")
    report["times"] = rows

    # -- 9. the kernels line -----------------------------------------------
    # depthwise: summed over the 26 stride-1 steps of one DetNet b8 and one
    # EDSNet b2 forward; int8_matmul and quantize_rows: the calibration
    # corners, the only main-path calls of those kernels.
    def summed(rs):
        out = {k: sum(r[k] for r in rs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
        out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["ops_ms"]
                           else "operations")
        return out

    main_rows = {"depthwise_conv3x3": summed(rows["depthwise_conv3x3"]),
                 "int8_matmul": rows["int8_matmul"][0],
                 "quantize_rows": rows["quantize_rows"][0]}
    meta = {
        "depthwise_conv3x3": ("depthwise_conv.cu",
                              "src/repro/kernels/depthwise_conv.py:39"),
        "int8_matmul": ("int8_matmul.cu",
                        "src/repro/kernels/int8_matmul.py:39"),
        "quantize_rows": ("quantize.cu", "src/repro/kernels/quantize.py:28"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = main_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "device_ms": device[name]["ms"],
            "plain_device_ms": device[name]["plain_ms"],
            "library_device_ms": device[name]["library_ms"]})
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - t0
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "chip_smoke.json").write_text(json.dumps(report,
                                                              indent=1))
    print(f"total {report['wall_s']:.1f} s (build included)")

    # -- 10. the result ----------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
