#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and nvcc. It
builds the CUDA kernels from the checkout's sources into build/torch_kernels/
(one nvcc per source, all at once) and drives the port's paths, each
with the kernels' launch counts set to 0 just before it and read just after:

  * the XR path (slice 1): INT8 PTQ inference of full-width DetNet and
    EDSNet and the kernel-calibration corners, checked against the same nets
    run on the CPU;
  * the LM path (slice 2, ``lm_slice``): the prefill forward of full-width,
    full-depth Llama-3.2-1B and Mamba-2-1.3B (random weights from a seed,
    B=2, S=2048) and the continuous-batching server on 8 requests each;
    then served tokens checked against the teacher-forced forward (one
    repeat at full width in f32 and bf16, and full depth in f32), and a
    one-repeat twin of each model checked against the CPU;
  * the XR training path (slice 5, ``train_slice``): full-width DetNet
    (b8, 128x128) and EDSNet (b4, 384x640) trained 20 steps each through
    ``train.loop.run_xr_training`` with checkpoints, every stride-1
    depthwise step on the kernel forward and backward (the input gradient
    through the forward kernel, the weight gradient through its own
    kernel), then resumed from step 10; its backward pieces are held to
    their plain versions at the 26 training shapes, one step to the same
    step on the CPU, and the steps and the weight-gradient kernel timed;
  * the dense and MoE decoders (slice 9, ``arch_slice``, S1-S5): the flash
    kernels with sliding windows and logit softcaps against autograd of
    their plain version at every configured (head dim, group) and S up to
    8192, and at each attention layer kind of the main path at its
    config's head counts; prefill (B=1, S=8192) and the server of
    full-width deepseek-7b, yi-34b, gemma2-9b, mixtral-8x7b (8 layers) and
    grok-1-314b (1 layer), the server's MoE dispatches held to the
    reference's algorithm and its tokens to the teacher-forced forward; a
    CPU twin, the ring cache decoded past its 4096-position window, and 5
    training steps at S=8192 of gemma2-9b and mixtral-8x7b;
  * phi-3-vision-4.2b and whisper-small (slice 10, ``encdec_slice``,
    V1-V4) at full width and depth: the flash kernels at whisper's
    non-causal encoder shape (1500 frames), its decoder's and phi-3's
    (D=96, one query head a kv head) against autograd of their plain
    version; phi-3's prefill with 256 image embeddings (B=2, S=2048) and
    its server, held to the teacher-forced forward; whisper's
    encoder-decoder prefill (B=4, 448 tokens over 1500 frames), its
    batch-1 decode with the cross-attention cache filled from the encoder
    held to the forward, and its server (a zero cross cache, as the
    reference's) held to batch-1 decode; one-repeat CPU twins of both;
    training of both through ``make_lm_step``.

Before each path every kernel of it is held against its plain PyTorch
version at the path's shapes; after it each kernel is timed beside its plain
version, a PyTorch library call for the same function and the card's bound:
CUDA events over 50 back-to-back calls, and device time from torch.profiler
windows whose capture is held to the launches they made (``device_us``).
int8_matmul and quantize_rows are also timed per shape in three groups
(``gemm_groups``: the calibration corners, the XR nets' 1x1 GEMMs, an LM
MLP projection), one window per group, each call after the L2 is flushed
twice over: once with dirty lines and once with clean ones
(``l2_flushes``). A reading under its bound fails the run. Any failed phase
exits non-zero.

Standard output ends with the card's `nvidia-smi` name and power limit, one
JSON line with the kernels' numbers, and the result line
{"ok": true, "device": {...}}. The per-shape details go to
build/chip_smoke.json.
"""
import contextlib
import ctypes
import gc
import json
import re
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

# CUDA-event timing: back-to-back calls per reading, so that at the main
# path's larger shapes a call's device time exceeds the host's cost to
# launch it
EVENT_CALLS = 50

# tolerances against the plain versions (reasons in CHANGES.md/PERF.md)
DW_TOL = {"float32": 1e-5, "bfloat16": 5e-2}    # FMA contraction, bf16 store
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5                  # cuDNN vs oneDNN sum order
# ... plus SENS_K times the net's own sensitivity: random-weight EDSNet
# turns a 1e-7 relative input change into ~7e-5 of its output scale, so
# two correct sum orders cannot agree closer than that
SENS_K = 10
TIE = 1e-3                                       # near-tie of a flipped code
FLIP_FRAC = 1e-3

XR_KERNELS = ("depthwise_conv3x3", "int8_matmul", "quantize_rows")

# -- slice 2: the LM prefill forward and the server ------------------------
BF16_OPS_PER_S = 989e12          # tensor cores, dense
LM_B, LM_S = 2, 2048             # prefill batch and sequence
LM_RAGGED_S = 1000               # not a multiple of the kernel's 64-row tile
# flash kernel vs its plain version in f32 on the same (upcast) inputs,
# element by element: FLASH_TOL for the online softmax's other sum order
# (times 1 + |value|); in bf16 also 2^-8 (|value| + A(q, k, |v|)) for the
# three roundings to bf16 (the probabilities before the PV product, as the
# model's reference rounds them, their denominator, the output), A the plain
# f32 attention applied to |v| (ref.flash_bf16_limit)
FLASH_TOL = 3e-5
SERVE_BATCH, SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_SEQ = 4, 8, 16, 128
# Served tokens against the teacher-forced forward over prompt + served
# tokens. The forward sees at every position what the server saw, so each
# position is checked on its own: the served token must be the forward's
# argmax wherever the forward's top-2 margin is at least a near-tie
# threshold. Decode and prefill reach the same logits along other paths and
# differ by rounding; an argmax can flip only where the margin is under
# twice their largest logit gap. The thresholds are fixed in advance:
#  * one repeat at full width, f32 and bf16: tests/test_torch_lm_width.py
#    holds the reference's and the port's decode-vs-prefill gap at serving
#    lengths under REF_GAP on nets drawn by the same law (the reference's
#    own gap there: ~1e-3 f32, ~3e-2 bf16). SERVE_TIE is twice REF_GAP.
#  * full depth, f32: random nets this deep amplify rounding, most of all
#    in Mamba, whose chunked segsum form rounds otherwise than its
#    step-by-step recurrence; the reference cannot be run at this size to
#    measure its gap. A decode fault moves logits by their own scale (~5),
#    so the batch-1 teacher-forced decode's gap from the forward is held
#    under FULL_GAP (25x and 7x the gaps the card has shown, 4.0e-4 and
#    0.142, and a fifth of the logit scale at most); the served tokens are held to the forward's argmax at
#    margins over 2 FULL_GAP and, for the batching, to the batch-1
#    decode's argmax at margins over BATCH_TIE (f32 rounding of a batch of
#    4 against a batch of 1).
# Each check must reach at least its share of the served tokens.
REF_GAP = {"float32": 1e-2, "bfloat16": 1e-1}
SERVE_TIE = {dt: 2 * g for dt, g in REF_GAP.items()}
SERVE_LEAST = {"float32": 0.75, "bfloat16": 0.25}
FULL_GAP = {"llama3.2-1b": 1e-2, "mamba2-1.3b": 1.0}
FULL_LEAST = {"llama3.2-1b": 0.75, "mamba2-1.3b": 0.0}
BATCH_TIE, BATCH_LEAST = 1e-3, 0.75
# card vs a CPU twin at full width, one repeat, two sequence lengths each
# (Llama's second is ragged for the flash tiles; Mamba's is one chunk)
LM_TWIN_S = {"llama3.2-1b": (512, 300), "mamba2-1.3b": (512, 200)}
LM_TWIN_TOL = 1e-4               # f32, times max(1, max|logit|), + SENS_K x
                                 # the card's own sensitivity
# bf16 twin: the card's median row error from the CPU's f32 logits at most
# BF16_FACTOR x the CPU's own bf16 error, + BF16_FLOOR (as the CPU tests)
BF16_FACTOR, BF16_FLOOR = 2.0, 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, *args, reps=5, inner=EVENT_CALLS):
    """Median over ``reps`` of the CUDA-event time per call of ``inner``
    back-to-back calls. Where a call's device time is under the host's cost
    to launch it, this measures the host; ``device_us`` does not."""
    import torch
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


# Profiler windows are padded with spin kernels of PAD_CYCLES clock cycles
# each (torch.cuda._sleep, device name "spin_kernel", ~0.6 ms), PAD_FRONT
# before the work and PAD_BACK after it, left out of every sum: the
# profiler drops the device events at a window's start, more the older the
# process and the longer the window's calls (PERF.md section 7; 16 pads lost
# all of themselves and some work events before the training steps' calls
# of tens of ms)
PAD_FRONT, PAD_BACK, PAD_CYCLES = 96, 4, 1_000_000
PAD_NAME = "spin_kernel"
CALL_MARK = "chip_smoke_call"     # profiler range around each timed call
FLUSH_BYTES = 96 * 2 ** 20        # written or read before each per-shape
                                  # call (L2: 50 MB)

# host-side CUDA calls that each put one operation (kernel, copy or fill)
# on the device, as the profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
               "cudaMemsetAsync", "cudaMemcpyAsync", "cudaMemcpy")


def device_us(calls, reps=5, expect=None, attempts=3):
    """Device time per pass over ``calls``, from the profiler: the sum over
    every kernel, copy and fill that ran (busy), and by name.

    The profiler can drop device events, so the window is padded with spin
    kernels (PAD_FRONT, PAD_BACK), and its capture is held to the launches
    the window made before anything is summed: the device events other than
    the pads must number the host-side launch calls (LAUNCH_APIS) the
    profiler saw less the pads', every name must appear a whole number of
    times per pass, and each name containing a key of ``expect`` (a kernel
    of this repository, counted by its wrapper) exactly reps x expect[key]
    times. Each call runs inside a ``record_function(CALL_MARK)`` range, so
    the launch calls made inside it say how many of the window's device
    operations (in stream order) are its own: capture["per_call_us"] has
    the median over passes of each call's device time (the sum over its
    operations).
    If the capture falls short, busy is None and by_name empty: "not
    measured", never a partial sum divided by ``reps``. A short window is
    profiled again, up to ``attempts`` windows in all. Returns
    (busy, by_name, capture), capture giving the counts checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn, args in calls:
        fn(*args)
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_FRONT):
                torch.cuda._sleep(PAD_CYCLES)
            for _ in range(reps):
                for fn, args in calls:
                    with record_function(CALL_MARK):
                        fn(*args)
            for _ in range(PAD_BACK):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        busy, by_name, capture = _capture(prof, reps, expect, len(calls))
        capture["attempt"] = attempt
        if busy is not None:
            break
    return busy, by_name, capture


def edge_loss(t0, n=400, cycles=10_000):
    """The profiler's loss at a window's start, unpadded: a window of ``n``
    spin kernels of ``cycles`` clock cycles each; returns the seconds since
    ``t0``, the spins captured and the device microseconds lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and PAD_NAME in e.name]
    lost = (n - len(us)) * statistics.median(us) if us else None
    return {"at_s": time.perf_counter() - t0, "captured": len(us), "of": n,
            "lost_us": lost}


def _capture(prof, reps, expect, n_calls):
    """Sums of one profiler window and whether its capture is whole (see
    ``device_us``)."""
    from torch.autograd import DeviceType
    us, count, launched, pads, ops = {}, {}, -PAD_FRONT - PAD_BACK, [], []
    marks, launch_at = [], []
    for e in prof.events():
        if e.name == CALL_MARK:
            # the range on the host, and its copy on the device's timeline
            # (a user annotation, not an operation)
            if e.device_type != DeviceType.CUDA:
                marks.append((e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA and PAD_NAME in e.name:
            pads.append(e.time_range.start)
        elif e.device_type == DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
            count[e.name] = count.get(e.name, 0) + 1
            ops.append((e.time_range.start, e.time_range.elapsed_us()))
        elif e.name in LAUNCH_APIS:
            launched += 1
            launch_at.append(e.time_range.start)
    first = min((t for t, _ in ops), default=0)
    front = sum(t < first for t in pads)
    short = []
    if sum(count.values()) < launched:
        short.append(f"{sum(count.values())} device events for {launched} "
                     "launch calls")
    short += [f"{n[:60]}: {c} events in {reps} passes"
              for n, c in count.items() if c % reps]
    for key, per_pass in (expect or {}).items():
        got = sum(c for n, c in count.items() if key in n)
        if got != reps * per_pass:
            short.append(f"{key}: {got} events, launched {reps * per_pass}")
    capture = {"reps": reps, "launch_calls": launched,
               "device_events": sum(count.values()),
               "pads_seen_front": front, "pads_seen_back": len(pads) - front,
               "short": short}
    if short:
        print(f"    profiler capture short: {'; '.join(short)} (spin pads "
              f"seen: {front} of {PAD_FRONT} before, {len(pads) - front} of "
              f"{PAD_BACK} after)")
        return None, {}, capture
    per_call = _per_call(sorted(ops), sorted(marks), sorted(launch_at))
    if per_call is not None and len(per_call) == reps * n_calls:
        capture["per_call_us"] = [statistics.median(
            per_call[r * n_calls + i] for r in range(reps))
            for i in range(n_calls)]
    by_name = {n: t / reps for n, t in us.items()}
    return sum(by_name.values()), by_name, capture


def _per_call(ops, marks, launch_at):
    """Device microseconds of each marked call: the device operations, in
    stream order, cut into runs of as many as each call's range made launch
    calls. None if those launches do not number the operations."""
    import bisect
    sizes = [bisect.bisect_right(launch_at, b) - bisect.bisect_left(
        launch_at, a) for a, b in marks]
    if sum(sizes) != len(ops):
        return None
    out, i = [], 0
    for n in sizes:
        out.append(sum(d for _, d in ops[i:i + n]))
        i += n
    return out


def check_bound(what, readings, bound_ms):
    """Fail the run if a reading (ms; None = not measured) is under the
    least time the card could take: no card beats its bound, so such a
    reading is a measurement fault and is never written down."""
    for label, ms in readings.items():
        if ms is not None:
            check(ms >= bound_ms, f"{what} {label} {ms} ms is under its bound "
                  f"{bound_ms} ms: a faulty reading")


def wall_profile(fn, reps=3, expect=None):
    """Wall time of ``fn()`` (median of ``reps`` after a warm-up, host clock
    around a synchronize, no profiler), the device-busy time in one call,
    the idle share and the top kernels by device time; and the device
    microseconds of that call by kernel name (empty if the profiler's
    capture fell short)."""
    import torch
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls[1:])
    busy, by_name, capture = device_us([(fn, ())], reps=1, expect=expect)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall,
            "device_busy_ms": None if busy is None else busy / 1e3,
            "idle_share": None if busy is None else 1 - busy / 1e3 / wall,
            "top_kernels_us": top, "capture": capture}, by_name


def lm_slice(dev, gen, report):
    """Slice 2: the LM prefill forward and the continuous-batching server
    of full-width Llama-3.2-1B and Mamba-2-1.3B. Returns the kernels-line
    entries of flash_attention and ssd_chunk_scan."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    def tree_map(fn, tree):
        return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- LM 1. each kernel against its plain version at the path's shapes --
    llama, mcfg = get_config("llama3.2-1b"), get_config("mamba2-1.3b")
    H, Kv, D = llama.num_heads, llama.num_kv_heads, llama.head_dim
    err = {"flash_attention": 0.0, "ssd_chunk_scan": 0.0}
    n_flash = 0
    for S in (LM_S, LM_RAGGED_S):
        for K in (Kv, H):                    # the model's GQA, and K = H
            q = torch.randn(LM_B, S, H, D, generator=gen).to(dev)
            k = torch.randn(LM_B, S, K, D, generator=gen).to(dev)
            v = torch.randn(LM_B, S, K, D, generator=gen).to(dev)
            for dt in (torch.bfloat16, torch.float32):
                # seq-major (B,S,H,D) views, as the model hands them over
                qt, kt, vt = (t.to(dt).transpose(1, 2) for t in (q, k, v))
                for causal in (True, False):
                    got = ops.flash_attention(qt, kt, vt, causal)
                    want = ref.flash_attention(qt.float(), kt.float(),
                                               vt.float(), causal)
                    torch.cuda.synchronize()
                    e = max_err(got, want)
                    if dt == torch.bfloat16:
                        lim = ref.flash_bf16_limit(want, qt, kt, vt, causal,
                                                   FLASH_TOL)
                    else:
                        lim = FLASH_TOL * (1 + want.abs())
                    over = float(((got.float() - want).abs() - lim).max())
                    check(got.dtype == dt and over <= 0,
                          f"flash_attention S={S} K={K} {dt} causal="
                          f"{causal}: an element is {over} over its bound "
                          f"(max abs err {e})")
                    n_flash += 1
                    if (S, K, dt, causal) == (LM_S, Kv, torch.bfloat16,
                                              True):
                        err["flash_attention"] = e   # the main path's call
                    print(f"  flash_attention B={LM_B} S={S} H={H} K={K} "
                          f"D={D} {str(dt)[6:]} causal={causal}: max abs "
                          f"err {e:.3g}")
    scan_shape = (LM_B, LM_S // mcfg.ssm_chunk, mcfg.ssm_heads,
                  mcfg.ssm_head_dim, mcfg.ssm_state)
    for dt in (torch.float32, torch.bfloat16):
        st = torch.randn(scan_shape, generator=gen).to(dev, dt)
        dc = torch.rand(scan_shape[:3], generator=gen).to(dev)
        got = ops.ssd_chunk_scan(st, dc)
        want = ref.ssd_chunk_scan(st, dc)
        torch.cuda.synchronize()
        err["ssd_chunk_scan"] = max(err["ssd_chunk_scan"], max_err(got, want))
        check(torch.equal(got, want), f"ssd_chunk_scan {scan_shape} {dt}: "
              f"not bit-equal (max err {err['ssd_chunk_scan']})")
    print(f"LM kernels vs plain: {n_flash} flash_attention cases within "
          f"{FLASH_TOL} (1 + |value|), + 2^-8 (|value| + A(q,k,|v|)) in "
          f"bf16, element by element; ssd_chunk_scan {scan_shape} bit-equal "
          "in f32 and bf16")

    # -- LM 2. the main path: prefill forwards and the server, counted -----
    models = {}
    for i, arch in enumerate(("llama3.2-1b", "mamba2-1.3b")):
        cfg = get_config(arch)
        t = time.perf_counter()
        params = lm.init_params(cfg, torch.Generator().manual_seed(SEED + i),
                                device=dev)
        n = sum(t.numel() for t in _leaves(params))
        print(f"{arch}: {n} parameters, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, materialized in "
              f"{time.perf_counter() - t:.1f} s")
        tok = next(synthetic.token_batches(LM_B, LM_S, cfg.vocab_size,
                                           seed=0))[0]["tokens"]
        models[arch] = (cfg, params, torch.from_numpy(tok).to(dev))
    n_flash_fwd, n_scan_fwd = llama.num_layers, mcfg.num_layers
    torch.cuda.synchronize()
    ops.reset_launches()
    t_main = time.perf_counter()
    logits = {}
    served = {}
    with torch.no_grad():
        for arch, (cfg, params, tok) in models.items():
            logits[arch], _ = lm.forward(cfg, params, tok)
        for arch, (cfg, params, _) in models.items():
            served[arch] = serve.serve(
                cfg, params, serve.make_requests(cfg, SERVE_REQUESTS,
                                                 SERVE_NEW, seed=SEED),
                batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ, device=dev)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    lm_launches = ops.launches()
    print(f"LM main path (2 forwards B={LM_B} S={LM_S}, 2 x "
          f"{SERVE_REQUESTS} served requests): {t_main:.2f} s, launches "
          f"{lm_launches}")
    check(lm_launches["flash_attention"] == n_flash_fwd,
          f"flash_attention: {lm_launches['flash_attention']} launches, not "
          f"{n_flash_fwd} (one per Llama attention layer)")
    check(lm_launches["ssd_chunk_scan"] == n_scan_fwd,
          f"ssd_chunk_scan: {lm_launches['ssd_chunk_scan']} launches, not "
          f"{n_scan_fwd} (one per Mamba SSD layer)")
    for arch, lg in logits.items():
        cfg = models[arch][0]
        check(tuple(lg.shape) == (LM_B, LM_S, cfg.vocab_size)
              and lg.dtype == torch.float32, f"{arch} logits {lg.shape}")
        check(bool(torch.isfinite(lg).all()), f"{arch} logits not finite")
    del logits
    for arch, (done, secs) in served.items():
        toks = sum(len(r.out_tokens) for r in done)
        check(len(done) == SERVE_REQUESTS and toks == SERVE_REQUESTS
              * SERVE_NEW, f"{arch} server: {len(done)} requests, {toks} "
              "tokens")
        check(all(0 <= t < models[arch][0].vocab_size for r in done
                  for t in r.out_tokens), f"{arch} server: a token outside "
              "the vocabulary")
        report[f"serve {arch}"] = {"requests": len(done), "tokens": toks,
                                   "seconds": secs, "tokens_per_s":
                                   toks / secs}
        print(f"  serve {arch}: {len(done)} requests, {toks} tokens in "
              f"{secs:.2f} s ({toks / secs:.1f} tok/s, batch "
              f"{SERVE_BATCH}, bf16)")

    # -- LM 3. served tokens against the teacher-forced forward ------------
    # (see SERVE_TIE and FULL_GAP above for the thresholds)
    def decode_rows(cfg, params, seq, first):
        """Logits of a teacher-forced batch-1 decode of ``seq``, rows
        ``first`` onwards."""
        cache = lm.init_cache(cfg, 1, len(seq), dev)
        rows = []
        for t in range(len(seq)):
            lg, _ = lm.decode_step(cfg, params, cache, torch.tensor(
                [[int(seq[t])]], device=dev), torch.tensor([t], device=dev))
            if t >= first:
                rows.append(lg[0])
        return torch.stack(rows)

    def agree(rows, tokens, tie, what):
        """Every token whose row has a top-2 margin of at least ``tie`` is
        that row's argmax; returns how many were checked."""
        top2 = torch.topk(rows, 2, dim=-1)
        margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
        argmax = top2.indices[:, 0].cpu()
        checked = 0
        for i, tokn in enumerate(tokens):
            if float(margin[i]) >= tie:
                check(int(argmax[i]) == tokn, f"{what} position {i}: served "
                      f"{tokn}, argmax {int(argmax[i])} (margin "
                      f"{float(margin[i])}, near-tie threshold {tie})")
                checked += 1
        return checked

    def served_vs_forward(cfg, params, tie, least, what, gap=None):
        """Serve the main path's requests (batch SERVE_BATCH; made anew,
        the engine fills them in) and hold every served
        token to the teacher-forced forward's argmax at margins of at least
        ``tie``; with ``gap``, also hold a batch-1 teacher-forced decode's
        logits within ``gap`` of the forward's and the served tokens to its
        argmax at margins of at least BATCH_TIE. Each check must reach
        ``least`` (BATCH_LEAST) of the served tokens."""
        done, _ = serve.serve(cfg, params, serve.make_requests(
            cfg, SERVE_REQUESTS, SERVE_NEW, seed=SEED), batch=SERVE_BATCH,
            max_seq=SERVE_MAX_SEQ, device=dev)
        n_tok = sum(len(r.out_tokens) for r in done)
        check(len(done) == SERVE_REQUESTS and n_tok == SERVE_REQUESTS
              * SERVE_NEW, f"{what}: {len(done)} requests, {n_tok} tokens")
        out = {"tokens": n_tok, "checked_fwd": 0, "checked_batch": 0,
               "max_gap": 0.0}
        for r in done:
            seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1],
                                                       np.int32)])
            first = len(r.prompt) - 1
            with torch.no_grad():
                rows = lm.forward(cfg, params, torch.from_numpy(seq)[None]
                                  .to(dev))[0][0, first:]
                out["checked_fwd"] += agree(
                    rows, r.out_tokens, tie,
                    f"{what} request {r.uid} vs the forward")
                if gap is None:
                    continue
                drows = decode_rows(cfg, params, seq, first)
            g = max_err(rows, drows)
            out["max_gap"] = max(out["max_gap"], g)
            check(g <= gap, f"{what} request {r.uid}: batch-1 decode vs "
                  f"forward logits differ by {g} > {gap}")
            out["checked_batch"] += agree(
                drows, r.out_tokens, BATCH_TIE,
                f"{what} request {r.uid} vs the batch-1 decode")
        check(out["checked_fwd"] >= least * n_tok, f"{what}: only "
              f"{out['checked_fwd']} of {n_tok} served tokens checked "
              f"against the forward (margins under {tie})")
        if gap is not None:
            check(out["checked_batch"] >= BATCH_LEAST * n_tok, f"{what}: "
                  f"only {out['checked_batch']} of {n_tok} served tokens "
                  f"checked against the batch-1 decode")
        print(f"  {what}: of {n_tok} served tokens {out['checked_fwd']} "
              f"checked against the forward's argmax (near-tie threshold "
              f"{tie:.3g})" + ("" if gap is None else
                               f", {out['checked_batch']} against the "
                               f"batch-1 decode's; decode-vs-forward gap "
                               f"{out['max_gap']:.4g} <= {gap}"))
        return out

    for i, (arch, (cfg, params, _)) in enumerate(models.items()):
        # one repeat at full width, drawn by the law of a one-repeat model
        # (as tests/test_torch_lm_width.py draws it)
        c1 = dataclasses.replace(cfg, num_layers=lm.block_period(cfg),
                                 dtype="float32")
        p1 = lm.init_params(c1, torch.Generator().manual_seed(SEED + 10 + i),
                            device=dev)
        for dt in ("float32", "bfloat16"):
            cast = getattr(torch, dt)
            report[f"serve check {arch} 1 repeat {dt}"] = served_vs_forward(
                dataclasses.replace(c1, dtype=dt),
                tree_map(lambda t: t.to(cast), p1), SERVE_TIE[dt],
                SERVE_LEAST[dt], f"serve {arch} 1 repeat {dt}")
        del p1
        # full depth, f32 copy of the main path's weights
        p32 = tree_map(lambda t: t.float(), params)
        report[f"serve check {arch} f32"] = served_vs_forward(
            dataclasses.replace(cfg, dtype="float32"), p32,
            2 * FULL_GAP[arch], FULL_LEAST[arch], f"serve {arch} f32",
            gap=FULL_GAP[arch])
        del p32
        torch.cuda.empty_cache()

    # -- LM 4. the card against a CPU twin, full width, one repeat ---------
    for arch, (cfg, params, _) in models.items():
        R1 = lm.block_period(cfg)
        c1 = dataclasses.replace(cfg, num_layers=R1)
        p_dev = dict(params, blocks=tree_map(lambda t: t[:1],
                                             params["blocks"]))
        p_cpu = tree_map(lambda t: t.cpu(), p_dev)
        for S in LM_TWIN_S[arch]:
            tok = torch.from_numpy(next(synthetic.token_batches(
                1, S, cfg.vocab_size, seed=1))[0]["tokens"])
            with torch.no_grad():
                out = {}
                for dt in ("float32", "bfloat16"):
                    cast = getattr(torch, dt)
                    pd = tree_map(lambda t: t.to(cast), p_dev)
                    pc = tree_map(lambda t: t.to(cast), p_cpu)
                    cd = dataclasses.replace(c1, dtype=dt)
                    out[dt, "card"] = lm.forward(cd, pd, tok.to(dev))[0]
                    out[dt, "cpu"] = lm.forward(cd, pc, tok)[0]
                    if dt == "float32":
                        nudged = dict(pd, embed=pd["embed"] * (1 + 1e-7))
                        out["nudged"] = lm.forward(cd, nudged,
                                                   tok.to(dev))[0]
            want = out["float32", "cpu"]
            got = out["float32", "card"].cpu()
            sens = float((out["nudged"].cpu() - got).abs().max())
            scale = max(1.0, float(want.abs().max()))
            diff = float((got - want).abs().max())
            lim = LM_TWIN_TOL * scale + SENS_K * sens
            check(diff <= lim, f"{arch} S={S} f32: card vs CPU differ by "
                  f"{diff} > {lim}")

            def row_err(a):
                d = (a.cpu().float() - want).reshape(-1, want.shape[-1])
                return float(d.pow(2).mean(-1).sqrt().median()) / float(
                    want.pow(2).mean().sqrt())
            e_card = row_err(out["bfloat16", "card"])
            e_cpu = row_err(out["bfloat16", "cpu"])
            check(e_card <= BF16_FACTOR * e_cpu + BF16_FLOOR,
                  f"{arch} S={S} bf16: card's median row error from f32 "
                  f"{e_card} vs the CPU's {e_cpu}")
            print(f"  card vs CPU {arch} 1 repeat S={S}: f32 max diff "
                  f"{diff:.3g} (scale {scale:.3g}, sensitivity to a 1e-7 "
                  f"embedding change {sens:.3g}); bf16 median row error "
                  f"from the CPU's f32: card {e_card:.4g}, CPU {e_cpu:.4g}")
            report[f"twin {arch} S={S}"] = {
                "f32_max_diff": diff, "scale": scale, "sensitivity": sens,
                "bf16_row_err_card": e_card, "bf16_row_err_cpu": e_cpu}

    # -- LM 5. times: forwards, kernel, plain version, library call, bound -
    # Each kernel's device time per launch on the main path comes from the
    # forward's profile, its capture held to the launches the forward made.
    per_fwd = {"flash_attention": n_flash_fwd, "ssd_chunk_scan": n_scan_fwd}
    cnames = {"flash_attention": "flash_tc_kernel",     # the bf16 kernel
              "ssd_chunk_scan": "ssd_scan_kernel"}
    fwd_kernel = {"llama3.2-1b": "flash_attention",
                  "mamba2-1.3b": "ssd_chunk_scan"}
    kernel_us = {}
    for arch, (cfg, params, tok) in models.items():
        name = fwd_kernel[arch]
        fp, by_name = wall_profile(
            lambda c=cfg, p=params, t=tok: lm.forward(c, p, t),
            expect={cnames[name]: per_fwd[name]})
        report[f"forward {arch}"] = fp
        busy = fp["device_busy_ms"]
        print(f"  forward {arch} B={LM_B} S={LM_S}: wall {fp['wall_ms']:.3f}"
              " ms, device busy " + ("not measured" if busy is None else
                                     f"{busy:.3f} ms, idle share "
                                     f"{fp['idle_share']:.3f}"))
        for kname, us in fp["top_kernels_us"]:
            print(f"    {us:9.1f} us  {kname[:90]}")
        us = sum(v for k, v in by_name.items() if cnames[name] in k)
        kernel_us[name] = us / per_fwd[name] if by_name else None
        if by_name:
            fp["kernel_share"] = us / 1e3 / busy
            print(f"    {name}: {kernel_us[name]:.1f} us per launch, "
                  f"{100 * fp['kernel_share']:.1f}% of the forward's device "
                  "time")
    q, k, v = (torch.randn(LM_B, LM_S, h, D, generator=gen).to(
        dev, torch.bfloat16).transpose(1, 2) for h in (H, Kv, Kv))
    pairs = LM_B * H * LM_S * (LM_S + 1) // 2       # causal (q, k) pairs
    flash_ops_ms = 4 * D * pairs / BF16_OPS_PER_S * 1e3
    flash_bytes_ms = 2 * LM_B * LM_S * D * (2 * H + 2 * Kv) \
        / HBM_BYTES_PER_S * 1e3

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    check(max_err(sdpa(q, k, v), ops.flash_attention(q, k, v)) <= 5e-2,
          "flash_attention disagrees with SDPA")
    st = torch.randn(scan_shape, generator=gen).to(dev)
    dc = torch.rand(scan_shape[:3], generator=gen).to(dev) * 0.5 + 0.5
    scan_bytes_ms = 4 * (2 * st.numel() + dc.numel()) / HBM_BYTES_PER_S * 1e3
    scan_ops_ms = 2 * st.numel() / FP32_OPS_PER_S * 1e3

    def segsum_form(states, decay):
        """The reference model's inter-chunk pass: exp(segsum) over the
        padded log decays, one einsum over all chunk pairs."""
        cs = torch.log(decay).transpose(1, 2)                  # (B,H,NC)
        dchunk = torch.exp(L._segsum(F.pad(cs, (1, 0))))
        allst = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
        return torch.einsum("bhzc,bchpn->bzhpn", dchunk, allst)[:, :-1]
    check(max_err(segsum_form(st, dc), ops.ssd_chunk_scan(st, dc)) <= 1e-3,
          "ssd_chunk_scan disagrees with the segsum form")

    def ms(busy):
        return None if busy is None else busy / 1e3

    times = {}
    for name, fns, args in (
            ("flash_attention", (ops.flash_attention, ref.flash_attention,
                                 sdpa), (q, k, v)),
            ("ssd_chunk_scan", (ops.ssd_chunk_scan, ref.ssd_chunk_scan,
                                segsum_form), (st, dc))):
        t = {}
        for label, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            t[label] = median_ms(fn, *args)
            t[label.replace("ms", "alone_device_ms")] = ms(device_us(
                [(fn, args)], expect={cnames[name]: 1} if label == "ms"
                else None)[0])
        t["device_ms"] = ms(kernel_us[name])       # per launch, main path
        t["plain_device_ms"] = t.pop("plain_alone_device_ms")
        t["library_device_ms"] = t.pop("library_alone_device_ms")
        times[name] = t
    # the scan has no library call; its row shows the reference model's
    # segsum-einsum form beside it, under its own keys
    scan = times["ssd_chunk_scan"]
    scan["segsum_ms"] = scan.pop("library_ms")
    scan["segsum_device_ms"] = scan.pop("library_device_ms")
    scan["library_ms"] = scan["library_device_ms"] = None
    times["flash_attention"].update(
        bound_ms=max(flash_ops_ms, flash_bytes_ms),
        bound_by="operations" if flash_ops_ms >= flash_bytes_ms else "bytes",
        ops_ms=flash_ops_ms, bytes_ms=flash_bytes_ms)
    times["ssd_chunk_scan"].update(
        bound_ms=max(scan_ops_ms, scan_bytes_ms),
        bound_by="operations" if scan_ops_ms >= scan_bytes_ms else "bytes",
        ops_ms=scan_ops_ms, bytes_ms=scan_bytes_ms)
    for name, t in times.items():
        check_bound(name, {k: v for k, v in t.items() if k.endswith("ms")
                           and k not in ("bound_ms", "ops_ms", "bytes_ms")},
                    t["bound_ms"])
        print(f"  time {name}: " + ", ".join(
            f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    report["lm_times"] = times

    meta = {"flash_attention": ("flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:65"),
            "ssd_chunk_scan": ("ssd_scan.cu",
                               "src/repro/kernels/ssd_scan.py:34")}
    entries = []
    for name, (src, replaces) in meta.items():
        t = times[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"],
            "alone_device_ms": t["alone_device_ms"]})
    for k in ("segsum_ms", "segsum_device_ms"):
        entries[1][k] = times["ssd_chunk_scan"][k]
    return entries


# -- slice 5: XR training ---------------------------------------------------
TRAIN_NETS = (("detnet", 8), ("edsnet", 4))    # the examples' batch sizes
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
U32 = 2.0 ** -24                 # f32 unit roundoff
# the weight-gradient kernel against its plain version, each tap: the plain
# version evaluated in f64 (its own error negligible), the kernel's error
# held to depth x 2^-24 x sum|x g| over that channel's products: a sum whose
# every term passes through at most ``depth`` f32 roundings
# (``wgrad_plan``: the thread's chain, then the block's, the cluster's and
# the rows' sums) is off by at most that much, whatever the terms cancel
# to; a bound on the result itself would fail wherever the sum cancels
# the Function's gradients against autograd of the plain forward, whose
# own f32 sums take an order we do not bound: dx within DW_TOL (as the
# forward), dw within WIRING_TOL x sum|x g| (a wiring fault, a turned or
# transposed tap, is off by O(sum|x g|))
WIRING_TOL = 1e-5
# one step on the card against the same step of the port on the CPU in
# f32 and in f64: the card's largest distance from the f64 gradients at
# most GRAD_K times the CPU f32's own, + GRAD_TOL x the largest entry,
# absolute over the net (leaves whose exact gradient is zero carry only
# noise). A fixed GRAD_TOL alone cannot hold here: at full width and b8
# the f32 step is ill-conditioned, CPU and card alike ~1% of the largest
# entry off f64 in the early BN leaves (PERF.md), where the smoke nets of
# the CPU tests stay within GRAD_TOL of the reference
RESUME_RTOL = 1e-5               # resumed steps against the first run
GRAD_TOL, GRAD_K = 1e-4, 2.0


def train_slice(dev, gen, report, dw_shapes):
    """Slice 5: XR training of full-width DetNet (b8, 128x128) and EDSNet
    (b4, 384x640) through ``train.loop.run_xr_training``, every stride-1
    depthwise step on the kernel forward (13) and backward (13 dx through
    the forward kernel, 13 dw). Returns the kernels-line entry of
    depthwise_conv3x3_wgrad and the two nets T2 trained, by name."""
    import math
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import depthwise_conv as dwk
    from repro_torch.launch import train_xr
    from repro_torch.models import xr
    from repro_torch.train import loop, optim

    # non-kernel convs' backward in cuDNN's deterministic algorithms, for
    # this phase only, so a resumed run can repeat the first (T2)
    det_flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfgs = {name: get_config(name) for name, _ in TRAIN_NETS}
    shapes = {name: dw_shapes(cfgs[name], b) for name, b in TRAIN_NETS}
    all_shapes = shapes["detnet"] + shapes["edsnet"]
    check(len(all_shapes) == 26, f"{len(all_shapes)} training depthwise "
          "shapes, not 26")

    def conv_wgrad(x, g):     # PyTorch's weight gradient: the yardstick
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        return torch.ops.aten.convolution_backward(
            gc, xc, torch.empty(x.shape[-1], 1, 3, 3, device=x.device),
            None, [1, 1], [1, 1], [1, 1], False, [0, 0], x.shape[-1],
            [False, True, False])[1]

    floor_fn = _build.library("depthwise_conv").launch_floor_launch
    floor_fn.argtypes, floor_fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch_floor():       # an empty kernel: no launch takes less
        _build.check_launch("depthwise_conv", floor_fn(
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)))

    # -- T1. the backward's pieces against their plain versions ------------
    inputs, err, worst, lib_off = [], 0.0, 0.0, 0.0
    for shape in all_shapes:
        C = shape[-1]
        x = torch.randn(shape, generator=gen).to(dev)
        g = torch.randn(shape, generator=gen).to(dev)
        w = torch.randn(C, 1, 3, 3, generator=gen).to(dev)
        inputs.append((x, g, w))
        wr = dwk.rotated(w)
        dx = ops.depthwise_conv3x3(g, wr)
        want = ref.depthwise_conv3x3(g, wr)
        e = float((dx - want).abs().max())
        lim = DW_TOL["float32"] * (1 + float(want.abs().max()))
        check(e <= lim, f"dx {shape}: max err {e} > {lim}")
        dw1 = ops.depthwise_conv3x3_wgrad(x, g)
        dw2 = ops.depthwise_conv3x3_wgrad(x, g)
        torch.cuda.synchronize()
        check(torch.equal(dw1, dw2), f"dw {shape}: two runs differ in bits")
        exact = ref.depthwise_conv3x3_wgrad(x.double(), g.double())
        mag = ref.depthwise_conv3x3_wgrad(x.double().abs(), g.double().abs())
        bound = dwk.wgrad_plan(*shape).depth * U32 * mag
        off = (dw1.double() - exact).abs()
        check(bool((off <= bound).all()), f"dw {shape}: off the f64 sum by "
              f"more than its rounding bound (max {float(off.max())})")
        worst = max(worst, float((off / bound)[bound > 0].max()))
        err = max(err, float((dw1 - ref.depthwise_conv3x3_wgrad(x, g))
                             .abs().max()))
        # cuDNN's weight gradient (full f32, deterministic here), whose own
        # order is not bounded: held as the Function's dw is, below
        lim = WIRING_TOL * mag
        lib = (conv_wgrad(x, g).double() - dw1.double()).abs()
        check(bool((lib <= lim).all()), f"dw {shape}: off cuDNN's weight "
              f"gradient by {float(lib.max())}")
        lib_off = max(lib_off, float((lib / lim)[lim > 0].max()))
        # the Function against autograd of the plain forward
        r = torch.randn(shape, generator=gen).to(dev)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        (ops.depthwise_conv3x3(xa, wa) * r).sum().backward()
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        (ref.depthwise_conv3x3(xb, wb) * r).sum().backward()
        e = float((xa.grad - xb.grad).abs().max())
        lim = DW_TOL["float32"] * (1 + float(xb.grad.abs().max()))
        check(e <= lim, f"Function dx {shape}: max err {e} > {lim}")
        mag_r = ref.depthwise_conv3x3_wgrad(x.abs(), r.abs())
        check(bool(((wa.grad - wb.grad).abs() <= WIRING_TOL * mag_r).all()),
              f"Function dw {shape}: off autograd of the plain forward")
    print(f"T1 backward vs plain: {len(all_shapes)} training depthwise "
          f"shapes: dx within {DW_TOL['float32']}, dw bit-identical run to "
          f"run and within {worst:.3g} of its rounding bound off the f64 "
          f"sum (max abs err vs the f32 plain version {err:.3g}), within "
          f"{lib_off:.3g} of {WIRING_TOL} x sum|x g| of cuDNN's; the "
          "Function's gradients match autograd of the plain forward")

    # -- T2. the main path: run_xr_training on the card, counted ----------
    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    data = {name: [next(it) for _ in range(TRAIN_STEPS)]
            for name, b in TRAIN_NETS
            for it in [train_xr.batches(cfgs[name], b)]}
    loss_fns = {"detnet": xr.circle_loss, "edsnet": xr.dice_loss}

    def train(name, seed, steps_per_launch):
        net = xr.XRNet(cfgs[name], torch.Generator().manual_seed(seed),
                       device=dev)
        per_step, times = [], []

        def beat(step, dt):
            per_step.append(dict(ops.launches()))
            times.append(dt)

        res = loop.run_xr_training(
            net, iter(data[name]), loss_fn=loss_fns[name],
            steps=TRAIN_STEPS, lr=3e-3, ckpt_dir=str(ckpt_root / name),
            ckpt_every=TRAIN_CKPT_EVERY,
            hooks=loop.TrainHooks(heartbeat=beat, log_every=10))
        before = steps_per_launch
        for i, now in enumerate(per_step):
            diff = {k: now[k] - before[k] for k in now}
            check(diff == {**{k: 0 for k in now}, "depthwise_conv3x3": 26,
                           "depthwise_conv3x3_wgrad": 13},
                  f"{name} step {i}: launches {diff}, not 13 forward + 13 "
                  "dx depthwise and 13 dw")
            before = now
        return net, res, times, before

    ops.reset_launches()
    dwk.DepthwiseConv3x3.copies = 0
    t_main = time.perf_counter()
    runs, after = {}, ops.launches()
    for i, (name, b) in enumerate(TRAIN_NETS):
        net, res, times, after = train(name, SEED + 10 + i, after)
        check(res.step == TRAIN_STEPS and len(res.losses) == TRAIN_STEPS,
              f"{name}: {res.step} steps")
        for k, p in net.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{name} {k}: gradient missing or not finite")
        for st in net.plan:
            if xr.uses_depthwise_kernel(st) or st.name == "stem":
                gw = getattr(net, st.name).w.grad
                check(bool((gw != 0).any()), f"{name} {st.name}.w: the "
                      "gradient is zero everywhere")
        check(all(map(math.isfinite, res.losses)), f"{name}: loss not finite")
        runs[name] = (net, res, times)
    # resume: drop the last checkpoint, rerun from step TRAIN_CKPT_EVERY
    resumed = {}
    for i, (name, b) in enumerate(TRAIN_NETS):
        last = ckpt_root / name / f"step_{TRAIN_STEPS:010d}"
        check(last.is_dir(), f"{name}: no checkpoint at step {TRAIN_STEPS}")
        shutil.rmtree(last)
        net, res, _, after = train(name, SEED + 20 + i, after)
        resumed[name] = (net, res)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = ops.launches()
    print(f"T2 training path: {t_main:.2f} s, launches {launches}, gradient "
          f"copies before the depthwise backward "
          f"{dwk.DepthwiseConv3x3.copies}")
    n_steps = 2 * (TRAIN_STEPS + TRAIN_STEPS - TRAIN_CKPT_EVERY)
    check(launches["depthwise_conv3x3"] == 26 * n_steps
          and launches["depthwise_conv3x3_wgrad"] == 13 * n_steps,
          f"training launches {launches}, not 26 + 13 per step x {n_steps}")
    det_losses = runs["detnet"][1].losses
    check(min(det_losses[-4:]) < det_losses[0],
          f"DetNet loss did not fall: {det_losses}")
    resume_err = {}
    for name, (net, res) in resumed.items():
        first = runs[name][1].losses[TRAIN_CKPT_EVERY:]
        check(len(res.losses) == TRAIN_STEPS - TRAIN_CKPT_EVERY,
              f"{name}: resumed run took {len(res.losses)} steps")
        rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, first))
        resume_err[name] = rel
        check(rel <= RESUME_RTOL, f"{name}: resumed steps differ from the "
              f"first run by {rel} relative")
    for name, (net, res, times) in runs.items():
        print(f"  {name}: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
              f"over {TRAIN_STEPS} steps; resumed steps "
              f"{TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} within "
              f"{resume_err[name]:.3g} relative of the first run")
    report["train"] = {
        name: {"losses": res.losses, "resumed": resumed[name][1].losses,
               "resume_rel_err": resume_err[name], "step_s": times}
        for name, (net, res, times) in runs.items()}
    report["train_launches"] = launches

    # -- T3. one step on the card against the same step on the CPU --------
    # and in f64 on the CPU (the yardstick: plain depthwise in f64)
    for i, (name, b) in enumerate(TRAIN_NETS):
        net = xr.XRNet(cfgs[name], torch.Generator().manual_seed(SEED + 30),
                       device=dev)
        twin = xr.XRNet(cfgs[name], device="cpu")
        twin.load_state_dict(net.state_dict())
        exact = xr.XRNet(cfgs[name], device="cpu")
        exact.load_state_dict(net.state_dict())
        exact.double()
        batch = data[name][0][0]
        lr_fn = optim.cosine_schedule(3e-3, 1, 1)      # lr(0) = 0
        out = []
        for m, d, dt in ((net, dev, torch.float32),
                         (twin, torch.device("cpu"), torch.float32),
                         (exact, torch.device("cpu"), torch.float64)):
            step = loop.make_xr_step(m, loss_fns[name], lr_fn)
            bt = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            bt = {k: v.to(dt) if v.is_floating_point() else v
                  for k, v in bt.items()}
            kernel = ops.depthwise_conv3x3
            if dt == torch.float64:    # the ops check refuses f64
                ops.depthwise_conv3x3 = ref.depthwise_conv3x3
            try:
                _, metrics = step(optim.adamw_init(
                    dict(m.named_parameters())), bt, 0)
            finally:
                ops.depthwise_conv3x3 = kernel
            out.append((float(metrics["loss"]), {
                k: p.grad.double().cpu() for k, p in m.named_parameters()}))
        (lc, gc), (lh, gh), (l64, g64) = out
        gmax = max(float(g.abs().max()) for g in g64.values())

        def off(g):
            return max(float((g[k] - g64[k]).abs().max()) for k in g64)
        e_card, e_cpu = off(gc), off(gh)
        diff = max(float((gc[k] - gh[k]).abs().max()) for k in gh)
        check(e_card <= GRAD_K * e_cpu + GRAD_TOL * gmax, f"{name}: the "
              f"card's gradients are {e_card} off the f64 ones, the CPU's "
              f"{e_cpu} (largest entry {gmax})")
        check(abs(lc - l64) <= GRAD_TOL * abs(l64), f"{name}: loss {lc} "
              f"(card), {l64} (f64)")
        print(f"T3 {name} b{b}: one step, loss card {lc} / CPU {lh} / f64 "
              f"{l64}; gradients off the f64 ones by {e_card / gmax:.3g} "
              f"(card) and {e_cpu / gmax:.3g} (CPU f32) of the largest "
              f"entry {gmax:.4g}; card vs CPU {diff / gmax:.3g}")
        report["train"][name].update(grad_off_f64_card=e_card / gmax,
                                     grad_off_f64_cpu=e_cpu / gmax,
                                     card_vs_cpu_grad=diff / gmax)

    # -- T4. times, with cuDNN's default algorithm choice again -----------
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        det_flags
    check(bool(torch.allclose(conv_wgrad(*inputs[0][:2]),
                              ops.depthwise_conv3x3_wgrad(*inputs[0][:2]),
                              rtol=1e-4, atol=1e-3)),
          "the library's weight gradient is not the same function")
    rows = []
    for shape, (x, g, w) in zip(all_shapes, inputs):
        B, H, W, C = shape
        rows.append(row(shape, (ops.depthwise_conv3x3_wgrad,
                                ref.depthwise_conv3x3_wgrad, conv_wgrad),
                        (x, g), 4 * (2 * B * H * W * C + 9 * C),
                        18 * B * H * W * C / FP32_OPS_PER_S))
    # device time per pass over each net's 13 calls: forward, dx, dw, cuDNN
    n13 = len(shapes["detnet"])
    passes = {}
    for gi, (name, _) in enumerate(TRAIN_NETS):
        part = inputs[gi * n13:(gi + 1) * n13]
        calls = {
            "forward": [(ops.depthwise_conv3x3, (x, w)) for x, g, w in part],
            "dx": [(ops.depthwise_conv3x3, (g, dwk.rotated(w)))
                   for x, g, w in part],
            "dw": [(ops.depthwise_conv3x3_wgrad, (x, g))
                   for x, g, w in part],
            "plain_dw": [(ref.depthwise_conv3x3_wgrad, (x, g))
                         for x, g, w in part],
            "library_dw": [(conv_wgrad, (x, g)) for x, g, w in part]}
        expect = {"forward": {"dw3x3_kernel": n13}, "dx": {"dw3x3_kernel":
                  n13}, "dw": {"dw3x3_wgrad": n13}, "plain_dw": None,
                  "library_dw": None}
        passes[name] = {}
        for label, cl in calls.items():
            busy, _, capture = device_us(cl, expect=expect[label])
            passes[name][f"{label}_ms"] = None if busy is None else busy / 1e3
        # per shape: the kernel, cuDNN's weight gradient and an empty
        # kernel (the floor of one launch) in one window
        grp = rows[gi * n13:(gi + 1) * n13]
        cl = [c for x, g, w in part for c in (
            (ops.depthwise_conv3x3_wgrad, (x, g)), (conv_wgrad, (x, g)))]
        _, _, capture = device_us(cl + [(launch_floor, ())], expect={
            "dw3x3_wgrad": n13, "launch_floor": 1})
        per = capture.get("per_call_us")
        if per is not None:
            for i, r in enumerate(grp):
                r["device_ms"] = per[2 * i] / 1e3
                r["library_device_ms"] = per[2 * i + 1] / 1e3
                r["floor_device_ms"] = per[-1] / 1e3
        passes[name]["dw_bound_ms"] = sum(r["bound_ms"] for r in grp)
        print(f"  T4 {name} device ms per pass of 13 depthwise steps: " +
              ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not "
                        "measured" for k, v in passes[name].items()))
    for r in rows:
        check_bound(f"depthwise_conv3x3_wgrad {r['shape']}", {
            k: r.get(k) for k in ("ms", "plain_ms", "library_ms",
                                  "device_ms", "library_device_ms")},
            r["bound_ms"])
        p = dwk.wgrad_plan(*r["shape"])
        r["layout"] = {"blocks": p.blocks, "clusters": p.n_clusters,
                       "cluster": p.cluster, "per_thread": p.per_thread,
                       "clusters_held": dwk.wgrad_clusters_held(*r["shape"])}
        print(f"  time depthwise_conv3x3_wgrad {str(r['shape']):20s} kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f}  library "
              f"{r['library_ms']:.4f}  bound {r['bound_ms']:.5f}" + "".join(
                  f"  {k[:-10] or 'kernel'} device {1e3 * r[k]:.2f} us"
                  for k in ("device_ms", "library_device_ms",
                            "floor_device_ms") if r.get(k) is not None)
              + f"  ({p.blocks} blocks, {p.n_chunks} x {p.n_clusters} "
              f"clusters of {p.cluster}, {p.per_thread} tiles a block; the "
              f"card holds {r['layout']['clusters_held']} such clusters)")
    timed = [r for r in rows if r.get("device_ms") is not None
             and r.get("library_device_ms") is not None]
    faster = sum(r["device_ms"] < r["library_device_ms"] for r in timed)
    print(f"  T4 dw kernel faster than cuDNN's weight gradient (device "
          f"time, one window): {faster} of {len(timed)} shapes measured")
    for name in passes:
        check_bound(f"dw pass {name}", {
            k: passes[name][k] for k in ("dw_ms", "plain_dw_ms",
                                         "library_dw_ms")},
            passes[name]["dw_bound_ms"])

    # one training step: wall (median of the run's steps after the first),
    # device busy, idle share and top kernels from one profiled step
    steps_report = {}
    for name, b in TRAIN_NETS:
        net = resumed[name][0]
        step = loop.make_xr_step(net, loss_fns[name],
                                 optim.cosine_schedule(3e-3, 1, 1))
        opt = optim.adamw_init(dict(net.named_parameters()))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data[name][0][0].items()}
        fp, by_name = wall_profile(lambda: step(opt, batch, 0), reps=3,
                                   expect={"dw3x3_kernel": 26,
                                           "dw3x3_wgrad": 13})
        times = runs[name][2]
        fp["step_wall_ms"] = 1e3 * statistics.median(times[1:])
        busy = fp["device_busy_ms"]
        if by_name:
            for key in ("dw3x3_kernel", "dw3x3_wgrad"):
                us = sum(v for k, v in by_name.items() if key in k)
                fp[f"{key}_us"] = us
                fp[f"{key}_share"] = us / 1e3 / busy
        steps_report[name] = fp
        print(f"  training step {name} b{b}: wall {fp['step_wall_ms']:.3f} ms "
              f"(median of steps 2-{TRAIN_STEPS} in run_xr_training; "
              f"{fp['wall_ms']:.3f} ms alone), device busy " +
              ("not measured" if busy is None else
               f"{busy:.3f} ms, idle share {fp['idle_share']:.3f}, "
               f"depthwise forward+dx {fp.get('dw3x3_kernel_us', 0):.1f} us "
               f"({100 * fp.get('dw3x3_kernel_share', 0):.1f}%), dw "
               f"{fp.get('dw3x3_wgrad_us', 0):.1f} us "
               f"({100 * fp.get('dw3x3_wgrad_share', 0):.1f}%)"))
        for kname, us in fp["top_kernels_us"]:
            print(f"    {us:9.1f} us  {kname[:90]}")
    report["train_steps"] = steps_report
    report["train_dw_passes"] = passes
    report["train_wgrad_times"] = rows

    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")}
    dev_ms = [passes[n]["dw_ms"] for n, _ in TRAIN_NETS]
    lib_ms = [passes[n]["library_dw_ms"] for n, _ in TRAIN_NETS]
    plain_ms = [passes[n]["plain_dw_ms"] for n, _ in TRAIN_NETS]
    entry = {
        "name": "depthwise_conv3x3_wgrad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/depthwise_conv.cu",
        "replaces": "none: no TPU kernel (the reference lets XLA transpose "
                    "lax.conv, src/repro/models/xr.py:222)",
        "launches": launches["depthwise_conv3x3_wgrad"],
        "max_abs_err": err, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
        "device_ms": None if None in dev_ms else sum(dev_ms),
        "plain_device_ms": None if None in plain_ms else sum(plain_ms),
        "library_device_ms": None if None in lib_ms else sum(lib_ms)}
    return entry, {name: runs[name][0] for name, _ in TRAIN_NETS}


# -- slice 11: the paper's pipeline, step 4 and the calibration gate ----------
# the paper's claims for P1 (VGSOT MRAM for every weight and activation
# level) at 7 nm, on the one-silicon (suite-sized) design of its Tables 2-3:
# memory power saved at each net's IPS_min on Simba, area saved on both
# systolic accelerators
PP_SAVINGS, PP_AREA = 0.24, 0.30
PP_NODE = 7


def pipeline_slice(dev, report, nets, samples):
    """Slice 11: the paper's four steps end to end. PP1 gates the
    calibration corners that the XR path ran (``samples``) against the
    committed refit (``harness.check``). PP2 takes the nets T2 trained
    (DetNet b8, EDSNet b4, full width), quantizes them and runs one INT8
    forward each on the card (13 depthwise launches a forward), extracts the
    trained configs' layer specs and prices them in the port's numpy plane
    (``core``): SRAM against P0/P1 on Simba and Eyeriss at 7 nm. The priced
    energies, powers, latencies and areas are the model's estimates for
    those accelerators, not measurements of this card."""
    import torch
    from repro_torch.calibrate import harness
    from repro_torch.core import dse, nvm
    from repro_torch.core import experiment as xp
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import xr
    from repro_torch.quant import ptq

    # -- PP1. the calibration gate -----------------------------------------
    data = harness.calibration_data(samples, dev)
    fails = harness.check(data=data)
    gate = Path(harness.CALIB_PATH).name
    check(not fails, f"PP1 calibration gate against {gate}: {fails}")
    print(f"PP1 calibration gate: green against {gate} (constants "
          f"{data['constants']})")

    # -- PP2. PTQ on the card, then specs and pricing ----------------------
    det, eds = nets["detnet"].cfg, nets["edsnet"].cfg
    frames = {"detnet": next(synthetic.fphab_batches(
                  8, det.input_hw, det.in_channels, seed=1))[0]["image"],
              "edsnet": next(synthetic.openeds_batches(
                  4, eds.input_hw, seed=1))[0]["image"]}
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    outs = {}
    for name, net in nets.items():
        qp = ptq.quantize_params(dict(net.named_parameters()))
        check(all(bool(torch.isfinite(v).all()) for v in qp.values()),
              f"PP2 {name}: quantized weights not finite")
        outs[name], _ = ptq.forward_int8(
            net, torch.from_numpy(frames[name]).to(dev))
    torch.cuda.synchronize()
    t_ptq = time.perf_counter() - t
    launches = ops.launches()
    check(launches["depthwise_conv3x3"] == 13 * len(nets),
          f"PP2 INT8 forwards: launches {launches}, not 13 depthwise each")
    for name, out in outs.items():
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"PP2 {name} {k} not "
                  "finite")
    print(f"PP2 INT8 PTQ of the trained nets on the card: {t_ptq:.3f} s, "
          f"launches {launches}")

    t = time.perf_counter()
    ev = xp.Evaluator()
    priced = {}
    for name, net in nets.items():
        specs = xr.conv_layer_specs(net.cfg)
        check(specs == ev.specs(name), f"PP2 {name}: the trained config's "
              "specs are not the ones the paper's tables price")
        ips = xp.IPS_MIN[name]
        for arch in xp.SYSTOLICS:
            reps = {v: dse.evaluate(specs, arch, PP_NODE, v)
                    for v in ("sram", "p0", "p1")}
            for v, r in reps.items():
                row = {"memory_power_uw": nvm.memory_power_w(r, ips) * 1e6,
                       "savings": nvm.savings_at_ips(r, reps["sram"], ips),
                       "latency_ms": r.latency_s * 1e3}
                priced[f"{name} {arch} {v}"] = row
                print(f"  PP2 modelled {arch} at {PP_NODE} nm, {name}'s "
                      f"{len(specs)} layers (buffers sized for it alone), "
                      f"{ips} IPS, {v}: memory power "
                      f"{row['memory_power_uw']:.3f} uW, savings "
                      f"{row['savings']:+.4f}, latency "
                      f"{row['latency_ms']:.4f} ms")
    table2 = xp.table2_rows(ev, node=PP_NODE)
    table3 = xp.table3_rows(ev, node=PP_NODE)
    t_price = time.perf_counter() - t
    simba3 = [r for r in table3 if r["arch"] == "simba"]
    check(len(simba3) == 2 and {r["arch"] for r in table2}
          == set(xp.SYSTOLICS), "PP2: the tables lack a row")
    for r in table3 + table2:
        print(f"  PP2 modelled, one silicon: {json.dumps(r)}")
    for r in simba3:
        check(r["p1_savings"] >= PP_SAVINGS, f"PP2 {r['workload']} on "
              f"Simba: P1 saves {r['p1_savings']} of the memory power at "
              f"IPS_min, under {PP_SAVINGS}")
    for r in table2:
        check(r["p1_savings"] >= PP_AREA, f"PP2 {r['arch']}: P1 saves "
              f"{r['p1_savings']} of the area, under {PP_AREA}")
    print(f"PP2 pricing in numpy on the host: {t_price:.3f} s; modelled P1 "
          f"memory power savings at IPS_min on Simba "
          f"{[r['p1_savings'] for r in simba3]} (>= {PP_SAVINGS}), area "
          f"savings {[r['p1_savings'] for r in table2]} (>= {PP_AREA})")
    report["pipeline"] = {
        "gate": {"path": gate, "fails": fails,
                 "constants": data["constants"],
                 "residuals": data["residuals"]},
        "launches": launches, "ptq_s": t_ptq, "price_s": t_price,
        "priced": priced, "table2": table2, "table3": table3}


# -- slice 6: LM training ----------------------------------------------------
LT_ARCHS = {"llama3.2-1b": 2, "mamba2-1.3b": 1}   # batch at S = LM_S; Mamba
                                 # cut to 1: at B=2 its step needs more than
                                 # the card's 80 GB (CUDA out of memory)
LT_STEPS = 10
LT_LR = 3e-4                     # launch/train's default
LT_DIMS_SHAPE = (2, 8, 2, LM_RAGGED_S)   # (B, H, K, S) of the head-dim cases
# the backward kernels against the plain backward in f32 on the same
# (upcast) inputs, element by element: FLASH_TOL times each gradient's
# magnitude (its sums over |terms|: a sum's rounding is bounded by its
# terms, not its value, and dS cancels in dP - delta), + 2^-8 (|value| +
# magnitude) in bf16 for the output rounding and the tensor-core route's
# P and dS rounded to bf16 as operands (ref.flash_bwd_limit); f32 (the
# CUDA-core route) within FLASH_TOL alone; the scan's dstates bit-equal, its
# ddecay within SCAN_BWD_TOL of sum |lam s| off the f64 sum
SCAN_BWD_TOL = 1e-6
# LT3: one step at one repeat, full width, f32, (B, S) small enough for an
# f64 evaluation on the CPU (Llama's S ragged for the flash tiles, Mamba's
# two 256-token chunks so that the scan carries a state)
LT_TWIN = {"llama3.2-1b": (1, 300), "mamba2-1.3b": (1, 512)}
LT_RESUME_STEPS, LT_CKPT_EVERY = 6, 3
# kernel names in profiles, and launches per wrapper call
# (the bf16 routes: LT2-LT5 train and time in bf16)
LT_CNAMES = {"flash_attention": ("flash_tc_kernel",),
             "flash_attention_bwd": ("flash_bwd_delta_tc",
                                     "flash_bwd_dkdv_tc", "flash_bwd_dq_tc"),
             "ssd_chunk_scan": ("ssd_scan_kernel",),
             "ssd_chunk_scan_bwd": ("ssd_scan_bwd_kernel",
                                    "ssd_scan_bwd_reduce")}
LT_KERNELS = {"llama3.2-1b": ("flash_attention", "flash_attention_bwd"),
              "mamba2-1.3b": ("ssd_chunk_scan", "ssd_chunk_scan_bwd")}


def lm_train_slice(dev, gen, report):
    """Slice 6: LM training of full-width, full-depth Llama-3.2-1B and
    Mamba-2-1.3B through ``launch.train.train``, the attention and the SSD
    scan forward and backward on the kernels (LT1-LT5). Returns the
    kernels-line entries of flash_attention_bwd and ssd_chunk_scan_bwd."""
    import dataclasses
    import math
    import shutil

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as ltrain
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.params import flatten, unflatten
    from repro_torch.train import loop, optim

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- LT1. the kernels against their plain versions -----------------------
    llama, mcfg = get_config("llama3.2-1b"), get_config("mamba2-1.3b")
    H, Kv, D = llama.num_heads, llama.num_kv_heads, llama.head_dim
    err = {"flash_attention_bwd": 0.0, "ssd_chunk_scan_bwd": 0.0}
    cases = [(LM_B, H, K, S, D) for S in (LM_S, LM_RAGGED_S) for K in (Kv, H)]
    cases += [(*LT_DIMS_SHAPE[:3], LT_DIMS_SHAPE[3], d) for d in fak.HEAD_DIMS
              if d != D]
    worst = {}
    for B, Hh, K, S, d in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(B, S, h, d, generator=gen).to(dev, dt)
                           .transpose(1, 2) for h in (Hh, K, K, Hh))
            for causal in (True, False):
                o, lse = fak.flash_attention(q, k, v, causal, with_lse=True)
                o2 = fak.flash_attention(q, k, v, causal)   # no lse written
                want = ref.flash_attention(q.float(), k.float(), v.float(),
                                           causal)
                lim = (ref.flash_bf16_limit(want, q, k, v, causal, FLASH_TOL)
                       if dt == torch.bfloat16
                       else FLASH_TOL * (1 + want.abs()))
                over = float(((o.float() - want).abs() - lim).max())
                e_lse = max_err(lse, ref.flash_attention_lse(
                    q.float(), k.float(), causal))
                got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
                again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
                torch.cuda.synchronize()
                want_g = ref.flash_attention_bwd(
                    q.float(), k.float(), v.float(), o.float(), lse,
                    do.float(), causal)
                lims = ref.flash_bwd_limit(want_g, q, k, v, o, lse, do,
                                           causal, FLASH_TOL,
                                           dt == torch.bfloat16)
                what = (f"B={B} H={Hh} K={K} S={S} D={d} {str(dt)[6:]} "
                        f"causal={causal}")
                check(over <= 0, f"flash_attention {what}: an element is "
                      f"{over} over its bound")
                check(torch.equal(o, o2), f"flash_attention {what}: the "
                      "forward with and without the log-sum-exp differ")
                check(e_lse <= FLASH_TOL * (1 + float(lse.abs().max())),
                      f"flash_attention {what}: log-sum-exp off by {e_lse}")
                overs, ratios = [], []
                for name, g, a, w, lm_ in zip("qkv", got, again, want_g,
                                              lims):
                    check(torch.equal(g, a), f"flash_attention_bwd {what}: "
                          f"d{name} differs in bits between two calls")
                    overs.append(float(((g.float() - w).abs() - lm_).max()))
                    ratios.append(float(((g.float() - w).abs() / lm_).max()))
                    check(overs[-1] <= 0, f"flash_attention_bwd {what}: a "
                          f"d{name} element is {overs[-1]} over its bound")
                e = max(max_err(g, w) for g, w in zip(got, want_g))
                if (B, Hh, K, S, d, dt, causal) == (LM_B, H, Kv, LM_S, D,
                                                    torch.bfloat16, True):
                    err["flash_attention_bwd"] = e     # the main path's call
                worst[what] = {"fwd_over": over, "lse_err": e_lse,
                               "bwd_over": overs, "bwd_of_bound": ratios,
                               "bwd_max_abs_err": e}
                print(f"  LT1 flash {what}: forward {over:.3g} under/over "
                      f"its bound, lse err {e_lse:.3g}; backward max abs "
                      f"err {e:.3g}, bound margins "
                      + ", ".join(f"{x:.3g}" for x in overs)
                      + ", worst element at "
                      + ", ".join(f"{x:.3g}" for x in ratios)
                      + " of its bound (dq, dk, dv)")
                del o, o2, lse, want, lim, got, again, want_g, lims
    report["lt1_flash"] = worst
    scan_shapes = [(b, LM_S // mcfg.ssm_chunk, mcfg.ssm_heads,
                    mcfg.ssm_head_dim, mcfg.ssm_state)
                   for b in sorted({LM_B, LT_ARCHS["mamba2-1.3b"]})]
    for shape in scan_shapes:
        for dt in (torch.float32, torch.bfloat16):
            st = torch.randn(shape, generator=gen).to(dev, dt)
            dc = torch.rand(shape[:3], generator=gen).to(dev)
            g = torch.randn(shape, generator=gen).to(dev, dt)
            out = ops.ssd_chunk_scan(st, dc)
            ds, dd = ops.ssd_chunk_scan_bwd(g, out, dc)
            ds2, dd2 = ops.ssd_chunk_scan_bwd(g, out, dc)
            torch.cuda.synchronize()
            check(torch.equal(ds, ds2) and torch.equal(dd, dd2),
                  f"ssd_chunk_scan_bwd {shape} {dt}: two calls differ")
            wds, wdd = ref.ssd_chunk_scan_bwd(g, out, dc)
            check(torch.equal(ds, wds), f"ssd_chunk_scan_bwd {shape} {dt}: "
                  "dstates not bit-equal to the plain reverse scan")
            exact = ref.ssd_chunk_scan_bwd(g.double(), out.double(),
                                           dc.double())[1]
            mag = ref.ssd_chunk_scan_bwd(g.double().abs(), out.double().abs(),
                                         dc.double())[1]
            off = float(((dd.double() - exact).abs()
                         / mag.clamp_min(1e-300)).max())
            check(off <= SCAN_BWD_TOL, f"ssd_chunk_scan_bwd {shape} {dt}: "
                  f"ddecay {off} of its magnitude off the f64 sum")
            if dt == torch.float32 and shape[0] == LT_ARCHS["mamba2-1.3b"]:
                err["ssd_chunk_scan_bwd"] = max(max_err(ds, wds),
                                                max_err(dd, wdd))
            print(f"  LT1 ssd_chunk_scan_bwd {shape} {str(dt)[6:]}: dstates "
                  f"bit-equal, ddecay {off:.3g} of sum |lam s| off f64, "
                  "the same bits twice")
    print(f"LT1 backward kernels vs plain: {len(cases) * 4} flash cases "
          f"(forward, log-sum-exp and dq/dk/dv within their bounds, the "
          f"same bits twice, the forward the same bits with and without "
          f"the log-sum-exp; head dims {fak.HEAD_DIMS}), "
          f"{len(scan_shapes) * 2} scan cases")

    # -- LT2. the main path: full-width, full-depth training, counted ------
    # (each model's step is timed, LT5, while it is on the card: one model
    # at a time, Mamba at B=1 needs ~50 GB)
    launched, steps_report = {}, {}
    for i, (arch, B) in enumerate(LT_ARCHS.items()):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        counts = []
        res = ltrain.train(cfg, steps=LT_STEPS, batch=B, seq=LM_S, lr=LT_LR,
                           device=dev, seed=SEED + 40 + i, log_every=5,
                           heartbeat=lambda s, t: counts.append(
                               dict(ops.launches())))
        params = res.params
        torch.cuda.synchronize()
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fwd_k, bwd_k = LT_KERNELS[arch]
        n = cfg.num_layers
        before = {k: 0 for k in launches}
        for j, now in enumerate(counts):
            diff = {k: now[k] - before[k] for k in now}
            check(diff == {**{k: 0 for k in now}, fwd_k: n, bwd_k: n},
                  f"{arch} step {j}: launches {diff}, not {n} {fwd_k} and "
                  f"{n} {bwd_k}")
            before = now
        for name in LT_KERNELS[arch]:
            check(launches[name] == LT_STEPS * n, f"{arch}: {name} launched "
                  f"{launches[name]} times in {LT_STEPS} steps")
        check(len(res.losses) == LT_STEPS
              and all(map(math.isfinite, res.losses)),
              f"{arch}: losses {res.losses}")
        for k, p in flatten(params).items():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{arch} {k}: gradient missing or not finite")
        # the same batch twice: its loss drops after one step (the
        # full-width twin of tests/test_smoke_archs.py's)
        step = loop.make_lm_step(cfg, params, lambda s: 1e-3)
        opt = optim.adamw_init(flatten(params))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
            synthetic.token_batches(B, LM_S, cfg.vocab_size, seed=7))[0]
            .items()}
        opt, m0 = step(opt, batch, 0)
        opt, m1 = step(opt, batch, 1)
        l0, l1 = float(m0["loss"]), float(m1["loss"])
        check(l1 < l0, f"{arch}: the same batch's loss did not drop after "
              f"one step ({l0} -> {l1})")
        launched[arch] = launches
        report[f"lm_train {arch}"] = {
            "batch": B, "seq": LM_S, "steps": LT_STEPS, "losses": res.losses,
            "step_s": res.step_s, "peak_gib": peak, "launches": launches,
            "same_batch_loss": [l0, l1]}
        print(f"LT2 {arch} B={B} S={LM_S} bf16: {LT_STEPS} steps, loss "
              f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, the same batch "
              f"{l0:.5f} -> {l1:.5f} after one step; {n} {fwd_k} + {n} "
              f"{bwd_k} launches a step; peak memory {peak:.2f} GiB")

        # LT5: one step's wall, device busy, idle share and kernel shares
        names = [c for k in LT_KERNELS[arch] for c in LT_CNAMES[k]]
        fp, by_name = wall_profile(lambda: step(opt, batch, S5_STEPS + 2),
                                   reps=2,
                                   expect={c: n for c in names})
        fp["step_wall_ms"] = 1e3 * statistics.median(res.step_s[1:])
        fp["peak_gib"] = peak
        busy = fp["device_busy_ms"]
        if by_name:
            for k in LT_KERNELS[arch]:
                us = sum(v for n_, v in by_name.items()
                         if any(c in n_ for c in LT_CNAMES[k]))
                fp[f"{k}_us_per_launch"] = us / n
                fp[f"{k}_share"] = us / 1e3 / busy
        steps_report[arch] = fp
        print(f"  LT5 training step {arch} B={B}: wall "
              f"{fp['step_wall_ms']:.3f} ms (median of steps 2-{LT_STEPS} in "
              f"launch.train; {fp['wall_ms']:.3f} ms alone), device busy " +
              ("not measured" if busy is None else
               f"{busy:.3f} ms, idle share {fp['idle_share']:.3f}, " +
               ", ".join(f"{k} {fp[f'{k}_us_per_launch']:.1f} us a launch "
                         f"({100 * fp[f'{k}_share']:.1f}%)"
                         for k in LT_KERNELS[arch])))
        for kname, us in fp["top_kernels_us"]:
            print(f"    {us:9.1f} us  {kname[:90]}")
        del params, res, step, opt, batch, m0, m1
        torch.cuda.empty_cache()
    report["lm_train_steps"] = steps_report

    # -- LT3. one step at one repeat, card against the CPU, f32 ------------
    lt3 = {}
    for i, arch in enumerate(LT_ARCHS):
        base = get_config(arch)
        c32 = dataclasses.replace(base, num_layers=lm.block_period(base),
                                  dtype="float32")
        B, S = LT_TWIN[arch]
        p0 = lm.init_params(c32, torch.Generator().manual_seed(SEED + 50 + i),
                            "cpu")
        tok = next(synthetic.token_batches(B, S, base.vocab_size, seed=3))[0]
        out = []
        for d, dt in ((dev, torch.float32), (torch.device("cpu"),
                                             torch.float32),
                      (torch.device("cpu"), torch.float64)):
            cfg = dataclasses.replace(c32, dtype=str(dt)[6:])
            params = {k: v.to(d, dt, copy=True)
                      for k, v in flatten(p0).items()}
            tree = unflatten(params)
            for p in params.values():
                p.requires_grad_(True)
            batch = {k: torch.from_numpy(v).to(d) for k, v in tok.items()}
            loss, _ = lm.lm_loss(cfg, tree, batch)
            loss.backward()
            out.append((float(loss.detach()), {k: p.grad.double().cpu()
                                      for k, p in params.items()}))
            del params, tree
        (lc, gc), (lh, gh), (l64, g64) = out
        gmax = max(float(g.abs().max()) for g in g64.values())

        def off(g):
            return max(float((g[k] - g64[k]).abs().max()) for k in g64)
        e_card, e_cpu = off(gc), off(gh)
        diff = max(float((gc[k] - gh[k]).abs().max()) for k in gh)
        check(e_card <= GRAD_K * e_cpu + GRAD_TOL * gmax, f"LT3 {arch}: the "
              f"card's gradients are {e_card} off the f64 ones, the CPU's "
              f"{e_cpu} (largest entry {gmax})")
        check(abs(lc - l64) <= GRAD_K * abs(lh - l64) + GRAD_TOL * abs(l64),
              f"LT3 {arch}: loss {lc} (card), {lh} (CPU), {l64} (f64)")
        lt3[arch] = {"loss_card": lc, "loss_cpu": lh, "loss_f64": l64,
                     "grad_off_f64_card": e_card / gmax,
                     "grad_off_f64_cpu": e_cpu / gmax,
                     "card_vs_cpu": diff / gmax}
        print(f"LT3 {arch} 1 repeat B={B} S={S} f32: loss card {lc} / CPU "
              f"{lh} / f64 {l64}; gradients off the f64 ones by "
              f"{e_card / gmax:.3g} (card) and {e_cpu / gmax:.3g} (CPU f32) "
              f"of the largest entry {gmax:.4g}; card vs CPU "
              f"{diff / gmax:.3g}")
        del out, gc, gh, g64
    report["lt3"] = lt3

    # -- LT4. checkpoint and resume at two repeats -------------------------
    ckpt_root = ROOT / "build" / "lm_ckpt"
    lt4 = {}
    for arch, B in LT_ARCHS.items():
        base = get_config(arch)
        cfg = dataclasses.replace(base, num_layers=2 * lm.block_period(base))
        d = ckpt_root / arch
        shutil.rmtree(d, ignore_errors=True)
        runs = []                                # (start, losses)
        for seed in (SEED + 60, SEED + 61):      # the second resumes
            torch.cuda.empty_cache()
            res = ltrain.train(
                cfg, steps=LT_RESUME_STEPS, batch=B, seq=LM_S, lr=LT_LR,
                ckpt_dir=str(d), ckpt_every=LT_CKPT_EVERY, device=dev,
                seed=seed, log_every=0)
            runs.append((res.start, res.losses))
            del res
            if len(runs) == 1:
                last = d / f"step_{LT_RESUME_STEPS:010d}"
                check(last.is_dir(), f"LT4 {arch}: no checkpoint at step "
                      f"{LT_RESUME_STEPS}")
                shutil.rmtree(last)
        (_, first), (start, again) = runs
        check(start == LT_CKPT_EVERY and again == first[LT_CKPT_EVERY:],
              f"LT4 {arch}: the resumed run (from {start}) took losses "
              f"{again}, the first {first[LT_CKPT_EVERY:]}")
        lt4[arch] = {"losses": first, "resumed": again}
        print(f"LT4 {arch} 2 repeats B={B}: steps {LT_CKPT_EVERY}-"
              f"{LT_RESUME_STEPS - 1} resumed from the step-{LT_CKPT_EVERY} "
              "checkpoint repeat the first run's losses bit for bit "
              "(deterministic algorithms off)")
        shutil.rmtree(d, ignore_errors=True)
    report["lt4"] = lt4

    # -- LT5. the kernels alone: kernel, plain version, library, bound -----
    def sdpa_bwd_call(q, k, v, do):
        """The backward of F.scaled_dot_product_attention alone (a graph
        made once, replayed): the flash backward's library yardstick."""
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        return lambda: torch.autograd.grad(y, (qs, ks, vs), do,
                                           retain_graph=True)

    def segsum_form(states, decay):
        cs = torch.log(decay).transpose(1, 2)
        dchunk = torch.exp(L._segsum(F.pad(cs, (1, 0))))
        allst = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
        return torch.einsum("bhzc,bchpn->bzhpn", dchunk, allst)[:, :-1]

    def segsum_bwd_call(st, dc, g):
        """The backward of the reference model's segsum-einsum form of the
        scan alone: the scan backward's yardstick (no library call)."""
        sa, da = st.clone().requires_grad_(), dc.clone().requires_grad_()
        y = segsum_form(sa, da)
        return lambda: torch.autograd.grad(y, (sa, da), g, retain_graph=True)

    def ms(busy):
        return None if busy is None else busy / 1e3

    q, k, v, do = (torch.randn(LM_B, LM_S, h, D, generator=gen).to(
        dev, torch.bfloat16).transpose(1, 2) for h in (H, Kv, Kv, H))
    o, lse = fak.flash_attention(q, k, v, True, with_lse=True)
    sdpa_bwd = sdpa_bwd_call(q, k, v, do)
    for a, b in zip(sdpa_bwd(), ops.flash_attention_bwd(q, k, v, o, lse,
                                                        do)):
        check(max_err(a, b) <= 5e-2 * float(b.float().abs().max()),
              "flash_attention_bwd disagrees with SDPA's backward")
    pairs = LM_B * H * LM_S * (LM_S + 1) // 2       # causal (q, k) pairs
    fb_ops_ms = 5 * 2 * D * pairs / BF16_OPS_PER_S * 1e3
    fb_bytes_ms = 2 * LM_B * LM_S * D * (4 * H + 4 * Kv) \
        / HBM_BYTES_PER_S * 1e3 + 4 * LM_B * H * LM_S / HBM_BYTES_PER_S * 1e3
    Bm = LT_ARCHS["mamba2-1.3b"]
    sshape = (Bm, LM_S // mcfg.ssm_chunk, mcfg.ssm_heads, mcfg.ssm_head_dim,
              mcfg.ssm_state)
    st = torch.randn(sshape, generator=gen).to(dev)
    dc = torch.rand(sshape[:3], generator=gen).to(dev) * 0.5 + 0.5
    gs = torch.randn(sshape, generator=gen).to(dev)
    so = ops.ssd_chunk_scan(st, dc)
    seg_bwd = segsum_bwd_call(st, dc, gs)
    check(max_err(seg_bwd()[0], ops.ssd_chunk_scan_bwd(gs, so, dc)[0])
          <= 1e-3, "ssd_chunk_scan_bwd disagrees with the segsum form's")
    n_el = st.numel()
    sb_bytes_ms = (4 * 3 * n_el + 4 * 2 * dc.numel()) / HBM_BYTES_PER_S * 1e3
    sb_ops_ms = 4 * n_el / FP32_OPS_PER_S * 1e3
    times = {}
    for name, fns, args, bound in (
            ("flash_attention_bwd",
             (ops.flash_attention_bwd, ref.flash_attention_bwd, sdpa_bwd),
             (q, k, v, o, lse, do), (fb_ops_ms, fb_bytes_ms)),
            ("ssd_chunk_scan_bwd",
             (ops.ssd_chunk_scan_bwd, ref.ssd_chunk_scan_bwd, seg_bwd),
             (gs, so, dc), (sb_ops_ms, sb_bytes_ms))):
        t = {}
        for label, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            a = () if label == "library_ms" else args
            t[label] = median_ms(fn, *a, inner=10)
            busy, by_name, _ = device_us(
                [(fn, a)], reps=3, expect={c: 1 for c in LT_CNAMES[name]}
                if label == "ms" else None)
            t[label.replace("ms", "device_ms")] = ms(busy)
            if label == "ms":                 # each launch of the kernel
                t["device_ms_by_kernel"] = {
                    c: ms(sum(u for n_, u in by_name.items() if c in n_))
                    if by_name else None for c in LT_CNAMES[name]}
        t.update(bound_ms=max(bound), ops_ms=bound[0], bytes_ms=bound[1],
                 bound_by="operations" if bound[0] >= bound[1] else "bytes")
        times[name] = t
    scan = times["ssd_chunk_scan_bwd"]
    scan["segsum_ms"] = scan.pop("library_ms")
    scan["segsum_device_ms"] = scan.pop("library_device_ms")
    scan["library_ms"] = scan["library_device_ms"] = None
    # per launch inside the training step, from its profile
    for name, arch in (("flash_attention_bwd", "llama3.2-1b"),
                       ("ssd_chunk_scan_bwd", "mamba2-1.3b")):
        fp = steps_report.get(arch, {})
        us = fp.get(f"{name}_us_per_launch")
        times[name]["step_device_ms"] = None if us is None else us / 1e3
    # the forward at every head dim: bf16, B=2, S=2048, 32 q / 8 kv heads
    fwd_dims = {}
    for d in fak.HEAD_DIMS:
        qd, kd, vd = (torch.randn(LM_B, LM_S, h, d, generator=gen).to(
            dev, torch.bfloat16).transpose(1, 2) for h in (H, Kv, Kv))
        row_d = {"ms": median_ms(ops.flash_attention, qd, kd, vd),
                 "device_ms": ms(device_us(
                     [(ops.flash_attention, (qd, kd, vd))], reps=3,
                     expect={"flash_tc_kernel": 1})[0]),
                 "with_lse_device_ms": ms(device_us(
                     [(lambda a, b, c: fak.flash_attention(
                         a, b, c, True, with_lse=True), (qd, kd, vd))],
                     reps=3, expect={"flash_tc_kernel": 1})[0]),
                 "bound_ms": 4 * d * pairs / BF16_OPS_PER_S * 1e3}
        check_bound(f"flash_attention D={d}", {
            k: row_d[k] for k in ("ms", "device_ms", "with_lse_device_ms")},
            row_d["bound_ms"])
        fwd_dims[d] = row_d
        print(f"  LT5 flash_attention forward D={d} bf16 B={LM_B} S={LM_S} "
              f"H={H} K={Kv}: event {row_d['ms']:.4f} ms, device " + (
                  "not measured" if row_d["device_ms"] is None else
                  f"{row_d['device_ms']:.4f} ms") + ", with the log-sum-exp "
              + ("not measured" if row_d["with_lse_device_ms"] is None else
                 f"{row_d['with_lse_device_ms']:.4f} ms")
              + f", bound {row_d['bound_ms']:.4f} ms")
    report["lm_fwd_dims"] = fwd_dims
    # the backward at every head dim, bf16 (the tensor-core route), the
    # same shapes, beside SDPA's backward kernels on the same inputs
    bwd_dims = {}
    for d in fak.HEAD_DIMS:
        qd, kd, vd, gd = (torch.randn(LM_B, LM_S, h, d, generator=gen).to(
            dev, torch.bfloat16).transpose(1, 2) for h in (H, Kv, Kv, H))
        od, ld = fak.flash_attention(qd, kd, vd, True, with_lse=True)
        args_d = (qd, kd, vd, od, ld, gd)
        sdpa_d = sdpa_bwd_call(qd, kd, vd, gd)
        row_d = {"ms": median_ms(ops.flash_attention_bwd, *args_d, inner=10),
                 "device_ms": ms(device_us(
                     [(ops.flash_attention_bwd, args_d)], reps=3,
                     expect={c: 1 for c in LT_CNAMES["flash_attention_bwd"]}
                 )[0]),
                 "library_device_ms": ms(device_us([(sdpa_d, ())],
                                                   reps=3)[0]),
                 "bound_ms": 5 * 2 * d * pairs / BF16_OPS_PER_S * 1e3}
        check_bound(f"flash_attention_bwd D={d}", {
            k: row_d[k] for k in ("ms", "device_ms", "library_device_ms")},
            row_d["bound_ms"])
        bwd_dims[d] = row_d
        print(f"  LT5 flash_attention_bwd D={d} bf16 B={LM_B} S={LM_S} "
              f"H={H} K={Kv}: event {row_d['ms']:.4f} ms, device " + (
                  "not measured" if row_d["device_ms"] is None else
                  f"{row_d['device_ms']:.4f} ms") + ", SDPA's backward "
              + ("not measured" if row_d["library_device_ms"] is None else
                 f"{row_d['library_device_ms']:.4f} ms")
              + f", operations bound {row_d['bound_ms']:.4f} ms")
        del qd, kd, vd, gd, od, ld, args_d, sdpa_d
    report["lm_bwd_dims"] = bwd_dims
    for name, t in times.items():
        check_bound(name, {k: v for k, v in t.items() if k.endswith("ms")
                           and k not in ("bound_ms", "ops_ms", "bytes_ms")},
                    t["bound_ms"])
        print(f"  LT5 time {name}: " + ", ".join(
            f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    report["lm_train_times"] = times

    meta = {"flash_attention_bwd": (
                "flash_attention.cu", "none: no TPU kernel (the reference's "
                "LM forward is jnp code that XLA differentiates, "
                "src/repro/models/layers.py:165)", "llama3.2-1b"),
            "ssd_chunk_scan_bwd": (
                "ssd_scan.cu", "none: no TPU kernel (XLA differentiates the "
                "reference's segsum einsum, src/repro/models/layers.py:472)",
                "mamba2-1.3b")}
    entries = []
    for name, (src, replaces, arch) in meta.items():
        t = times[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launched[arch][name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"],
            "step_device_ms": t["step_device_ms"]})
    for k in ("segsum_ms", "segsum_device_ms"):
        entries[1][k] = times["ssd_chunk_scan_bwd"][k]
    return entries


# -- slice 9: the dense and MoE decoders ----------------------------------
# deepseek-7b, yi-34b, gemma2-9b, mixtral-8x7b, grok-1-314b at full width.
# Depth is cut only where one card's 80 GB forces it: mixtral-8x7b (46.7 B
# parameters, 93 GB in bf16) to 8 layers, grok-1-314b (6.5 B a layer with
# its embedding) to 1. yi-34b (68.8 GB) runs at full depth and fails the run
# if it does not fit. Weights are drawn on the card from a seeded card
# generator.
ARCHS9 = ("deepseek-7b", "gemma2-9b", "yi-34b", "mixtral-8x7b",
          "grok-1-314b")
ARCH_LAYERS = {"mixtral-8x7b": 8, "grok-1-314b": 1}
ARCH_S = 8192                    # prefill and training: twice the window
# S1: the flash kernels with windows and softcaps against autograd of the
# plain version, (D, G, window, softcap): every (head dim, group) of the five
# configs at 2 kv heads, each with its config's masks (gemma2 local and
# global, mixtral's window, grok's cap) and the window-and-cap pair on
# deepseek's and yi's shapes; S below, at and above the window, ragged, 2x.
# Then every attention layer kind of the five on the main path (B=1, the
# configs' own head counts, bf16; ``_main_attn``) at S=ARCH_S and at its
# config's training S.
S1_ATTN = ((128, 1, 4096, 30.0), (128, 4, 4096, 0.0), (128, 6, 0, 30.0),
           (128, 7, 4096, 50.0), (256, 2, 4096, 50.0), (256, 2, 0, 50.0))
S1_S, S1_K = (2048, 4096, 4097, 8192), 2
HOLD_HEADS = 8                   # query heads a plain-version call holds
# the kernels line's windowed entries: a gemma2 local layer and a mixtral
# layer on the main path (B=1, S=ARCH_S)
ARCH_ENTRIES = {"gemma2-9b": (16, 8, 256, 4096, 50.0),
                "mixtral-8x7b": (32, 8, 128, 4096, 0.0)}
# S2 holds each served token to the teacher-forced forward's argmax
# wherever the forward's top-2 margin is at least S2_TIE[dtype] times
# max(1, max|logit|) of the request, and at least S2_LEAST[moe] of the
# served tokens must be checked so. The dense configs: the main path's own
# bf16 server at full depth (in development calls its tokens parted from
# the forward's argmax at margins of at most 0.031 x the scale). The MoE
# configs: a second server on the same weights in f32, as bf16 noise moves
# their router logits across far more than a near-tie (its logits sat
# within 2.4e-3 x the scale of the forward's); a request's positions from
# its first assignment that either run dropped (the batch's capacity drops
# tokens by who shares the batch) or routed otherwise on are left out
S2_TIE = {"bfloat16": 0.05, "float32": 5e-3}
S2_LEAST = {False: 0.25, True: 0.1}
# S3 (card vs CPU) and S4 (the ring) run the first repeat of S2's gemma2
# and mixtral, in f32
S3_S = (300,)                    # ragged for the flash tiles
S4_LEN = 4096 + 128              # decoded positions: the ring wraps at 4096
# S4 threshold, fixed in advance: the batch-1 decode's logits within
# REF_GAP (f32) of the windowed forward's at every compared position, as
# the one-repeat serving checks hold decode against prefill
S4_GAP = 1e-2
# MoE routes on two paths (card vs CPU, decode vs forward) may part only at
# a near-tie: the k-th and (k+1)-th probabilities of the token within
# ROUTE_TIE (relative); such tokens, and tokens a forward dropped at its
# capacity, are left out of the logits comparison, at most ROUTE_LEAST
ROUTE_TIE, ROUTE_LEAST = 1e-4, 0.01
S4_LEAST = 0.5                   # positions S4 must compare, at least
# S5 trains one repeat (a second does not fit: about 24 bytes a parameter
# of weights, gradients, f32 AdamW moments and the update's copies) at
# B=1, S=ARCH_S
S5_ARCHS, S5_STEPS = ("gemma2-9b", "mixtral-8x7b"), 5
# attention kernels of PyTorch that must not appear on the main path
LIB_ATTN = ("fmha", "pytorch_flash", "efficient_attention", "flash::")


def _visible_pairs(S, window, causal=True):
    """(q, k) pairs an attention computes: S^2 without the causal mask;
    causal, the sum over rows of min(q + 1, window) (window 0: the full
    triangle)."""
    if not causal:
        return S * S
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_bounds(B, H, K, S, D, window, causal=True):
    """(forward, backward) bounds in ms: operations (4 and 10 B H D per
    visible pair, the bf16 tensor cores) against bytes (q, k, v, o once;
    the backward also dO, dq, dk, dv, lse), the larger of the two."""
    pairs = B * H * _visible_pairs(S, window, causal)
    f_ops = 4 * D * pairs / BF16_OPS_PER_S * 1e3
    b_ops = 10 * D * pairs / BF16_OPS_PER_S * 1e3
    f_bytes = 2 * B * S * D * (2 * H + 2 * K) / HBM_BYTES_PER_S * 1e3
    b_bytes = (2 * B * S * D * (4 * H + 4 * K) + 4 * B * H * S) \
        / HBM_BYTES_PER_S * 1e3
    return ({"bound_ms": max(f_ops, f_bytes), "ops_ms": f_ops,
             "bytes_ms": f_bytes,
             "bound_by": "operations" if f_ops >= f_bytes else "bytes"},
            {"bound_ms": max(b_ops, b_bytes), "ops_ms": b_ops,
             "bytes_ms": b_bytes,
             "bound_by": "operations" if b_ops >= b_bytes else "bytes"})


def _route_np(probs, topk):
    """The reference's dispatch in numpy from a (T, E) f32 probability
    array: stable descending order (the lower expert first on ties), the
    token-major exclusive count of each expert's assignments."""
    import numpy as np
    eidx = np.argsort(-probs, axis=-1, kind="stable")[:, :topk]
    flat = eidx.reshape(-1)
    onehot = np.eye(probs.shape[1], dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    return eidx, pos


def _near_tie(probs, topk):
    """Tokens two of whose top topk+1 probabilities, next in order, are
    within ROUTE_TIE of the larger (relative): a route, or the order of its
    experts, that may part between two paths."""
    return _route_gap(probs, topk) <= ROUTE_TIE


def _route_gap(probs, topk):
    """The least relative gap between probabilities next in order among
    each token's top topk+1 (T, E) -> (T,)."""
    import numpy as np
    p = np.sort(probs, axis=-1)[:, ::-1][:, :topk + 1]
    return ((p[:, :-1] - p[:, 1:]) / p[:, :-1]).min(-1)


def _flex(window, cap, S, dev):
    """flex_attention with a tanh softcap score_mod and a causal window
    block mask, compiled: one PyTorch call computing the windowed,
    softcapped kernel's function (timed beside it, never called by the
    port)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx
        return ok & (kv_idx > q_idx - window) if window else ok
    import torch._dynamo
    # one static compile per shape and score_mod: past the default limit of
    # 8, dynamo would run flex_attention eagerly (its math path), and a
    # recompile with dynamic shapes fails to lower ("unbacked_bindings")
    torch._dynamo.config.cache_size_limit = 64
    bm = create_block_mask(mask_mod, None, None, S, S, device=dev)
    cf = torch.compile(flex_attention, dynamic=False)

    def fn(q, k, v):
        return cf(q, k, v, score_mod=score_mod, block_mask=bm,
                  enable_gqa=True)
    return fn


def _routed(fn, *args, **kw):
    """fn(*args) with every MoE dispatch's probabilities (T, E), experts
    (T, topk), slots (T*topk,) and capacity recorded, in call order."""
    from repro_torch.models import layers as L
    rec, route = [], L.moe_route

    def rfn(c, logits):
        out = route(c, logits)
        rec.append((out[0].double().cpu().numpy(), out[2].cpu().numpy(),
                    out[3].cpu().numpy(), out[4]))
        return out
    L.moe_route = rfn
    try:
        return fn(*args, **kw), rec
    finally:
        L.moe_route = route


def _widen(tree):
    """Every tensor of a nested dict to f32, in place, one at a time."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _widen(v)
        else:
            tree[k] = v.float()


def _serve_recorded(cfg, params, dev):
    """``serve.serve`` of the main path's requests (SERVE_REQUESTS, batch
    SERVE_BATCH) with each engine step recorded: its slots' request uids
    and positions, its logits and its MoE dispatches. Returns (finished
    requests, seconds, steps, every dispatch)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    steps, refill, decode = [], ServeEngine._refill, lm.decode_step

    def rrefill(self):
        refill(self)
        steps.append({"uids": [s and s.req.uid for s in self.slots],
                      "pos": [s and s.pos for s in self.slots]})

    def rdecode(*args, **kw):
        logits, cache = decode(*args, **kw)
        steps[-1]["logits"] = logits
        return logits, cache
    ServeEngine._refill, lm.decode_step = rrefill, rdecode
    try:
        (done, secs), routes = _routed(
            serve.serve, cfg, params, serve.make_requests(
                cfg, SERVE_REQUESTS, SERVE_NEW, seed=SEED),
            batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ, device=dev)
    finally:
        ServeEngine._refill, lm.decode_step = refill, decode
    steps = [st for st in steps if "logits" in st]
    n = len(routes) // len(steps)           # MoE layers a step
    for j, st in enumerate(steps):
        st["routes"] = routes[j * n:(j + 1) * n]
    return done, secs, steps, routes


def _forward_rows(cfg, params, seq, dev):
    """The teacher-forced forward's logits over ``seq`` (S,) and its MoE
    dispatches (``_routed``)."""
    import torch
    from repro_torch.models import lm
    with torch.no_grad():
        (rows, _), frt = _routed(lm.forward, cfg, params,
                                 torch.from_numpy(seq)[None].to(dev))
    return rows[0], frt


def _served_vs_forward(cfg, params, done, steps, dev, what,
                       teacher=_forward_rows, tie=None, least=None):
    """Hold a recorded server run (``_serve_recorded``) to the
    teacher-forced forward (or another ``teacher(cfg, params, seq, dev)``
    giving (logits rows, MoE dispatches)) over each request's prompt and
    served tokens: each served token must be the forward's argmax wherever
    the forward's top-2 margin is at least ``tie`` (S2_TIE[dtype]) x
    max(1, max|logit|) of its request, and at least ``least`` (S2_LEAST)
    of the served tokens must be checked so.
    With MoE, a request's positions from the first assignment that either
    run dropped at its capacity (the server's is the batch's, so who shares
    the batch decides), or that the two routed otherwise (allowed only at a
    near-tie, ``_near_tie``), on are left out. Returns the counts, the
    largest gap between the two runs' logits (relative to the scale) and
    each compared token's margin, agreement and gap."""
    import numpy as np
    import torch
    at = {}        # (uid, position) -> (logits row, its dispatch per layer)
    for st in steps:
        for i, (uid, pos) in enumerate(zip(st["uids"], st["pos"])):
            if uid is not None:
                at[uid, pos] = (st["logits"][i], [
                    (e[i], sl.reshape(len(e), -1)[i], C)
                    for _, e, sl, C in st["routes"]])
    out = {"tokens": 0, "compared": 0, "checked": 0, "max_gap_rel": 0.0,
           "left_out_dropped": 0, "left_out_parted": 0, "parted_ties": [],
           "compared_tokens": []}
    tie = S2_TIE[cfg.dtype] if tie is None else tie
    for r in done:
        seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1],
                                                   np.int32)])
        first = len(r.prompt) - 1
        rows, frt = teacher(cfg, params, seq, dev)
        end, why = len(seq), None          # positions [first, end) compared
        for p in range(len(seq)):
            srv = at[r.uid, p][1]
            if any((sl >= C).any() for _, sl, C in srv) or any(
                    (fs.reshape(len(seq), -1)[p] >= C).any()
                    for _, _, fs, C in frt):
                end, why = p, "dropped"
                break
            parted = [j for j, ((es, _, _), (_, fe, _, _)) in enumerate(
                zip(srv, frt)) if not np.array_equal(es, fe[p])]
            if parted:                     # the first layer: the others follow
                probs = frt[parted[0]][0][p:p + 1]
                out["parted_ties"].append(float(_route_gap(
                    probs, cfg.experts_per_token)[0]))
                check(bool(_near_tie(probs, cfg.experts_per_token)[0]),
                      f"{what} request {r.uid} position {p} layer "
                      f"{parted[0]}: the server routes otherwise than the "
                      "forward away from a near-tie")
                end, why = p, "parted"
                break
        n_out = len(r.out_tokens)
        out["tokens"] += n_out
        n_cmp = max(0, end - first)
        if why:
            out[f"left_out_{why}"] += n_out - n_cmp
        if not n_cmp:
            continue
        fw = rows[first:end].float()
        sv = torch.stack([at[r.uid, p][0] for p in range(first, end)]).float()
        scale = max(1.0, float(fw.abs().max()))
        gaps = ((sv - fw).abs().amax(-1) / scale).cpu()
        top2 = torch.topk(fw, 2, dim=-1)
        margin = ((top2.values[:, 0] - top2.values[:, 1]) / scale).cpu()
        argmax = top2.indices[:, 0].cpu()
        for j in range(n_cmp):
            same = int(argmax[j]) == r.out_tokens[j]
            out["compared_tokens"].append((r.uid, j, float(margin[j]), same,
                                           float(gaps[j])))
            if float(margin[j]) >= tie:
                check(same, f"{what} request {r.uid} token {j}: served "
                      f"{r.out_tokens[j]}, the forward's argmax "
                      f"{int(argmax[j])} at a margin of {float(margin[j])} "
                      f"x {scale} (near-tie threshold {tie} x it)")
                out["checked"] += 1
        out["max_gap_rel"] = max(out["max_gap_rel"], float(gaps.max()))
        out["compared"] += n_cmp
    if least is None:
        least = S2_LEAST[bool(cfg.num_experts)]
    check(out["checked"] >= least * out["tokens"], f"{what}: only "
          f"{out['checked']} of {out['tokens']} served tokens checked "
          f"against the forward (margins under {tie} x the scale)")
    return out


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _qkvo(gen, dev, B, H, K, S, D, dt):
    """q, o-gradient (B,H,S,D) and k, v (B,K,S,D) drawn from ``gen`` as the
    transposed views of seq-major (B,S,heads,D) tensors, as the model's
    projections are."""
    import torch
    return tuple(torch.randn(B, S, h, D, generator=gen).to(dev, dt)
                 .transpose(1, 2) for h in (H, K, K, H))


def _bwd_graph(fn, q, k, v, do):
    """A call that runs autograd of ``fn`` back from ``do`` (its graph
    built once)."""
    import torch
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    y = fn(qs, ks, vs)
    return lambda: torch.autograd.grad(y, (qs, ks, vs), do,
                                       retain_graph=True)


def hold_flash(q, k, v, do, window, cap, what, causal=True):
    """The kernels' forward (with and without the log-sum-exp) and
    backward (twice: the same bits) on q, k, v, do against autograd of
    the plain version, every element within its bound (``ref.
    flash_limit``, ``flash_bf16_limit`` for bf16; ``flash_bwd_limit``).
    The plain version takes HOLD_HEADS query heads at a time (heads are
    independent), so that its S x S scores fit beside the full-size
    call. Returns o, lse and the errors and margins."""
    import math

    import torch
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops, ref
    o, lse = fak.flash_attention(q, k, v, causal, with_lse=True,
                                 window=window, softcap=cap)
    o2 = ops.flash_attention(q, k, v, causal, window, cap)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
    check(torch.equal(o, o2), f"{what}: the forward with and without "
          "the log-sum-exp differ")
    for name, g, a in zip("qkv", got, again):
        check(torch.equal(g, a), f"{what}: d{name} differs in bits "
              "between two calls")
    del o2, again
    bf16 = q.dtype == torch.bfloat16
    G = q.shape[1] // k.shape[1]
    n = max(1, HOLD_HEADS // G)             # kv heads a plain call
    res = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0,
           "lse_max_abs_err": 0.0, "fwd_over": -math.inf,
           "bwd_over": [-math.inf] * 3}
    for j in range(0, k.shape[1], n):
        hq, hk = slice(j * G, (j + n) * G), slice(j, j + n)
        qs, ks, vs, dos = q[:, hq], k[:, hk], v[:, hk], do[:, hq]
        qf, kf, vf = (t.detach().float().requires_grad_()
                      for t in (qs, ks, vs))
        want = ref.flash_attention(qf, kf, vf, causal, window, cap)
        want.backward(dos.float())
        want = want.detach()
        lim = (ref.flash_bf16_limit if bf16 else ref.flash_limit)(
            want, qs, ks, vs, causal, FLASH_TOL, window, cap)
        res["fwd_over"] = max(res["fwd_over"], float(
            ((o[:, hq].float() - want).abs() - lim).max()))
        res["fwd_max_abs_err"] = max(res["fwd_max_abs_err"],
                                     _max_err(o[:, hq], want))
        del want, lim
        res["lse_max_abs_err"] = max(res["lse_max_abs_err"], _max_err(
            lse[:, hq], ref.flash_attention_lse(qs.float(), ks.float(),
                                                causal, window, cap)))
        wg = (qf.grad, kf.grad, vf.grad)
        lims = ref.flash_bwd_limit(wg, qs, ks, vs, o[:, hq], lse[:, hq],
                                   dos, causal, FLASH_TOL, bf16, window, cap)
        for i, (g, w, lm_) in enumerate(zip(
                (got[0][:, hq], got[1][:, hk], got[2][:, hk]), wg, lims)):
            res["bwd_over"][i] = max(res["bwd_over"][i], float(
                ((g.float() - w).abs() - lm_).max()))
            res["bwd_max_abs_err"] = max(res["bwd_max_abs_err"],
                                         _max_err(g, w))
        del qf, kf, vf, wg, lims
    check(res["fwd_over"] <= 0, f"{what}: a forward element is "
          f"{res['fwd_over']} over its bound")
    check(res["lse_max_abs_err"] <= FLASH_TOL * (
        1 + float(lse.abs().max())), f"{what}: log-sum-exp off by "
        f"{res['lse_max_abs_err']}")
    for name, x in zip("qkv", res["bwd_over"]):
        check(x <= 0, f"{what}: a d{name} element is {x} over its bound")
    return o, lse, res


def _held(res):
    return (f"forward max abs err {res['fwd_max_abs_err']:.3g} (margin "
            f"{res['fwd_over']:.3g} to its bound), backward "
            f"{res['bwd_max_abs_err']:.3g} (margins " + ", ".join(
                f"{x:.3g}" for x in res["bwd_over"]) + ")")


def arch_slice(dev, gen, report):
    """Slice 9 (S1-S5): the dense and MoE decoders at full width -- the
    windowed and softcapped flash kernels against autograd of the plain
    version (S1), prefill and the server of all five configs (S2), a CPU
    twin (S3), the ring cache past the window (S4) and training (S5) of
    gemma2-9b and mixtral-8x7b. Returns the kernels-line entries of the
    windowed flash forward and backward at gemma2's and mixtral's
    shapes."""
    import dataclasses
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as ltrain
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    from repro_torch.train import loop

    def ms(busy):
        return None if busy is None else busy / 1e3

    def masked_sdpa(window, S):
        mask = ref.visible(S, True, window, dev)

        def fn(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return fn

    def library(window, cap, q, k, v, do=None):
        """(fn, note): the one PyTorch call that computes the kernel's
        function on q, k, v -- SDPA with a boolean window mask without a
        softcap, compiled flex_attention (``_flex``) with one -- tried once
        (its backward too, given ``do``), or (None, the reason) where it
        does not compile."""
        if not cap:
            return masked_sdpa(window, q.shape[2]), (
                "F.scaled_dot_product_attention, boolean window mask")
        try:
            fn = _flex(window, cap, q.shape[2], dev)
            if do is None:
                fn(q, k, v)
            else:
                _bwd_graph(fn, q, k, v, do)()
            torch.cuda.synchronize()
        except Exception as e:      # the yardstick only: the port never calls it
            return None, f"none: flex_attention did not compile ({e!r:.200})"
        return fn, ("torch.nn.attention.flex_attention, compiled, tanh "
                    "score_mod and window block mask")

    # full-width models of 12-69 GB and S=8192 training: segments that grow
    # in place, so that the earlier slices' cached blocks do not fragment
    # the card (gemma2's step ran out of memory with 23 GiB reserved and
    # unused)
    gc.collect()                  # the earlier slices' cycles hold tensors
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    print(f"slice 9 starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
          f"reserved, {torch.cuda.mem_get_info()[0] / 2 ** 30:.2f} free")
    t_s = time.perf_counter()
    # -- S1. the kernels against autograd of their plain version -----------
    s1, s1_lib = [], []
    for D, G, window, cap in S1_ATTN:
        H, K = G * S1_K, S1_K
        for S in S1_S:
            for dt in (torch.bfloat16, torch.float32):
                q, k, v, do = _qkvo(gen, dev, 1, H, K, S, D, dt)
                what = (f"D={D} H={H} K={K} S={S} window={window} softcap="
                        f"{cap} {str(dt)[6:]}")
                o, lse, res = hold_flash(q, k, v, do, window, cap,
                                         f"S1 flash {what}")
                row = {"D": D, "H": H, "K": K, "S": S, "window": window,
                       "softcap": cap, "dtype": str(dt)[6:], **res}
                bf16 = dt == torch.bfloat16
                if bf16:           # device time of both, one window
                    fcall = (lambda a, b, c, w=window, s=cap:
                             fak.flash_attention(a, b, c, True, window=w,
                                                 softcap=s))
                    bcall = (lambda *a, w=window, s=cap:
                             fak.flash_attention_bwd(*a, True, w, s))
                    busy, _, cap_ = device_us(
                        [(fcall, (q, k, v)), (bcall, (q, k, v, o, lse, do))],
                        reps=2, expect={"flash_tc_kernel": 1,
                                        "flash_bwd_dkdv_tc": 1,
                                        "flash_bwd_dq_tc": 1,
                                        "flash_bwd_delta_tc": 1})
                    per = cap_.get("per_call_us") if busy is not None else None
                    fb, bb = _flash_bounds(1, H, K, S, D, window)
                    row.update(fwd_device_ms=None if per is None
                               else per[0] / 1e3,
                               bwd_device_ms=None if per is None
                               else per[1] / 1e3,
                               fwd_bound_ms=fb["bound_ms"],
                               bwd_bound_ms=bb["bound_ms"])
                    row["library"] = (f"timed at S={S1_S[-1]} only (a "
                                      "flex_attention compile per shape)")
                    if S == S1_S[-1]:   # after the kernels line's calls
                        s1_lib.append((row, what, D, H, K, window, cap))
                    check_bound(f"S1 flash {what}", {
                        "fwd": row["fwd_device_ms"]}, fb["bound_ms"])
                    check_bound(f"S1 flash_bwd {what}", {
                        "bwd": row["bwd_device_ms"]}, bb["bound_ms"])
                s1.append(row)
                print(f"  S1 flash {what}: {_held(res)}" + (
                    "" if not bf16 else
                    "; device fwd " + (
                        "not measured" if row["fwd_device_ms"] is None
                        else f"{row['fwd_device_ms']:.4f} ms")
                    + f" (bound {row['fwd_bound_ms']:.4f}), bwd " + (
                        "not measured" if row["bwd_device_ms"] is None
                        else f"{row['bwd_device_ms']:.4f} ms")
                    + f" (bound {row['bwd_bound_ms']:.4f})"))
                del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    report["s1_flash"] = s1
    print(f"S1 windowed/softcapped flash vs autograd of the plain version: "
          f"{len(s1)} cases, forward, log-sum-exp and dq/dk/dv within their "
          f"bounds (tanh term {2.0 ** -21:.3g} x cap), the same bits twice; "
          f"{time.perf_counter() - t_s:.1f} s")

    # every attention layer kind of the main path (prefill and training),
    # at the configs' own head counts, B=1, S=ARCH_S, bf16
    main = {}
    for arch in ARCHS9:
        cfg = get_config(arch)
        kinds = {(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                  L.window_of(cfg, cfg.is_local_layer(j)),
                  cfg.attn_logit_softcap)
                 for j in range(cfg.num_layers) if cfg.is_attn_layer(j)}
        for H, K, D, window, cap in sorted(kinds):
            what = (f"{arch} B=1 S={ARCH_S} H={H} K={K} D={D} window "
                    f"{window} softcap {cap} bf16")
            q, k, v, do = _qkvo(gen, dev, 1, H, K, ARCH_S, D, torch.bfloat16)
            _, _, res = hold_flash(q, k, v, do, window, cap,
                                   f"S1 main path {what}")
            main[H, K, D, window, cap] = res
            print(f"  S1 main path {what}: {_held(res)}")
            del q, k, v, do
            torch.cuda.empty_cache()
    report["s1_main_path"] = [dict(zip(("H", "K", "D", "window", "softcap"),
                                       key), S=ARCH_S, **res)
                              for key, res in main.items()]
    print(f"S1 main-path shapes: {len(main)} kinds within their bounds")

    # kernels-line entries at the main path's shapes, with the library call
    entries, lib_note = {}, {}
    for arch, (H, K, D, window, cap) in ARCH_ENTRIES.items():
        q, k, v, do = _qkvo(gen, dev, 1, H, K, ARCH_S, D, torch.bfloat16)
        o, lse = fak.flash_attention(q, k, v, True, with_lse=True,
                                     window=window, softcap=cap)
        res = main[H, K, D, window, cap]
        lib, note = library(window, cap, q, k, v, do)
        lib_note[arch] = note
        fb, bb = _flash_bounds(1, H, K, ARCH_S, D, window)
        fwd = (lambda a, b, c, w=window, s=cap:
               ops.flash_attention(a, b, c, True, w, s))
        bwd = (lambda *a, w=window, s=cap:
               ops.flash_attention_bwd(*a, True, w, s))
        plain = (lambda a, b, c, w=window, s=cap:
                 ref.flash_attention(a, b, c, True, w, s))
        plain_b = (lambda *a, w=window, s=cap:
                   ref.flash_attention_bwd(*a, True, w, s))
        tf = {"ms": median_ms(fwd, q, k, v),
              "plain_ms": median_ms(plain, q, k, v, reps=3, inner=3),
              "device_ms": ms(device_us([(fwd, (q, k, v))], reps=3,
                                        expect={"flash_tc_kernel": 1})[0]),
              "max_abs_err": res["fwd_max_abs_err"], **fb}
        args = (q, k, v, o, lse, do)
        tb = {"ms": median_ms(bwd, *args, inner=10),
              "plain_ms": median_ms(plain_b, *args, reps=3, inner=2),
              "device_ms": ms(device_us([(bwd, args)], reps=3, expect={
                  c: 1 for c in LT_CNAMES["flash_attention_bwd"]})[0]),
              "max_abs_err": res["bwd_max_abs_err"], **bb}
        if lib is not None:
            check(_max_err(lib(q, k, v), o) <= 5e-2 * max(
                1.0, float(o.float().abs().max())),
                  f"{arch}: the library call disagrees with the kernel")
            lbwd = _bwd_graph(lib, q, k, v, do)
            tf["library_ms"] = median_ms(lib, q, k, v)
            tf["library_device_ms"] = ms(device_us([(lib, (q, k, v))],
                                                   reps=3)[0])
            tb["library_ms"] = median_ms(lbwd, inner=10)
            tb["library_device_ms"] = ms(device_us([(lbwd, ())], reps=3)[0])
            del lbwd
        else:
            tf["library_ms"] = tb["library_ms"] = None
            tf["library_device_ms"] = tb["library_device_ms"] = None
        for name, t in (("flash_attention", tf), ("flash_attention_bwd",
                                                  tb)):
            check_bound(f"{name}[{arch}]", {
                kk: vv for kk, vv in t.items() if kk.endswith("ms") and kk
                not in ("bound_ms", "ops_ms", "bytes_ms")}, t["bound_ms"])
            entries[f"{name}[{arch}]"] = t
            print(f"  time {name} [{arch}] B=1 S={ARCH_S} H={H} K={K} D={D} "
                  f"window {window} softcap {cap} bf16: " + ", ".join(
                      f"{kk} {vv:.5g}" if isinstance(vv, float)
                      else f"{kk} {vv}" for kk, vv in t.items())
                  + f"; library: {note}")
        del q, k, v, do, o, lse, lib
        torch.cuda.empty_cache()
    # the library call at S1's longest shapes, after the kernels line's
    # (a failed flex compile can break the next ones in the process); with
    # a softcap its forward only (a flex backward compile per shape)
    for row, what, D, H, K, window, cap in s1_lib:
        q, k, v, do = _qkvo(gen, dev, 1, H, K, S1_S[-1], D, torch.bfloat16)
        fn, note = library(window, cap, q, k, v)
        row["library"] = note + (" (forward only)" if cap else "")
        if fn is not None:
            row["library_fwd_device_ms"] = ms(device_us([(fn, (q, k, v))],
                                                        reps=2)[0])
        if fn is not None and not cap:
            row["library_bwd_device_ms"] = ms(device_us(
                [(_bwd_graph(fn, q, k, v, do), ())], reps=2)[0])
        fb, bb = _flash_bounds(1, H, K, S1_S[-1], D, window)
        check_bound(f"S1 library {what}", {
            "fwd": row.get("library_fwd_device_ms")}, fb["bound_ms"])
        check_bound(f"S1 library bwd {what}", {
            "bwd": row.get("library_bwd_device_ms")}, bb["bound_ms"])
        print(f"  S1 library {what}: " + ", ".join(
            f"{d} {row[f'library_{d}_device_ms']:.4f} ms"
            for d in ("fwd", "bwd")
            if row.get(f"library_{d}_device_ms") is not None)
            + f" ({row['library']})")
        del q, k, v, do
    report["arch_flash_times"] = entries
    report["arch_flash_library"] = lib_note
    print(f"S1 done in {time.perf_counter() - t_s:.1f} s")

    # -- S2. prefill and the server at full width, counted -------------------
    t_s = time.perf_counter()
    first, s2, served_launch = {}, {}, {}
    for i, arch in enumerate(ARCHS9):
        base = get_config(arch)
        cfg = base
        if arch in ARCH_LAYERS:
            cfg = dataclasses.replace(base, num_layers=ARCH_LAYERS[arch])
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(
            SEED + 70 + i), dev)
        torch.cuda.synchronize()
        n_par = sum(p.numel() for p in _leaves(params))
        cut = ("" if cfg.num_layers == base.num_layers else
               f" (cut from {base.num_layers}: one card's 80 GB)")
        print(f"{arch}: {n_par} parameters, {cfg.num_layers} layers{cut}, "
              f"d_model {cfg.d_model}, drawn on the card in "
              f"{time.perf_counter() - t:.1f} s")
        tok = torch.from_numpy(next(synthetic.token_batches(
            1, ARCH_S, cfg.vocab_size, seed=0))[0]["tokens"]).to(dev)
        n_attn = sum(cfg.is_attn_layer(j) for j in range(cfg.num_layers))
        torch.cuda.synchronize()
        ops.reset_launches()
        t_main = time.perf_counter()
        with torch.no_grad():
            logits, aux = lm.forward(cfg, params, tok)
            done, secs, steps, routes = _serve_recorded(cfg, params, dev)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t_main
        launches = ops.launches()
        served_launch[arch] = launches
        check(launches == {**{k_: 0 for k_ in launches},
                           "flash_attention": n_attn},
              f"S2 {arch}: launches {launches}, not {n_attn} flash_attention "
              "(one per attention layer of the prefill; decode runs none)")
        check(tuple(logits.shape) == (1, ARCH_S, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"S2 {arch}: logits {tuple(logits.shape)} not finite")
        check(bool(torch.isfinite(aux)) and (float(aux) > 0) == bool(
            cfg.num_experts), f"S2 {arch}: aux loss {float(aux)}")
        if cfg.final_logit_softcap:
            check(float(logits.abs().max()) <= cfg.final_logit_softcap,
                  f"S2 {arch}: logits past the final softcap")
        del logits
        toks = sum(len(r.out_tokens) for r in done)
        check(len(done) == SERVE_REQUESTS and toks == SERVE_REQUESTS
              * SERVE_NEW and all(0 <= x < cfg.vocab_size for r in done
                                  for x in r.out_tokens),
              f"S2 {arch} server: {len(done)} requests, {toks} tokens")
        row = {"layers": cfg.num_layers, "full_layers": base.num_layers,
               "parameters": n_par, "main_path_s": t_main,
               "serve": {"tokens": toks, "seconds": secs,
                         "tokens_per_s": toks / secs}}
        if cfg.num_experts:
            # the server's batched dispatches against the reference's
            # algorithm in numpy, assignment for assignment
            n_assign = n_drop = 0
            for probs, eidx, pos, C in routes:
                T = probs.shape[0]
                we, wp = _route_np(probs, cfg.experts_per_token)
                check(np.array_equal(eidx, we) and np.array_equal(pos, wp)
                      and C == L.moe_capacity(cfg, T),
                      f"S2 {arch} server: a dispatch of {T} tokens differs "
                      "from the reference's order and slots")
                n_assign += pos.size
                n_drop += int((pos >= C).sum())
            check(len(routes) > 0, f"S2 {arch}: no MoE dispatch recorded")
            row["server_dispatches"] = {"calls": len(routes),
                                        "assignments": n_assign,
                                        "dropped": n_drop}
            print(f"  S2 {arch} server: {len(routes)} MoE dispatches, "
                  f"{n_assign} assignments, {n_drop} dropped at the batch's "
                  "capacity, each equal to the reference's dispatch in "
                  "numpy, index for index")
        # one profiled prefill: the flash kernel once per attention layer,
        # no PyTorch attention
        fp = _prefill_profile(
            lambda c=cfg, p=params, t_=tok: lm.forward(c, p, t_), n_attn,
            f"S2 {arch} prefill B=1 S={ARCH_S}")
        row["prefill"] = fp
        s2[arch] = row
        print(f"  S2 {arch} server: {toks} tokens in {secs:.2f} s "
              f"({toks / secs:.1f} tok/s, batch {SERVE_BATCH}, bf16)")
        if arch in S5_ARCHS:       # its first repeat, for S3 and S4
            R1 = lm.block_period(cfg)
            first[arch] = (dataclasses.replace(
                cfg, num_layers=R1, dtype="float32"), {
                    k_: (v_[:R1] if k_.startswith("blocks.") else v_)
                    .float().cpu() for k_, v_ in flatten(params).items()})
        # the served tokens against the teacher-forced forward (S2_TIE):
        # dense configs, the main path's bf16 server; MoE, a second server
        # on the same weights widened to f32 in place
        ccfg = cfg
        if cfg.num_experts:
            del done, steps
            _widen(params)
            ccfg = dataclasses.replace(cfg, dtype="float32")
            done, _, steps, _ = _serve_recorded(ccfg, params, dev)
        sv = _served_vs_forward(ccfg, params, done, steps, dev,
                                f"S2 {arch} server {ccfg.dtype}")
        row["served_vs_forward"] = sv
        print(f"  S2 {arch} server ({ccfg.dtype}) vs the teacher-forced "
              f"forward: of {sv['tokens']} served tokens {sv['compared']} "
              f"compared (left out: {sv['left_out_dropped']} from a dropped"
              f" assignment on, {sv['left_out_parted']} from a near-tie "
              "route on), " + f"{sv['checked']} of them the forward's "
              f"argmax at margins of at least {S2_TIE[ccfg.dtype]} x max(1,"
              f" max|logit|); logits within {sv['max_gap_rel']:.3g} x that "
              "of the forward's")
        del params, tok, done, steps
        torch.cuda.empty_cache()
    report["s2"] = s2
    print(f"S2 done in {time.perf_counter() - t_s:.1f} s")

    from repro_torch.models.params import unflatten

    # -- S3. the card against a CPU twin, one repeat, full width -----------
    t_s = time.perf_counter()
    s3 = {}
    for arch, (c1, flat1) in first.items():
        for S in S3_S:
            tok = torch.from_numpy(next(synthetic.token_batches(
                1, S, c1.vocab_size, seed=1))[0]["tokens"])
            out, rts = {}, {}
            with torch.no_grad():
                for dt in ("float32", "bfloat16"):
                    cast = getattr(torch, dt)
                    cd = dataclasses.replace(c1, dtype=dt)
                    pd = unflatten({k_: v_.to(dev, cast)
                                    for k_, v_ in flat1.items()})
                    pc = unflatten({k_: v_.to(cast)
                                    for k_, v_ in flat1.items()})
                    (out[dt, "card"], _), rts[dt, "card"] = _routed(
                        lm.forward, cd, pd, tok.to(dev))
                    (out[dt, "cpu"], _), rts[dt, "cpu"] = _routed(
                        lm.forward, cd, pc, tok)
                    if dt == "float32":
                        nudged = dict(pd, embed=pd["embed"] * (1 + 1e-7))
                        out["nudged"] = lm.forward(cd, nudged,
                                                   tok.to(dev))[0]
                    del pd, pc
            want = out["float32", "cpu"][0]
            got = out["float32", "card"][0].cpu()
            keep = torch.ones(S, dtype=torch.bool)
            for (pc_, ec, _, _), (_, ed, _, _) in zip(rts["float32", "cpu"],
                                                       rts["float32",
                                                           "card"]):
                part = (ec != ed).any(-1)
                check(not (part & ~_near_tie(pc_, c1.experts_per_token))
                      .any(), f"S3 {arch} S={S}: a route differs between "
                      "the card and the CPU away from a near-tie")
                keep &= torch.from_numpy(~part)
            check(int((~keep).sum()) <= ROUTE_LEAST * S, f"S3 {arch} S={S}: "
                  f"{int((~keep).sum())} tokens routed otherwise")
            sens = float((out["nudged"][0].cpu() - got).abs().max())
            scale = max(1.0, float(want.abs().max()))
            diff = float((got[keep] - want[keep]).abs().max())
            lim = LM_TWIN_TOL * scale + SENS_K * sens
            check(diff <= lim, f"S3 {arch} S={S} f32: card vs CPU differ by "
                  f"{diff} > {lim}")

            def row_err(a):
                d = (a[0].cpu().float() - want).reshape(-1, want.shape[-1])
                return float(d.pow(2).mean(-1).sqrt().median()) / float(
                    want.pow(2).mean().sqrt())
            e_card = row_err(out["bfloat16", "card"])
            e_cpu = row_err(out["bfloat16", "cpu"])
            check(e_card <= BF16_FACTOR * e_cpu + BF16_FLOOR,
                  f"S3 {arch} S={S} bf16: card's median row error from f32 "
                  f"{e_card} vs the CPU's {e_cpu}")
            s3[f"{arch} S={S}"] = {
                "f32_max_diff": diff, "scale": scale, "sensitivity": sens,
                "tokens_routed_otherwise": int((~keep).sum()),
                "bf16_row_err_card": e_card, "bf16_row_err_cpu": e_cpu}
            print(f"  S3 card vs CPU {arch} 1 repeat S={S}: f32 max diff "
                  f"{diff:.3g} (scale {scale:.3g}, sensitivity {sens:.3g}, "
                  f"{int((~keep).sum())} near-tie routes left out); bf16 "
                  f"median row error from the CPU's f32: card {e_card:.4g}, "
                  f"CPU {e_cpu:.4g}")
            del out
    report["s3"] = s3
    print(f"S3 done in {time.perf_counter() - t_s:.1f} s")

    # -- S4. the ring cache past the window: decode vs the forward ---------
    t_s = time.perf_counter()
    s4 = {}
    for arch, (c1, flat1) in first.items():
        params = unflatten({k_: v_.to(dev) for k_, v_ in flat1.items()})
        tok = torch.from_numpy(next(synthetic.token_batches(
            1, S4_LEN, c1.vocab_size, seed=2))[0]["tokens"]).to(dev)
        with torch.no_grad():
            (full, _), frt = _routed(lm.forward, c1, params, tok)
            cache = lm.init_cache(c1, 1, S4_LEN, dev)
            ring = [blk["k"].shape[2] for blk in cache.values()
                    if "k" in blk]
            check(min(ring) == c1.sliding_window < S4_LEN,
                  f"S4 {arch}: cache lengths {ring}, no ring of the window")
            rows, drt = [], []
            for t_ in range(S4_LEN):
                (lg, _), r_ = _routed(lm.decode_step, c1, params, cache,
                                     tok[:, t_:t_ + 1],
                                     torch.tensor([t_], device=dev))
                rows.append(lg[0])
                drt.append(r_)
            dec = torch.stack(rows)
        dropped = np.zeros(S4_LEN, bool)
        parted = np.zeros(S4_LEN, bool)
        if c1.num_experts:
            for j, (pf, ef, posf, C) in enumerate(frt):
                dropped |= (posf >= C).reshape(S4_LEN, -1).any(-1)
                ed = np.stack([r_[j][1][0] for r_ in drt])
                part = (ef != ed).any(-1)
                check(not (part & ~_near_tie(pf, c1.experts_per_token))
                      .any(), f"S4 {arch}: decode routes a token otherwise "
                      "than the forward away from a near-tie")
                check(all(int((r_[j][2] >= r_[j][3]).sum()) == 0
                          for r_ in drt), f"S4 {arch}: batch-1 decode "
                      "dropped an assignment")
                parted |= part
        # a token the forward dropped at its capacity is computed in full
        # by the batch-1 decode (the reference's batch-dependent capacity)
        keep = torch.from_numpy(~(dropped | parted))
        check(int(parted.sum()) <= ROUTE_LEAST * S4_LEN
              and int(keep[S4_LEN - 64:].sum()) > 0
              and int(keep.sum()) >= S4_LEAST * S4_LEN,
              f"S4 {arch}: {int(dropped.sum())} positions dropped by the "
              f"forward and {int(parted.sum())} routed otherwise: too few "
              "left to compare")
        gap_all = (dec - full[0]).abs().amax(-1).cpu()
        gap = float(gap_all[keep].max())
        wrapped = float(gap_all[keep & (torch.arange(S4_LEN)
                                        >= c1.sliding_window)].max())
        check(gap <= S4_GAP, f"S4 {arch}: decode vs the windowed forward "
              f"differ by {gap} > {S4_GAP}")
        s4[arch] = {"positions": S4_LEN, "ring": min(ring), "max_gap": gap,
                    "max_gap_after_wrap": wrapped,
                    "dropped_by_forward": int(dropped.sum()),
                    "near_tie_routes": int(parted.sum())}
        print(f"  S4 {arch} 1 repeat f32: {S4_LEN} decode steps through a "
              f"{min(ring)}-position ring (wraps at {c1.sliding_window}); "
              f"logits within {gap:.3g} of the windowed forward's "
              f"({wrapped:.3g} after the wrap; threshold {S4_GAP}) at "
              f"{int(keep.sum())} positions; left out: "
              f"{int(dropped.sum())} the forward dropped at its capacity, "
              f"{int(parted.sum())} near-tie routes")
        del params, tok, full, cache, rows, dec
        torch.cuda.empty_cache()
    report["s4"] = s4
    del first
    print(f"S4 done in {time.perf_counter() - t_s:.1f} s")

    # -- S5. training through launch.train, counted -----------------------
    t_s = time.perf_counter()
    s5, trained = {}, {}
    for i, arch in enumerate(S5_ARCHS):
        base = get_config(arch)
        cfg = dataclasses.replace(base, num_layers=lm.block_period(base))
        n_attn = cfg.num_layers
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        counts = []
        seq = ARCH_S
        res = ltrain.train(cfg, steps=S5_STEPS, batch=1, seq=seq,
                           lr=LT_LR, device=dev, seed=SEED + 80 + i,
                           log_every=0, heartbeat=lambda s, t: counts.append(
                               dict(ops.launches())))
        torch.cuda.synchronize()
        launches = ops.launches()
        trained[arch] = launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        before = {k_: 0 for k_ in launches}
        for j, now in enumerate(counts):
            diff = {k_: now[k_] - before[k_] for k_ in now}
            check(diff == {**{k_: 0 for k_ in now},
                           "flash_attention": n_attn,
                           "flash_attention_bwd": n_attn},
                  f"S5 {arch} step {j}: launches {diff}")
            before = now
        check(len(res.losses) == S5_STEPS
              and all(map(math.isfinite, res.losses)),
              f"S5 {arch}: losses {res.losses}")
        # two more steps on one batch, from the run's own AdamW state (a
        # second state beside it would not fit at gemma2's S=8192)
        params, opt = res.params, res.opt_state
        res.opt_state = None
        step = loop.make_lm_step(cfg, params, lambda s: 1e-3)
        batch = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in next(
            synthetic.token_batches(1, seq, cfg.vocab_size, seed=7))[0]
            .items()}
        opt, m0 = step(opt, batch, S5_STEPS)
        opt, m1 = step(opt, batch, S5_STEPS + 1)
        aux0 = float(m0["moe_aux"])
        check(math.isfinite(aux0) and (aux0 > 0) == bool(cfg.num_experts),
              f"S5 {arch}: aux loss {aux0}")
        check(float(m1["loss"]) < float(m0["loss"]), f"S5 {arch}: the same "
              "batch's loss did not drop after one step")
        names = [c for k_ in ("flash_attention", "flash_attention_bwd")
                 for c in LT_CNAMES[k_]]
        fp, by_name = wall_profile(lambda: step(opt, batch, S5_STEPS + 2),
                                   reps=2,
                                   expect={c: n_attn for c in names})
        lib = [n_ for n_ in by_name if any(x in n_ for x in LIB_ATTN)]
        check(not lib, f"S5 {arch}: PyTorch attention kernels in the "
              f"training step: {lib}")
        fp["step_wall_ms"] = 1e3 * statistics.median(res.step_s[1:])
        fp["peak_gib"] = peak
        busy = fp["device_busy_ms"]
        if by_name:
            for k_ in ("flash_attention", "flash_attention_bwd"):
                us = sum(v_ for n_, v_ in by_name.items()
                         if any(c in n_ for c in LT_CNAMES[k_]))
                fp[f"{k_}_us_per_launch"] = us / n_attn
                fp[f"{k_}_share"] = us / 1e3 / busy
        s5[arch] = {"layers": cfg.num_layers, "batch": 1, "seq": seq,
                    "losses": res.losses, "aux": aux0,
                    "same_batch_loss": [float(m0["loss"]),
                                        float(m1["loss"])], **fp}
        print(f"  S5 {arch} {cfg.num_layers} layers (one repeat) B=1 "
              f"S={seq} bf16: {S5_STEPS} steps, loss {res.losses[0]:.4f}"
              f" -> {res.losses[-1]:.4f}, aux {aux0:.4g}; step wall "
              f"{fp['step_wall_ms']:.3f} ms, device busy " + (
                  "not measured" if busy is None else
                  f"{busy:.3f} ms, idle share {fp['idle_share']:.3f}, flash "
                  f"fwd {fp['flash_attention_us_per_launch']:.1f} us and bwd"
                  f" {fp['flash_attention_bwd_us_per_launch']:.1f} us a "
                  "launch") + f"; peak memory {peak:.2f} GiB")
        for kname, us_ in fp["top_kernels_us"]:
            print(f"    {us_:9.1f} us  {kname[:90]}")
        del params, res, step, opt, batch, m0, m1
        torch.cuda.empty_cache()
    report["s5"] = s5
    print(f"S5 done in {time.perf_counter() - t_s:.1f} s")

    out = []
    for arch in ARCH_ENTRIES:
        for name, replaces in (
                ("flash_attention", "src/repro/kernels/flash_attention.py:65"),
                ("flash_attention_bwd", "none: no TPU kernel (the "
                 "reference's LM forward is jnp code that XLA "
                 "differentiates, src/repro/models/layers.py:165)")):
            t = entries[f"{name}[{arch}]"]
            step_us = s5.get(arch, {}).get(f"{name}_us_per_launch")
            out.append({
                "name": f"{name}[{arch}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": replaces,
                "launches": served_launch[arch][name] + trained[arch][name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
                "step_device_ms": None if step_us is None else step_us / 1e3,
                "library": lib_note[arch]})
    return out


# -- slice 10: phi-3-vision-4.2b and whisper-small --------------------------
# Both at full width and depth, bf16; weights drawn on the card from a
# seeded card generator, image embeddings and frames from the script's CPU
# generator. V1: the flash kernels at the three attention shapes of the
# new main path, (B, H, K, S, D, causal): whisper's encoder (non-causal over
# its 1500 frames, ragged for every tile), its decoder (448 positions,
# Whisper's text context, arXiv:2212.04356), phi-3 (causal, D=96, one query
# head a kv head) at the prefill's B=2, S=2048
V_ATTN = {"whisper-small encoder": (4, 12, 12, 1500, 64, False),
          "whisper-small decoder": (4, 12, 12, 448, 64, True),
          "phi-3-vision-4.2b": (LM_B, 32, 32, LM_S, 96, True)}
V_WHISPER_B, V_WHISPER_S = 4, 448
V_TWIN_S = 300                   # the one-repeat CPU twins, ragged
# V3: batch-1 decode of whisper with its cross-attention cache filled from
# encoder_kv, f32, against the forward on the same frames, at all 448
# positions: at one repeat (one encoder and one decoder layer) the logits
# within V3_GAP x max(1, max|logit|) (as FULL_GAP holds Llama's full-depth
# f32 decode); at full depth within that + SENS_K x the forward's own
# change under a 1e-7 relative change of the embedding, as the twins hold
# the card to the CPU: the random-init net amplifies rounding with depth,
# and the decode-vs-forward gap grows with the forward's sensitivity (both
# printed). At one repeat the first step with a zero cross cache must be
# off by more than the limit (the frames reach the decoder).
V3_GAP = 1e-2
# V4: training through make_lm_step (AdamW, launch/train's cosine schedule
# at LT_LR): whisper at full depth, (B, S, steps), over 1500 frames a
# sequence; phi-3 with its 256 image embeddings, cut to V4_PHI_LAYERS of
# its 32 layers: one step at B=1 S=2048 runs out of the card's memory at
# 32 and 28 layers and peaks at 49.88 GiB at 16 layers, 73.51 at 24
# (tools/lm_train_memory.py --expandable-segments, about 3 GiB a layer:
# weights, gradients, f32 AdamW moments and the update's and clipping's
# copies), so 20 layers (about 62 GiB) leave room beside what the earlier
# slices of this process hold
V4_WHISPER = (8, 448, 10)
V4_PHI = (1, LM_S, 3)
V4_PHI_LAYERS = 20


@contextlib.contextmanager
def _attn_tally():
    """Record each ``models.layers.attention`` call inside the block: its
    ``causal`` flag and whether autograd is on (each call is one flash
    launch, and one backward launch when the step's backward runs).
    Yields the list of (causal, grad enabled)."""
    import torch
    from repro_torch.models import layers as L
    rec, attention = [], L.attention

    def tallied(*args, causal=True, **kw):
        rec.append((causal, torch.is_grad_enabled()))
        return attention(*args, causal=causal, **kw)
    L.attention = tallied
    try:
        yield rec
    finally:
        L.attention = attention


def _zero_cross_decode(cfg, params, seq, dev):
    """Batch-1 teacher-forced decode over ``seq`` (S,) from a fresh cache,
    its cross-attention K/V zero as the server's are: (logits rows, no
    MoE dispatches)."""
    import torch
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, 1, len(seq), dev)
    rows = []
    with torch.no_grad():
        for t, x in enumerate(seq):
            lg, _ = lm.decode_step(
                cfg, params, cache,
                torch.tensor([[int(x)]], dtype=torch.int32, device=dev),
                torch.tensor([t], dtype=torch.int32, device=dev))
            rows.append(lg[0])
    return torch.stack(rows), []


def _lm_twin(c1, flat1, tok, extras, dev, what):
    """A one-repeat model (config ``c1``, its leaves ``flat1`` in f32 on
    the CPU) on the card against the same on the CPU, as S3 holds it: f32
    logits within LM_TWIN_TOL x max(1, max|logit|) + SENS_K x the card's
    change under a 1e-7 relative change of every leaf and input; bf16, the
    card's median row error from the CPU's f32 logits at most BF16_FACTOR
    x the CPU's own + BF16_FLOOR. ``extras``: the forward's image
    embeddings or encoder frames, f32 on the CPU. (S3 changes the
    embedding alone; whisper's decoder input is its positional rows,
    O(1) beside embedding rows of 0.02, and its encoder reads only the
    frames, so the embedding alone would probe neither.) Returns the
    readings."""
    import dataclasses

    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import flatten, unflatten
    out, cpu = {}, torch.device("cpu")
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            cast = getattr(torch, dt)
            cd = dataclasses.replace(c1, dtype=dt)
            for where, d in (("card", dev), ("cpu", cpu)):
                p = unflatten({k: v.to(d, cast) for k, v in flat1.items()})
                ex = {k: v.to(d, cast) for k, v in extras.items()}
                out[dt, where] = lm.forward(cd, p, tok.to(d), **ex)[0][0] \
                    .float().cpu()
                if (dt, where) == ("float32", "card"):
                    out["nudged"] = lm.forward(
                        cd, unflatten({k: v * (1 + 1e-7) for k, v in
                                       flatten(p).items()}), tok.to(d),
                        **{k: v * (1 + 1e-7) for k, v in ex.items()}
                    )[0][0].cpu()
                del p, ex
    want, got = out["float32", "cpu"], out["float32", "card"]
    sens = float((out["nudged"] - got).abs().max())
    scale = max(1.0, float(want.abs().max()))
    diff = float((got - want).abs().max())
    lim = LM_TWIN_TOL * scale + SENS_K * sens
    f64 = {}
    if diff > lim:
        # the CPU's own f32 distance from an f64 evaluation as the
        # yardstick, as LT3 holds a step (GRAD_K): one repeat of these
        # random nets reads the repeat count as the fan-in, so its weights
        # have std 1 and its f32 logits can sit far off f64
        with torch.no_grad():
            want64 = lm.forward(
                dataclasses.replace(c1, dtype="float64"),
                unflatten({k: v.double() for k, v in flat1.items()}), tok,
                **{k: v.double() for k, v in extras.items()})[0][0]
        f64 = {"cpu_off_f64": float((want.double() - want64).abs().max()),
               "card_off_f64": float((got.double() - want64).abs().max())}
        lim = GRAD_K * f64["cpu_off_f64"] + LM_TWIN_TOL * scale
        diff = f64["card_off_f64"]
        del want64
    check(diff <= lim, f"{what} f32: card vs CPU differ by {diff} > {lim}"
          + (f" (off f64: {f64})" if f64 else ""))

    def row_err(a):
        d = a - want
        return float(d.pow(2).mean(-1).sqrt().median()) / float(
            want.pow(2).mean().sqrt())
    e_card, e_cpu = (row_err(out["bfloat16", w]) for w in ("card", "cpu"))
    check(e_card <= BF16_FACTOR * e_cpu + BF16_FLOOR, f"{what} bf16: the "
          f"card's median row error from f32 {e_card} vs the CPU's {e_cpu}")
    print(f"  {what}: f32 " + (
        f"max diff {diff:.3g} (scale {scale:.3g}, sensitivity {sens:.3g}, "
        f"limit {lim:.3g})" if not f64 else
        f"off an f64 evaluation by {f64['card_off_f64']:.3g} on the card, "
        f"{f64['cpu_off_f64']:.3g} on the CPU (scale {scale:.3g}, limit "
        f"{lim:.3g}; the card's f32 {float((got - want).abs().max()):.3g} "
        f"from the CPU's, sensitivity {sens:.3g})")
        + f"; bf16 median row error from the CPU's f32: card {e_card:.4g}, "
        f"CPU {e_cpu:.4g}")
    return {"f32_max_diff": float((got - want).abs().max()), "scale": scale,
            "sensitivity": sens, "limit": lim, **f64,
            "bf16_row_err_card": e_card, "bf16_row_err_cpu": e_cpu}


def _first_repeat(cfg, params):
    """(config, f32 CPU leaves) of a model's first repeat, with one
    encoder layer where it has an encoder."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    R1 = lm.block_period(cfg)
    c1 = dataclasses.replace(cfg, num_layers=R1, dtype="float32",
                             encoder_layers=min(1, cfg.encoder_layers))
    cut = ("blocks.", "encoder.layers.")
    return c1, {k: (v[:R1] if k.startswith(cut) else v).float().cpu()
                for k, v in flatten(params).items()}


def _prefill_profile(fn, n_attn, what):
    """wall_profile of one prefill forward: the flash kernel ``n_attn``
    times and no PyTorch attention kernel; adds the flash kernel's time a
    launch and its share of the device time."""
    fp, by_name = wall_profile(fn, reps=2, expect={"flash_tc_kernel": n_attn})
    lib = [n_ for n_ in by_name if any(x in n_ for x in LIB_ATTN)]
    check(not lib, f"{what}: PyTorch attention kernels in the prefill: {lib}")
    busy = fp["device_busy_ms"]
    if by_name:
        us = sum(v_ for n_, v_ in by_name.items() if "flash_tc_kernel" in n_)
        fp["flash_us_per_launch"] = us / n_attn
        fp["flash_share"] = us / 1e3 / busy
    print(f"  {what}: wall {fp['wall_ms']:.3f} ms, device busy " + (
        "not measured" if busy is None else
        f"{busy:.3f} ms, idle share {fp['idle_share']:.3f}, flash "
        f"{n_attn} launches, {fp['flash_us_per_launch']:.1f} us each, "
        f"{100 * fp['flash_share']:.1f}% of the device time"))
    for kname, us_ in fp["top_kernels_us"]:
        print(f"    {us_:9.1f} us  {kname[:90]}")
    return fp


def _train_steps(cfg, params, batch_of, steps, n_attn, what):
    """``steps`` steps of ``make_lm_step`` (launch/train's cosine schedule
    at LT_LR) on ``batch_of(i)``, counted: each step launches the flash
    kernel and its backward once per attention layer (``n_attn``, the
    encoder's included), no other kernel of the repo; the losses finite,
    and the first batch's loss lower after the steps than at the first
    step; then one profiled step. Returns (readings, launches, attention
    tally, the last batch)."""
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    from repro_torch.train import loop, optim
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = loop.make_lm_step(cfg, params, optim.cosine_schedule(
        LT_LR, warmup=max(1, steps // 10), total=steps))
    opt = optim.adamw_init(flatten(params))
    losses, secs, counts = [], [], []
    with _attn_tally() as tally:
        ops.reset_launches()
        for i in range(steps):
            t = time.perf_counter()
            b = batch_of(i)
            first = b if i == 0 else first
            opt, m = step(opt, b, i)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t)
            counts.append(dict(ops.launches()))
        launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    before = {k_: 0 for k_ in launches}
    for j, now in enumerate(counts):
        diff = {k_: now[k_] - before[k_] for k_ in now}
        check(diff == {**{k_: 0 for k_ in now}, "flash_attention": n_attn,
                       "flash_attention_bwd": n_attn},
              f"{what} step {j}: launches {diff}")
        before = now
    check(len(tally) == steps * n_attn and all(g for _, g in tally),
          f"{what}: {len(tally)} attention calls")
    with torch.no_grad():
        again = float(lm.lm_loss(cfg, params, first)[0])
    check(all(map(math.isfinite, losses)) and again < losses[0],
          f"{what}: losses {losses}, the first batch's {again} after them")
    names = [c for k_ in ("flash_attention", "flash_attention_bwd")
             for c in LT_CNAMES[k_]]
    fp, by_name = wall_profile(lambda: step(opt, b, steps), reps=2,
                               expect={c: n_attn for c in names})
    lib = [n_ for n_ in by_name if any(x in n_ for x in LIB_ATTN)]
    check(not lib, f"{what}: PyTorch attention kernels in the step: {lib}")
    fp["step_wall_ms"] = 1e3 * statistics.median(secs[1:])
    fp["peak_gib"] = peak
    busy = fp["device_busy_ms"]
    if by_name:
        for k_ in ("flash_attention", "flash_attention_bwd"):
            us = sum(v_ for n_, v_ in by_name.items()
                     if any(c in n_ for c in LT_CNAMES[k_]))
            fp[f"{k_}_us_per_launch"] = us / n_attn
            fp[f"{k_}_share"] = us / 1e3 / busy
    out = {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "steps": steps, "losses": losses, "first_batch_after": again,
           **fp}
    print(f"  {what}: {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (the first batch's {again:.4f} after them); "
          f"step wall {fp['step_wall_ms']:.3f} ms, device "
          "busy " + ("not measured" if busy is None else
                     f"{busy:.3f} ms, idle share {fp['idle_share']:.3f}, "
                     f"flash fwd {fp['flash_attention_us_per_launch']:.1f} us"
                     f" and bwd {fp['flash_attention_bwd_us_per_launch']:.1f}"
                     " us a launch") + f"; peak memory {peak:.2f} GiB")
    for kname, us_ in fp["top_kernels_us"]:
        print(f"    {us_:9.1f} us  {kname[:90]}")
    del step, opt, first
    return out, launches, tally, b


def _decode_vs_forward(cfg, params, frames, tok, dev):
    """Batch-1 teacher-forced decode of ``tok`` (1, S) with the
    cross-attention cache filled from ``encoder_kv`` of ``frames``, against
    the forward on the same frames: the largest logit gap, the gap of a
    first step with a zero cross cache, and the forward's change under a
    1e-7 relative change of the embedding, each over max(1, max|logit|)."""
    import torch
    from repro_torch.models import lm
    S = tok.shape[1]
    with torch.no_grad():
        full = lm.forward(cfg, params, tok, encoder_frames=frames)[0][0]
        nudged = lm.forward(cfg, dict(params, embed=params["embed"]
                                      * (1 + 1e-7)), tok,
                            encoder_frames=frames)[0][0]
        kv = lm.encoder_kv(cfg, params, lm.encode(cfg, params, frames))
        zero = lm.decode_step(cfg, params, lm.init_cache(cfg, 1, S, dev),
                              tok[:, :1], torch.tensor([0], device=dev))[0]
        cache = lm.init_cache(cfg, 1, S, dev)
        for j in range(lm.block_period(cfg)):
            cache[f"blk{j}"]["xk"].copy_(kv["k"][j])
            cache[f"blk{j}"]["xv"].copy_(kv["v"][j])
        rows = []
        for t in range(S):
            lg, _ = lm.decode_step(cfg, params, cache, tok[:, t:t + 1],
                                   torch.tensor([t], device=dev))
            rows.append(lg[0])
        dec = torch.stack(rows)
    scale = max(1.0, float(full.abs().max()))
    return {"gap": float((dec - full).abs().max()) / scale,
            "zero_gap": float((zero[0] - full[0]).abs().max()) / scale,
            "sens": float((nudged - full).abs().max()) / scale,
            "scale": scale}


def encdec_slice(dev, gen, report):
    """Slice 10 (V1-V4): phi-3-vision-4.2b and whisper-small at full width
    and depth -- the flash kernels at the new main-path shapes (V1),
    phi-3's prefill with image embeddings and its server (V2), whisper's
    encoder-decoder prefill, its decode with a filled cross-attention
    cache and its server with a zero one (V3), and training of both
    (V4), with CPU twins. Returns the kernels-line entries of the flash
    forward and backward at the three shapes."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.models.params import flatten, unflatten

    def ms(busy):
        return None if busy is None else busy / 1e3

    gc.collect()
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    # -- V1. the kernels at the new shapes, against their plain version ---
    t_s = time.perf_counter()
    entries = {}
    for name, (B, H, K, S, D, causal) in V_ATTN.items():
        what = (f"{name} B={B} H={H} K={K} S={S} D={D} "
                f"{'causal' if causal else 'non-causal'} bf16")
        q, k, v, do = _qkvo(gen, dev, B, H, K, S, D, bf)
        o, lse, res = hold_flash(q, k, v, do, 0, 0.0, f"V1 flash {what}",
                                 causal)
        print(f"  V1 flash {what}: {_held(res)}")
        fb, bb = _flash_bounds(B, H, K, S, D, 0, causal)

        def fwd(a, b, c, cz=causal):
            return ops.flash_attention(a, b, c, cz)

        def bwd(*a, cz=causal):
            return ops.flash_attention_bwd(*a, cz)

        def plain(a, b, c, cz=causal):
            return ref.flash_attention(a, b, c, cz)

        def plain_b(*a, cz=causal):
            return ref.flash_attention_bwd(*a, cz)

        def sdpa(a, b, c, cz=causal):
            return F.scaled_dot_product_attention(a, b, c, is_causal=cz)
        check(_max_err(sdpa(q, k, v), o) <= 5e-2 * max(
            1.0, float(o.float().abs().max())),
            f"V1 {name}: SDPA disagrees with the kernel")
        args = (q, k, v, o, lse, do)
        lbwd = _bwd_graph(sdpa, q, k, v, do)
        tf = {"ms": median_ms(fwd, q, k, v),
              "plain_ms": median_ms(plain, q, k, v, reps=3, inner=3),
              "library_ms": median_ms(sdpa, q, k, v),
              "device_ms": ms(device_us([(fwd, (q, k, v))], reps=3,
                                        expect={"flash_tc_kernel": 1})[0]),
              "library_device_ms": ms(device_us([(sdpa, (q, k, v))],
                                                reps=3)[0]),
              "max_abs_err": res["fwd_max_abs_err"], **fb}
        tb = {"ms": median_ms(bwd, *args, inner=10),
              "plain_ms": median_ms(plain_b, *args, reps=3, inner=2),
              "library_ms": median_ms(lbwd, inner=10),
              "device_ms": ms(device_us([(bwd, args)], reps=3, expect={
                  c: 1 for c in LT_CNAMES["flash_attention_bwd"]})[0]),
              "library_device_ms": ms(device_us([(lbwd, ())], reps=3)[0]),
              "max_abs_err": res["bwd_max_abs_err"], **bb}
        for kname, t in (("flash_attention", tf), ("flash_attention_bwd",
                                                   tb)):
            check_bound(f"V1 {kname}[{name}]", {
                kk: vv for kk, vv in t.items() if kk.endswith("ms") and kk
                not in ("bound_ms", "ops_ms", "bytes_ms")}, t["bound_ms"])
            entries[f"{kname}[{name}]"] = t
            print(f"  time {kname} [{what}]: " + ", ".join(
                f"{kk} {vv:.5g}" if isinstance(vv, float) else f"{kk} {vv}"
                for kk, vv in t.items()) + "; library: F.scaled_dot_product_"
                f"attention, is_causal={causal}")
        del q, k, v, do, o, lse, lbwd
        torch.cuda.empty_cache()
    report["v1"] = entries
    print(f"V1 done in {time.perf_counter() - t_s:.1f} s")

    # -- V2. phi-3-vision: prefill with images and the server, counted ----
    t_s = time.perf_counter()
    path = {}                          # model -> [(launches, tally), ...]
    cfg = get_config("phi-3-vision-4.2b")
    t = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(
        SEED + 100), dev)
    torch.cuda.synchronize()
    n_par = sum(p_.numel() for p_ in _leaves(params))
    print(f"phi-3-vision-4.2b: {n_par} parameters, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, drawn on the card in "
          f"{time.perf_counter() - t:.1f} s")
    N = cfg.num_image_tokens
    img = torch.randn(LM_B, N, cfg.d_model, generator=gen).to(dev, bf)
    tok = torch.from_numpy(next(synthetic.token_batches(
        LM_B, LM_S, cfg.vocab_size, seed=0))[0]["tokens"]).to(dev)
    torch.cuda.synchronize()
    with _attn_tally() as tally:
        ops.reset_launches()
        t_main = time.perf_counter()
        with torch.no_grad():
            logits, _ = lm.forward(cfg, params, tok, image_embeds=img)
            done, secs, steps, _ = _serve_recorded(cfg, params, dev)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t_main
        launches = ops.launches()
    path["phi-3-vision-4.2b"] = [(launches, list(tally))]
    check(launches == {**{k_: 0 for k_ in launches},
                       "flash_attention": cfg.num_layers}
          and len(tally) == cfg.num_layers,
          f"V2 phi-3: launches {launches}, not {cfg.num_layers} "
          "flash_attention (one a layer of the prefill; decode runs none)")
    check(tuple(logits.shape) == (LM_B, LM_S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "V2 phi-3: logits")
    with torch.no_grad():
        text = lm.forward(cfg, params, tok)[0]
    check(not torch.equal(text[:, N:], logits[:, N:]), "V2 phi-3: the "
          "image embeddings change no logit after them")
    del logits, text
    toks = sum(len(r.out_tokens) for r in done)
    check(len(done) == SERVE_REQUESTS and toks == SERVE_REQUESTS * SERVE_NEW,
          f"V2 phi-3 server: {len(done)} requests, {toks} tokens")
    fp = _prefill_profile(
        lambda: lm.forward(cfg, params, tok, image_embeds=img),
        cfg.num_layers, f"V2 phi-3-vision-4.2b prefill B={LM_B} S={LM_S} "
        f"with {N} image embeddings")
    sv = _served_vs_forward(cfg, params, done, steps, dev,
                            "V2 phi-3 server bf16")
    print(f"  V2 phi-3 server: {toks} tokens in {secs:.2f} s "
          f"({toks / secs:.1f} tok/s, batch {SERVE_BATCH}, bf16); against "
          f"the teacher-forced text-only forward: {sv['checked']} of "
          f"{sv['compared']} the forward's argmax at margins of at least "
          f"{S2_TIE['bfloat16']} x max(1, max|logit|), logits within "
          f"{sv['max_gap_rel']:.3g} x that")
    c1, flat1 = _first_repeat(cfg, params)
    del params, steps, done
    torch.cuda.empty_cache()
    twin = _lm_twin(c1, flat1, tok[:1, :V_TWIN_S].cpu(),
                    {"image_embeds": img[:1].float().cpu()}, dev,
                    f"V2 phi-3 card vs CPU, 1 layer, S={V_TWIN_S} with {N} "
                    "image embeddings")
    del flat1, tok, img
    report["v2"] = {"parameters": n_par, "main_path_s": t_main,
                    "prefill": fp, "serve": {"tokens": toks, "seconds": secs,
                                             "tokens_per_s": toks / secs},
                    "served_vs_forward": sv, "twin": twin}
    print(f"V2 done in {time.perf_counter() - t_s:.1f} s")

    # -- V3. whisper-small: encoder-decoder prefill, decode, server -------
    t_s = time.perf_counter()
    cfg = get_config("whisper-small")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(
        SEED + 101), dev)
    n_par = sum(p_.numel() for p_ in _leaves(params))
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    Fr = cfg.num_encoder_frames
    print(f"whisper-small: {n_par} parameters, {n_enc} encoder and {n_dec} "
          f"decoder layers, d_model {cfg.d_model}, {Fr} frames")
    B, S = V_WHISPER_B, V_WHISPER_S
    frames = torch.randn(B, Fr, cfg.d_model, generator=gen).to(dev, bf)
    tok = torch.from_numpy(next(synthetic.token_batches(
        B, S, cfg.vocab_size, seed=0))[0]["tokens"]).to(dev)
    torch.cuda.synchronize()
    with _attn_tally() as tally:
        ops.reset_launches()
        t_main = time.perf_counter()
        with torch.no_grad():
            logits, _ = lm.forward(cfg, params, tok, encoder_frames=frames)
            done, secs, steps, _ = _serve_recorded(cfg, params, dev)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t_main
        launches = ops.launches()
    path["whisper-small"] = [(launches, list(tally))]
    check(launches == {**{k_: 0 for k_ in launches},
                       "flash_attention": n_enc + n_dec}
          and sorted(c for c, _ in tally) == [False] * n_enc + [True] * n_dec,
          f"V3 whisper: launches {launches}, attention calls "
          f"{[c for c, _ in tally]}: not {n_enc} non-causal and {n_dec} "
          "causal flash launches (decode runs none)")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "V3 whisper: logits")
    del logits
    toks = sum(len(r.out_tokens) for r in done)
    check(len(done) == SERVE_REQUESTS and toks == SERVE_REQUESTS * SERVE_NEW,
          f"V3 whisper server: {len(done)} requests, {toks} tokens")
    fp = _prefill_profile(
        lambda: lm.forward(cfg, params, tok, encoder_frames=frames),
        n_enc + n_dec, f"V3 whisper-small prefill B={B}: {Fr} frames "
        f"through the encoder, {S} tokens through the decoder")
    del steps, done
    # the server's cross cache is zero (as the reference's): its tokens
    # against batch-1 decode of a zero cross cache. Whisper's logits are
    # O(1) (max|logit| about 1), so bf16 noise swamps their top-2 margins;
    # a second server on the same weights widened to f32 is held to the f32
    # batch-1 decode at margins over BATCH_TIE, as slice 2 holds batching
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = unflatten({k_: v_.float() for k_, v_ in flatten(params).items()})
    done32, _, steps32, _ = _serve_recorded(c32, p32, dev)
    sv = _served_vs_forward(c32, p32, done32, steps32, dev,
                            "V3 whisper server f32",
                            teacher=_zero_cross_decode, tie=BATCH_TIE,
                            least=BATCH_LEAST)
    print(f"  V3 whisper server: {toks} tokens in {secs:.2f} s "
          f"({toks / secs:.1f} tok/s, batch {SERVE_BATCH}, bf16, zero cross "
          "cache); the same server in f32 against batch-1 decode of a zero "
          f"cross cache: {sv['checked']} of {sv['compared']} tokens its "
          f"argmax at margins of at least {BATCH_TIE} x max(1, max|logit|), "
          f"logits within {sv['max_gap_rel']:.3g} x that")
    del steps32, done32
    # decode with the cross cache filled from encoder_kv, f32: one repeat
    # (the tight check), then full depth
    c1, flat1 = _first_repeat(cfg, params)
    fr1, tk1 = frames[:1].float(), tok[:1]
    dvf = {}
    for depth, c_, p_ in (
            ("1 repeat", c1, unflatten({k_: v_.to(dev)
                                        for k_, v_ in flat1.items()})),
            ("full depth", c32, p32)):
        r_ = dvf[depth] = _decode_vs_forward(c_, p_, fr1, tk1, dev)
        lim = V3_GAP + (0.0 if depth == "1 repeat" else SENS_K * r_["sens"])
        check(r_["gap"] <= lim, f"V3 whisper {depth} decode with filled "
              f"cross K/V vs the forward: {r_['gap']} x the scale > {lim}")
        check(depth != "1 repeat" or r_["zero_gap"] > lim, f"V3 whisper "
              f"{depth}: a zero cross cache decodes within "
              f"{r_['zero_gap']} x the scale of the frames' forward: the "
              "frames do not reach decode")
        print(f"  V3 whisper batch-1 decode {depth}, {c_.encoder_layers}+"
              f"{c_.num_layers} layers, cross K/V from encoder_kv, f32, "
              f"{S} positions: logits within {r_['gap']:.3g} x max(1, "
              f"max|logit|) ({r_['scale']:.3g}) of the forward's (limit "
              f"{lim:.3g}; the forward's change under a 1e-7 change of the "
              f"embedding {r_['sens']:.3g}); a zero cross cache "
              f"{r_['zero_gap']:.3g} off at position 0")
        del p_
    del p32
    twin = _lm_twin(c1, flat1, tok[:1, :V_TWIN_S].cpu(),
                    {"encoder_frames": frames[:1].float().cpu()}, dev,
                    f"V3 whisper card vs CPU, 1 encoder and 1 decoder "
                    f"layer, {Fr} frames, S={V_TWIN_S}")
    del flat1, frames, tok
    report["v3"] = {"parameters": n_par, "main_path_s": t_main,
                    "prefill": fp, "serve": {"tokens": toks, "seconds": secs,
                                             "tokens_per_s": toks / secs},
                    "served_vs_zero_cross_decode": sv,
                    "decode_vs_forward": dvf, "twin": twin}
    print(f"V3 done in {time.perf_counter() - t_s:.1f} s")

    # -- V4. training through make_lm_step, counted ------------------------
    t_s = time.perf_counter()
    B, S, n = V4_WHISPER
    wframes = torch.randn(n, B, Fr, cfg.d_model, generator=gen).to(bf)
    wtok = synthetic.token_batches(B, S, cfg.vocab_size, seed=SEED)

    def whisper_batch(i):
        b = {k_: torch.from_numpy(v_).to(dev)
             for k_, v_ in next(wtok)[0].items()}
        b["encoder_frames"] = wframes[i].to(dev)
        return b
    v4 = {}
    v4["whisper-small"], launches, tally, _ = _train_steps(
        cfg, params, whisper_batch, n, n_enc + n_dec,
        f"V4 whisper-small B={B} S={S} over {Fr} frames")
    path["whisper-small"].append((launches, tally))
    check(sorted(c for c, _ in tally) == [False] * (n * n_enc)
          + [True] * (n * n_dec), "V4 whisper: not one non-causal flash a "
          "step and encoder layer")
    enc = {k_: p_ for k_, p_ in flatten(params).items()
           if k_.startswith("encoder.")}
    check(len(enc) == 9 and all(
        p_.grad is not None and bool(torch.isfinite(p_.grad).all())
        and bool(p_.grad.any()) for p_ in enc.values()),
          "V4 whisper: an encoder leaf got no finite, nonzero gradient")
    del params, enc, wframes
    gc.collect()
    torch.cuda.empty_cache()
    base = get_config("phi-3-vision-4.2b")
    cfg = dataclasses.replace(base, num_layers=V4_PHI_LAYERS)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(
        SEED + 102), dev)
    B, S, n = V4_PHI
    pimg = torch.randn(n, B, N, cfg.d_model, generator=gen).to(bf)
    ptok = synthetic.token_batches(B, S, cfg.vocab_size, seed=SEED + 1)

    def phi_batch(i):
        b = {k_: torch.from_numpy(v_).to(dev)
             for k_, v_ in next(ptok)[0].items()}
        b["image_embeds"] = pimg[i].to(dev).requires_grad_(True)
        return b
    v4["phi-3-vision-4.2b"], launches, tally, last = _train_steps(
        cfg, params, phi_batch, n, cfg.num_layers,
        f"V4 phi-3-vision-4.2b {cfg.num_layers} layers (cut from "
        f"{base.num_layers}: one card's 80 GB) B={B} S={S} with {N} image "
        "embeddings")
    path["phi-3-vision-4.2b"].append((launches, tally))
    g = last["image_embeds"].grad
    check(g is not None and bool(torch.isfinite(g).all()) and bool(g.any()),
          "V4 phi-3: no gradient reached the image embeddings")
    del params, pimg, last, g
    gc.collect()
    torch.cuda.empty_cache()
    report["v4"] = v4
    print(f"V4 done in {time.perf_counter() - t_s:.1f} s")

    # the kernels line: launches on each model's main path (V2-V4), split
    # by the attention calls' causal flag for whisper's encoder and decoder
    def counted(model, causal):
        fwd = bwd = 0
        for launches, tally in path[model]:
            check(launches["flash_attention"] == len(tally)
                  and launches["flash_attention_bwd"] == sum(
                      g_ for _, g_ in tally), f"{model}: launches "
                  f"{launches} do not number its attention calls")
            sel = [g_ for c, g_ in tally if causal is None or c == causal]
            fwd, bwd = fwd + len(sel), bwd + sum(sel)
        return fwd, bwd
    out = []
    for name, model, causal in (
            ("whisper-small encoder", "whisper-small", False),
            ("whisper-small decoder", "whisper-small", True),
            ("phi-3-vision-4.2b", "phi-3-vision-4.2b", None)):
        n_fwd, n_bwd = counted(model, causal)
        for kname, replaces, n_ in (
                ("flash_attention", "src/repro/kernels/flash_attention.py:65",
                 n_fwd),
                ("flash_attention_bwd", "none: no TPU kernel (the "
                 "reference's LM forward is jnp code that XLA "
                 "differentiates, src/repro/models/layers.py:165)", n_bwd)):
            t = entries[f"{kname}[{name}]"]
            # the step's profile names one kernel for whisper's encoder and
            # decoder launches: their mean, under its own key
            step_us = v4[model].get(f"{kname}_us_per_launch")
            step_ms = None if step_us is None else step_us / 1e3
            mean = ({} if causal is None else
                    {"step_device_ms_encoder_and_decoder_mean": step_ms})
            out.append({
                "name": f"{kname}[{name}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": replaces, "launches": n_,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
                "step_device_ms": step_ms if causal is None else None,
                **mean,
                "library": "F.scaled_dot_product_attention, is_causal="
                           f"{bool(causal) if causal is not None else True}"})
    return out


def row(shape, fns, args, nbytes, op_secs, library_args=None):
    """CUDA-event times of kernel, plain version and library call (None if
    there is none; on ``library_args`` if given, else on the same inputs),
    beside the bound: the larger of the bytes over the memory rate and the
    operations over their rate."""
    kernel, plain, library = fns
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = op_secs * 1e3
    return dict(shape=shape, ms=median_ms(kernel, *args),
                plain_ms=median_ms(plain, *args),
                library_ms=(None if library is None
                            else median_ms(library, *(library_args or args))),
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def int_mm_scaled(a, b, sa, sb):
    """cuBLASLt's int8 GEMM and the dequant in PyTorch: int8_matmul's
    library yardstick, never called by the port. It is timed on B as
    ``stored_weight`` keeps it."""
    import torch
    return torch._int_mm(a, b).float() * sa[:, None] * sb[None, :]


def stored_weight(a, b, sa, sb):
    """int8_matmul's inputs with B (K, N) stored column by column, as
    nn.Linear stores a weight (x @ W.t()), made once outside any timed call:
    on that layout torch._int_mm runs cuBLASLt's int8 tensor-core kernel;
    on a row-major B it runs a slower sm80 kernel (both are timed)."""
    return a, b.t().contiguous().t(), sa, sb


def l2_flushes(dev):
    """Two calls that flush the L2 cache (50 MB) through a buffer of
    FLUSH_BYTES before a per-shape call, so that the call reads its inputs
    from device memory:

      * "dirty" writes the buffer: every line the call brings in, read or
        written, evicts a dirty line whose write-back it pays, so no reading
        can beat the bytes bound of its inputs and outputs, but a reading
        holds up to one foreign write-back per line it moves;
      * "clean" reads the buffer: the call pays no foreign write-back, and
        its outputs can stay in the L2 past its end, so its reading is held
        only to the bytes of its inputs (``in_bound_ms``)."""
    import torch
    buf = torch.ones(FLUSH_BYTES // 4, device=dev)
    return {"dirty": lambda: buf.fill_(1.0), "clean": lambda: buf.sum()}


def group_device_ms(fn, arg_list, flush, cname=None):
    """Device ms of one call of ``fn`` at each of ``arg_list``, from one
    capture-checked profiler window over the whole group, each call after
    ``flush``; None where the capture fell short. With ``cname``, the window
    must hold one launch of that kernel per call."""
    calls = []
    for args in arg_list:
        calls += [(flush, ()), (fn, args)]
    _, _, capture = device_us(calls, expect=None if cname is None
                              else {cname: len(arg_list)})
    per = capture.get("per_call_us")
    if per is None:
        print(f"    per-call device times not found: {capture}")
    return [None if per is None else per[2 * i + 1] / 1e3
            for i in range(len(arg_list))]


def time_gemm_shapes(dev, gen, mm_groups, q_groups):
    """int8_matmul and quantize_rows at every shape of their groups
    (``gemm_groups``): CUDA-event times of kernel, plain version and library
    call (``row``), then device times at each shape, one window per group
    and reading, each call after an L2 flush (``l2_flushes``): the kernel
    after either flush (``device_ms``, ``clean_device_ms``), int8_matmul's
    library call on the stored weight after either
    (``library_device_ms``, ``library_clean_device_ms``), on a row-major B
    after the dirty one (``library_rowmajor_device_ms``), and its GEMM alone
    (torch._int_mm on the stored weight, int32 out, no dequant) after the
    dirty one (``int_mm_device_ms``). Returns the rows by kernel name."""
    import torch
    from repro_torch.kernels import ops, ref
    rows = {"int8_matmul": [], "quantize_rows": []}
    inputs = {"int8_matmul": {}, "quantize_rows": {}}
    lib_inputs = {}
    for group in mm_groups.values():
        for m, k, n in group:
            args = (torch.randint(-128, 128, (m, k), generator=gen,
                                  dtype=torch.int8).to(dev),
                    torch.randint(-128, 128, (k, n), generator=gen,
                                  dtype=torch.int8).to(dev),
                    torch.rand(m, generator=gen).to(dev),
                    torch.rand(n, generator=gen).to(dev))
            inputs["int8_matmul"][m, k, n] = args
            lib_inputs[m, k, n] = stored_weight(*args)
            in_bytes = m * k + k * n + 4 * (m + n)
            rows["int8_matmul"].append(row(
                (m, k, n), (ops.int8_matmul, ref.int8_matmul, int_mm_scaled),
                args, in_bytes + 4 * m * n,
                2 * m * n * k / INT8_OPS_PER_S + 2 * m * n / FP32_OPS_PER_S,
                library_args=lib_inputs[m, k, n]))
            rows["int8_matmul"][-1]["in_bytes_ms"] = (
                in_bytes / HBM_BYTES_PER_S * 1e3)
    for group in q_groups.values():
        for m, n in group:
            args = (torch.randn(m, n, generator=gen).to(dev),)
            inputs["quantize_rows"][m, n] = args
            rows["quantize_rows"].append(row(
                (m, n), (ops.quantize_rows, ref.quantize_rows, None), args,
                5 * m * n + 4 * m, 6 * m * n / FP32_OPS_PER_S))
            rows["quantize_rows"][-1]["in_bytes_ms"] = (
                4 * m * n / HBM_BYTES_PER_S * 1e3)
    flushes = l2_flushes(dev)
    readings = {
        "int8_matmul": [
            ("device_ms", ops.int8_matmul, inputs["int8_matmul"], "dirty"),
            ("clean_device_ms", ops.int8_matmul, inputs["int8_matmul"],
             "clean"),
            ("library_device_ms", int_mm_scaled, lib_inputs, "dirty"),
            ("library_clean_device_ms", int_mm_scaled, lib_inputs, "clean"),
            ("library_rowmajor_device_ms", int_mm_scaled,
             inputs["int8_matmul"], "dirty"),
            ("int_mm_device_ms", torch._int_mm,
             {s: args[:2] for s, args in lib_inputs.items()}, "dirty")],
        "quantize_rows": [
            ("device_ms", ops.quantize_rows, inputs["quantize_rows"],
             "dirty"),
            ("clean_device_ms", ops.quantize_rows, inputs["quantize_rows"],
             "clean")]}
    cnames = {"int8_matmul": "int8_mm_kernel",
              "quantize_rows": "quantize_rows_kernel"}
    for name, groups in (("int8_matmul", mm_groups),
                         ("quantize_rows", q_groups)):
        by_shape = {r["shape"]: r for r in rows[name]}
        for r in rows[name]:
            r["in_bound_ms"] = max(r["in_bytes_ms"], r["ops_ms"])
        for group, shapes in groups.items():
            for s in shapes:
                by_shape[s]["group"] = group
            for key, fn, arg_of, flush in readings[name]:
                got = group_device_ms(
                    fn, [arg_of[s] for s in shapes], flushes[flush],
                    cnames[name] if fn is getattr(ops, name) else None)
                for s, ms in zip(shapes, got):
                    by_shape[s][key] = ms
    return rows


def gemm_groups(get_config, xr):
    """The shapes int8_matmul and quantize_rows are timed at, in three
    groups: the calibration corners (the main path's calls); the XR 1x1
    GEMMs, every expand and project layer of DetNet at batch 8 and EDSNet at
    batch 2 as (M = batch H W, K = in_ch, N = out_ch), and (M, out_ch) for
    quantize_rows; and Llama-3.2-1B's MLP projection at prefill B x S =
    LM_B x LM_S, (B S, d_model, d_ff) and (B S, d_model)."""
    mm = {"corner": [(128, 128, 128)], "xr": [], "lm": []}
    qr = {"corner": [(256, 512)], "xr": [], "lm": []}
    for net, batch in (("detnet", 8), ("edsnet", 2)):
        specs = [s for s in xr.conv_layer_specs(get_config(net))
                 if s.name.endswith(("_expand", "_project"))]
        mm["xr"] += sorted({(batch * s.in_hw[0] * s.in_hw[1], s.in_ch,
                             s.out_ch) for s in specs})
        qr["xr"] += sorted({(batch * s.in_hw[0] * s.in_hw[1], s.out_ch)
                            for s in specs})
    llama = get_config("llama3.2-1b")
    mm["lm"] = [(LM_B * LM_S, llama.d_model, llama.d_ff)]
    qr["lm"] = [(LM_B * LM_S, llama.d_model)]
    return mm, qr


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


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
    spills = []
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
            if re.search(r"\b[1-9]\d* bytes spill", line):
                spills.append(f"{name}: {line.strip()}")
    check(not spills, f"register spills: {spills}")
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": secs,
              "profiler_edge_loss": [edge_loss(t0)]}

    # -- main-path shapes --------------------------------------------------
    det_cfg, eds_cfg = get_config("detnet"), get_config("edsnet")
    det_b, eds_b = 8, 2

    def dw_shapes(cfg, batch):
        hw = {}
        xr._walk(cfg, lambda st, src: hw.setdefault(st.name, src))
        return [(batch, *hw[st.name][:2], hw[st.name][2])
                for st in xr.build_plan(cfg) if xr.uses_depthwise_kernel(st)]

    dw_main = dw_shapes(det_cfg, det_b) + dw_shapes(eds_cfg, eds_b)
    mm_groups, q_groups = gemm_groups(get_config, xr)
    mm_shapes = [s for g in mm_groups.values() for s in g]  # corner first
    q_shapes = [s for g in q_groups.values() for s in g]
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
    print(f"XR main path: {t_main:.2f} s, launches {launches}")
    for name in XR_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the XR path")
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
    def conv_dw(x, w):                       # cuDNN/ATen depthwise conv
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1,
                        groups=x.shape[-1])

    rows = {"depthwise_conv3x3": []}
    for shape in dw_main:                      # f32, as the forward runs
        B, H, W, C = shape
        x = torch.randn(shape, generator=gen).to(dev)
        w = torch.randn(C, 1, 3, 3, generator=gen).to(dev)
        rows["depthwise_conv3x3"].append(row(
            shape, (ops.depthwise_conv3x3, ref.depthwise_conv3x3, conv_dw),
            (x, w), 4 * (2 * B * H * W * C + 9 * C),
            18 * B * H * W * C / FP32_OPS_PER_S))
    rows.update(time_gemm_shapes(dev, gen, mm_groups, q_groups))
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
                                int_mm_scaled),     # on the stored weight
                "quantize_rows": (ops.quantize_rows, ref.quantize_rows, None)}
    # device time of one main-path pass of each kernel (depthwise: the 26
    # steps; the others: their calibration corner), its capture held to the
    # launches the kernel's wrapper made
    cnames = {"depthwise_conv3x3": "dw3x3_kernel",
              "int8_matmul": "int8_mm_kernel",
              "quantize_rows": "quantize_rows_kernel"}
    device = {}
    for name, fns in variants.items():
        device[name] = {}
        for label, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            if fn is None:
                device[name][label] = None
                continue
            arg_list = dev_inputs[name]
            if fn is int_mm_scaled:
                arg_list = [stored_weight(*a) for a in arg_list]
            busy, _, capture = device_us(
                [(fn, a) for a in arg_list],
                expect={cnames[name]: len(dev_inputs[name])}
                if label == "ms" else None)
            device[name][label] = None if busy is None else busy / 1e3
            per_call = capture.get("per_call_us")
            if name == "depthwise_conv3x3" and per_call:
                for r, us in zip(rows[name], per_call):
                    r[label.replace("ms", "device_ms")] = us / 1e3
        print(f"  device time per main-path pass {name}: {device[name]}")
    report["device_ms"] = device

    for label, net, x, sc in (("DetNet b8", det, det_img, det_scales),
                              ("EDSNet b2", eds, eds_img, eds_scales)):
        fp, by_name = wall_profile(
            lambda n=net, x=x, sc=sc: ptq.forward_int8(n, x, act_scales=sc),
            reps=5, expect={"dw3x3_kernel": 13})
        report[f"forward {label}"] = fp
        busy = fp["device_busy_ms"]
        print(f"  forward_int8 {label}: wall {fp['wall_ms']:.3f} ms, device "
              "busy " + ("not measured" if busy is None else
                         f"{busy:.3f} ms, idle share {fp['idle_share']:.3f}"))
        for kname, us in fp["top_kernels_us"]:
            print(f"    {us:9.1f} us  {kname[:90]}")
        if by_name:
            us = sum(v for k, v in by_name.items() if "dw3x3_kernel" in k)
            fp["depthwise_us"] = us
            fp["depthwise_share"] = us / 1e3 / busy
            print(f"    depthwise_conv3x3: {us:.1f} us in 13 launches, "
                  f"{100 * fp['depthwise_share']:.1f}% of the forward's "
                  "device time")

    for name, rs in rows.items():
        for r in rs:
            check_bound(f"{name} {r['shape']}", {
                k: r.get(k) for k in ("ms", "plain_ms", "library_ms",
                                      "device_ms", "library_device_ms",
                                      "library_rowmajor_device_ms",
                                      "int_mm_device_ms")},
                r["bound_ms"])
            if "in_bound_ms" in r:
                check_bound(f"{name} {r['shape']} after a clean flush", {
                    k: r.get(k) for k in ("clean_device_ms",
                                          "library_clean_device_ms")},
                    r["in_bound_ms"])
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            dev_us = "".join(
                f"  {k[:-10] or 'kernel'} device {1e3 * r[k]:.2f} us"
                for k in ("device_ms", "clean_device_ms", "plain_device_ms",
                          "library_device_ms", "library_clean_device_ms",
                          "library_rowmajor_device_ms", "int_mm_device_ms")
                if r.get(k) is not None)
            print(f"  time {name:17s} {str(r['shape']):22s} kernel "
                  f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f}  library "
                  f"{lib}  bound {r['bound_ms']:.5f} ({r['bound_by']})"
                  + dev_us)
    report["times"] = rows

    phase_s = {"build and XR (slice 1)": time.perf_counter() - t0}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    # -- slice 2: the LM path (LM 1-5 in lm_slice) --------------------------
    lm_entries = phase("LM serving (slice 2)", lm_slice, dev, gen, report)

    # -- slice 5: XR training (T1-T4 in train_slice) -----------------------
    train_entry, trained = phase("XR training (slice 5)", train_slice, dev,
                                 gen, report, dw_shapes)

    # -- slice 11: the paper's pipeline (PP1-PP2 in pipeline_slice) --------
    phase("paper pipeline (slice 11)", pipeline_slice, dev, report, trained,
          samples)
    check(phase_s["paper pipeline (slice 11)"] < 60,
          "the paper pipeline phase took a minute or more")
    del trained

    # -- slice 6: LM training (LT1-LT5 in lm_train_slice) ------------------
    lm_train_entries = phase("LM training (slice 6)", lm_train_slice, dev,
                             gen, report)

    # -- slice 9: the dense and MoE decoders (S1-S5 in arch_slice) ---------
    arch_entries = phase("dense and MoE decoders (slice 9)", arch_slice, dev,
                         gen, report)

    # -- slice 10: phi-3-vision and whisper-small (V1-V4 in encdec_slice) --
    encdec_entries = phase("phi-3-vision and whisper-small (slice 10)",
                           encdec_slice, dev, gen, report)
    report["phase_s"] = phase_s

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
        check_bound(name, {"ms": r["ms"], "plain_ms": r["plain_ms"],
                           "library_ms": r["library_ms"],
                           **{f"device {k}": v
                              for k, v in device[name].items()}},
                    r["bound_ms"])
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
    kernels += (lm_entries + [train_entry] + lm_train_entries + arch_entries
                + encdec_entries)
    report["kernels"] = kernels
    report["profiler_edge_loss"].append(edge_loss(t0))
    print("profiler loss at an unpadded window's start: " + "; ".join(
        f"{e['captured']} of {e['of']} spin kernels captured at "
        f"{e['at_s']:.0f} s" for e in report["profiler_edge_loss"]))
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
