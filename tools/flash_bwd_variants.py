#!/usr/bin/env python3
"""Build variants of the flash-attention kernels and time their bf16
backward in turns, on the card.

    PYTHONPATH=src python tools/flash_bwd_variants.py NAME=[FLAGS] ...
        [--out build/flash_bwd_variants.json]

Each NAME=FLAGS compiles ``src/repro_torch/kernels/csrc/flash_attention.cu``
with nvcc's flags of ``kernels/_build.py`` plus FLAGS, comma-separated
(``base=`` is the source as it is; ``wg1=-DFLASH_BWD_WGS=1`` sets the
backward's warpgroups a block), all in parallel, and prints each backward
kernel's registers, spills and any ptxas warning. Every variant is then
held to ``ref.flash_bwd_limit`` (bf16) against the plain backward, and to
the same bits on a second call, at every head dim over ragged, grouped,
causal and non-causal shapes; and timed at B=2, S=2048, 32 query over 8
kv heads, causal, at every head dim: CUDA-event medians per call of 20,
the variants in turns (a, b, ..., then reversed, three times) with the
least kept, beside the profiler's device time of each of the backward's
launches (a window padded with spin kernels at its start, where the
profiler drops events; a launch not captured every time reads "not
measured"). Prints the card's name and power limit first; refuses
without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, KV, S = 2, 32, 8, 2048
CHECKS = ((2, 8, 2, 1000), (1, 4, 4, 130), (1, 2, 1, 1))   # (B, H, K, S)
TOL = 3e-5                   # chip_smoke.py's FLASH_TOL
PAD, REPS = 96, 5            # spin kernels before a profiled window, calls


def build(variants, out_dir):
    """{name: (ctypes launcher, ptxas summary lines)}, every variant built
    in parallel."""
    from repro_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    src = str(_build.CSRC / "flash_attention.cu")
    procs = {}
    for name, flags in variants.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *[f for f in flags.split(",") if f],
               "-o", os.path.join(out_dir, f"{name}.so"), src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name}: nvcc exited {p.returncode}\n{log}")
        lines, notes = log.splitlines(), []
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '.*?(flash_bwd_\w+?_tc)"
                          r"ILi(\d+)", line)
            if m:
                regs = re.search(r"Used (\d+) registers", lines[i + 3])
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 2])
                notes.append(f"{m.group(1)} D={m.group(2)}: "
                             f"{regs.group(1) if regs else '?'} registers, "
                             f"{spill.group(1) if spill else '?'} bytes "
                             "spilled")
            if "Performance Loss" in line or "error" in line:
                notes.append(line.strip())
        fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")
                         ).flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (fn, notes)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=[FLAGS]")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "flash_bwd_variants.json"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        sys.exit("needs a card: the kernels have no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    variants = dict(v.split("=", 1) for v in args.variants)
    libs = build(variants, os.path.join(ROOT, "build", "flash_bwd_variants"))
    for name, (_, notes) in libs.items():
        for n in notes:
            print(f"  {name}: {n}")

    def use(name):
        fa._bwd_launcher = lambda: libs[name][0]

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)

    def inputs(b, h, kv, s, d):
        return [torch.randn(b, s, n, d, generator=gen).to(
            dev, torch.bfloat16).transpose(1, 2) for n in (h, kv, kv, h)]

    report = {"card": card, "variants": variants, "checks": [], "times": {}}
    for d in fa.HEAD_DIMS:
        for shape in CHECKS:
            for causal in (True, False):
                q, k, v, do = inputs(*shape, d)
                o, lse = fa.flash_attention(q, k, v, causal, with_lse=True)
                want = ref.flash_attention_bwd(q.float(), k.float(),
                                               v.float(), o.float(), lse,
                                               do.float(), causal)
                lims = ref.flash_bwd_limit(want, q, k, v, o, lse, do,
                                           causal, TOL, True)
                for name in libs:
                    use(name)
                    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
                    again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal)
                    torch.cuda.synchronize()
                    ratio = max(float(((g.float() - w).abs() / lim).max())
                                for g, w, lim in zip(got, want, lims))
                    same = all(map(torch.equal, got, again))
                    report["checks"].append([name, d, *shape, causal, ratio,
                                             same])
                    if not (ratio <= 1 and same):
                        sys.exit(f"{name} D={d} {shape} causal={causal}: "
                                 f"{ratio} of its bound, same bits {same}")
    print(f"checks: every variant within its bound and the same bits twice "
          f"at {len(report['checks'])} cases")

    def event_ms(fn, n=20):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    pairs = B * H * S * (S + 1) // 2
    for d in fa.HEAD_DIMS:
        q, k, v, do = inputs(B, H, KV, S, d)
        o, lse = fa.flash_attention(q, k, v, True, with_lse=True)
        call = (lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True))
        ms = {n: [] for n in libs}
        for name in (list(libs) + list(libs)[::-1]) * 3:
            use(name)
            ms[name].append(event_ms(call))
        row = {"bound_ms": 5 * 2 * d * pairs / 989e12 * 1e3}
        for name in libs:
            use(name)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PAD):         # the profiler drops a window's
                    torch.cuda._sleep(1_000_000)   # first events
                for _ in range(REPS):
                    call()
                torch.cuda.synchronize()
            # a launch whose events were not all captured: not measured
            split = {re.search(r"flash_bwd_\w+", e.key).group(0):
                     e.device_time_total / REPS / 1e3
                     if e.count == REPS else None
                     for e in prof.key_averages() if "flash_bwd" in e.key}
            row[name] = {"ms": min(ms[name]),
                         "ms_median": statistics.median(ms[name]),
                         "device_ms_by_kernel": split}
        report["times"][d] = row
        print(f"D={d} (bound {row['bound_ms']:.4f} ms): " + "; ".join(
            f"{n} {row[n]['ms']:.4f} ms (" + ", ".join(
                f"{k[10:]} " + ("not measured" if t is None else f"{t:.4f}")
                for k, t in row[n]["device_ms_by_kernel"].items()) + ")"
            for n in libs))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
