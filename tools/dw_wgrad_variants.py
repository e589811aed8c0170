#!/usr/bin/env python3
"""Time layouts of the depthwise weight-gradient kernel in turns, on the
card.

    PYTHONPATH=src python tools/dw_wgrad_variants.py NAME=[KNOB=V,...] ...
        [--out build/dw_wgrad_variants.json]

Each NAME=KNOBS sets constants of ``kernels/depthwise_conv`` that
``wgrad_plan`` reads (``base=`` keeps them as they are;
``one8=CLUSTER_ONE=8`` caps a chunk's only cluster at 8 blocks;
``wave1=WGRAD_BLOCKS=132`` caps the blocks at one an SM; the knobs are
WGRAD_FILL, WGRAD_BLOCKS, WGRAD_MAX_TH, WGRAD_MAX_TW, CLUSTER_ONE and
CLUSTER_MANY). The kernel itself takes any layout, so nothing is rebuilt:
the source is built once, and its ptxas line for each instance of
``dw3x3_wgrad_kernel`` (registers, spills) is printed. Every variant is
held to the rounding bound of ``wgrad_plan(...).depth`` against the f64
sum and to the same bits on a second call at the 12 distinct training
shapes (DetNet b8, EDSNet b4) and the edge shapes, with every ticket back
at 0 after. Then each is timed at the training shapes, the variants in
turns (a, b, ..., then reversed, three times), the least kept: the
device time of each call from a profiler window of all 12 shapes x 5
passes (padded with spin kernels at its start, where the profiler drops
events; a window that did not capture every launch reads "not
measured"), and the CUDA-event time per call of 20 back-to-back calls,
the host's cost included. Prints the card's name and power limit first;
refuses without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = [(8, 64, 64, 32), (8, 32, 32, 144), (8, 16, 16, 192),
         (8, 8, 8, 384), (8, 8, 8, 576), (8, 4, 4, 960),
         (4, 192, 320, 32), (4, 96, 160, 144), (4, 48, 80, 192),
         (4, 24, 40, 384), (4, 24, 40, 576), (4, 12, 20, 960)]
EDGES = [(2, 5, 3, 30), (2, 4, 4, 1), (1, 1, 1, 1), (2, 3, 5, 8),
         (2, 12, 20, 68), (3, 9, 7, 13), (1, 2, 2, 2049)]
KNOBS = ("WGRAD_FILL", "WGRAD_BLOCKS", "WGRAD_MAX_TH", "WGRAD_MAX_TW",
         "CLUSTER_ONE", "CLUSTER_MANY")
PAD, REPS = 96, 5            # spin kernels before a profiled window, passes
HBM_BYTES_PER_S = 3.35e12


def parse(spec: str):
    name, knobs = spec.split("=", 1)
    out = {}
    for kv in filter(None, knobs.split(",")):
        k, v = kv.split("=")
        if k not in KNOBS:
            sys.exit(f"{name}: unknown knob {k} (one of {', '.join(KNOBS)})")
        out[k] = int(v)
    return name, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=[KNOB=V,...]")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "dw_wgrad_variants.json"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import depthwise_conv as dwk

    if not torch.cuda.is_available():
        sys.exit("needs a card: the kernel has no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    _build.build(("depthwise_conv",))
    log = _build.BUILD_LOG.get("depthwise_conv", "").splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "wgrad" in line:
            print(f"  ptxas {line.split()[-1]}: " + " ".join(
                ln.strip() for ln in log[i + 1:i + 4]
                if "spill" in ln or "registers" in ln))
    variants = dict(map(parse, args.variants))
    defaults = {k: getattr(dwk, k) for k in KNOBS}

    def use(name):
        for k, v in {**defaults, **variants[name]}.items():
            setattr(dwk, k, v)
        dwk.wgrad_plan.cache_clear()

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(18)
    data = {s: (torch.randn(s, generator=gen).to(dev),
                torch.randn(s, generator=gen).to(dev)) for s in TRAIN + EDGES}
    report = {"card": card, "variants": variants, "checks": [], "times": {}}
    for s, (x, g) in data.items():
        exact = ref.depthwise_conv3x3_wgrad(x.double(), g.double())
        mag = ref.depthwise_conv3x3_wgrad(x.double().abs(), g.double().abs())
        for name in variants:
            use(name)
            bound = dwk.wgrad_plan(*s).depth * 2.0 ** -24 * mag
            got = dwk.depthwise_conv3x3_wgrad(x, g)
            again = dwk.depthwise_conv3x3_wgrad(x, g)
            torch.cuda.synchronize()
            off = (got.double() - exact).abs()
            ratio = float((off / bound)[bound > 0].max())
            ok = bool((off <= bound).all()) and torch.equal(got, again)
            report["checks"].append([name, s, ratio, ok])
            if not ok:
                sys.exit(f"{name} {s}: {ratio} of its bound, or not the same "
                         "bits twice")
    clean = all(bool((t == 0).all()) for t, _ in dwk._WORKSPACE.values())
    if not clean:
        sys.exit("a ticket was left dirty")
    print(f"checks: every variant within its bound and the same bits twice "
          f"at {len(report['checks'])} cases; every ticket back at 0")

    def event_ms(x, g, n=20):
        for _ in range(3):
            dwk.depthwise_conv3x3_wgrad(x, g)
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for _ in range(n):
            dwk.depthwise_conv3x3_wgrad(x, g)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def device_ms():
        """Each training shape's device ms from one padded window of REPS
        passes, None if the window lost a launch."""
        for s in TRAIN:
            dwk.depthwise_conv3x3_wgrad(*data[s])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(1_000_000)
            for _ in range(REPS):
                for s in TRAIN:
                    dwk.depthwise_conv3x3_wgrad(*data[s])
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                    for e in prof.events() if e.device_type ==
                    DeviceType.CUDA and "dw3x3_wgrad" in e.name)
        if len(ev) != REPS * len(TRAIN):
            return [None] * len(TRAIN)
        return [min(ev[r * len(TRAIN) + i][1] for r in range(REPS)) / 1e3
                for i in range(len(TRAIN))]

    ev_ms = {n: [[] for _ in TRAIN] for n in variants}
    dev_ms = {n: [[] for _ in TRAIN] for n in variants}
    for name in (list(variants) + list(variants)[::-1]) * 3:
        use(name)
        for i, t in enumerate(device_ms()):
            if t is not None:
                dev_ms[name][i].append(t)
        for i, s in enumerate(TRAIN):
            ev_ms[name][i].append(event_ms(*data[s]))
    for i, s in enumerate(TRAIN):
        B, H, W, C = s
        row = {"bound_ms": 4 * (2 * B * H * W * C + 9 * C)
               / HBM_BYTES_PER_S * 1e3}
        for name in variants:
            use(name)
            p = dwk.wgrad_plan(*s)
            row[name] = {
                "device_ms": min(dev_ms[name][i], default=None),
                "event_ms": min(ev_ms[name][i]),
                "layout": p._asdict(), "blocks": p.blocks,
                "clusters_held": dwk.wgrad_clusters_held(*s)}
        report["times"][str(s)] = row
        print(f"{str(s):18s} bound {1e3 * row['bound_ms']:6.2f} us: " +
              "; ".join(
                  f"{n} " + ("not measured" if row[n]["device_ms"] is None
                             else f"{1e3 * row[n]['device_ms']:.2f}")
                  + f" us (event {1e3 * row[n]['event_ms']:.1f}; "
                  f"{row[n]['blocks']} blocks, "
                  f"{row[n]['layout']['n_clusters']}x"
                  f"{row[n]['layout']['cluster']}, held "
                  f"{row[n]['clusters_held']})" for n in variants))
    for name in variants:
        tot = [min(d, default=None) for d in dev_ms[name]]
        for lo, hi, net in ((0, 6, "DetNet"), (6, 12, "EDSNet")):
            mult = [1, 1, 2, 4, 2, 3][:hi - lo]     # calls a pass
            part = tot[lo:hi]
            print(f"  {name} {net} pass of 13: " + (
                "not measured" if None in part else
                f"{sum(m * t for m, t in zip(mult, part)):.4f} ms"))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
