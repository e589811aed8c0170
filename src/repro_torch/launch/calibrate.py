"""Calibration probes, the port of ``tools/calibrate.py``.

Default mode: component breakdown for the Table-3 cells + Table-2 areas
against the paper's targets, evaluated on the ``Evaluator``/columnar path
of ``repro_torch.core`` in numpy on the host (the model's estimates for the
XR accelerators, not measurements of this machine).

Kernel mode (``--kernels``): run the port's kernel calibration harness
(``repro_torch.calibrate.harness``), which measures the compute-plane
corners through the hand-written kernels on ``--device`` (the card by
default; ``--device cpu`` runs their plain versions). ``--write`` refreshes
the port's refit ``calibrated_h100.json``, ``--check`` gates on
fit-residual regression against it. Neither touches ``calibrated.json``,
the byte copy of the reference's fit that the pricing reads.

    PYTHONPATH=src python -m repro_torch.launch.calibrate \\
        [--kernels [--write | --check] [--device cpu]]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import experiment as xp
from repro_torch.core import nvm as nvm_mod

TARGETS_T3 = {  # (workload, arch) -> (p0_sav, p1_sav, p0_lat_ms, p1_lat_ms)
    ("detnet", "simba"): (0.27, 0.31, 0.34, 0.42),
    ("detnet", "eyeriss"): (-0.04, 0.09, 0.86, 0.86),
    ("edsnet", "simba"): (0.29, 0.24, 48.57, 60.72),
    ("edsnet", "eyeriss"): (-0.15, -0.26, 45.22, 45.22),
}
TARGETS_T2 = {  # arch -> (sram, p0, p1) mm^2
    "simba": (2.89, 2.41, 1.88),
    "eyeriss": (2.56, 2.11, 1.67),
}


def _report(workload, arch, node, variant):
    return xp.default_evaluator().report(
        xp.DesignPoint(workload=workload, arch=arch, node=node,
                       variant=variant))


def probe(w, a, node=7) -> Tuple[float, float]:
    """Print one Table-3 cell's breakdown; returns its (p0, p1) savings."""
    ips = xp.IPS_MIN[w]
    sram = _report(w, a, node, "sram")
    p0 = _report(w, a, node, "p0")
    p1 = _report(w, a, node, "p1")
    ps = nvm_mod.memory_power_w(sram, ips)
    t = TARGETS_T3[(w, a)]
    print(f"\n--- {w} / {a} @ IPS={ips} (targets p0={t[0]:+.0%} p1={t[1]:+.0%} "
          f"lat {t[2]}/{t[3]} ms) ---")
    print(f"  P_sram({ips})={ps*1e6:8.1f} uW   [dyn {sram.buffer_pj*1e-12*ips*1e6:7.1f}"
          f" | standby {sram.standby_w*1e6:7.1f} (w {sram.weight_standby_w*1e6:6.1f})]")
    savings = []
    for name, r in (("p0", p0), ("p1", p1)):
        pn = nvm_mod.memory_power_w(r, ips)
        savings.append(1 - pn / ps)
        print(f"  P_{name}  ({ips})={pn*1e6:8.1f} uW   [dyn {r.buffer_pj*1e-12*ips*1e6:7.1f}"
              f" | standby {r.standby_w*1e6:7.1f}]  savings={1-pn/ps:+.1%}")
    for name, r in (("sram", sram), ("p0", p0), ("p1", p1)):
        lv = "  ".join(f"{k}: r={v.read_pj/1e6:8.2f} w={v.write_pj/1e6:8.2f}uJ"
                       for k, v in r.levels.items())
        print(f"  [{name:4s}] lat={r.latency_s*1e3:8.2f}ms bottleneck={r.bottleneck:10s} {lv}")
    return savings[0], savings[1]


def tables() -> Dict:
    """Print the Table-3 probes and Table-2 areas; returns
    ``{"table3": {(workload, arch): (p0_sav, p1_sav)}, "table2": rows}``."""
    t3 = {}
    for w in ("detnet", "edsnet"):
        for a in ("simba", "eyeriss"):
            t3[(w, a)] = probe(w, a)

    print("\n=== Table 2 ===")
    rows = xp.SWEEPS["table2"].rows()
    for r in rows:
        t = TARGETS_T2[r["arch"]]
        print(f"{r['arch']:8s} sram={r['sram_mm2']:.2f} (t {t[0]})  p0={r['p0_mm2']:.2f} (t {t[1]})"
              f"  p1={r['p1_mm2']:.2f} (t {t[2]})  sav {r['p0_savings']:.1%}/{r['p1_savings']:.1%}")
    return {"table3": t3, "table2": rows}


def kernels(write=False, do_check=False, device="cuda") -> int:
    """The harness on ``device``: the refit printed (``--write`` writes it
    to ``calibrated_h100.json``), or with ``do_check`` gated against it."""
    from repro_torch.calibrate import harness as cal
    if do_check:
        fails = cal.check(device=device)
        for f in fails:
            print("FAIL:", f)
        print("calibrate --kernels --check:", "FAIL" if fails else "OK")
        return 1 if fails else 0
    data = (cal.write_calibrated(device=device) if write
            else cal.run_calibration(device))
    print("=== kernel calibration"
          + (f" (wrote {cal.CALIB_PATH})" if write else "") + " ===")
    for k, v in sorted(data["constants"].items()):
        print(f"  {k:22s} = {v:.6f}")
    for k, v in sorted(data["residuals"].items()):
        print(f"  residual {k:22s} = {v:.6g}")
    for s in data["samples"]:
        print(f"  [{s['kernel']:14s} {s['precision']:5s}] w{s['weight_bits']:<2d} "
              f"a{s['act_bits']:<2d} macs={s['macs']:>8d} flops={s['flops']:>9.0f} "
              f"bytes={s['bytes_accessed']:>8.0f} (analytic {s['analytic_bytes']:>7.0f}) "
              f"ref_err={s['max_abs_err']:.3g}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="run the kernel calibration harness")
    ap.add_argument("--write", action="store_true",
                    help="with --kernels: refresh calibrated_h100.json")
    ap.add_argument("--check", action="store_true",
                    help="with --kernels: gate on fit-residual regression")
    ap.add_argument("--device", default="cuda",
                    help="with --kernels: the device (default: the card)")
    args = ap.parse_args(argv)
    if args.kernels:
        return kernels(write=args.write, do_check=args.check,
                       device=args.device)
    tables()
    return 0


if __name__ == "__main__":
    sys.exit(main())
