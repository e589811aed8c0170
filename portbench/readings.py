"""Readings of a cell's checked numbers over many seeds in one process, the
ground on which each limit in ``portbench/limits/`` is set.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        --modes program,<control>,<fault> [--seconds S] [--out FILE]

``program`` runs the cell as its runs do; a control (the driver's
``CONTROLS``: TF32 in training; 4-bit codes, TF32 or the bfloat16
reference in INT8 evaluation) runs it one precision down; a fault name
(``portbench/faults.py``) runs it with that fault planted. Each mode runs
every seed, in one process. Training's numbers need no window
(``--seconds 0`` reads the checked steps, then steps on past the
schedule's warm-up to the late check step); INT8's want a short one at
the cell's own load. The limits in force are ignored: each run prints its
readings as one JSON line, and ``--out`` gets them all.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib.env import set_process_env
    set_process_env(ROOT)
    import torch

    from portbench import faults
    from portbench.drivers import xr_common as common
    from portbench.lib import bench

    cell = bench.resolve(a.workload, ROOT)
    driver = cell.driver
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows = []
    for mode in a.modes.split(","):
        control = mode if mode in driver.CONTROLS else ""
        plant = (contextlib.nullcontext if mode == "program" or control
                 else faults.FAULTS[driver.KIND][mode])
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            with plant():
                out = driver.run(cell, seed, a.seconds, False, dev,
                                 control=control)
            row = {"workload": a.workload, "mode": mode, "seed": seed,
                   "readings": {k: v for k, (v, _) in out.checks.items()},
                   "worst": out.where, "units": out.window.units,
                   "seconds": time.perf_counter() - t0,
                   "memory_peak_bytes": out.memory_peak_bytes}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del out
            common.free(dev)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
