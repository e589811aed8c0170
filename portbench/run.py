"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The cell's
files are found by name (``portbench/lib/bench.py``), its driver builds
the program and measures a window of ``--seconds``; ``--trace 1`` then
profiles a few more steps or requests and prints the cell's per-layer
metrics instead of its end-to-end ones. Every run checks what the timed
path produced against the plain reference and prints each compared number
beside its limit, on standard error and under "checks" in the result.

Exit codes: 0 with a result line; 3 without enough CUDA devices; 4 when
JAX or the JAX package was loaded; 5 when the trace's capture fell short
three times; 1 on any other failure. Only exit 0 prints a result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib.env import forbidden_modules, set_process_env
    set_process_env(ROOT)

    import torch

    from portbench.lib import bench, result
    torch.set_num_threads(1)

    cell = bench.resolve(a.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    outcome = cell.driver.run(cell, a.seed, a.seconds, bool(a.trace), dev)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    if a.trace and outcome.window.summary is None:
        print("portbench: the trace's capture fell short "
              f"{outcome.window.attempts} times", file=sys.stderr)
        return 5
    line = result.line(cell, outcome, bool(a.trace),
                       outcome.window.t0 - T_START,
                       torch.cuda.get_device_name(dev))
    if a.trace:
        print(f"trace capture {outcome.window.summary.capture} in "
              f"{outcome.window.attempts} segment(s)", file=sys.stderr)
    print("setup " + " ".join(f"{k} {v:.3f}s" for k, v in
                              outcome.setup.items()), file=sys.stderr)
    for name, (value, limit) in outcome.checks.items():
        at = outcome.where.get(name)
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}"
              + (f" (worst: {at})" if at else ""), file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
