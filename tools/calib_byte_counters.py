"""Try hardware counters as the byte source of the calibration corners.

The port's calibration harness reports each corner's bytes as the kernel's
analytic count (``"cost_source": "analytic"``). This script asks the card
for measured global-memory traffic instead, once per source, and records
what the driver answers:

  * CUPTI range-profiler metrics through ``torch.profiler``'s experimental
    config (``profiler_metrics``, per kernel), around the five corners
    (``repro_torch.calibrate.harness.run_samples`` on the card), after an
    L2 flush (a 96 MiB write), since the corners fit in L2;
  * ``ncu`` from the CUDA toolkit, if it is there, on the same corners.

Each source runs in a child process whose output is kept: the metric
values it read, or the driver's words when it refused. Writes
``build/calib_byte_counters.json``.

    PYTHONPATH=src python tools/calib_byte_counters.py
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
METRICS = ["dram__bytes_read.sum", "dram__bytes_write.sum",
           "lts__t_bytes.sum"]
KERNELS = ("int8_mm_kernel", "dw3x3_kernel", "quantize_rows_kernel")


def corners():
    """A call that runs the five corners on the card after an L2 flush."""
    import torch
    from repro_torch.calibrate import harness
    from repro_torch.kernels import _build
    _build.build()
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def run():
        flush.fill_(1)
        return harness.run_samples("cuda")
    run()                                           # warm: load, first use
    torch.cuda.synchronize()
    return run


def child_profiler():
    import torch
    from torch._C._profiler import _ExperimentalConfig
    run = corners()
    cfg = _ExperimentalConfig(profiler_metrics=METRICS,
                              profiler_measure_per_kernel=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            experimental_config=cfg) as prof:
        run()
        torch.cuda.synchronize()
    trace = ROOT / "build" / "calib_byte_counters_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    read = []
    for e in events:
        args = e.get("args", {})
        got = {m: args[m] for m in METRICS if m in args}
        if got:
            read.append({"name": e.get("name"), **got})
    kernels = [e.get("name") for e in events
               if any(k in str(e.get("name")) for k in KERNELS)]
    print(json.dumps({"metric_events": read, "kernel_events": kernels}))


def child_ncu_target():
    corners()()


def run_child(cmd, timeout):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=timeout)
        return {"cmd": cmd, "rc": res.returncode,
                "stdout": res.stdout[-6000:], "stderr": res.stderr[-6000:]}
    except subprocess.TimeoutExpired as e:
        return {"cmd": cmd, "rc": "timeout", "stdout": str(e.stdout)[-3000:],
                "stderr": str(e.stderr)[-3000:]}


def driver_words(text):
    """Lines that carry the driver's or CUPTI's answer."""
    pat = re.compile(r"CUPTI|ERR_NVGPUCTRPERM|privilege|permission|"
                     r"not supported|profil", re.I)
    return [ln.strip() for ln in text.splitlines() if pat.search(ln)][:20]


def main():
    if len(sys.argv) > 1:
        {"--profiler": child_profiler, "--target": child_ncu_target}[
            sys.argv[1]]()
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"card": torch.cuda.get_device_name(0), "metrics": METRICS}
    me = [sys.executable, str(Path(__file__).resolve())]
    prof = run_child(me + ["--profiler"], 600)
    parsed = None
    for ln in prof["stdout"].splitlines()[::-1]:
        if ln.startswith("{"):
            parsed = json.loads(ln)
            break
    prof["read"] = parsed
    prof["driver_words"] = driver_words(prof["stdout"] + prof["stderr"])
    out["torch_profiler"] = prof
    toolkit_ncu = Path("/usr/local/cuda/bin/ncu")
    ncu = shutil.which("ncu") or (str(toolkit_ncu) if toolkit_ncu.exists()
                                  else None)
    if ncu is None:
        out["ncu"] = {"found": False}
    else:
        res = run_child([ncu, "--metrics", ",".join(METRICS), "-k",
                         "regex:" + "|".join(KERNELS)] + me + ["--target"],
                        300)
        res["found"] = ncu
        res["driver_words"] = driver_words(res["stdout"] + res["stderr"])
        out["ncu"] = res
    (ROOT / "build" / "calib_byte_counters.json").write_text(
        json.dumps(out, indent=1))
    n_read = len((parsed or {}).get("metric_events", []))
    print(f"card {out['card']}")
    print(f"torch.profiler CUPTI metrics: rc {prof['rc']}, {n_read} events "
          f"with metric values; driver's words: {prof['driver_words']}")
    if parsed:
        for e in parsed["metric_events"][:12]:
            print(f"  {e}")
    if out["ncu"].get("found"):
        print(f"ncu ({out['ncu']['found']}): rc {out['ncu']['rc']}; words: "
              f"{out['ncu']['driver_words']}")
        print(out["ncu"]["stdout"][-2000:])
    else:
        print("ncu: not in the toolkit")


if __name__ == "__main__":
    main()
