"""The harness: ``BENCHMARK.json`` against the benchmark contract, cells
resolved to their files by name, files dropped into a copy found with no
edit to ``run.py``, the trace's reduction, and whole runs of both drivers
on the CPU at the smoke size: sound (``correct`` true), with each planted
fault and with the INT8 controls that the CPU has (``correct`` false).
The tests marked ``cuda`` run a cell on the card and skip without one."""
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import CELLS as CELLS_OF
from conftest import ROOT, smoke_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SEED = 2 ** 31 + 4242


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


CELLS = [w["name"] for w in bench()["workloads"]]


def test_contract_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_lines():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in b["workloads"]] \
            + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [x["why"] for k in ("configs", "workloads") for x in b[k]] \
        + [m["layer"] for m in b["per_layer"]] + [c["source"] for c in b["configs"]]
    for t in texts + b["command"]:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    for p in (ROOT / "portbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_one_layer_one_name():
    """Metrics of one layer give it letter for letter."""
    by_prefix = {}
    for m in bench()["per_layer"]:
        by_prefix.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    from portbench.lib import bench as lib
    c = lib.resolve(cell, ROOT)
    assert c.config["name"] in cell and hasattr(c.driver, "run")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    reported = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert hasattr(c.metric_reader(m["name"]), "read")
        # the metric's end-to-end metric is reported in every cell it lists
        assert m["moves"] in reported, (m["name"], cell)
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_dropped_in_files_are_found(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    (and entries) to a copy: found by name, ``run.py`` untouched."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    (tmp_path / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps({"name": "tiny", "task": "detection"}))
    (tmp_path / "portbench" / "traffic" / "burst.json").write_text(
        json.dumps({"driver": "xr_int8", "batch": 3}))
    (tmp_path / "portbench" / "limits" / "tiny-burst.json").write_text(
        json.dumps({"out_gap": 0.5}))
    (tmp_path / "portbench" / "metrics" / "odd_count.infer.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    b["configs"].append({"name": "tiny", "source": "https://example.org/x",
                         "file": "portbench/configs/tiny.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "tiny-burst", "config": "tiny",
                           "traffic": "burst", "chips": 1, "why": "test"})
    for name in ("odd_count.infer", "odd_count.infer.tiny"):
        b["per_layer"].append({"name": name, "unit": "n",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "infer_items_per_s.detnet",
                               "workloads": ["tiny-burst"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "detnet-int8-b256" in m["workloads"]:
            m["workloads"].append("tiny-burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    from portbench.lib import bench as lib
    c = lib.resolve("tiny-burst", tmp_path)
    assert c.config["name"] == "tiny" and c.traffic["batch"] == 3
    assert c.driver.KIND == "infer" and c.limits == {"out_gap": 0.5}
    assert [m["name"] for m in c.per_layer][-2:] == ["odd_count.infer",
                                                     "odd_count.infer.tiny"]
    # a name with no file of its own is read by its longest prefix's file
    assert c.metric_reader("odd_count.infer").read(None) == 7.0
    assert c.metric_reader("odd_count.infer.tiny").read(None) == 7.0
    with pytest.raises(FileNotFoundError):
        c.metric_reader("even_count")
    assert (tmp_path / "portbench" / "run.py").read_bytes() \
        == (ROOT / "portbench" / "run.py").read_bytes()
    with pytest.raises(KeyError):
        lib.resolve("no-such-cell", tmp_path)


def test_trace_reduction():
    """Busy time is the union of the device operations, idle time goes to
    the innermost host range over it, and a capture with fewer device
    events than launch calls is not measured."""
    from portbench.lib import tracing as T
    E = T._Event
    evs = [E(T.WINDOW_MARK, 0, 100, False, 1),
           E("k1", 10, 20, True, 0), E("k2", 15, 30, True, 0),
           E("k3", 50, 60, True, 0), E("Memcpy HtoD", 70, 72, True, 0),
           E(T.PAD_NAME, 101, 150, True, 0),
           E("cudaLaunchKernel", 5, 6, False, 1),
           E("cudaLaunchKernel", 7, 8, False, 1),
           E("cudaLaunchKernel", 40, 41, False, 1),
           E("aten::mul", 4, 9, False, 1), E("aten::item", 60, 95, False, 1),
           E("cudaMemcpyAsync", 61, 70, False, 1)]
    s = T.summarize(evs, 2)
    assert (s.busy_us, s.window_us, len(s.ops)) == (32.0, 100, 4)
    assert s.idle_by_host == {"aten::mul": 3.0, "cudaLaunchKernel": 3.0,
                              T.IDLE_NO_RANGE: 29.0, "aten::item": 24.0,
                              "cudaMemcpyAsync": 9.0}
    br = s.breakdown()
    assert br["device_ops"][0] == ["k2", 15e-6] and len(br["idle_gaps"]) == 5
    assert T.summarize(evs[:4] + evs[5:], 2) is None        # a copy lost


def test_window_counts_only_its_own_units():
    from portbench.lib.window import Window
    w = Window(0.0, False, 3)
    w.start()
    assert w.open and w.tick(5) and w.done
    assert (w.units, w.items) == (1, 5) and w.elapsed >= 0


@pytest.mark.parametrize("kind", ["train", "infer"])
@pytest.mark.parametrize("arch", ["detnet", "edsnet"])
def test_whole_run_on_the_cpu(arch, kind, cpu):
    from portbench.lib import result
    from portbench.lib.outcome import context
    cell = smoke_cell(arch, kind)
    out = cell.driver.run(cell, SEED, 0.3, False, cpu)
    assert out.correct, out.checks
    assert out.attempted == out.window.units > 0
    line = result.line(cell, out, False, 1.5, "cpu-test")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["metrics"]["setup_s"]["value"] == 1.5
    assert all(v["value"] > 0 for v in line["metrics"].values())
    json.dumps(line, allow_nan=False)
    ctx = context(out, "cpu-test")             # no trace, no peaks
    for m in cell.per_layer:
        assert cell.metric_reader(m["name"]).read(ctx) is None


# The smoke EDSNet's gradient norm stays under the clip's 1.0, so there the
# clip scales nothing and leaving it out is no fault.
@pytest.mark.parametrize("arch,fault", [
    (arch, fault) for arch in ("detnet", "edsnet")
    for fault in ("state_unchanged", "half_batch", "no_decay")]
    + [("detnet", "no_clip")])
def test_training_faults_are_caught(arch, fault, cpu):
    from portbench import faults
    cell = smoke_cell(arch, "train")
    with faults.FAULTS["train"][fault]():
        out = cell.driver.run(cell, SEED, 0.0, False, cpu)
    assert not out.correct, out.checks


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered", "bits4",
                                   "bf16"])
@pytest.mark.parametrize("arch", ["detnet", "edsnet"])
def test_int8_faults_and_control_are_caught(arch, fault, cpu):
    """The planted faults, and the controls that run on the CPU (TF32 is
    the card's alone)."""
    import contextlib

    from portbench import faults
    cell = smoke_cell(arch, "infer")
    control = fault if fault in cell.driver.CONTROLS else ""
    plant = contextlib.nullcontext if control \
        else faults.FAULTS["infer"][fault]
    with plant():
        out = cell.driver.run(cell, SEED, 0.2, False, cpu, control=control)
    assert not out.correct, out.checks


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 3 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "infer"])
def test_tf32_control_fails_on_the_card(kind):
    """TF32, a control of both kinds, fails a check; the program at
    float32 passes on the same seed. Training runs at the smoke size;
    INT8 at the cell's own size, since at the smoke size TF32's answers
    stay inside the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench.lib import bench
    dev = torch.device("cuda")
    for control in ("", "tf32"):
        cell = smoke_cell("edsnet", kind) if kind == "train" \
            else bench.resolve(CELLS_OF["edsnet", kind], ROOT)
        out = cell.driver.run(cell, SEED, 0.0 if kind == "train" else 0.2,
                              False, dev, control=control)
        assert out.correct != bool(control), out.checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, tmp_path):
    """A short untraced run of each cell from the repository root."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
