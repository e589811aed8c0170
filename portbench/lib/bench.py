"""``BENCHMARK.json`` and the files each cell is made of, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:

  * the configuration's file is the ``file`` of its ``configs`` entry
    (``portbench/configs/<config>.json``): the sizes as they are run;
  * the traffic mix is ``portbench/traffic/<traffic>.json``: parameters
    only, with ``driver`` naming the module ``portbench/drivers/<driver>.py``
    that builds the program, drives its entry over the window and checks
    what it produced;
  * the limits of that check are ``portbench/limits/<cell>.json``;
  * each per-layer metric the cell lists is read by
    ``portbench/metrics/<metric>.py`` (its ``read(ctx)``), or, where no
    file has the whole name, by the file of its longest prefix that ends
    before a dot: ``mfu.train.detnet`` is read by ``mfu.train.py``, so one
    reader serves a quantity that each configuration reports under a name
    of its own. An end-to-end metric takes the driver's value by the same
    rule (``train_items_per_s.detnet`` that of ``train_items_per_s``).

So a cell, a traffic mix or a metric is added by adding files.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config: Dict           # the configuration file's contents
    traffic: Dict          # the traffic file's contents
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path

    @property
    def driver(self) -> ModuleType:
        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}")

    def metric_reader(self, name: str) -> ModuleType:
        base = self.root / "portbench" / "metrics"
        for n in prefixes(name):
            if (base / f"{n}.py").is_file():
                return load_file(base / f"{n}.py")
        raise FileNotFoundError(f"no reader in {base} for {name!r}")


def prefixes(name: str) -> List[str]:
    """``name`` and each prefix of it that ends before a dot, longest
    first: "a.b.c" -> ["a.b.c", "a.b", "a"]."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def by_prefix(name: str, values: Dict[str, float]) -> float:
    """The value of ``name``'s longest prefix that ``values`` holds."""
    for n in prefixes(name):
        if n in values:
            return values[n]
    raise KeyError(f"no value for {name!r} among {sorted(values)}")


def _lists(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files
    read; raises KeyError for an unknown cell."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bdir = root / "portbench"
    return Cell(
        name=name,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((bdir / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bdir / "limits" / f"{name}.json").read_text()),
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _lists(m, name)],
        per_layer=[m for m in bench["per_layer"] if _lists(m, name)],
        root=root)


def load_file(path: Path) -> ModuleType:
    """Import a module from its file (metric names carry dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", path.stem), path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
