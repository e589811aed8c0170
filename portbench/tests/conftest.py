"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root. They put the root (for ``portbench``) and ``src`` (for
the port and, in the tests that compare with it, the JAX package) on the
path. The repository's suite (``tests/``) does not collect them."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TRAIN = {"driver": "xr_train", "batch": 8, "pool": 4, "warm_steps": 4,
         "checked_steps": 3, "trace_steps": 2}
INFER = {"driver": "xr_int8", "batch": 8, "pool": 4, "clients": 1, "bits": 8,
         "stats_batch": 8, "warm_requests": 1, "trace_requests": 2,
         "sampled_requests": 4}
CELLS = {("detnet", "train"): "detnet-train-b256",
         ("edsnet", "train"): "edsnet-train-b16",
         ("detnet", "infer"): "detnet-int8-b256",
         ("edsnet", "infer"): "edsnet-int8-b32"}


def smoke_config(arch: str) -> dict:
    """The port's smoke configuration of ``arch`` as a configuration
    file's dict."""
    from repro_torch.configs import get_smoke
    return json.loads(json.dumps(dataclasses.asdict(get_smoke(arch))))


def smoke_cell(arch: str, kind: str):
    """The cell of ``arch`` and ``kind`` with the smoke configuration and a
    small batch, under the cell's own limits."""
    from portbench.lib import bench
    cell = bench.resolve(CELLS[arch, kind], ROOT)
    cell.config = smoke_config(arch)
    cell.traffic = dict(TRAIN if kind == "train" else INFER)
    return cell


@pytest.fixture
def cpu():
    import torch
    torch.manual_seed(0)
    return torch.device("cpu")
