"""Package rules of repro_torch: no JAX and nothing of repro on its import
graph, and entry points that run on the card unless asked for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")


def test_entry_points_refuse_to_run_without_a_card():
    _no_cuda()
    from repro_torch import resolve_device
    from repro_torch.calibrate import harness
    from repro_torch.configs import get_smoke
    from repro_torch.models import xr
    from repro_torch.models.params import materialize
    cfg = get_smoke("detnet")
    g = torch.Generator().manual_seed(0)
    for call in (lambda: resolve_device(),
                 lambda: xr.XRNet(cfg),
                 lambda: materialize(xr.param_defs(cfg)[0], g),
                 lambda: harness.run_samples(),
                 lambda: harness.run_calibration()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_training_entry_points_refuse_to_run_without_a_card():
    _no_cuda()
    from repro_torch.launch import train_xr
    for argv in (["--arch", "detnet", "--steps", "3"],
                 ["--arch", "edsnet", "--full"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_xr.main(argv)


def test_unported_architectures_raise_keyerror():
    from repro_torch.configs import get_config, get_smoke
    assert get_config("detnet").name == "detnet"
    for arch in ("llama3.2-1b", "deepseek-7b", "yi-34b", "gemma2-9b",
                 "mixtral-8x7b", "grok-1-314b", "phi-3-vision-4.2b",
                 "whisper-small", "jamba-1.5-large-398b"):
        assert get_config(arch).name == arch
        assert get_smoke(arch).is_smoke
    for get in (get_config, get_smoke):
        with pytest.raises(KeyError, match="not ported.*no such "
                                           "architecture"):
            get("jamba-2-large")


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_and_without_the_repo(tmp_path):
    _no_cuda()
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
