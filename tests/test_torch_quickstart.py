"""The paper's pipeline end to end in the port (train, INT8 PTQ, specs,
pricing), the twin of tests/test_system.py::test_paper_pipeline_end_to_end,
and the port of examples/quickstart.py run as a module."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dse as jdse
from repro_torch.configs import get_smoke
from repro_torch.core import dse, nvm
from repro_torch.data import synthetic
from repro_torch.models import xr
from repro_torch.quant import ptq
from repro_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]


def test_paper_pipeline_end_to_end():
    """Train a smoke DetNet, quantize it, run one INT8 frame, and price its
    config: the SRAM and P1 reports equal the reference's field for field."""
    cfg = get_smoke("detnet")
    net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device="cpu")
    batches = synthetic.fphab_batches(4, cfg.input_hw, cfg.in_channels)
    res = loop.run_xr_training(net, batches, loss_fn=xr.circle_loss,
                               steps=5, lr=1e-3,
                               hooks=loop.TrainHooks(log_every=0))
    assert res.step == 5 and np.isfinite(res.losses).all()

    qparams = ptq.quantize_params(dict(net.named_parameters()))
    assert qparams.keys() == dict(net.named_parameters()).keys()
    img = torch.from_numpy(
        synthetic.fphab_sample(0, 0, cfg.input_hw)["image"])[None]
    outs, _ = ptq.forward_int8(net, img)
    assert bool(torch.isfinite(outs["center"]).all())

    jcfg = jconfigs.get_smoke("detnet")
    for variant in ("sram", "p1"):
        got = dse.evaluate(net.cfg, "simba", 7, variant)
        want = jdse.evaluate(jcfg, "simba", 7, variant)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_pj > 0
    assert nvm.memory_power_w(dse.evaluate(cfg, "simba", 7, "p1"), 1.0) > 0


def test_quickstart_runs_as_a_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart",
         "--device", "cpu", "--steps", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "modelled Simba accelerator at 7 nm" in out
    for v in ("SRAM", "P0", "P1"):
        assert f"  {v}" in out and "uW memory power" in out
    assert out.count("vs SRAM") == 2


def test_quickstart_prices_the_trained_specs():
    from repro_torch.launch import quickstart
    r = quickstart.main(["--device", "cpu", "--steps", "2"])
    assert [s.name for s in r["specs"]] == [
        s.name for s in xr.conv_layer_specs(get_smoke("detnet"))]
    sram = dse.evaluate(r["specs"], "simba", 7, "sram")
    p1 = dse.evaluate(r["specs"], "simba", 7, "p1")
    assert r["priced"]["p1"]["savings"] == nvm.savings_at_ips(p1, sram, 10.0)
    assert r["priced"]["sram"]["latency_ms"] == sram.latency_s * 1e3


def test_quickstart_and_the_gate_refuse_to_run_without_a_card(tmp_path):
    """Both entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    from repro_torch.calibrate import harness
    from repro_torch.launch import quickstart
    for call in (lambda: quickstart.main(["--steps", "1"]),
                 lambda: harness.check(),
                 lambda: harness.write_calibrated(str(tmp_path / "x.json")),
                 lambda: harness.main(["--check"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "x.json").exists()
