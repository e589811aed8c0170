"""The benchmark's frozen counts against the port's own layer plan at
today's configurations, and its configuration files against the port's."""
import dataclasses
import json

import pytest

from conftest import ROOT

ARCHS = ("detnet", "edsnet")
MACS = {"detnet": 98_040_320, "edsnet": 10_392_913_920}


def config(arch):
    return json.loads((ROOT / "portbench" / "configs" / f"{arch}.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_macs_equal_the_ports(arch):
    from portbench.counts import xr as counts
    from repro_torch.configs import get_config
    from repro_torch.models import xr
    specs = xr.conv_layer_specs(get_config(arch))
    assert counts.macs_per_image(config(arch)) == sum(s.macs for s in specs) \
        == MACS[arch]
    assert counts.model_flops(config(arch), "infer") == 2 * MACS[arch]
    assert counts.model_flops(config(arch), "train") == 6 * MACS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_thirteen_kernel_steps(arch):
    from portbench.counts import xr as counts
    from repro_torch.configs import get_config
    from repro_torch.models import xr
    cfg = get_config(arch)
    assert sum(map(xr.uses_depthwise_kernel, xr.build_plan(cfg))) == 13
    assert len(counts.dw_launches(config(arch), 1)) == 13
    assert counts.dw_launches_per_unit(config(arch), "train") == (26, 13)
    assert counts.dw_launches_per_unit(config(arch), "infer") == (13, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_launch_shapes_are_the_ports(arch):
    """Each kernel step's input (H, W, C), as the port's plan walks it."""
    from portbench.counts import xr as counts
    from repro_torch.configs import get_config
    from repro_torch.models import xr
    want = []
    xr._walk(get_config(arch), lambda st, src: want.append((7, *src))
             if xr.uses_depthwise_kernel(st) else None)
    assert counts.dw_launches(config(arch), 7) == want


def test_byte_bounds():
    from portbench.counts import xr as counts
    shape = (2, 8, 8, 16)
    act = 2 * 8 * 8 * 16 * 4
    for which in ("fwd", "dx", "wgrad"):
        assert counts.dw_bytes(shape, which) == 2 * act + 9 * 16 * 4
    cfg = config("detnet")
    per = sum(counts.dw_bytes(s, "fwd") for s in counts.dw_launches(cfg, 4))
    assert counts.dw_bytes_per_unit(cfg, 4, "infer") == per
    assert counts.dw_bytes_per_unit(cfg, 4, "train") == 3 * per


@pytest.mark.parametrize("arch", ARCHS)
def test_config_files_hold_the_ports_sizes(arch):
    """Every field of the port's configuration, in the file as it is run;
    the harness builds the program's configuration from the file."""
    from portbench.drivers.xr_common import program_config
    from repro_torch.configs import get_config
    port = get_config(arch)
    got = config(arch)
    for f in dataclasses.fields(port):
        want = getattr(port, f.name)
        assert json.loads(json.dumps(want)) == got[f.name], f.name
    assert program_config(got) == port
