"""Roofline probe of one dry-run cell, port of ``tools/hillclimb.py``'s
roofline mode: trace ONE cell with config and rule overrides on the
production mesh and print its modelled H100 roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch gemma2-9b --shape decode_32k [--multi-pod] \\
        [--set swa_ring_buffer=True] [--rule expert_cap=pod,data] [--profile]

``--profile`` prints the per-device byte table by op from the dry-run's
tally (unfused aten inputs and outputs, and the kernels'), in place of the
reference's HLO profile. The tool's DSE and system modes are not ported
here. Runs on torch's fake process group, so as its own process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core import roofline as rl
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod


def parse_override(s: str):
    k, v = s.split("=", 1)
    with contextlib.suppress(Exception):
        v = eval(v, {}, {})
    return k, v


def profile(tally, top: int = 18) -> None:
    """Bytes by op name (per device, unfused) and the kernels' launches."""
    print("\n-- bytes by op (per device, unfused aten inputs+outputs; "
          "kernels' own) --")
    for op, b in sorted(tally.by_op.items(), key=lambda x: -x[1])[:top]:
        print(f"   {op:<28}{b/1e9:10.2f} GB")
    print("-- kernels (launches, GFLOP, GB) --")
    for name, (n, ops, nb) in sorted(tally.kernels.items()):
        print(f"   {name:<28}{n:6d}{ops/1e9:12.1f}{nb/1e9:10.2f}")


def roofline_main(a) -> rl.Roofline:
    cfg = get_config(a.arch)
    if a.set:
        cfg = dataclasses.replace(cfg, **dict(parse_override(s)
                                              for s in a.set))
    rules = mesh_mod.shape_rules(cfg, a.shape) or {}
    for r in a.rule:
        k, v = r.split("=", 1)
        rules[k] = tuple(v.split(",")) if v else None
    shape, _ = mesh_mod.production_shape(a.multi_pod)
    n = 1
    for d in shape:
        n *= d
    t0 = time.monotonic()
    with dryrun.fake_group(n):
        mesh = mesh_mod.make_production_mesh(multi_pod=a.multi_pod,
                                             device_type="cpu")
        flops, byts, coll, by_kind, t2 = dryrun.extrapolated(
            cfg, a.shape, mesh, rules)
    r = rl.Roofline(a.arch, a.shape, "x".join(map(str, shape)), n,
                    flops * n, byts * n, coll * n, by_kind,
                    mesh_mod.model_flops(cfg, a.shape))
    print(f"\n=== {a.arch} x {a.shape} overrides={a.set} rules={a.rule} "
          f"({time.monotonic()-t0:.0f}s; modelled H100 roofline) ===")
    print(f"t_compute={r.t_compute*1e3:.2f}ms t_memory={r.t_memory*1e3:.2f}ms "
          f"t_collective={r.t_collective*1e3:.2f}ms bound={r.bottleneck}")
    print(f"useful={r.useful_flop_frac:.3f} roofline_frac={r.roofline_frac:.5f}")
    print("collectives/dev: " + ", ".join(
        f"{k}={v/1e9:.2f}GB" for k, v in by_kind.items() if v))
    if a.profile:
        profile(t2)
    return r


def main(argv: Optional[Sequence[str]] = None) -> rl.Roofline:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, help="LM config name")
    p.add_argument("--shape", required=True, help="input shape set")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--set", action="append", default=[],
                   help="cfg field override, e.g. swa_ring_buffer=True")
    p.add_argument("--rule", action="append", default=[],
                   help="sharding rule override, e.g. expert_cap=pod,data")
    p.add_argument("--profile", action="store_true")
    return roofline_main(p.parse_args(argv))


if __name__ == "__main__":
    main()
