"""DSE sweep driver — backward-compatible shims over the experiment API.

The canonical surface now lives in ``core.space`` (``DesignPoint`` /
``DesignSpace``) and ``core.experiment`` (``Evaluator`` / ``ResultSet`` /
``SWEEPS``): every paper table/figure is a declarative space there, and all
shared work (workload extraction, suite buffer sizing, arch construction,
dataflow mapping) is memoized by a process-wide evaluator. These wrappers
keep the historical call signatures working:

  * ``evaluate(workload, arch, node, variant, nvm)`` -> ``EnergyReport``
  * ``sweep_fig2f`` / ``sweep_fig3d`` / ``fig4_breakdown`` / ``sweep_fig5``
    / ``table2_area`` / ``table3_ips`` / ``lm_kv_dse`` -> row dicts,
    byte-compatible with the legacy nested-loop implementations (the parity
    suite in ``tests/test_space.py`` enforces this).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core import area as area_mod
from repro_torch.core import experiment as xp
from repro_torch.core.energy import EnergyReport
from repro_torch.core.experiment import (ACT_CAP_KB, IPS_APP, IPS_MIN, NODES_FIG2F,
                                         PAPER_NODES, extract_specs, size_arch)
from repro_torch.core.space import PAPER_SUITE, DesignPoint


def suite_sizes(suite=PAPER_SUITE) -> tuple:
    """(weight_kb, act_kb) sized for the max over the workload suite."""
    return xp.default_evaluator().suite_sizes(tuple(suite))


def _point(workload, arch_name: str, node: int, variant: str,
           nvm: Optional[str], pe_config: str, suite, kw) -> DesignPoint:
    if isinstance(workload, list):
        workload = tuple(workload)
    return DesignPoint(
        workload=workload, arch=arch_name, node=node, variant=variant,
        nvm=nvm, pe_config=pe_config,
        suite=tuple(suite) if suite else None,
        extract_kw=tuple(sorted(kw.items())))


def evaluate(workload, arch_name: str, node: int, variant: str = "sram",
             nvm: Optional[str] = None, pe_config: str = "v2",
             suite=PAPER_SUITE, **kw) -> EnergyReport:
    """End-to-end: workload -> access counts -> priced EnergyReport.

    ``suite``: size buffers for this workload set (one silicon design, as in
    the paper's Tables 2-3); pass None to size for the workload alone.
    """
    return xp.default_evaluator().report(
        _point(workload, arch_name, node, variant, nvm, pe_config, suite, kw))


def evaluate_area(workload, arch_name: str, node: int = 7,
                  variant: str = "sram", nvm: Optional[str] = None,
                  pe_config: str = "v2", suite=PAPER_SUITE,
                  **kw) -> area_mod.AreaReport:
    """Area counterpart of ``evaluate`` — same suite-sizing default, so the
    one-silicon-design method of Table 2 applies to both planes."""
    return xp.default_evaluator().area(
        _point(workload, arch_name, node, variant, nvm, pe_config, suite, kw))


# ---------------------------------------------------------------------------
# paper sweeps (shims over experiment.SWEEPS)
# ---------------------------------------------------------------------------

def sweep_fig2f(workloads=PAPER_SUITE) -> List[Dict]:
    """EDP vs node for the three SRAM-only architectures."""
    return xp.SWEEPS["fig2f"].rows(workloads=workloads)


def sweep_fig3d(workloads=PAPER_SUITE) -> List[Dict]:
    """Single-inference energy for 9 variants x {28,7}nm."""
    return xp.SWEEPS["fig3d"].rows(workloads=workloads)


def sweep_fig5(workloads=PAPER_SUITE, node: int = 7,
               n_points: int = 25) -> List[Dict]:
    """Memory power vs IPS for SRAM + 3 MRAM devices, P0/P1, both systolics."""
    return xp.SWEEPS["fig5"].rows(workloads=workloads, node=node,
                                  n_points=n_points)


def table2_area(workloads=PAPER_SUITE, node: int = 7) -> List[Dict]:
    """Area of systolic accelerators at 7nm: SRAM vs P0 vs P1 (VGSOT)."""
    return xp.SWEEPS["table2"].rows(workloads=workloads, node=node)


def table3_ips(node: int = 7) -> List[Dict]:
    """Latency + memory-power savings at IPS_min (PE config v2, 64x64)."""
    return xp.SWEEPS["table3"].rows(node=node)


def fig4_breakdown(node_pairs=((28, "stt"), (7, "vgsot"))) -> List[Dict]:
    """Read/write/compute energy split per NVM variant (paper Fig 4)."""
    return xp.SWEEPS["fig4"].rows(node_pairs=node_pairs)


def lm_kv_dse(arch_names=("simba", "eyeriss"), node: int = 7,
              context_len: int = 4096, archs=("llama3.2-1b",)) -> List[Dict]:
    """Should the KV cache + weights of an edge LM live in MRAM?  Applies the
    paper's P0/P1 question to decode-step workloads (DESIGN.md §2)."""
    return xp.SWEEPS["lm_kv"].rows(arch_names=arch_names, node=node,
                                   context_len=context_len, archs=archs)


def sweep_quant(workloads=PAPER_SUITE, node: int = 7,
                context_len: int = 4096,
                lm_archs=("llama3.2-1b",)) -> List[Dict]:
    """Precision axis: energy/latency/area + MRAM cross-over at the
    INT8 / W4A8 / INT4 corners (DESIGN.md §5 §Precision)."""
    return xp.SWEEPS["quant"].rows(workloads=workloads, node=node,
                                   context_len=context_len,
                                   lm_archs=lm_archs)


def sweep_placement(workloads=PAPER_SUITE, arch: str = "simba",
                    node: int = 7, **kw) -> List[Dict]:
    """Per-level technology lattice: every hybrid hierarchy of the arch
    priced in one columnar pass, vs the paper's P0/P1 corners
    (DESIGN.md §6 §Placement)."""
    return xp.SWEEPS["placement"].rows(workloads=workloads, arch=arch,
                                       node=node, **kw)


def sweep_system(streams=None, arch: str = "simba", node: int = 7,
                 **kw) -> List[Dict]:
    """Multi-stream system plane: the XR bundle (hand detection @10 IPS +
    eye segmentation @0.1 IPS by default) time-shared on one accelerator
    across the placement lattice (DESIGN.md §7 §System)."""
    if streams is None:
        streams = xp.XR_BUNDLE
    return xp.SWEEPS["system"].rows(streams=streams, arch=arch, node=node,
                                    **kw)


def sweep_trace(scenario="gaming", streams=None, arch: str = "simba",
                node: int = 7, **kw) -> List[Dict]:
    """Trace-driven dynamic simulation: one XR scenario (idle / gaming /
    passthrough / multi_user) simulated over the placement lattice and
    ranked by battery life (DESIGN.md §11)."""
    if streams is None:
        streams = xp.XR_BUNDLE
    return xp.SWEEPS["trace"].rows(scenario=scenario, streams=streams,
                                   arch=arch, node=node, **kw)
