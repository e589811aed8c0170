"""H100 roofline terms of a traced step, port of ``repro.core.roofline``.

    compute term    = FLOPs / (chips x peak_FLOP/s)
    memory term     = bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

The figures are the H100 SXM's published ones: 989e12 dense bf16 FLOP/s,
3.35e12 B/s of HBM3, and NVLink 4 at 900 GB/s a GPU, both directions
together. The collective term divides the bytes of each collective's
RESULT on a device (what it receives, the reference's proxy) by those 900
GB/s, so it is the time if receiving used both directions' bandwidth: a
ring collective sends as much as it receives at once, over 450 GB/s each
way, and takes up to twice this term. One link figure also assumes that
every group lies inside one NVLink domain of 8 GPUs; a 16-way "model" axis
does not (its groups cross InfiniBand, about a ninth of the rate), so the
term is a lower bound there. These are modelled figures, not measurements.

The reference parses collectives out of compiled HLO text. The port has no
HLO: ``CostTally`` is a ``CommDebugMode`` that sees every op a DTensor
program runs on its local shards (not the ops DTensor's sharding
propagation runs on FakeTensors of the global shapes), and tallies per
device the collectives' result bytes by kind (under the reference's five kind names; DTensor has
no collective-permute), the operations of the aten ops
(``torch.utils.flop_counter``'s formulas) and their bytes (each op's
inputs and outputs, unfused: an upper bound on the traffic a fused
program moves), by op name.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

import torch

# H100 SXM hardware constants (per GPU)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 900e9               # bytes/s, NVLink 4, both directions

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# op-name fragment -> kind (functional collectives and c10d ops alike)
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
# ops that move no bytes of their own
_FREE = ("empty", "empty_like", "empty_strided", "new_empty", "detach",
         "lift_fresh", "_wrap_tensor_autograd", "wait_tensor")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


def _fake(args) -> bool:
    """Whether an op runs on FakeTensors: DTensor's sharding propagation
    running an op on global shapes to learn its output's (once per op and
    input layout; not work any rank does)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(a, FakeTensor) or (
        isinstance(a, (list, tuple)) and _fake(a)) for a in args)


def collective_kind(name: str):
    """The reference's kind of a collective op's name, or None."""
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _comm_mode():
    from torch.distributed.tensor.debug import CommDebugMode
    return CommDebugMode


def cost_tally():
    """A fresh ``CostTally`` (``CommDebugMode`` is imported on first use,
    not with this module)."""
    base = _comm_mode()

    class CostTally(base):
        """Per-device cost of what runs inside it: ``flops``, ``bytes``
        (unfused), ``coll`` (result bytes by kind), ``by_op`` and
        ``flops_by_op`` (by op name) and ``kernels`` (launches,
        operations and bytes of what ``kernels.meta`` reports)."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.coll: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
            self.by_op: Dict[str, float] = defaultdict(float)
            self.flops_by_op: Dict[str, float] = defaultdict(float)
            self.kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
            # the step's activation peak and its phases' peaks, set by
            # launch.dryrun.trace
            self.temp_bytes = 0
            self.temp_phases = [0]

        def kernel(self, name: str, ops: float, nbytes: float) -> None:
            k = self.kernels[name]
            k[0] += 1
            k[1] += ops
            k[2] += nbytes
            self.flops += ops
            self.bytes += nbytes
            self.by_op[name] += nbytes
            self.flops_by_op[name] += ops

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not hasattr(func, "_overloadpacket"):
                return out
            name = func._overloadpacket.__name__
            kind = collective_kind(str(func._overloadpacket))
            if kind is not None:
                self.coll[kind] += _nbytes(out)
                return out
            if name in _FREE or getattr(func, "is_view", False) \
                    or _fake(args) or _fake((out,)):
                return out
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                n = fn(*args, **(kwargs or {}), out_val=out)
                self.flops += n
                self.flops_by_op[name] += n
            nb = _nbytes(args) + _nbytes(kwargs or {}) + _nbytes(out)
            self.bytes += nb
            self.by_op[name] += nb
            return out

    return CostTally()


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                # the step's operations over all chips
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    model_flops: float              # analytic 6ND (or 6·N_active·D)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: overlapped terms -> max."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_frac(self) -> float:
        """MODEL_FLOPS / traced FLOPs: exposes recompute and replicated
        work."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the per-chip peak the step achieves at the bound:
        useful model FLOPs per second at roofline step time / peak."""
        if self.step_time_s == 0:
            return 0.0
        return (self.model_flops / self.step_time_s) / (
            self.chips * PEAK_FLOPS_BF16)

    def row(self) -> Dict:
        return dict(arch=self.arch, shape=self.shape, mesh=self.mesh,
                    t_compute=self.t_compute, t_memory=self.t_memory,
                    t_collective=self.t_collective,
                    bottleneck=self.bottleneck,
                    hlo_gflops=self.hlo_flops / 1e9,
                    hlo_gb=self.hlo_bytes / 1e9,
                    coll_gb=self.coll_bytes / 1e9,
                    useful_flop_frac=self.useful_flop_frac,
                    roofline_frac=self.roofline_frac)
