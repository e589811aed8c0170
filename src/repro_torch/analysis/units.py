"""Unit algebra and the repo's naming-convention registry.

A :class:`Unit` is a vector of base-dimension exponents plus a scale
factor relative to the SI-ish base of each dimension (J, s, bit, m²).
So ``pJ = (energy, 1e-12)``, ``kB = (bit, 8192)``, ``uW = (energy/time,
1e-6)``, ``GHz = (1/time, 1e9)``.

The key mechanic: multiplying a *value* by a literal constant ``c``
divides its unit's scale by ``c`` — because the stored number changed
while the physical quantity did not.  ``v_pj * 1e-12`` lands exactly on
scale 1 => joules; ``capacity_kb * 1024 * 8`` lands on bits.  A missing
conversion leaves the scale orders of magnitude off, which is what the
UN checker flags (dimension mismatch, or scale ratio > TOLERANCE on
addition/assignment).

Units attach to names via suffix conventions (``_pj``, ``_pj_per_bit``,
``_kb``, ``_uw`` …, with trailing node tags like ``_45`` stripped) plus
the explicit declarations below for `core/devices.py` tables whose names
predate the convention.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Optional, Tuple

# base dimensions: energy (J), time (s), information (bit), area (m2),
# ops (flop). Counts (macs, elems, cycles) are dimensionless on purpose:
# `macs * weight_bits -> bits` and `cycles / clock_hz -> s` must hold.
_DIMS = ("J", "s", "bit", "m2", "flop")

Vec = Tuple[Fraction, ...]

_ZERO: Vec = tuple(Fraction(0) for _ in _DIMS)


def _vec(**kw: int) -> Vec:
    return tuple(Fraction(kw.get(d, 0)) for d in _DIMS)


def _vadd(a: Vec, b: Vec) -> Vec:
    return tuple(x + y for x, y in zip(a, b))


def _vsub(a: Vec, b: Vec) -> Vec:
    return tuple(x - y for x, y in zip(a, b))


@dataclass(frozen=True)
class Unit:
    dims: Vec
    scale: float

    def __mul__(self, other: "Unit") -> "Unit":
        return Unit(_vadd(self.dims, other.dims), self.scale * other.scale)

    def __truediv__(self, other: "Unit") -> "Unit":
        return Unit(_vsub(self.dims, other.dims), self.scale / other.scale)

    def scaled_by_literal(self, c: float, divide: bool = False) -> "Unit":
        """Unit of ``value * c`` (or ``value / c``)."""
        if c == 0:
            return self
        if divide:
            return Unit(self.dims, self.scale * c)
        return Unit(self.dims, self.scale / c)

    @property
    def dimensionless(self) -> bool:
        return self.dims == _ZERO

    def compatible(self, other: "Unit", tol: float = 100.0) -> bool:
        """Same dimensions and scales within a factor of `tol`.

        The tolerance absorbs physics constants (x2 port multipliers,
        /8 byte packing) while still catching SI-prefix and kB->bit
        slips, which are >= x1000 / x8192 off.
        """
        if self.dims != other.dims:
            return False
        if self.scale == 0 or other.scale == 0:
            return True
        ratio = self.scale / other.scale
        if ratio < 1:
            ratio = 1 / ratio
        return ratio <= tol

    def __str__(self) -> str:
        num, den = [], []
        for d, e in zip(_DIMS, self.dims):
            if e > 0:
                num.append(d if e == 1 else f"{d}^{e}")
            elif e < 0:
                den.append(d if e == -1 else f"{d}^{-e}")
        body = "*".join(num) or "1"
        if den:
            body += "/" + "/".join(den)
        if self.scale != 1.0:
            body = f"{self.scale:g}*{body}"
        return body


DIMENSIONLESS = Unit(_ZERO, 1.0)

# ------------------------------------------------------------ token table

_E = _vec(J=1)
_T = _vec(s=1)
_B = _vec(bit=1)
_A = _vec(m2=1)
_F = _vec(flop=1)

#: suffix token -> Unit. Trailing node tags (``_45``) are stripped first.
TOKENS: Dict[str, Unit] = {
    "j": Unit(_E, 1.0),
    "mj": Unit(_E, 1e-3),
    "uj": Unit(_E, 1e-6),
    "nj": Unit(_E, 1e-9),
    "pj": Unit(_E, 1e-12),
    "s": Unit(_T, 1.0),
    "ms": Unit(_T, 1e-3),
    "us": Unit(_T, 1e-6),
    "ns": Unit(_T, 1e-9),
    "w": Unit(_vsub(_E, _T), 1.0),           # J/s
    "mw": Unit(_vsub(_E, _T), 1e-3),
    "uw": Unit(_vsub(_E, _T), 1e-6),
    "hz": Unit(_vsub(_ZERO, _T), 1.0),       # 1/s
    "ghz": Unit(_vsub(_ZERO, _T), 1e9),
    "ips": Unit(_vsub(_ZERO, _T), 1.0),      # inferences/s; count-free
    "rate": Unit(_vsub(_ZERO, _T), 1.0),     # events/s (switch_rate, ...)
    "bit": Unit(_B, 1.0),
    "bits": Unit(_B, 1.0),
    "width": Unit(_B, 1.0),                  # operand widths (psum_width)
    "byte": Unit(_B, 8.0),
    "bytes": Unit(_B, 8.0),
    "kb": Unit(_B, 8192.0),
    "mm2": Unit(_A, 1e-6),
    "um2": Unit(_A, 1e-12),
    "flops": Unit(_F, 1.0),
    "bw": Unit(_vsub(_B, _T), 8.0),          # bytes/s (roofline bandwidth)
    # dimensionless counts & factors — declaring them *known* lets
    # products like `macs * weight_bits` resolve to bits instead of
    # poisoning downstream checks with unknowns.
    "mac": DIMENSIONLESS,
    "macs": DIMENSIONLESS,
    "elems": DIMENSIONLESS,
    "cycle": DIMENSIONLESS,                  # _macs_per_cycle throughput
    "cycles": DIMENSIONLESS,
    "pe": DIMENSIONLESS,                     # _macs_per_pe_per_cycle
    "count": DIMENSIONLESS,
    "scale": DIMENSIONLESS,
    "frac": DIMENSIONLESS,
    "fraction": DIMENSIONLESS,
    "ratio": DIMENSIONLESS,
    "mult": DIMENSIONLESS,
    "duty": DIMENSIONLESS,
}

#: names that are a unit all by themselves (no underscore prefix needed)
WHOLE_NAMES: Dict[str, Unit] = {
    "ips": TOKENS["ips"],
    "bits": TOKENS["bits"],
    "macs": TOKENS["macs"],
    "duty": TOKENS["duty"],
    "scale": TOKENS["scale"],
}

_NODE_TAG = re.compile(r"_(?:\d+)$")       # _45, _7 process-node tags

#: singular forms are denominators only (``pj_per_bit``), never a name's
#: own unit — ``e_bit`` holds an energy, not a bit count.
_NOT_A_TAIL = {"bit", "byte", "mac", "cycle", "pe"}


def parse_name(name: str) -> Optional[Unit]:
    """Unit implied by a variable/function/attr name, or None.

    Grammar (right-anchored): ``..._<tok>``, ``..._<tok>_per_<tok>...``,
    with an optional trailing node tag. ``a_pj_per_bit`` => pJ/bit.
    ``..._at_<tok>`` is a parameter annotation (``savings_at_ips`` is a
    fraction *evaluated at* an IPS), not a unit.
    """
    base = _NODE_TAG.sub("", name.lower())
    if base in WHOLE_NAMES:
        return WHOLE_NAMES[base]
    parts = base.split("_")
    if len(parts) < 2:
        return None
    if len(parts) >= 2 and parts[-2] == "at":
        return None
    # find the longest trailing run of the form  tok (per tok)*
    if "per" in parts:
        i = len(parts) - 1 - parts[::-1].index("per")
        num_tok, den_toks = parts[i - 1] if i >= 1 else "", parts[i + 1:]
        if num_tok in TOKENS and all(t in TOKENS for t in den_toks) \
                and den_toks:
            u = TOKENS[num_tok]
            for t in den_toks:
                u = u / TOKENS[t]
            return u
        return None
    tail = parts[-1]
    if tail in TOKENS and tail not in _NOT_A_TAIL:
        return TOKENS[tail]
    return None


def parse_spec(spec: str) -> Unit:
    """Parse an explicit declaration like ``"pJ/bit"`` or ``"byte/s"``."""
    s = spec.strip().lower()
    if s in ("1", "", "dimensionless"):
        return DIMENSIONLESS
    if "/" in s:
        num, *dens = s.split("/")
        u = TOKENS[num.strip()]
        for d in dens:
            u = u / TOKENS[d.strip()]
        return u
    return TOKENS[s]


# --------------------------------------------------- explicit declarations

#: qualname relative to the analysed package (``Project.local``) -> unit
#: spec. Covers devices.py tables and roofline constants
#: whose names predate (or sit outside) the suffix convention.
DECLARED: Dict[str, str] = {
    # devices.py — scaling tables are pure ratios
    "core.devices.NODE_ENERGY_SCALE": "1",
    "core.devices.NODE_AREA_SCALE": "1",
    "core.devices.SRAM_AREA_SCALE": "1",
    "core.devices.NODE_DELAY_SCALE": "1",
    "core.devices.STANDBY_CURRENT_RATIO": "1",
    # energy/leakage/area constants
    "core.devices.SRAM_E_BASE_PJ_BIT": "pj/bit",
    "core.devices.SRAM_E_SQRT_PJ_BIT": "pj/bit",   # per sqrt(kB)
    "core.devices.SRAM_LEAK_UW_PER_KB_45": "uw/kb",
    "core.devices.SRAM_CELL_UM2_45": "um2/bit",
    "core.devices.MAC_INT8_PJ_45": "pj",
    "core.devices.CPU_OP_OVERHEAD_PJ_45": "pj",
    "core.devices.MAC_AREA_UM2_45": "um2",
    "core.devices.BASE_CLOCK_GHZ_45": "ghz",
    "core.devices.WAKEUP_TIME_S": "s",
    "core.devices.WEIGHT_STAGE_PJ_PER_BIT": "pj/bit",
    "core.devices.cell_energy_fraction": "1",
    # dataflow.py
    "core.dataflow.DELIVERY_PJ_PER_MAC_45": "pj",   # per MAC (count)
    "core.dataflow.CPU_DELIVERY_PJ_PER_MAC_45": "pj",
    "core.dataflow.CPU_SIMD": "1",
    # roofline.py
    "core.roofline.PEAK_FLOPS_BF16": "flops/s",
    "core.roofline.HBM_BW": "byte/s",
    "core.roofline.ICI_BW": "byte/s",
    "core.roofline._DTYPE_BYTES": "byte",
    # area.py
    "core.area.LOGIC_OVERHEAD": "1",
}
