"""Declarative design-space description for the paper's experiment matrix.

The DSE plane explores {workload x arch x node x variant x NVM device x PE
config}. Instead of nested for-loops per figure, a sweep is:

    space = (DesignSpace.product(
                 "fig2f",
                 workload=("detnet", "edsnet"),
                 arch=("cpu", "eyeriss", "simba"),
                 node=(45, 40, 28, 22, 7))
             .where(lambda p: p.node != 40 if p.arch == "cpu" else p.node != 45))
    results = Evaluator().evaluate(space)

Three pieces live here (evaluation lives in ``core.experiment``):

  * ``DesignPoint`` — one frozen, hashable coordinate of the matrix.
  * ``Bind``        — an axis value that sets SEVERAL point fields at once
                      (e.g. the paper's (node, device) corners (28, STT) and
                      (7, VGSOT) vary together, not as a cross product).
  * ``DesignSpace`` — an ordered, de-duplicated set of points with cartesian
                      ``product`` construction, ``where`` filters and union.

Iteration order is row-major over the axes in declaration order — exactly
the nested-loop order of the legacy ``dse.sweep_*`` functions, which is what
lets the parity tests compare row lists positionally.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, fields, replace
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

from repro_torch.configs.base import ConvLayerSpec
from repro_torch.core.placement import Placement

# The paper's XR design is ONE piece of silicon serving the workload suite;
# Tables 2-3 size buffers for the max over this suite.
PAPER_SUITE = ("detnet", "edsnet")


class _Unset:
    """Sentinel distinguishing "kwarg not given" from an explicit ``None``
    (``nvm=None`` is a real value: defer to the node's paper device)."""

    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()


@dataclass(frozen=True)
class DesignPoint:
    """One coordinate of the design-space matrix.

    ``workload`` is a config name (preferred: hashable + suite-sizing aware)
    or a frozen ``XRConfig``/``ModelConfig`` instance. ``extract_kw`` holds
    workload-extraction kwargs (e.g. ``context_len`` for LM decode specs) as
    a sorted item tuple so the point stays hashable.

    The technology axis is the frozen ``placement`` (see
    ``core.placement``): an ordered per-level device assignment. The legacy
    ``variant``/``nvm`` pair is accepted and CANONICALIZED into it —
    ``DesignPoint(w, a, n, "p0", nvm="stt")`` and
    ``DesignPoint(w, a, n, placement=Placement.variant("p0", "stt"))`` are
    the same (equal, same hash) point. After construction ``variant`` always
    holds the placement's label (``"sram"/"p0"/"p1"`` for the paper corners,
    an explicit ``gwb=stt+...`` label for hybrids) and ``nvm`` the
    placement's bound device, so every existing row builder keeps emitting
    byte-identical rows. Change the trio through ``with_()`` (it keeps the
    three fields coherent; raw ``dataclasses.replace`` with a new
    ``placement`` would see the stale label).

    ``weight_bits`` / ``act_bits`` / ``psum_bits`` override the extracted
    layers' operand widths (``None`` keeps each layer's own default, INT8).
    Precision is STRUCTURAL: it changes traffic, buffer sizing and area, so
    it is part of ``workload_key()`` and flows through every Evaluator
    cache. Sweep correlated corners with ``Bind(weight_bits=4, act_bits=8)``
    axis values (see ``experiment.QUANT_CORNERS``).
    """
    workload: Any
    arch: str
    node: int
    variant: Any = None                # label str | Placement | None
    nvm: Any = _UNSET                  # device str | None (paper's @node)
    pe_config: str = "v2"
    suite: Optional[Tuple[str, ...]] = PAPER_SUITE
    extract_kw: Tuple[Tuple[str, Any], ...] = ()
    weight_bits: Optional[int] = None  # None -> spec default (INT8)
    act_bits: Optional[int] = None
    psum_bits: Optional[int] = None
    placement: Optional[Placement] = None

    def __post_init__(self):
        if isinstance(self.suite, list):
            object.__setattr__(self, "suite", tuple(self.suite))
        if isinstance(self.extract_kw, dict):
            object.__setattr__(self, "extract_kw",
                               tuple(sorted(self.extract_kw.items())))
        # canonicalize the (variant, nvm, placement) trio: `placement` is
        # authoritative; explicit legacy kwargs override it (the sentinel
        # tells an omitted kwarg from an explicit nvm=None)
        pl, v, n = self.placement, self.variant, self.nvm
        if isinstance(v, Placement):           # positional Placement
            if pl is not None and pl != v:
                raise TypeError(
                    "DesignPoint: got two different placements (via "
                    "variant= and placement=)")
            pl, v = v, None
        if pl is None:
            pl = Placement.variant(v or "sram",
                                   None if n is _UNSET else n)
        elif v is not None and v != pl.label:
            pl = Placement.variant(v, pl.nvm if n is _UNSET else n)
        elif n is not _UNSET and n != pl.nvm:
            pl = pl.with_nvm(n)
        object.__setattr__(self, "placement", pl)
        object.__setattr__(self, "variant", pl.label)
        object.__setattr__(self, "nvm", pl.nvm)

    # --- convenience --------------------------------------------------------
    def with_(self, **changes) -> "DesignPoint":
        if "placement" in changes:
            # an explicit placement supersedes the canonicalized legacy
            # fields; placement=None resets the trio to the SRAM baseline
            changes.setdefault("variant", None)
            changes.setdefault("nvm", _UNSET)
        return replace(self, **changes)

    @property
    def workload_name(self) -> str:
        if isinstance(self.workload, str):
            return self.workload
        return getattr(self.workload, "name", "custom")

    def arch_spec(self):
        """Unsized ``ArchSpec`` for this point's (arch, pe_config) — owns
        the cpu asymmetry (the CPU model takes no pe_config; ``get_arch``
        would warn). Level NAMES/classes are what placement selectors
        resolve against, and sizing does not change them."""
        from repro_torch.core.archspec import get_arch
        if self.arch == "cpu":
            return get_arch("cpu")
        return get_arch(self.arch, pe_config=self.pe_config)

    def precision(self) -> Tuple[Optional[int], Optional[int], Optional[int]]:
        """Operand-width overrides as a hashable (weight, act, psum) tuple
        (raw: ``None`` = keep each extracted spec's own width)."""
        return (self.weight_bits, self.act_bits, self.psum_bits)

    def normalized_precision(self) -> Tuple[int, int, int]:
        """Physical corner identity with defaults resolved against
        ``ConvLayerSpec``'s rules: ``None`` widths -> the INT8 field
        defaults, psum ``None`` -> the derived ``psum_width``. The single
        source of the defaulting rule for pairing (``nvm.sram_pairs``) and
        labels — a default-width point and an explicit
        ``Bind(weight_bits=8, act_bits=8)`` corner normalize identically."""
        probe = ConvLayerSpec("_", "dense", 1, 1, 1, 1, (1, 1), **{
            k: v for k, v in zip(("weight_bits", "act_bits", "psum_bits"),
                                 self.precision()) if v is not None})
        return (probe.weight_bits, probe.act_bits, probe.psum_width)

    @property
    def precision_label(self) -> str:
        """Human label for tables: uniform widths collapse ('int8' for the
        defaults AND the explicit 8/8 corner, 'int4'), mixed ones read
        'w4a8'."""
        w, a, _ = self.normalized_precision()
        return f"int{w}" if w == a else f"w{w}a{a}"

    def workload_key(self) -> Tuple:
        """Cache key for extraction: config identity + extraction kwargs +
        operand widths (precision changes the extracted specs)."""
        return (self.workload, self.extract_kw, self.precision())

    def asdict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


_POINT_FIELDS = {f.name for f in fields(DesignPoint)}


class Bind:
    """Axis value binding several DesignPoint fields together.

    ``corner=(Bind(node=28, nvm="stt"), Bind(node=7, nvm="vgsot"))`` sweeps
    the two paper corners without crossing node against device.
    """

    def __init__(self, **kw):
        unknown = set(kw) - _POINT_FIELDS
        if unknown:
            raise TypeError(f"Bind: unknown DesignPoint fields {sorted(unknown)}")
        self.fields = dict(kw)

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.fields.items())
        return f"Bind({inner})"

    def __eq__(self, other):
        return isinstance(other, Bind) and self.fields == other.fields

    def __hash__(self):
        return hash(tuple(sorted(self.fields.items())))


AxisValues = Sequence[Any]


def _as_axis(values: Any) -> Tuple[Any, ...]:
    """Normalize one axis: scalars (incl. strings/configs) become 1-tuples."""
    if isinstance(values, (str, bytes, int, float, bool, Bind)) or values is None:
        return (values,)
    try:
        return tuple(values)
    except TypeError:
        return (values,)


def product_kwargs(norm: Dict[str, Tuple[Any, ...]],
                   combo: Sequence[Any]) -> Dict[str, Any]:
    """Merge one axis-value combination into ``DesignPoint`` kwargs
    (``Bind`` values contribute all their bound fields). Shared between the
    eager ``DesignSpace.product`` and the JAX package's lazy row-major
    iterators, so both resolve clashes identically."""
    kw: Dict[str, Any] = {}
    for axis_name, value in zip(norm, combo):
        fields = value.fields if isinstance(value, Bind) \
            else {axis_name: value}
        clash = set(fields) & set(kw)
        if clash:
            raise TypeError(
                f"axis {axis_name!r} sets fields {sorted(clash)} "
                f"already bound by an earlier axis")
        kw.update(fields)
    return kw


def check_axes(norm: Dict[str, Tuple[Any, ...]]) -> None:
    """Validate normalized product axes: names must be DesignPoint fields
    unless every value on the axis is a ``Bind``."""
    for k, vals in norm.items():
        if k not in _POINT_FIELDS and not all(
                isinstance(v, Bind) for v in vals):
            raise TypeError(
                f"axis {k!r} is not a DesignPoint field; non-field axes "
                f"must contain only Bind values")


class DesignSpace:
    """Ordered, de-duplicated collection of ``DesignPoint``s with named axes."""

    def __init__(self, points: Iterable[DesignPoint], name: str = "space",
                 axes: Optional[Dict[str, Tuple[Any, ...]]] = None):
        seen = set()
        uniq: List[DesignPoint] = []
        for p in points:
            if not isinstance(p, DesignPoint):
                raise TypeError(f"DesignSpace holds DesignPoints, got {type(p)}")
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        self._points: Tuple[DesignPoint, ...] = tuple(uniq)
        # the membership set is built once here (the points are immutable);
        # __contains__ must never rebuild it per query
        self._point_set: frozenset = frozenset(seen)
        self.name = name
        self.axes: Dict[str, Tuple[Any, ...]] = dict(axes or {})

    # --- construction -------------------------------------------------------
    @classmethod
    def product(cls, name: str = "space", **axes: Any) -> "DesignSpace":
        """Cartesian product over named axes, row-major in declaration order.

        Axis names are ``DesignPoint`` field names; an axis whose values are
        ``Bind`` objects may use any name (its bound fields are merged in).
        Scalar axis values (strings, ints, configs) are auto-wrapped.
        """
        norm = {k: _as_axis(v) for k, v in axes.items()}
        check_axes(norm)
        points = [DesignPoint(**product_kwargs(norm, combo))
                  for combo in itertools.product(*norm.values())]
        return cls(points, name=name, axes=norm)

    @classmethod
    def from_points(cls, points: Iterable[DesignPoint],
                    name: str = "space") -> "DesignSpace":
        return cls(points, name=name)

    # --- algebra ------------------------------------------------------------
    def where(self, *predicates: Callable[[DesignPoint], bool]) -> "DesignSpace":
        pts = [p for p in self._points if all(pred(p) for pred in predicates)]
        return DesignSpace(pts, name=self.name, axes=self.axes)

    def map(self, fn: Callable[[DesignPoint], DesignPoint]) -> "DesignSpace":
        # axes metadata survives map exactly like it survives where: the
        # DECLARED values stay queryable via axis() even when fn rewrites
        # point fields (field-name axes always reflect the actual points)
        return DesignSpace([fn(p) for p in self._points], name=self.name,
                           axes=self.axes)

    def __add__(self, other: "DesignSpace") -> "DesignSpace":
        merged = dict(self.axes)
        for k, vals in getattr(other, "axes", {}).items():
            have = merged.get(k, ())
            merged[k] = have + tuple(v for v in vals if v not in have)
        return DesignSpace(self._points + tuple(other),
                           name=f"{self.name}+{other.name}", axes=merged)

    # --- container protocol -------------------------------------------------
    def __iter__(self) -> Iterator[DesignPoint]:
        return iter(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def __getitem__(self, i) -> Union[DesignPoint, Tuple[DesignPoint, ...]]:
        return self._points[i]

    def __contains__(self, p: DesignPoint) -> bool:
        return p in self._point_set

    def __repr__(self):
        ax = ", ".join(f"{k}[{len(v)}]" for k, v in self.axes.items())
        return f"DesignSpace({self.name!r}, {len(self)} points, axes: {ax})"

    def axis(self, name: str) -> Tuple[Any, ...]:
        """Distinct values actually present for a point field, in order.
        Non-field (Bind) axis names return their declared values."""
        if name not in _POINT_FIELDS:
            if name in self.axes:
                return self.axes[name]
            raise KeyError(name)
        seen: Dict[Any, None] = {}
        for p in self._points:
            seen.setdefault(getattr(p, name))
        return tuple(seen)
