"""Per-level memory-technology placement: the axis that opens hybrid
hierarchies (DESIGN.md §6 §Placement).

The paper evaluates exactly two MRAM placements — P0 (weight levels) and P1
(everything) — but its real question is *which levels of the hierarchy
should be non-volatile at a given inference rate*. Heterogeneous hierarchies
are what silicon ships (Siracusa's weight-MRAM + SRAM L1, arXiv:2312.14750),
so the technology axis here is a first-class object instead of a closed
``(variant, nvm)`` string pair:

  * ``Placement`` — a frozen, hashable, ORDERED mapping from memory-level
    selector to device name. A selector is a level name (``"gwb"``), a level
    class (``"weight"`` / ``"input"`` / ``"output"`` / ``"unified"``), or
    ``"*"`` (every level); later entries override earlier ones. A tech of
    ``None`` defers to the placement's bound ``nvm`` device (or, at
    resolution time, the paper's device for the node) — exactly the legacy
    ``nvm=None`` semantics.
  * ``Placement.sram()`` / ``Placement.variant("p0"|"p1", nvm)`` — the
    paper's corners as named shims; byte-parity with the legacy
    ``archspec.apply_variant`` path is asserted by the parity suite
    (``tests/test_placement.py`` vs ``tests/legacy_reference.py``).
  * ``Placement.uniform(tech)`` / ``Placement.per_level(mapping)`` — open
    constructors for anything in between.
  * ``Placement.enumerate(arch, techs, levels=...)`` — the full per-level
    lattice (``len(techs) ** len(levels)`` distinct placements), the input
    of ``SWEEPS["placement"]``.
  * ``with_level(name, tech)`` — a single-level move (hillclimb
    neighborhoods, ``tools/hillclimb.py``).

Every device name is validated against ``devices.DEVICES`` at construction,
so a typo'd ``nvm="sttt"`` fails HERE with the offending selector named
instead of as a bare ``KeyError`` deep inside pricing.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core import devices as dev
from repro_torch.core.archspec import VARIANTS, ArchSpec, MemLevel, get_arch

Selector = str                      # level name | level class | "*"
Tech = Optional[str]                # device name | None (defer to nvm)
Entry = Tuple[Selector, Tech]

LEVEL_CLASSES = ("weight", "input", "output", "unified")


def _check_tech(tech: Tech, where: str) -> Tech:
    if tech is not None and tech not in dev.DEVICES:
        raise ValueError(
            f"{where}: unknown memory technology {tech!r} "
            f"(known devices: {sorted(dev.DEVICES)})")
    return tech


def _auto_label(entries: Sequence[Entry]) -> str:
    if not entries:
        return "sram"
    return "+".join(f"{sel}={tech or 'nvm'}" for sel, tech in entries)


@dataclass(frozen=True)
class Placement:
    """Frozen, hashable per-level technology assignment.

    ``entries`` is an ordered ``(selector, tech)`` tuple; ``nvm`` is the
    device that ``tech=None`` entries resolve to (``None`` = defer to the
    caller / the paper's per-node device); ``label`` is the display name
    (``DesignPoint.variant`` returns it, so the legacy ``"sram"/"p0"/"p1"``
    strings keep flowing through every row builder unchanged).
    """
    entries: Tuple[Entry, ...] = ()
    nvm: Optional[str] = None
    label: str = "sram"

    def __post_init__(self):
        norm = []
        for e in self.entries:
            sel, tech = e
            if not isinstance(sel, str):
                raise TypeError(f"Placement selector must be a level name, "
                                f"level class or '*', got {sel!r}")
            norm.append((sel, _check_tech(tech, f"Placement[{sel}]")))
        object.__setattr__(self, "entries", tuple(norm))
        _check_tech(self.nvm, "Placement.nvm")

    # --- constructors -------------------------------------------------------
    @classmethod
    def sram(cls) -> "Placement":
        """The all-SRAM baseline (no level converted)."""
        return _SRAM

    @classmethod
    def variant(cls, label: str, nvm: Optional[str] = None) -> "Placement":
        """The paper's corners as named shims: ``"sram"`` converts nothing,
        ``"p0"`` converts the weight-class levels, ``"p1"`` everything.
        ``nvm=None`` defers to the node's paper device (legacy semantics)."""
        if isinstance(label, Placement):
            return label if nvm is None else label.with_nvm(nvm)
        if label not in VARIANTS:
            raise ValueError(
                f"unknown variant {label!r} (one of {VARIANTS}); use "
                f"Placement.per_level/uniform/enumerate for hybrid placements")
        if label == "sram":
            return cls((), nvm, "sram")
        entries = (("weight", None),) if label == "p0" else (("*", None),)
        return cls(entries, nvm, label)

    @classmethod
    def uniform(cls, tech: str) -> "Placement":
        """Every level in one technology (``uniform('sram')`` is the
        explicit spelling of the baseline)."""
        _check_tech(tech, "Placement.uniform")
        return cls((("*", tech),), None, f"*={tech}")

    @classmethod
    def per_level(cls, mapping: Union[Mapping[str, Tech], Iterable[Entry]],
                  nvm: Optional[str] = None) -> "Placement":
        """Ordered {selector: tech} assignment (dict or (sel, tech) pairs)."""
        entries = tuple(mapping.items() if isinstance(mapping, Mapping)
                        else mapping)
        return cls(entries, nvm, _auto_label(entries))

    @classmethod
    def enumerate(cls, arch: Union[str, ArchSpec], techs: Sequence[str],
                  levels: Optional[Sequence[str]] = None) -> List["Placement"]:
        """The exhaustive per-level lattice: every assignment of ``techs``
        to ``levels`` (default: all memory levels of ``arch``), row-major in
        level order — ``len(techs) ** len(levels)`` distinct placements.
        Constrain ``levels`` to sweep a sub-lattice (e.g. weight levels
        only)."""
        if isinstance(arch, str):
            arch = get_arch(arch)
        names = tuple(levels if levels is not None
                      else (l.name for l in arch.levels))
        known = {l.name for l in arch.levels} | set(LEVEL_CLASSES) | {"*"}
        for n in names:
            if n not in known:
                raise ValueError(
                    f"Placement.enumerate: {n!r} is not a level of "
                    f"{arch.name!r} (levels: {[l.name for l in arch.levels]})")
        techs = tuple(techs)
        for t in techs:
            _check_tech(t, "Placement.enumerate")
        return [cls.per_level(tuple(zip(names, combo)))
                for combo in itertools.product(techs, repeat=len(names))]

    # --- algebra ------------------------------------------------------------
    def with_level(self, name: str, tech: Tech) -> "Placement":
        """Single-level move: re-assign ``name`` so the new tech WINS the
        ordered override resolution. The hillclimb neighborhood op.

        An existing ``name`` entry is edited in place only when no later
        entry (a class, ``"*"`` or a duplicate name) could override it —
        otherwise the stale entries are dropped and the move appended last,
        so the label never claims a tech the resolution ignores."""
        _check_tech(tech, f"Placement.with_level[{name}]")
        entries = list(self.entries)
        hits = [i for i, (sel, _) in enumerate(entries) if sel == name]
        overridable = ("*",) + LEVEL_CLASSES
        if hits and not any(sel == name or sel in overridable
                            for sel, _ in entries[hits[-1] + 1:]):
            entries[hits[-1]] = (name, tech)
        else:
            entries = [e for e in entries if e[0] != name] + [(name, tech)]
        return Placement(tuple(entries), self.nvm, _auto_label(entries))

    def with_nvm(self, nvm: Optional[str]) -> "Placement":
        """Re-bind the device that deferred (``tech=None``) entries use."""
        return replace(self, nvm=nvm)

    # --- predicates ---------------------------------------------------------
    @property
    def converts_nothing(self) -> bool:
        """True iff every level stays SRAM (the baseline test the pairing
        helpers use — an explicit all-``sram`` lattice point counts)."""
        return all(t == "sram" for _, t in self.entries)

    # --- resolution ---------------------------------------------------------
    def techs_for(self, levels: Sequence[MemLevel],
                  default_nvm: Optional[str] = None) -> List[str]:
        """Per-level technology vector for ``levels`` (the columnar plane's
        batching unit). Entries apply in order. Class selectors and ``"*"``
        are SET selectors — matching zero levels is vacuous (an arch without
        output buffers ignores an ``output=...`` entry) — but a level-NAME
        selector that matches nothing is an error naming the hierarchy (it
        is almost certainly a placement built for a different arch)."""
        out = [l.tech for l in levels]
        for sel, tech in self.entries:
            t = tech if tech is not None else (self.nvm or default_nvm)
            if t is None:
                raise ValueError(
                    f"placement {self.label!r}: selector {sel!r} defers to "
                    f"an NVM device but none is bound (set nvm= on the "
                    f"placement or pass default_nvm=)")
            _check_tech(t, f"placement {self.label!r}[{sel}]")
            matched = False
            for j, l in enumerate(levels):
                if sel == "*" or sel == l.name or sel == l.cls:
                    out[j] = t
                    matched = True
            if not matched and sel != "*" and sel not in LEVEL_CLASSES:
                raise ValueError(
                    f"placement {self.label!r}: selector {sel!r} matches no "
                    f"memory level (levels: {[l.name for l in levels]}, "
                    f"classes: {sorted({l.cls for l in levels})})")
        return out

    def resolve(self, spec: ArchSpec,
                default_nvm: Optional[str] = None) -> Dict[str, str]:
        """{level name: tech} for ``ArchSpec.with_tech`` (only levels whose
        tech actually changes are listed)."""
        techs = self.techs_for(spec.levels, default_nvm)
        return {l.name: t for l, t in zip(spec.levels, techs) if t != l.tech}

    def apply(self, spec: ArchSpec,
              default_nvm: Optional[str] = None) -> ArchSpec:
        """Tech-mapped copy of ``spec`` (identity for the SRAM baseline,
        matching the legacy ``apply_variant`` short-circuit)."""
        if not self.entries:
            return spec
        return spec.with_tech(self.resolve(spec, default_nvm))

    def __repr__(self):
        nvm = f", nvm={self.nvm!r}" if self.nvm else ""
        return f"Placement({self.label!r}{nvm})"


_SRAM = Placement((), None, "sram")
