"""FZ — frozen-axis invariants.

Every dataclass used as a cache key or DSE axis must be
``@dataclass(frozen=True)`` with recursively hashable field types
(tuples of frozen things, scalars, strings — never lists/dicts/sets/
ndarrays), or a stale mutation would silently corrupt every Evaluator
cache keyed on it.  Additionally, memoizing classes (those with cache
dicts, e.g. ``Evaluator``) may not assign ``self.<attr>`` outside
``__init__`` — all mutable state must be declared up front so cached
methods stay observationally pure.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import ClassInfo, Project, annotation_tokens

#: DSE axes / cache keys (terminal names resolved against the project)
# qualnames relative to the analysed package (``Project.qual``)
DEFAULT_AXIS_CLASSES = (
    "core.space.DesignPoint",
    "core.schedule.SystemPoint",
    "core.schedule.Stream",
    "core.placement.Placement",
    "core.archspec.MemLevel",
    "core.archspec.ArchSpec",
    "configs.base.ConvLayerSpec",
    "configs.base.ModelConfig",
    "configs.base.XRConfig",
)

DEFAULT_EVALUATOR_CLASSES = ("core.experiment.Evaluator",)

_UNHASHABLE = {"List", "list", "Dict", "dict", "Set", "set", "ndarray",
               "bytearray", "MutableMapping", "MutableSequence",
               "DefaultDict", "defaultdict", "OrderedDict", "Counter"}
_HASHABLE_LEAVES = {"int", "float", "str", "bool", "bytes", "complex",
                    "None", "NoneType", "Optional", "Union", "Tuple",
                    "tuple", "FrozenSet", "frozenset", "Any", "Callable",
                    "type", "Fraction", "Decimal", "Enum"}


def _dataclass_frozen(ci: ClassInfo) -> Optional[bool]:
    """True/False if decorated with @dataclass(...), None otherwise."""
    for dec in ci.node.decorator_list:
        base = dec.func if isinstance(dec, ast.Call) else dec
        name = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else "")
        if name != "dataclass":
            continue
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                    return bool(kw.value.value)
            return False          # @dataclass(...) without frozen=True
        return False              # bare @dataclass
    return None


def _field_annotations(ci: ClassInfo) -> List[Tuple[str, ast.expr]]:
    out = []
    for stmt in ci.node.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            if annotation_tokens(stmt.annotation) and \
                    "ClassVar" in annotation_tokens(stmt.annotation):
                continue
            out.append((stmt.target.id, stmt.annotation))
    return out


def _check_class(proj: Project, ci: ClassInfo, out: List[Finding],
                 seen: Set[str]) -> None:
    if ci.qualname in seen:
        return
    seen.add(ci.qualname)
    mod = proj.modules[ci.module]
    rel = proj.rel(mod)
    name = ci.node.name

    frozen = _dataclass_frozen(ci)
    if frozen is None:
        # non-dataclass axes (e.g. a hand-rolled Bind) must define
        # __hash__ and __eq__ to be key-safe; only flag dataclasses here.
        pass
    elif not frozen:
        out.append(Finding(
            "FZ", "unfrozen-axis", Severity.ERROR, rel, name,
            f"'{name}' is used as a cache key / DSE axis but is not "
            f"@dataclass(frozen=True)", line=ci.node.lineno))

    for fname, ann in _field_annotations(ci):
        toks = annotation_tokens(ann)
        bad = sorted(set(toks) & _UNHASHABLE)
        if bad:
            out.append(Finding(
                "FZ", "unhashable-field", Severity.ERROR, rel, name,
                f"field '{fname}' of axis dataclass '{name}' has "
                f"unhashable type component(s) {bad}",
                line=ann.lineno))
            continue
        # nested project dataclasses must themselves be frozen
        for tok in toks:
            if tok in _HASHABLE_LEAVES or tok in _UNHASHABLE:
                continue
            sub = proj.resolve_class(mod, tok)
            if sub is None:
                continue
            if _dataclass_frozen(sub) is False:
                out.append(Finding(
                    "FZ", "unfrozen-field-type", Severity.ERROR, rel, name,
                    f"field '{fname}' of axis dataclass '{name}' embeds "
                    f"'{tok}', a dataclass that is not frozen=True",
                    line=ann.lineno))
            if _dataclass_frozen(sub) is not None:
                _check_class(proj, sub, out, seen)


def _check_evaluator(proj: Project, ci: ClassInfo,
                     out: List[Finding]) -> None:
    """Cached methods may not grow new self state outside __init__."""
    mod = proj.modules[ci.module]
    rel = proj.rel(mod)
    declared: Set[str] = set()
    init = ci.methods.get("__init__")
    if init is not None:
        for node in ast.walk(init.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        declared.add(t.attr)
    for mname, fi in ci.methods.items():
        if mname == "__init__":
            continue
        for node in ast.walk(fi.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.append(Finding(
                            "FZ", "cache-mutation", Severity.ERROR, rel,
                            f"{ci.node.name}.{mname}",
                            f"memoizing class '{ci.node.name}' mutates "
                            f"'self.{t.attr}' outside __init__ (declared "
                            f"cache dicts may only be updated via "
                            f"subscript)", line=node.lineno))


def check(proj: Project,
          axis_classes: Optional[Sequence[str]] = None,
          evaluator_classes: Optional[Sequence[str]] = None
          ) -> List[Finding]:
    if axis_classes is None:
        axis_classes = proj.quals(DEFAULT_AXIS_CLASSES)
    if evaluator_classes is None:
        evaluator_classes = proj.quals(DEFAULT_EVALUATOR_CLASSES)
    out: List[Finding] = []
    seen: Set[str] = set()
    for qual in axis_classes:
        ci = proj.classes.get(qual)
        if ci is None:
            # tolerate terminal-name config in fixture projects
            hits = [c for q, c in proj.classes.items()
                    if q.rsplit(".", 1)[-1] == qual.rsplit(".", 1)[-1]]
            ci = hits[0] if len(hits) == 1 else None
        if ci is not None:
            _check_class(proj, ci, out, seen)
    for qual in evaluator_classes:
        ci = proj.classes.get(qual)
        if ci is not None:
            _check_evaluator(proj, ci, out)
    seen_fp, uniq = set(), []
    for f in out:
        if f.fingerprint not in seen_fp:
            seen_fp.add(f.fingerprint)
            uniq.append(f)
    return uniq
