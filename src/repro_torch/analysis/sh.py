"""SH — symbolic shape/broadcast dataflow over the columnar pricing stack.

Infers symbolic axis shapes for numpy expressions using the project axis
vocabulary (`AXES`: P points, L levels, G groups, W windows, S systems,
R streams, ...) and checks elementwise/broadcast compatibility across
`core/columns.py`, `core/schedule.py`, `trace/simulator.py`, and
`search/stream.py`'s stride-arithmetic fast path.

Shape sources, in priority order:

* the explicit registries below (`PARAM_VALS`, `RETURN_VALS`,
  `ATTR_VALS`, `CLASS_SCALARS`, `FIELD_SUBST`/`PARAM_SUBST`);
* trailing ``# (P, L)`` comments on ndarray-annotated dataclass fields
  and on ``def`` lines (the house convention throughout the repo);
* interprocedural return-shape summaries computed bottom-up over the
  call graph (`Project.fixpoint`), context-insensitive;
* the single-uppercase-letter convention: a bare read of ``W``/``S``/...
  (or such a name assigned an unknown scalar, e.g. ``W = rates.shape[0]``)
  is the matching axis extent. Assigning an *array* to such a name (as
  `map_specs` does with ``W``) overrides the convention.

A dim is a sorted tuple of atoms: ``("P",)``, a product ``("R", "W")``
(flattened W·R), a literal ``("0",)``, broadcast slot ``("1",)``, or the
unknown ``("?",)``. Unknowns propagate *optimistically* (same trade as
UN): ``unknown ⊗ (P, L)`` keeps ``(P, L)``, and literal-vs-named dims
are assumed consistent except under the constructor rule, where an
``if X == literal:`` guard must pin the axis.

Substitutions handle axis aliasing: `SystemGeometry.plan` is a
`PricingPlan` with one row per *stream*, so its ``P`` reads as ``R``
(`FIELD_SUBST`), and the same rename follows `columns.price`'s return
through `schedule.price` via call-site substitution propagation.

Rules (all messages are line-free for fingerprint stability):

* ``broadcast-mismatch`` — named-vs-named dim conflict in an
  elementwise op / comparison / matmul contraction.
* ``rank-promotion`` — unequal-rank operands that share no named axis
  position: the ``(P, 1)`` meets ``(L,)`` outer-product-by-accident.
* ``reduce-axis`` — reduction axis out of the inferred rank.
* ``bincount-mismatch`` — ``np.bincount`` x vs weights length conflict.
* ``reshape-factor`` — reshape/ravel/tile whose symbolic element
  multisets don't factor (``(W·R,)`` into ``(W, S)``).
* ``ctor-shape`` — shape-declared dataclass constructed with an arg
  whose dims conflict with the declaration; a literal dim is accepted
  only where a dominating ``if AXIS == literal:`` guard pins the axis.
* ``return-shape`` — declared ``def``-line return shape vs inferred.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import (FuncInfo, ModuleInfo, Project,
                                    annotation_tokens)

DEFAULT_MODULES = (
    "core.columns",
    "core.schedule",
    "trace.simulator",
    "search.stream",
)

#: axis vocabulary: single uppercase letters with project-wide meaning
AXES = {
    "P": "design points (plan rows)",
    "L": "memory levels (mask-padded)",
    "G": "traffic groups",
    "N": "workload layers",
    "W": "trace windows",
    "S": "systems",
    "R": "stream rows (system x stream)",
    "K": "batched-bisection rows",
    "Q": "IPS-grid points",
}

Dim = Tuple[str, ...]
Shape = Tuple[Dim, ...]

_UNK: Dim = ("?",)


@dataclass(frozen=True)
class _Val:
    """Inferred value: array shape, axis scalar, object, or tuple."""
    kind: str                                   # array | axis | obj | tuple
    shape: Optional[Shape] = None               # array
    atom: Optional[str] = None                  # axis scalar / literal int
    cls: Optional[str] = None                   # obj class qualname
    subst: Tuple[Tuple[str, str], ...] = ()     # obj axis renames
    elts: Tuple[Optional["_Val"], ...] = ()     # tuple elements


def _dim(*atoms: str) -> Dim:
    return tuple(sorted(atoms))


def A(*dims) -> _Val:
    """Array value from dim specs (str atom or tuple of atoms)."""
    shape = tuple(_dim(d) if isinstance(d, str) else _dim(*d) for d in dims)
    return _Val("array", shape=shape)


def X(atom: str) -> _Val:
    return _Val("axis", atom=atom)


def O(cls: str, subst: Optional[Dict[str, str]] = None) -> _Val:  # noqa: E743 - O(bject) reads fine next to A(rray)/X(axis)
    return _Val("obj", cls=cls, subst=tuple(sorted((subst or {}).items())))


def T(*elts: Optional[_Val]) -> _Val:
    return _Val("tuple", elts=tuple(elts))


def _is_lit(d: Dim) -> bool:
    return all(a.isdigit() for a in d)


def _named(d: Dim) -> bool:
    return any(a in AXES for a in d)


def _apply_subst(val: Optional[_Val],
                 subst: Tuple[Tuple[str, str], ...]) -> Optional[_Val]:
    if val is None or not subst:
        return val
    table = dict(subst)
    if val.kind == "array" and val.shape is not None:
        shape = tuple(_dim(*(table.get(a, a) for a in d)) for d in val.shape)
        return _Val("array", shape=shape)
    if val.kind == "axis" and val.atom is not None:
        return _Val("axis", atom=table.get(val.atom, val.atom))
    if val.kind == "obj":
        merged = dict(val.subst)
        merged.update(table)
        return _Val("obj", cls=val.cls, subst=tuple(sorted(merged.items())))
    if val.kind == "tuple":
        return _Val("tuple",
                    elts=tuple(_apply_subst(e, subst) for e in val.elts))
    return val


def _fmt(shape: Shape) -> str:
    return "(" + ", ".join("·".join(d) for d in shape) + ")"


def _src(node: ast.AST, limit: int = 48) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        text = "<expr>"
    return text if len(text) <= limit else text[:limit - 3] + "..."


# --------------------------------------------------------------- registries

#: The registries are keyed by qualnames relative to the analysed package
#: (``Project.local``), so one table serves any package name.

#: per-function parameter seeds: qualname -> {param: _Val}
PARAM_VALS: Dict[str, Dict[str, _Val]] = {
    "core.schedule.switch_rate_at": {
        "sys_idx": A("R"), "ips": A("R"), "is_union_rows": A("R"),
        "n_systems": X("S")},
    "core.schedule._rollup": {
        "sys_idx": A("R"), "ips": A("R"), "is_union_rows": A("R"),
        "S": X("S"), "e_mem_j": A("R"), "e_compute_j": A("R"),
        "latency_s": A("R"), "standby_w": A("R"), "wake_j": A("R"),
        "rel_j": A("R")},
    "core.schedule.window_rollup": {"rates": A("W", "R")},
    "trace.simulator._weighted_percentile": {
        "values": A("W", "S"), "weights": A("W")},
    "core.columns.crossover_ips": {
        "nvm_rows": A("K"), "sram_rows": A("K")},
    "search.stream.LatticePricer._plan": {
        "gf": A("P"), "gid": A("P"), "nf": A("P"), "pf": A("P")},
}

#: return-shape seeds for functions whose bodies erase the shape
RETURN_VALS: Dict[str, _Val] = {
    "trace.scenario.Scenario.rate_matrix": T(A("W"), A("W"), A("W", "R")),
    "trace.simulator._row_rates": T(A("W"), A("W"), A("W", "R")),
}

#: non-field instance attributes with known shapes
ATTR_VALS: Dict[str, _Val] = {
    # (G, 6, L) pre-gathered per-group column block (see _compile)
    "search.stream.LatticePricer._gstack": A("G", "6", "L"),
}

#: int-valued properties that measure an axis
CLASS_SCALARS: Dict[str, str] = {
    "core.columns.PricingPlan.n_points": "P",
    "core.schedule.SystemGeometry.n_systems": "S",
    "core.schedule.WindowColumns.n_windows": "W",
}

#: axis renames on object-typed fields (P == R for per-stream plans)
FIELD_SUBST: Dict[str, Dict[str, str]] = {
    "core.schedule.SystemGeometry.plan": {"P": "R"},
}

#: axis renames on object-typed parameters
PARAM_SUBST: Dict[str, Dict[str, str]] = {
    "core.schedule.reload_energy_j": {"table": {"P": "R"}},
}

_TYPING_TOKENS = frozenset({
    "np", "numpy", "ndarray", "Optional", "Tuple", "List", "Dict",
    "Sequence", "Iterable", "Mapping", "OrderedDict", "Union", "Any",
    "float", "int", "str", "bool", "object", "tuple", "list", "dict",
})

_SHAPE_RE = re.compile(r"\(([^)]*)\)")

_REDUCE_METHODS = frozenset({"sum", "max", "min", "mean", "prod", "std",
                             "var", "any", "all", "argmax", "argmin"})
_PASS_METHODS = frozenset({"copy", "astype", "clip", "round", "cumsum",
                           "argsort", "conj"})
_EW_FUNCS = frozenset({"minimum", "maximum", "fmax", "fmin", "add",
                       "subtract", "multiply", "divide", "hypot",
                       "logaddexp", "power", "logical_and", "logical_or",
                       "logical_xor", "take_along_axis"})
_UNARY_FUNCS = frozenset({"abs", "sqrt", "exp", "log", "log2", "log10",
                          "ceil", "floor", "round", "nan_to_num",
                          "isfinite", "isnan", "sign", "copy", "negative",
                          "logical_not", "asarray", "ascontiguousarray",
                          "atleast_1d", "clip"})
_REDUCE_FUNCS = frozenset({"sum", "max", "min", "mean", "prod", "std",
                           "var", "median", "any", "all", "argmax",
                           "argmin", "nanmax", "nanmin", "nansum"})


def _parse_dims(comment: str) -> Optional[Shape]:
    """'(P, L)' -> ((P,), (L,)); unknown tokens become '?' dims."""
    m = _SHAPE_RE.search(comment)
    if m is None:
        return None
    dims: List[Dim] = []
    for tok in m.group(1).split(","):
        tok = tok.strip().rstrip("'")
        if not tok:
            continue
        if tok.isdigit():
            dims.append((tok,))
        elif tok in AXES:
            dims.append((tok,))
        else:
            dims.append(_UNK)
    return tuple(dims)


def _trailing_shape(mod: ModuleInfo, lineno: int) -> Optional[Shape]:
    lines = mod.source.splitlines()
    if not 1 <= lineno <= len(lines):
        return None
    line = lines[lineno - 1]
    if "#" not in line:
        return None
    return _parse_dims(line.split("#", 1)[1])


@dataclass
class _FieldInfo:
    shape: Optional[Shape] = None        # from trailing comment (ndarray)
    cls: Optional[str] = None            # resolved class qualname
    is_array: bool = False


class _Engine:
    """Shared inference state: class field maps + function summaries."""

    def __init__(self, proj: Project):
        self.proj = proj
        self.summaries: Dict[str, Optional[_Val]] = {}
        self._fields: Dict[str, Dict[str, _FieldInfo]] = {}
        self._def_shapes: Dict[str, Optional[Shape]] = {}

    # --------------------------------------------------------- class fields

    def class_fields(self, cls_qual: str) -> Dict[str, _FieldInfo]:
        cached = self._fields.get(cls_qual)
        if cached is not None:
            return cached
        out: Dict[str, _FieldInfo] = {}
        ci = self.proj.classes.get(cls_qual)
        if ci is not None:
            mod = self.proj.modules[ci.module]
            for stmt in ci.node.body:
                if not (isinstance(stmt, ast.AnnAssign) and
                        isinstance(stmt.target, ast.Name)):
                    continue
                toks = annotation_tokens(stmt.annotation)
                info = _FieldInfo(is_array="ndarray" in toks)
                if info.is_array:
                    info.shape = _trailing_shape(mod, stmt.lineno)
                else:
                    for tok in toks:
                        if tok in _TYPING_TOKENS:
                            continue
                        target = self.proj.resolve_class(mod, tok)
                        if target is not None:
                            info.cls = target.qualname
                            break
                out[stmt.target.id] = info
        self._fields[cls_qual] = out
        return out

    def field_order(self, cls_qual: str) -> List[str]:
        """Dataclass constructor parameter order == field declaration."""
        return list(self.class_fields(cls_qual))

    def def_shape(self, fi: FuncInfo) -> Optional[Shape]:
        cached = self._def_shapes.get(fi.qualname, "miss")
        if cached != "miss":
            return cached
        mod = self.proj.modules[fi.module]
        shape = _trailing_shape(mod, fi.node.lineno)
        self._def_shapes[fi.qualname] = shape
        return shape

    # --------------------------------------------------------- callee value

    def callee_value(self, fi: FuncInfo,
                     arg_vals: Sequence[Optional[_Val]]) -> Optional[_Val]:
        """Return value of a resolved call, with call-site substitution
        propagation from object-typed arguments (P == R through
        `schedule.price` -> `columns.price(geom.plan)`)."""
        val = RETURN_VALS.get(self.proj.local(fi.qualname))
        if val is None:
            val = self.summaries.get(fi.qualname)
        if val is None:
            shape = self.def_shape(fi)
            if shape is not None:
                val = _Val("array", shape=shape)
        if val is None:
            val = self.return_class(fi)
        if val is None:
            return None
        subst: Dict[str, str] = {}
        for av in arg_vals:
            if av is not None and av.kind == "obj":
                for k, v in av.subst:
                    subst.setdefault(k, v)
        if subst:
            val = _apply_subst(val, tuple(sorted(subst.items())))
        return val

    def return_class(self, fi: FuncInfo) -> Optional[_Val]:
        if fi.node.returns is None:
            return None
        mod = self.proj.modules[fi.module]
        for tok in annotation_tokens(fi.node.returns):
            if tok in _TYPING_TOKENS:
                continue
            ci = self.proj.resolve_class(mod, tok)
            if ci is not None:
                return O(ci.qualname)
        return None

    # ------------------------------------------------------------ transfer

    def transfer(self, fi: FuncInfo,
                 summaries: Dict[str, Optional[_Val]]) -> Optional[_Val]:
        self.summaries = summaries
        fn = _Fn(self, fi, out=None)
        fn.run()
        return fn.return_summary()

    def collect(self, fi: FuncInfo, out: List[Finding]) -> None:
        fn = _Fn(self, fi, out=out)
        fn.run()


class _Fn:
    """Single-pass, statement-ordered inference over one function."""

    def __init__(self, eng: _Engine, fi: FuncInfo,
                 out: Optional[List[Finding]]):
        self.eng = eng
        self.proj = eng.proj
        self.fi = fi
        self.mod = eng.proj.modules[fi.module]
        self.out = out
        self.env: Dict[str, Optional[_Val]] = {}
        self.lambdas: Dict[str, ast.Lambda] = {}
        self.pins: Dict[str, int] = {}        # axis atom -> guarded literal
        self.returns: List[Optional[_Val]] = []
        self._seed_params()

    # ------------------------------------------------------------ reporting

    def _flag(self, rule: str, message: str, node: ast.AST,
              severity: Severity = Severity.ERROR) -> None:
        if self.out is None:
            return
        self.out.append(Finding(
            checker="SH", rule=rule, severity=severity,
            path=self.proj.rel(self.mod),
            symbol=self.fi.qualname.removeprefix(self.mod.name + "."),
            message=message, line=getattr(node, "lineno", 0)))

    # -------------------------------------------------------------- seeding

    def _seed_params(self) -> None:
        seeds = PARAM_VALS.get(self.proj.local(self.fi.qualname), {})
        substs = PARAM_SUBST.get(self.proj.local(self.fi.qualname), {})
        args = self.fi.node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.arg in ("self", "cls") and self.fi.cls is not None:
                self.env[a.arg] = O(f"{self.mod.name}.{self.fi.cls}")
                continue
            if a.arg in seeds:
                self.env[a.arg] = seeds[a.arg]
                continue
            val = self._class_from_annotation(a.annotation)
            if val is not None and a.arg in substs:
                val = _apply_subst(val, tuple(sorted(substs[a.arg].items())))
            self.env[a.arg] = val

    def _class_from_annotation(self,
                               ann: Optional[ast.expr]) -> Optional[_Val]:
        for tok in annotation_tokens(ann):
            if tok in _TYPING_TOKENS:
                continue
            ci = self.proj.resolve_class(self.mod, tok)
            if ci is not None:
                return O(ci.qualname)
        return None

    # ---------------------------------------------------------------- names

    def _name(self, name: str) -> Optional[_Val]:
        if name in self.env:
            val = self.env[name]
            if val is not None:
                return val
        if len(name) == 1 and name in AXES:
            # bare or assigned-unknown axis letter is the axis extent
            return X(name)
        return None

    # ------------------------------------------------------------ inference

    def infer(self, node: ast.expr) -> Optional[_Val]:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return None
            if isinstance(node.value, int) and node.value >= 0:
                return _Val("axis", atom=str(node.value))
            return None
        if isinstance(node, ast.Name):
            return self._name(node.id)
        if isinstance(node, ast.Attribute):
            return self._attr(node)
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.UnaryOp):
            val = self.infer(node.operand)
            return val if val is not None and val.kind == "array" else None
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Compare):
            vals = [self.infer(node.left)]
            vals += [self.infer(c) for c in node.comparators]
            out = vals[0]
            for v in vals[1:]:
                out = self._ew(out, v, node, "comparison")
            return out
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self.infer(v)
            return None
        if isinstance(node, ast.IfExp):
            self.infer(node.test)
            a, b = self.infer(node.body), self.infer(node.orelse)
            return a if a == b else None
        if isinstance(node, (ast.Tuple, ast.List)):
            return T(*(self.infer(e) for e in node.elts))
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                             ast.DictComp)):
            return None
        if isinstance(node, ast.Starred):
            self.infer(node.value)
            return None
        if isinstance(node, ast.Lambda):
            return None
        if isinstance(node, ast.JoinedStr):
            return None
        return None

    # ----------------------------------------------------------- attributes

    def _attr(self, node: ast.Attribute) -> Optional[_Val]:
        base = self.infer(node.value)
        if base is None:
            return None
        if base.kind == "obj":
            return self._obj_attr(base, node.attr)
        if base.kind == "array" and base.shape is not None:
            if node.attr == "T":
                return _Val("array", shape=base.shape[::-1])
            if node.attr == "shape":
                elts = []
                for d in base.shape:
                    elts.append(X(d[0]) if len(d) == 1 else None)
                return T(*elts)
            if node.attr == "ndim":
                return _Val("axis", atom=str(len(base.shape)))
        return None

    def _obj_attr(self, base: _Val, attr: str) -> Optional[_Val]:
        qual = f"{base.cls}.{attr}"
        key = self.proj.local(qual)
        if key in ATTR_VALS:
            return _apply_subst(ATTR_VALS[key], base.subst)
        if key in CLASS_SCALARS:
            return _apply_subst(X(CLASS_SCALARS[key]), base.subst)
        fields = self.eng.class_fields(base.cls)
        if attr in fields:
            info = fields[attr]
            if info.shape is not None:
                return _apply_subst(_Val("array", shape=info.shape),
                                    base.subst)
            if info.cls is not None:
                sub = FIELD_SUBST.get(key, {})
                val = O(info.cls, sub)
                return _apply_subst(val, base.subst)
            return None
        ci = self.proj.classes.get(base.cls)
        if ci is not None:
            fi = ci.methods.get(attr)
            if fi is not None and fi.is_property:
                val = self.eng.callee_value(fi, (base,))
                return _apply_subst(val, base.subst)
        return None

    # ----------------------------------------------------------- subscripts

    def _subscript(self, node: ast.Subscript) -> Optional[_Val]:
        base = self.infer(node.value)
        idx = node.slice
        if isinstance(idx, ast.Index):  # pragma: no cover - py<3.9 only
            idx = idx.value
        items = list(idx.elts) if isinstance(idx, ast.Tuple) else [idx]
        if base is None:
            for it in items:
                if not isinstance(it, ast.Slice):
                    self.infer(it)
            return None
        if base.kind == "tuple":
            if len(items) == 1 and isinstance(items[0], ast.Constant) and \
                    isinstance(items[0].value, int) and \
                    0 <= items[0].value < len(base.elts):
                return base.elts[items[0].value]
            return None
        if base.kind != "array" or base.shape is None:
            return None

        shape = base.shape
        vals: List[Optional[_Val]] = []
        for it in items:
            if isinstance(it, ast.Slice):
                vals.append(_Val("tuple"))          # marker: slice
            elif isinstance(it, ast.Constant) and it.value is None:
                vals.append(_Val("axis", atom="new"))  # marker: newaxis
            else:
                vals.append(self.infer(it))

        adv = [v for v in vals if v is not None and v.kind == "array"]
        if adv:
            # handle only [adv/int..., trailing slices] — no newaxis mix
            consumed = 0
            seen_slice = False
            for it, v in zip(items, vals):
                if isinstance(it, ast.Slice):
                    seen_slice = True
                    continue
                if v is not None and v.atom == "new":
                    return None
                if seen_slice:
                    return None                     # adv after slice: punt
                consumed += 1
            head: Shape = adv[0].shape or (_UNK,)
            for v in adv[1:]:
                merged = self._ew(
                    _Val("array", shape=head), v,
                    node, "advanced index")
                head = merged.shape if merged is not None and \
                    merged.shape is not None else (_UNK,)
            n_sliced = sum(1 for it in items if isinstance(it, ast.Slice))
            if consumed + n_sliced > len(shape):
                return None
            mid = shape[consumed:consumed + n_sliced]
            tail = shape[consumed + n_sliced:]
            return _Val("array", shape=tuple(head) + mid + tail)

        out: List[Dim] = []
        pos = 0
        for it, v in zip(items, vals):
            if isinstance(it, ast.Slice):
                if pos >= len(shape):
                    return None
                out.append(shape[pos])              # slices keep the axis
                pos += 1
            elif v is not None and v.atom == "new":
                out.append(("1",))
            else:
                if pos >= len(shape):
                    return None
                pos += 1                            # int index drops the dim
        out.extend(shape[pos:])
        return _Val("array", shape=tuple(out))

    # ------------------------------------------------------------- elemwise

    def _dim_compat(self, da: Dim, db: Dim) -> bool:
        if da == db or "?" in da or "?" in db:
            return True
        if da == ("1",) or db == ("1",):
            return True
        if _is_lit(da) or _is_lit(db):
            return True                 # literal-vs-named: optimistic
        return False

    @staticmethod
    def _dim_join(da: Dim, db: Dim) -> Dim:
        if da == db:
            return da
        if da == ("1",) or "?" in da or _is_lit(da):
            return db
        if db == ("1",) or "?" in db or _is_lit(db):
            return da
        return _UNK

    def _ew(self, a: Optional[_Val], b: Optional[_Val], node: ast.AST,
            what: str) -> Optional[_Val]:
        """Elementwise combine with broadcast checking."""
        arrs = [v for v in (a, b) if v is not None and v.kind == "array"
                and v.shape is not None]
        if len(arrs) < 2:
            return arrs[0] if arrs else None
        sa, sb = arrs[0].shape, arrs[1].shape
        la, lb = len(sa), len(sb)
        out: List[Dim] = []
        conflict = None
        matched_named = 0
        n = max(la, lb)
        for i in range(n):
            da = sa[la - n + i] if la - n + i >= 0 else ("1",)
            db = sb[lb - n + i] if lb - n + i >= 0 else ("1",)
            if not self._dim_compat(da, db):
                conflict = (da, db)
            elif da == db and _named(da):
                matched_named += 1
            out.append(self._dim_join(da, db))
        if conflict is not None:
            self._flag("broadcast-mismatch",
                       f"incompatible {what} in '{_src(node)}': "
                       f"{_fmt(sa)} vs {_fmt(sb)} (axis "
                       f"{'·'.join(conflict[0])} vs "
                       f"{'·'.join(conflict[1])})", node)
            return _Val("array", shape=tuple(
                d if "?" not in d else _UNK for d in out))
        if la != lb and matched_named == 0 and _named_shape(sa) and \
                _named_shape(sb) and not _has_unknown(sa) and \
                not _has_unknown(sb):
            self._flag("rank-promotion",
                       f"rank-promoting {what} in '{_src(node)}': "
                       f"{_fmt(sa)} meets {_fmt(sb)} with no shared named "
                       f"axis — likely an unintended outer product", node,
                       severity=Severity.WARNING)
        return _Val("array", shape=tuple(out))

    def _matmul(self, a: Optional[_Val], b: Optional[_Val],
                node: ast.BinOp) -> Optional[_Val]:
        if not (a is not None and a.kind == "array" and a.shape and
                b is not None and b.kind == "array" and b.shape):
            return None
        sa, sb = a.shape, b.shape
        ca = sa[-1]
        cb = sb[-2] if len(sb) >= 2 else sb[-1]
        if not self._dim_compat(ca, cb) or (
                _named(ca) and _named(cb) and ca != cb):
            self._flag("broadcast-mismatch",
                       f"matmul contraction mismatch in '{_src(node)}': "
                       f"{_fmt(sa)} @ {_fmt(sb)} contracts "
                       f"{'·'.join(ca)} against {'·'.join(cb)}", node)
        if len(sa) == 1 and len(sb) == 1:
            return None
        if len(sa) == 1:
            return _Val("array", shape=sb[:-2] + sb[-1:])
        if len(sb) == 1:
            return _Val("array", shape=sa[:-1])
        return _Val("array", shape=sa[:-1] + sb[-1:])

    def _binop(self, node: ast.BinOp) -> Optional[_Val]:
        a, b = self.infer(node.left), self.infer(node.right)
        if isinstance(node.op, ast.MatMult):
            return self._matmul(a, b, node)
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                                ast.FloorDiv, ast.Mod, ast.Pow)):
            return self._ew(a, b, node, "elementwise op")
        return None

    # ---------------------------------------------------------- dims of AST

    def _dim_of(self, e: ast.expr) -> Dim:
        """Dim described by a shape-position expression (zeros/reshape/
        tile/minlength arguments)."""
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Mult):
            da, db = self._dim_of(e.left), self._dim_of(e.right)
            if "?" in da or "?" in db:
                return _UNK
            return _dim(*(da + db))
        if isinstance(e, ast.Constant) and isinstance(e.value, int):
            return (str(e.value),) if e.value >= 0 else _UNK
        val = self.infer(e)
        if val is not None and val.kind == "axis" and val.atom is not None \
                and val.atom != "new":
            return (val.atom,)
        return _UNK

    def _shape_of(self, e: ast.expr) -> Shape:
        if isinstance(e, (ast.Tuple, ast.List)):
            return tuple(self._dim_of(x) for x in e.elts)
        return (self._dim_of(e),)

    # ------------------------------------------------------------ reduction

    def _reduce(self, val: Optional[_Val], call: ast.Call,
                axis_pos: int) -> Optional[_Val]:
        axis_expr = None
        if len(call.args) > axis_pos:
            axis_expr = call.args[axis_pos]
        for kw in call.keywords:
            if kw.arg == "axis":
                axis_expr = kw.value
        keepdims = any(kw.arg == "keepdims" and
                       isinstance(kw.value, ast.Constant) and
                       kw.value.value is True for kw in call.keywords)
        if val is None or val.kind != "array" or val.shape is None:
            return None
        shape = val.shape
        if axis_expr is None:
            return None                              # full reduction: scalar
        axes = self._axis_literals(axis_expr)
        if axes is None:
            return None
        rank = len(shape)
        norm = []
        for k in axes:
            if not -rank <= k < rank:
                self._flag("reduce-axis",
                           f"reduction over axis {k} of '{_src(call)}' "
                           f"but the operand has inferred shape "
                           f"{_fmt(shape)}", call)
                return None
            norm.append(k % rank)
        out = [(("1",) if keepdims else None) if i in norm else d
               for i, d in enumerate(shape)]
        kept = tuple(d for d in out if d is not None)
        return _Val("array", shape=kept) if kept else None

    @staticmethod
    def _axis_literals(e: ast.expr) -> Optional[List[int]]:
        def lit(x: ast.expr) -> Optional[int]:
            if isinstance(x, ast.Constant) and isinstance(x.value, int):
                return x.value
            if isinstance(x, ast.UnaryOp) and isinstance(x.op, ast.USub) \
                    and isinstance(x.operand, ast.Constant) and \
                    isinstance(x.operand.value, int):
                return -x.operand.value
            return None
        if isinstance(e, ast.Tuple):
            out = [lit(x) for x in e.elts]
            return None if any(v is None for v in out) else out  # type: ignore[return-value]
        v = lit(e)
        return None if v is None else [v]

    # -------------------------------------------------------------- reshape

    def _check_factor(self, src_shape: Shape, dst_shape: Shape,
                      node: ast.AST, what: str) -> None:
        if _has_unknown(src_shape) or _has_unknown(dst_shape):
            return
        src_atoms = sorted(a for d in src_shape for a in d if a != "1")
        dst_atoms = sorted(a for d in dst_shape for a in d if a != "1")
        if src_atoms == dst_atoms:
            return
        if not (any(a in AXES for a in src_atoms) and
                any(a in AXES for a in dst_atoms)):
            return                       # pure-literal factoring: optimistic
        self._flag("reshape-factor",
                   f"{what} in '{_src(node)}' does not factor: "
                   f"{_fmt(src_shape)} has elements "
                   f"{'·'.join(src_atoms) or '1'} but target "
                   f"{_fmt(dst_shape)} has {'·'.join(dst_atoms) or '1'}",
                   node)

    def _reshape(self, val: Optional[_Val], call: ast.Call,
                 shape_args: List[ast.expr]) -> Optional[_Val]:
        if len(shape_args) == 1 and isinstance(shape_args[0],
                                               (ast.Tuple, ast.List)):
            shape_args = list(shape_args[0].elts)
        if any(isinstance(a, ast.UnaryOp) for a in shape_args):
            return None                                   # reshape(-1, ...)
        if len(shape_args) == 1:
            sv = self.infer(shape_args[0])
            if sv is not None and sv.kind == "tuple":
                # x.reshape(other.shape): dims from the shape tuple
                dst2 = tuple(
                    (e.atom,) if e is not None and e.kind == "axis" and
                    e.atom is not None else _UNK for e in sv.elts)
                if val is not None and val.kind == "array" and \
                        val.shape is not None:
                    self._check_factor(val.shape, dst2, call, "reshape")
                return _Val("array", shape=dst2)
            if not (sv is not None and sv.kind == "axis"):
                return None               # dynamic shape value: rank unknown
        dst = tuple(self._dim_of(a) for a in shape_args)
        if val is not None and val.kind == "array" and val.shape is not None:
            self._check_factor(val.shape, dst, call, "reshape")
        return _Val("array", shape=dst)

    def _flatten(self, val: Optional[_Val]) -> Optional[_Val]:
        if val is None or val.kind != "array" or val.shape is None:
            return None
        atoms = [a for d in val.shape for a in d if a != "1"]
        if any(a == "?" for a in atoms):
            return _Val("array", shape=(_UNK,))
        return _Val("array", shape=(_dim(*atoms) if atoms else ("1",),))

    # ----------------------------------------------------------------- call

    def _np_name(self, func: ast.expr) -> Optional[str]:
        """'np.add.reduceat' -> 'add.reduceat' when the root is numpy."""
        attrs: List[str] = []
        cur = func
        while isinstance(cur, ast.Attribute):
            attrs.append(cur.attr)
            cur = cur.value
        if not (isinstance(cur, ast.Name) and attrs):
            return None
        target = self.proj.resolve_name(self.mod, cur.id)
        if target != "numpy":
            return None
        return ".".join(reversed(attrs))

    def _resolve_class_call(self, func: ast.expr) -> Optional[str]:
        if isinstance(func, ast.Name):
            target = self.proj.resolve_name(self.mod, func.id)
            if target in self.proj.classes:
                return target
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name):
            target = self.proj.resolve_name(self.mod, func.value.id)
            if target is not None and \
                    f"{target}.{func.attr}" in self.proj.classes:
                return f"{target}.{func.attr}"
        return None

    def _call(self, node: ast.Call) -> Optional[_Val]:
        arg_vals = [self.infer(a) for a in node.args]
        kw_vals = {kw.arg: self.infer(kw.value) for kw in node.keywords}
        func = node.func

        npname = self._np_name(func)
        if npname is not None:
            return self._np_call(npname, node, arg_vals, kw_vals)

        # builtins
        if isinstance(func, ast.Name):
            if func.id == "len" and len(arg_vals) == 1:
                v = arg_vals[0]
                if v is not None and v.kind == "array" and v.shape:
                    d = v.shape[0]
                    if len(d) == 1 and d != _UNK:
                        return X(d[0])
                return None
            if func.id in ("float", "int") and arg_vals:
                v = arg_vals[0]
                if v is not None and v.kind == "axis":
                    return v
                return None
            if func.id in self.lambdas:
                return self._inline_lambda(self.lambdas[func.id], node,
                                           arg_vals)

        # constructor of a shape-declared class
        cls_qual = self._resolve_class_call(func)
        if cls_qual is not None:
            self._check_ctor(cls_qual, node, arg_vals, kw_vals)
            return O(cls_qual)

        # method on an inferred receiver
        if isinstance(func, ast.Attribute):
            recv = self.infer(func.value)
            if recv is not None and recv.kind == "array":
                return self._array_method(recv, func.attr, node)
            if recv is not None and recv.kind == "obj":
                ci = self.proj.classes.get(recv.cls)
                mfi = ci.methods.get(func.attr) if ci is not None else None
                if mfi is not None:
                    val = self.eng.callee_value(mfi, (recv, *arg_vals))
                    return _apply_subst(val, recv.subst)

        # resolved project function
        fi = self.proj.resolve_call(self.mod, self.fi.cls, node)
        if fi is not None:
            return self.eng.callee_value(fi, arg_vals)
        return None

    def _inline_lambda(self, lam: ast.Lambda, call: ast.Call,
                       arg_vals: List[Optional[_Val]]) -> Optional[_Val]:
        params = [a.arg for a in lam.args.args]
        saved = {p: self.env.get(p) for p in params}
        for p, v in zip(params, arg_vals):
            self.env[p] = v
        try:
            return self.infer(lam.body)
        finally:
            for p, v in saved.items():
                self.env[p] = v

    def _array_method(self, recv: _Val, name: str,
                      node: ast.Call) -> Optional[_Val]:
        if name in _REDUCE_METHODS:
            return self._reduce(recv, node, axis_pos=0)
        if name in _PASS_METHODS:
            return recv
        if name == "reshape":
            return self._reshape(recv, node, list(node.args))
        if name in ("ravel", "flatten"):
            return self._flatten(recv)
        if name == "squeeze":
            if recv.shape is None:
                return None
            return _Val("array", shape=tuple(
                d for d in recv.shape if d != ("1",)))
        if name == "transpose":
            if recv.shape is None or node.args:
                return None
            return _Val("array", shape=recv.shape[::-1])
        return None

    def _np_call(self, name: str, node: ast.Call,
                 arg_vals: List[Optional[_Val]],
                 kw_vals: Dict[Optional[str], Optional[_Val]]
                 ) -> Optional[_Val]:
        a0 = arg_vals[0] if arg_vals else None
        if name in ("zeros", "ones", "empty", "full") and node.args:
            return _Val("array", shape=self._shape_of(node.args[0]))
        if name in ("zeros_like", "ones_like", "empty_like", "full_like"):
            return a0
        if name == "arange":
            if len(node.args) == 1:
                return _Val("array", shape=(self._dim_of(node.args[0]),))
            return _Val("array", shape=(_UNK,))
        if name in ("asarray", "ascontiguousarray"):
            return a0 if a0 is not None and a0.kind == "array" else None
        if name == "array":
            if a0 is not None and a0.kind == "array":
                return a0
            if node.args and isinstance(node.args[0], (ast.List, ast.Tuple)):
                return _Val("array",
                            shape=((str(len(node.args[0].elts)),),))
            if node.args and isinstance(node.args[0],
                                        (ast.ListComp, ast.GeneratorExp)):
                return _Val("array", shape=(_UNK,))
            return None
        if name == "atleast_2d":
            if a0 is not None and a0.kind == "array" and a0.shape is not None:
                if len(a0.shape) == 1:
                    return _Val("array", shape=(("1",),) + a0.shape)
                return a0
            return None
        if name == "where":
            if len(arg_vals) == 3:
                out = self._ew(arg_vals[0], arg_vals[1], node, "np.where")
                return self._ew(out, arg_vals[2], node, "np.where")
            return None
        if name in _EW_FUNCS:
            out = a0
            for v in arg_vals[1:]:
                out = self._ew(out, v, node, f"np.{name}")
            return out
        if name in _REDUCE_FUNCS:
            return self._reduce(a0, node, axis_pos=1)
        if name in _UNARY_FUNCS:
            return a0 if a0 is not None and a0.kind == "array" else None
        if name == "isin":
            return a0
        if name == "interp":
            return a0
        if name == "bincount":
            return self._bincount(node, arg_vals, kw_vals)
        if name == "tile":
            return self._tile(node, a0)
        if name == "reshape" and len(node.args) >= 2:
            return self._reshape(a0, node, list(node.args[1:]))
        if name in ("ravel", "flatten"):
            return self._flatten(a0)
        if name == "stack":
            return self._stack(node, arg_vals, kw_vals)
        if name == "unique":
            inv = any(kw.arg == "return_inverse" for kw in node.keywords)
            if inv:
                return T(_Val("array", shape=(_UNK,)),
                         a0 if a0 is not None and a0.kind == "array"
                         else _Val("array", shape=(_UNK,)))
            return _Val("array", shape=(_UNK,))
        if name in ("flatnonzero", "searchsorted", "add.reduceat"):
            return _Val("array", shape=(_UNK,))
        if name in ("dot", "matmul"):
            if len(arg_vals) == 2:
                fake = ast.BinOp(left=node.args[0], op=ast.MatMult(),
                                 right=node.args[1])
                ast.copy_location(fake, node)
                return self._matmul(arg_vals[0], arg_vals[1], fake)
            return None
        if name == "argsort":
            return a0
        return None

    def _bincount(self, node: ast.Call, arg_vals: List[Optional[_Val]],
                  kw_vals: Dict[Optional[str], Optional[_Val]]
                  ) -> Optional[_Val]:
        x = arg_vals[0] if arg_vals else None
        w = arg_vals[1] if len(arg_vals) > 1 else kw_vals.get("weights")
        if x is not None and w is not None and x.kind == w.kind == "array" \
                and x.shape is not None and w.shape is not None and \
                len(x.shape) == 1 and len(w.shape) == 1:
            dx, dw = x.shape[0], w.shape[0]
            if "?" not in dx and "?" not in dw and dx != dw and \
                    _named(dx) and _named(dw):
                self._flag("bincount-mismatch",
                           f"np.bincount in '{_src(node)}' pairs x of "
                           f"length {'·'.join(dx)} with weights of length "
                           f"{'·'.join(dw)}", node)
        min_expr = None
        for kw in node.keywords:
            if kw.arg == "minlength":
                min_expr = kw.value
        if min_expr is None and len(node.args) > 2:
            min_expr = node.args[2]
        if min_expr is not None:
            return _Val("array", shape=(self._dim_of(min_expr),))
        return _Val("array", shape=(_UNK,))

    def _tile(self, node: ast.Call, a0: Optional[_Val]) -> Optional[_Val]:
        if len(node.args) < 2 or a0 is None or a0.kind != "array" or \
                a0.shape is None or len(a0.shape) != 1:
            return None
        rep = self._dim_of(node.args[1])
        src = a0.shape[0]
        if "?" in rep or "?" in src:
            return _Val("array", shape=(_UNK,))
        atoms = [a for a in src + rep if a != "1"]
        return _Val("array", shape=(_dim(*atoms) if atoms else ("1",),))

    def _stack(self, node: ast.Call, arg_vals: List[Optional[_Val]],
               kw_vals: Dict[Optional[str], Optional[_Val]]
               ) -> Optional[_Val]:
        if not (node.args and isinstance(node.args[0],
                                         (ast.List, ast.Tuple))):
            return None
        elts = [self.infer(e) for e in node.args[0].elts]
        shapes = {v.shape for v in elts
                  if v is not None and v.kind == "array"}
        if len(shapes) != 1 or len(elts) != len(
                [v for v in elts if v is not None and v.kind == "array"]):
            return None
        base = next(iter(shapes))
        if base is None:
            return None
        axis = 0
        for kw in node.keywords:
            if kw.arg == "axis" and isinstance(kw.value, ast.Constant) and \
                    isinstance(kw.value.value, int):
                axis = kw.value.value
        if len(node.args) > 1 and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, int):
            axis = node.args[1].value
        if not 0 <= axis <= len(base):
            return None
        new = (str(len(node.args[0].elts)),)
        return _Val("array", shape=base[:axis] + (new,) + base[axis:])

    # ---------------------------------------------------------- constructor

    def _check_ctor(self, cls_qual: str, node: ast.Call,
                    arg_vals: List[Optional[_Val]],
                    kw_vals: Dict[Optional[str], Optional[_Val]]) -> None:
        fields = self.eng.class_fields(cls_qual)
        if not any(f.shape is not None for f in fields.values()):
            return
        order = self.eng.field_order(cls_qual)
        pairs: List[Tuple[str, ast.expr, Optional[_Val]]] = []
        for i, (arg, val) in enumerate(zip(node.args, arg_vals)):
            if isinstance(arg, ast.Starred):
                break
            if i < len(order):
                pairs.append((order[i], arg, val))
        for kw in node.keywords:
            if kw.arg is not None:
                pairs.append((kw.arg, kw.value, kw_vals.get(kw.arg)))
        cls_name = cls_qual.rsplit(".", 1)[-1]
        for fname, arg, val in pairs:
            info = fields.get(fname)
            if info is None or info.shape is None or val is None or \
                    val.kind != "array" or val.shape is None:
                continue
            decl = info.shape
            got = val.shape
            if len(got) != len(decl):
                self._flag("ctor-shape",
                           f"'{cls_name}.{fname}' is declared {_fmt(decl)} "
                           f"but argument '{_src(arg)}' has inferred rank-"
                           f"{len(got)} shape {_fmt(got)}", arg)
                continue
            for d, g in zip(decl, got):
                if d == _UNK or "?" in g or d == g:
                    continue
                if _is_lit(g):
                    n = int(g[0]) if len(g) == 1 else -1
                    axis = d[0] if len(d) == 1 and d[0] in AXES else None
                    if axis is None:
                        continue
                    pinned = self.pins.get(axis)
                    if pinned == n or (pinned is None and n == 1):
                        continue
                    if pinned is not None:
                        self._flag(
                            "ctor-shape",
                            f"'{cls_name}.{fname}' is declared {_fmt(decl)} "
                            f"but argument '{_src(arg)}' pins axis {axis} "
                            f"to {n} where the dominating guard pins it to "
                            f"{pinned}", arg)
                    else:
                        self._flag(
                            "ctor-shape",
                            f"'{cls_name}.{fname}' is declared {_fmt(decl)} "
                            f"but argument '{_src(arg)}' hard-codes dim "
                            f"{n} for axis {axis} ({AXES[axis]}) without a "
                            f"dominating '{axis} == {n}' guard", arg)
                    break
                if _named(d) and _named(g) and d != g:
                    self._flag(
                        "ctor-shape",
                        f"'{cls_name}.{fname}' is declared {_fmt(decl)} "
                        f"but argument '{_src(arg)}' has inferred shape "
                        f"{_fmt(got)}", arg)
                    break

    # ----------------------------------------------------------- statements

    def _guard_pins(self, test: ast.expr) -> Dict[str, int]:
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1 and
                isinstance(test.ops[0], ast.Eq)):
            return {}
        left, right = test.left, test.comparators[0]
        if isinstance(left, ast.Constant):
            left, right = right, left
        if not (isinstance(right, ast.Constant) and
                isinstance(right.value, int)):
            return {}
        val = self.infer(left)
        if val is not None and val.kind == "axis" and val.atom in AXES:
            return {val.atom: right.value}
        return {}

    def _bind(self, target: ast.expr, val: Optional[_Val],
              value_node: Optional[ast.expr]) -> None:
        if isinstance(target, ast.Name):
            if isinstance(value_node, ast.Lambda):
                self.lambdas[target.id] = value_node
                return
            self.env[target.id] = val
            return
        if isinstance(target, ast.Tuple):
            if val is not None and val.kind == "tuple" and \
                    len(val.elts) == len(target.elts):
                for t, v in zip(target.elts, val.elts):
                    self._bind(t, v, None)
            else:
                for t in target.elts:
                    self._bind(t, None, None)
            return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            self.infer(target)            # runs index checks on the store

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            val = self.infer(stmt.value)
            for t in stmt.targets:
                self._bind(t, val, stmt.value)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.infer(stmt.value), stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            tval = self.infer(stmt.target)
            vval = self.infer(stmt.value)
            if not isinstance(stmt.op, ast.MatMult):
                self._ew(tval, vval, stmt, "augmented assignment")
        elif isinstance(stmt, ast.Return):
            if stmt.value is None:
                self.returns.append(None)
            else:
                val = self.infer(stmt.value)
                self.returns.append(val)
                self._check_return(val, stmt)
        elif isinstance(stmt, ast.Expr):
            self.infer(stmt.value)
        elif isinstance(stmt, ast.If):
            self.infer(stmt.test)
            pins = self._guard_pins(stmt.test)
            if pins:
                saved = dict(self.pins)
                self.pins.update(pins)
                for s in stmt.body:
                    self._stmt(s)
                self.pins = saved
            else:
                for s in stmt.body:
                    self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, ast.For):
            self.infer(stmt.iter)
            self._bind(stmt.target, None, None)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, ast.While):
            self.infer(stmt.test)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self.infer(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, None, None)
            for s in stmt.body:
                self._stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in stmt.body + stmt.orelse + stmt.finalbody:
                self._stmt(s)
            for h in stmt.handlers:
                for s in h.body:
                    self._stmt(s)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass                          # nested scopes: their own pass
        elif isinstance(stmt, (ast.Assert, ast.Raise)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.infer(child)

    def _check_return(self, val: Optional[_Val], stmt: ast.Return) -> None:
        decl = self.eng.def_shape(self.fi)
        if decl is None or val is None or val.kind != "array" or \
                val.shape is None:
            return
        got = val.shape
        if len(got) != len(decl):
            if not _has_unknown(got) and not _has_unknown(decl):
                self._flag("return-shape",
                           f"declared return shape {_fmt(decl)} but "
                           f"'{_src(stmt.value)}' has inferred shape "
                           f"{_fmt(got)}", stmt,
                           severity=Severity.WARNING)
            return
        for d, g in zip(decl, got):
            if _named(d) and _named(g) and "?" not in d and "?" not in g \
                    and d != g:
                self._flag("return-shape",
                           f"declared return shape {_fmt(decl)} but "
                           f"'{_src(stmt.value)}' has inferred shape "
                           f"{_fmt(got)}", stmt,
                           severity=Severity.WARNING)
                return

    # ------------------------------------------------------------------ run

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self._stmt(stmt)

    def return_summary(self) -> Optional[_Val]:
        vals = [v for v in self.returns if v is not None]
        if vals and all(v == vals[0] for v in vals) and \
                len(vals) == len(self.returns):
            return vals[0]
        # all non-None and same class obj across branches still informative
        if vals and all(v.kind == "obj" and v.cls == vals[0].cls
                        for v in vals):
            return vals[0]
        return None


def _named_shape(shape: Shape) -> bool:
    return any(_named(d) for d in shape)


def _has_unknown(shape: Shape) -> bool:
    return any("?" in d for d in shape)


def check(proj: Project,
          modules: Optional[Sequence[str]] = None) -> List[Finding]:
    if modules is None:
        modules = proj.quals(DEFAULT_MODULES)
    eng = _Engine(proj)
    eng.summaries = proj.fixpoint(eng.transfer, bottom=None, max_rounds=6)
    out: List[Finding] = []
    for modname in modules:
        mod = proj.modules.get(modname)
        if mod is None:
            continue
        for fi in proj.iter_functions(modname):
            eng.collect(fi, out)
    seen, uniq = set(), []
    for f in out:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            uniq.append(f)
    return uniq
