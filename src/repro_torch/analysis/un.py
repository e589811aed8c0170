"""UN — unit/dimension analysis over the energy-pricing algebra.

Intraprocedural, name-convention driven (see `units.py`):

* names carry units via suffix (``read_pj``, ``capacity_kb``,
  ``standby_w``) or explicit declaration (`units.DECLARED`);
* literal multiplications rescale units (``* 1e-12`` turns pJ into J,
  ``* 1024 * 8`` turns kB into bits);
* additions/``np.maximum``/``np.where`` demand compatible operands;
* assignments and returns to united names demand a matching value unit.

Unknown values propagate *optimistically*: ``known_unit * unknown``
keeps the known unit. This trades a little soundness for a lot of
coverage — the alternative (unknown poisons everything) silences the
checker on real numpy code, where masks and device-column lookups are
everywhere. Misassigned optimism shows up as a finding and gets either
fixed or baselined with a justification.
"""
from __future__ import annotations

import ast
import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import FuncInfo, ModuleInfo, Project
from repro_torch.analysis.units import (DECLARED, DIMENSIONLESS, Unit, parse_name,
                                  parse_spec)

#: modules scanned by default (energy algebra + its constant tables)
# module paths relative to the analysed package (``Project.qual``)
DEFAULT_MODULES = (
    "core.energy",
    "core.nvm",
    "core.columns",
    "core.schedule",
    "core.area",
    "core.roofline",
    "core.devices",
    "core.dataflow",
)

SCALE_TOLERANCE = 100.0

# numpy / builtin callables that pass their first argument's unit through
_PASSTHROUGH_FUNCS = {
    "abs", "asarray", "array", "ascontiguousarray", "copy", "ravel",
    "float", "int", "ceil", "floor", "sum", "cumsum", "round", "squeeze",
    "atleast_1d", "nan_to_num", "sorted",
}
# callables whose arguments must unify (and whose result is the unified unit)
_UNIFY_FUNCS = {"maximum", "minimum", "fmax", "fmin", "max", "min",
                "where", "clip", "select", "interp"}
# methods that pass the receiver's unit through
_PASSTHROUGH_METHODS = {
    "sum", "max", "min", "mean", "copy", "astype", "reshape", "ravel",
    "item", "squeeze", "clip", "cumsum", "round", "flatten", "tolist",
}
# calls that never carry units (predicates, index math, constructors...)
_UNITLESS_FUNCS = {"len", "range", "enumerate", "bool", "isinstance",
                   "argsort", "argmin", "argmax", "searchsorted", "sign",
                   "isnan", "isfinite", "zeros", "ones", "arange"}


@dataclass
class _UVal:
    """Inferred unit of an expression."""
    unit: Optional[Unit]        # None = unknown
    is_lit: bool = False        # numeric literal: unit-neutral in add/unify
    is_zero: bool = False       # literal zero: neutral everywhere


_UNKNOWN = _UVal(None)
_NEUTRAL = _UVal(DIMENSIONLESS, is_lit=True)


def _lit(value) -> _UVal:
    try:
        v = abs(float(value))
    except (TypeError, ValueError):
        return _UNKNOWN
    if v == 0:
        return _UVal(DIMENSIONLESS, is_lit=True, is_zero=True)
    # literal c behaves as a dimensionless unit of scale 1/c: multiplying
    # a pJ value by 1e-12 then lands exactly on scale 1 == joules.
    return _UVal(Unit(DIMENSIONLESS.dims, 1.0 / v), is_lit=True)


def _known(uv: _UVal) -> bool:
    return uv.unit is not None and not uv.is_lit


def _src(node: ast.expr, limit: int = 48) -> str:
    """Reformat-stable snippet of an expression (ast.unparse normalizes
    whitespace, so fingerprints survive reflowing)."""
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        text = "<expr>"
    return text if len(text) <= limit else text[:limit - 3] + "..."


class _FunctionChecker(ast.NodeVisitor):
    def __init__(self, proj: Project, mod: ModuleInfo, fi: FuncInfo,
                 declared: Dict[str, str], out: List[Finding]):
        self.proj = proj
        self.mod = mod
        self.fi = fi
        self.declared = declared
        self.out = out
        self.env: Dict[str, Optional[Unit]] = {}

    # ------------------------------------------------------------ reporting

    def _flag(self, rule: str, message: str, node: ast.AST,
              severity: Severity = Severity.ERROR) -> None:
        self.out.append(Finding(
            checker="UN", rule=rule, severity=severity,
            path=self.proj.rel(self.mod),
            symbol=self.fi.qualname.removeprefix(self.mod.name + "."),
            message=message, line=getattr(node, "lineno", 0)))

    # ----------------------------------------------------------- name units

    def _declared_unit(self, qualname: str) -> Optional[Unit]:
        spec = self.declared.get(qualname)
        return parse_spec(spec) if spec is not None else None

    def _name_unit(self, name: str) -> Optional[Unit]:
        u = self._declared_unit(f"{self.mod.name}.{name}")
        return u if u is not None else parse_name(name)

    def _var(self, name: str) -> _UVal:
        if name in self.env:
            u = self.env[name]
            if u is not None:
                return _UVal(u)
        u = self._name_unit(name)
        return _UVal(u) if u is not None else _UNKNOWN

    # ------------------------------------------------------------ inference

    def infer(self, node: ast.expr) -> _UVal:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or not isinstance(
                    node.value, (int, float)):
                return _UNKNOWN
            return _lit(node.value)
        if isinstance(node, ast.Name):
            return self._var(node.id)
        if isinstance(node, ast.Attribute):
            return self._attr(node)
        if isinstance(node, ast.Subscript):
            return self.infer(node.value)
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.IfExp):
            self.infer(node.test)
            return self._unify([self.infer(node.body),
                                self.infer(node.orelse)], node, "if/else")
        if isinstance(node, ast.Compare):
            self.infer(node.left)
            for c in node.comparators:
                self.infer(c)
            return _UNKNOWN
        if isinstance(node, ast.BoolOp):
            vals = [self.infer(v) for v in node.values]
            for v in vals:
                if _known(v):
                    return v
            return _UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                self.infer(elt)
            return _UNKNOWN
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            # comprehension: unit of the element expression (loop vars are
            # unknown, which is fine for the optimistic rules)
            return self.infer(node.elt)
        if isinstance(node, ast.Starred):
            return self.infer(node.value)
        return _UNKNOWN

    def _attr(self, node: ast.Attribute) -> _UVal:
        if isinstance(node.value, ast.Name):
            target = self.proj.resolve_name(self.mod, node.value.id) or \
                self.mod.imports.get(node.value.id)
            if target is not None:
                u = self._declared_unit(f"{target}.{node.attr}")
                if u is not None:
                    return _UVal(u)
        u = parse_name(node.attr)
        return _UVal(u) if u is not None else _UNKNOWN

    def _binop(self, node: ast.BinOp) -> _UVal:
        left, right = self.infer(node.left), self.infer(node.right)
        op = node.op
        if isinstance(op, (ast.Mult, ast.Div, ast.FloorDiv)):
            if left.is_zero:
                return left
            if right.is_zero:
                return right if isinstance(op, ast.Mult) else _UNKNOWN
            if left.unit is None or right.unit is None:
                # optimistic: unknown * united keeps the known unit —
                # but folding a literal into an unknown would fabricate
                # a scale, so unknown * literal stays unknown.
                known = left if left.unit is not None else right
                if _known(known):
                    return known
                return _UNKNOWN
            u = (left.unit * right.unit if isinstance(op, ast.Mult)
                 else left.unit / right.unit)
            lit = left.is_lit and right.is_lit
            return _UVal(u, is_lit=lit)
        if isinstance(op, (ast.Add, ast.Sub)):
            self._check_add(left, right, node)
            for v in (left, right):
                if _known(v):
                    return v
            if left.is_lit or right.is_lit:
                return left if left.is_lit else right
            return _UNKNOWN
        if isinstance(op, ast.Pow):
            if _known(left) and right.is_lit and right.unit is not None \
                    and not right.is_zero:
                with contextlib.suppress(OverflowError, ZeroDivisionError):
                    exp = 1.0 / right.unit.scale   # recover literal value
                    if exp == int(exp):
                        k = int(exp)
                        dims = tuple(d * k for d in left.unit.dims)
                        return _UVal(Unit(dims, left.unit.scale ** k))
            return _UNKNOWN
        if isinstance(op, ast.Mod):
            return left
        return _UNKNOWN

    def _check_add(self, left: _UVal, right: _UVal, node: ast.BinOp) -> None:
        if left.is_zero or right.is_zero:
            return
        if left.is_lit or right.is_lit:
            return                       # `1.0 - duty`, `x + 7` idioms
        if not (_known(left) and _known(right)):
            return
        if left.unit.compatible(right.unit, SCALE_TOLERANCE):
            return
        opname = "+" if isinstance(node.op, ast.Add) else "-"
        self._flag("add-mismatch",
                   f"incompatible units in '{_src(node.left)} {opname} "
                   f"{_src(node.right)}': [{left.unit}] vs [{right.unit}]",
                   node)

    def _unify(self, vals: Sequence[_UVal], node: ast.AST,
               what: str) -> _UVal:
        known = [v for v in vals if _known(v)]
        for a, b in zip(known, known[1:]):
            if not a.unit.compatible(b.unit, SCALE_TOLERANCE):
                self._flag("unify-mismatch",
                           f"incompatible units unified in {what}: "
                           f"[{a.unit}] vs [{b.unit}]", node)
                break
        if known:
            return known[0]
        for v in vals:
            if v.is_lit and not v.is_zero:
                return v
        return _UNKNOWN

    def _call(self, node: ast.Call) -> _UVal:
        args = [self.infer(a) for a in node.args]
        for kw in node.keywords:
            self.infer(kw.value)
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")

        if name in _UNITLESS_FUNCS:
            return _UNKNOWN
        if name in _UNIFY_FUNCS:
            # np.where(cond, a, b): the condition carries no unit
            uvals = args[1:] if name in ("where", "select") and \
                len(args) > 1 else args
            return self._unify(uvals, node, f"{name}()")
        if name == "full" and len(args) >= 2:
            return args[1]
        if name in _PASSTHROUGH_FUNCS and args:
            return args[0]

        # method on a united receiver: table.mem_pj.sum(axis=1)
        if isinstance(fn, ast.Attribute) and name in _PASSTHROUGH_METHODS:
            recv = self.infer(fn.value)
            if _known(recv):
                return recv

        # resolved project function / declared qualname / name suffix
        fi = self.proj.resolve_call(self.mod, self.fi.cls, node)
        if fi is not None:
            u = self._declared_unit(fi.qualname)
            if u is not None:
                return _UVal(u)
            u = parse_name(fi.node.name)
            if u is not None:
                return _UVal(u)
            return _UNKNOWN
        u = parse_name(name) if name else None
        return _UVal(u) if u is not None else _UNKNOWN

    # ----------------------------------------------------------- statements

    def _check_target(self, target: ast.expr, value_uv: _UVal,
                      value_node: ast.expr) -> None:
        tname = None
        if isinstance(target, ast.Name):
            tname = target.id
        elif isinstance(target, ast.Attribute):
            tname = target.attr
        if tname is None:
            return
        nu = self._name_unit(tname)
        if nu is not None and _known(value_uv) and \
                not nu.compatible(value_uv.unit, SCALE_TOLERANCE):
            self._flag("assign-mismatch",
                       f"'{tname}' implies [{nu}] but is assigned "
                       f"'{_src(value_node)}' of [{value_uv.unit}]",
                       target)
        if isinstance(target, ast.Name):
            self.env[target.id] = value_uv.unit if _known(value_uv) else (
                nu if nu is not None else None)

    def visit_Assign(self, node: ast.Assign) -> None:
        uv = self.infer(node.value)
        for target in node.targets:
            if isinstance(target, ast.Tuple) and isinstance(
                    node.value, ast.Tuple) and \
                    len(target.elts) == len(node.value.elts):
                for t, v in zip(target.elts, node.value.elts):
                    self._check_target(t, self.infer(v), v)
            elif isinstance(target, ast.Tuple):
                # tuple-unpack of a call: every element inherits the
                # callee's (single) declared unit — good enough for
                # `er, ew = unit_energy_pj_per_bit(plan)`
                for t in target.elts:
                    self._check_target(t, uv, node.value)
            else:
                self._check_target(target, uv, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_target(node.target, self.infer(node.value),
                               node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        uv = self.infer(node.value)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            tgt = self.infer(node.target)
            fake = ast.BinOp(left=node.target, op=node.op, right=node.value)
            ast.copy_location(fake, node)
            self._check_add(tgt, uv, fake)

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is None:
            return
        uv = self.infer(node.value)
        fu = self._declared_unit(self.fi.qualname) or \
            parse_name(self.fi.node.name)
        if fu is not None and _known(uv) and \
                not fu.compatible(uv.unit, SCALE_TOLERANCE):
            self._flag("return-mismatch",
                       f"returns '{_src(node.value)}' of [{uv.unit}] but "
                       f"the function name implies [{fu}]", node)

    def visit_Expr(self, node: ast.Expr) -> None:
        self.infer(node.value)

    def visit_If(self, node: ast.If) -> None:
        self.infer(node.test)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_For(self, node: ast.For) -> None:
        # loop targets are unknown; still scan the body
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self.infer(node.test)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_With(self, node: ast.With) -> None:
        for stmt in node.body:
            self.visit(stmt)

    def visit_Try(self, node: ast.Try) -> None:
        for stmt in node.body + node.orelse + node.finalbody:
            self.visit(stmt)
        for h in node.handlers:
            for stmt in h.body:
                self.visit(stmt)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass                              # nested defs get their own pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self.visit(stmt)


def _check_module_constants(proj: Project, mod: ModuleInfo,
                            declared: Dict[str, str],
                            out: List[Finding]) -> None:
    """Module-level `NAME_PJ = expr` assignments get the same treatment."""
    pseudo = ast.FunctionDef(
        name="<module>", args=ast.arguments(
            posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[],
            defaults=[]),
        body=[s for s in mod.tree.body
              if isinstance(s, (ast.Assign, ast.AnnAssign))],
        decorator_list=[], returns=None)
    fi = FuncInfo(f"{mod.name}.<module>", mod.name, None, pseudo)
    _FunctionChecker(proj, mod, fi, declared, out).run()


def check(proj: Project, modules: Optional[Sequence[str]] = None,
          declared: Optional[Dict[str, str]] = None) -> List[Finding]:
    if modules is None:
        modules = proj.quals(DEFAULT_MODULES)
    decl = {proj.qual(k): v for k, v in DECLARED.items()}
    if declared:
        decl.update(declared)
    out: List[Finding] = []
    for modname in modules:
        mod = proj.modules.get(modname)
        if mod is None:
            continue
        _check_module_constants(proj, mod, decl, out)
        for fi in proj.iter_functions(modname):
            checker = _FunctionChecker(proj, mod, fi, decl, out)
            checker.run()
    # dedupe identical fingerprints (same add repeated in two branches)
    seen, uniq = set(), []
    for f in out:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            uniq.append(f)
    return uniq
