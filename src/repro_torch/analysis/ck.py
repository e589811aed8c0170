"""CK — cache-key soundness for memoizing evaluators.

Finds cache sites (``key in self._dict`` membership tests, plus call
sites of LRU helpers like ``Evaluator._cached_plan``), computes the
transitive set of DesignPoint/SystemPoint attributes the cached
computation reads, and flags attributes not folded into the cache key.

Coverage uses the *derived-key assumption*: a key element covers every
point attribute read while computing it (``w_kb, a_kb = self._sizing(
point)`` covers the suite/precision attrs that sizing consumed). This is
sound exactly when the cached computation consumes those attributes
through the same derived values — which is the design contract of the
Evaluator's layered caches; violations of the contract surface as
findings on the attrs the computation reads *directly*.

Branch-scoped keys are supported: when a method assigns ``key`` in both
arms of an ``if``, each assignment is checked against the reads of its
own arm (plus the shared prefix/suffix), so `base_arch`'s two key shapes
are analyzed independently.

Shared-dict collision check: two cache sites storing into the same dict
with key shapes that cannot be proven disjoint (same arity, no position
with definitely-different literals/types) are flagged — unless both keys
are bare point objects, which are definitionally consistent.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import (FuncInfo, ModuleInfo, Project,
                                    annotation_tokens, call_arg_map)

# module paths relative to the analysed package (``Project.qual``)
DEFAULT_MODULES = ("core.experiment",)
#: terminal class names treated as cacheable point axes
POINT_CLASSES = ("DesignPoint", "SystemPoint")
#: name heuristics for un-annotated code (this repo's house style)
POINT_NAMES = frozenset({"point", "p", "dp", "sp", "spoint"})
COLLECTION_NAMES = frozenset({"points", "pts", "spoints", "dps"})

_FULL = "*"          # marker: reads/covers the entire point


@dataclass
class _Site:
    method: FuncInfo            # method containing the lookup
    dict_attr: str              # "_archs"
    key_node: ast.expr          # the key expression checked/stored
    variant: int = 0            # branch-variant index within the method
    excluded: FrozenSet[int] = frozenset()   # stmt ids outside this branch
    build_exprs: Tuple[ast.expr, ...] = ()   # helper-call computation args


@dataclass
class _ReadCtx:
    mod: ModuleInfo
    cls: Optional[str]
    func: ast.FunctionDef
    point_vars: Dict[str, str]          # var name -> point class or "coll"
    excluded: FrozenSet[int] = frozenset()
    locals_: Dict[str, List[ast.expr]] = field(default_factory=dict)


class _Analyzer:
    def __init__(self, proj: Project, point_classes: Sequence[str],
                 point_names: FrozenSet[str],
                 collection_names: FrozenSet[str]):
        self.proj = proj
        self.point_classes = tuple(point_classes)
        self.point_names = point_names
        self.collection_names = collection_names
        self._memo: Dict[Tuple, Set[str]] = {}
        self._active: Set[Tuple] = set()

    # --------------------------------------------------- point-likeness

    def _param_point_class(self, fn: ast.FunctionDef,
                           name: str) -> Optional[str]:
        for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
            if a.arg != name:
                continue
            toks = annotation_tokens(a.annotation)
            for pc in self.point_classes:
                if pc in toks:
                    coll = any(t in ("Sequence", "Iterable", "List", "list",
                                     "Tuple", "tuple", "Set", "frozenset")
                               for t in toks)
                    return "coll" if coll else pc
        return None

    def _point_vars(self, fn: ast.FunctionDef) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
            pc = self._param_point_class(fn, a.arg)
            if pc:
                out[a.arg] = pc
            elif a.arg in self.point_names:
                out[a.arg] = self.point_classes[0]
            elif a.arg in self.collection_names:
                out[a.arg] = "coll"
        # loop vars and comprehension vars over point-ish names
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.For):
                targets.append(node.target)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.SetComp, ast.DictComp)):
                targets.extend(g.target for g in node.generators)
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        if n.id in self.point_names:
                            out.setdefault(n.id, self.point_classes[0])
                        elif n.id in self.collection_names:
                            out.setdefault(n.id, "coll")
        return out

    # ----------------------------------------------------- read collection

    def _locals_map(self, fn: ast.FunctionDef) -> Dict[str, List[ast.expr]]:
        out: Dict[str, List[ast.expr]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.setdefault(tgt.id, []).append(node.value)
                    elif isinstance(tgt, ast.Tuple) and all(
                            isinstance(e, ast.Name) for e in tgt.elts):
                        for e in tgt.elts:
                            out.setdefault(e.id, []).append(node.value)
        return out

    def _point_method_reads(self, cls_token: str, method: str) -> Set[str]:
        """Attrs read by e.g. DesignPoint.workload_key(), transitively."""
        for qual, ci in self.proj.classes.items():
            if qual.rsplit(".", 1)[-1] != cls_token:
                continue
            fi = ci.methods.get(method)
            if fi is None:
                continue
            mod = self.proj.modules[ci.module]
            ctx = _ReadCtx(mod, ci.node.name, fi.node,
                           {"self": cls_token},
                           locals_=self._locals_map(fi.node))
            return self.func_reads(ctx)
        return {method}        # unknown method: treat its name as a read

    def func_reads(self, ctx: _ReadCtx) -> Set[str]:
        key = (ctx.mod.name, ctx.func.name,
               frozenset(ctx.point_vars.items()), ctx.excluded)
        if key in self._memo:
            return self._memo[key]
        if key in self._active:
            return set()
        self._active.add(key)
        reads: Set[str] = set()
        for stmt in ctx.func.body:
            self._walk(stmt, ctx, reads)
        self._active.discard(key)
        if not ctx.excluded:
            self._memo[key] = reads
        return reads

    def expr_reads(self, expr: ast.expr, ctx: _ReadCtx,
                   _depth: int = 0) -> Set[str]:
        reads: Set[str] = set()
        self._walk(expr, ctx, reads, trace_locals=True, _depth=_depth)
        return reads

    def _walk(self, node: ast.AST, ctx: _ReadCtx, reads: Set[str],
              trace_locals: bool = False, _depth: int = 0) -> None:
        if _depth > 12:
            return
        if isinstance(node, ast.If) and ctx.excluded:
            self._walk(node.test, ctx, reads, trace_locals, _depth)
            for branch in (node.body, node.orelse):
                if branch and id(branch[0]) in ctx.excluded:
                    continue
                for stmt in branch:
                    self._walk(stmt, ctx, reads, trace_locals, _depth)
            return
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id in ctx.point_vars:
                reads.add(node.attr)
                return
            self._walk(base, ctx, reads, trace_locals, _depth)
            return
        if isinstance(node, ast.Call):
            self._call_reads(node, ctx, reads, trace_locals, _depth)
            return
        if isinstance(node, ast.Name):
            if node.id in ctx.point_vars:
                reads.add(_FULL)
            elif trace_locals and node.id in ctx.locals_:
                for val in ctx.locals_[node.id]:
                    self._walk(val, ctx, reads, True, _depth + 1)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child, ctx, reads, trace_locals, _depth)

    def _call_reads(self, call: ast.Call, ctx: _ReadCtx, reads: Set[str],
                    trace_locals: bool, _depth: int) -> None:
        fn = call.func
        # point.method(...) -> expand the point class's method
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and fn.value.id in ctx.point_vars:
            cls_token = ctx.point_vars[fn.value.id]
            if cls_token == "coll":
                reads.add(_FULL)
            else:
                reads |= self._point_method_reads(cls_token, fn.attr)
            for a in call.args:
                self._walk(a, ctx, reads, trace_locals, _depth)
            for k in call.keywords:
                self._walk(k.value, ctx, reads, trace_locals, _depth)
            return
        # resolved project call: map point args onto callee params
        fi = self.proj.resolve_call(ctx.mod, ctx.cls, call)
        if fi is not None and _depth <= 8:
            argmap = call_arg_map(call, fi.node, skip_self=fi.cls is not None)
            callee_points: Dict[str, str] = {}
            for pname, aexpr in argmap.items():
                if isinstance(aexpr, ast.Name) and \
                        aexpr.id in ctx.point_vars:
                    callee_points[pname] = ctx.point_vars[aexpr.id]
            callee_mod = self.proj.modules[fi.module]
            sub = _ReadCtx(callee_mod, fi.cls, fi.node, callee_points)
            sub.point_vars.update(self._point_vars(fi.node))
            sub.locals_ = self._locals_map(fi.node)
            # reads of point params inside the callee count as our reads
            reads |= {r for r in self.func_reads(sub)}
        self._walk(fn, ctx, reads, trace_locals, _depth)
        mapped = fi is not None
        for a in call.args:
            if mapped and isinstance(a, ast.Name) and a.id in ctx.point_vars:
                continue       # accounted transitively via the callee
            self._walk(a, ctx, reads, trace_locals, _depth)
        for k in call.keywords:
            if mapped and isinstance(k.value, ast.Name) and \
                    k.value.id in ctx.point_vars:
                continue
            self._walk(k.value, ctx, reads, trace_locals, _depth)

    # ------------------------------------------------------- key coverage

    def key_coverage(self, key: ast.expr, ctx: _ReadCtx) -> Set[str]:
        """Attrs covered by the key (may contain _FULL)."""
        elements = key.elts if isinstance(key, ast.Tuple) else [key]
        covered: Set[str] = set()
        for e in elements:
            if isinstance(e, ast.Name) and e.id in ctx.point_vars:
                covered.add(_FULL)
                continue
            covered |= self.expr_reads(e, ctx)
        return covered

    # -------------------------------------------------------- key shapes

    def key_shape(self, key: ast.expr, ctx: _ReadCtx) -> Tuple[Tuple, ...]:
        elements = key.elts if isinstance(key, ast.Tuple) else [key]
        shape: List[Tuple] = []
        for e in elements:
            shape.append(self._descriptor(e, ctx))
        return tuple(shape)

    def _descriptor(self, e: ast.expr, ctx: _ReadCtx, _depth: int = 0) \
            -> Tuple:
        if isinstance(e, ast.Constant):
            return ("lit", repr(e.value), type(e.value).__name__)
        if isinstance(e, ast.Name):
            if e.id in ctx.point_vars:
                return ("point",)
            ptype = self._param_type_token(ctx.func, e.id)
            if ptype is not None:
                return ("type", ptype)
            if _depth < 3 and e.id in ctx.locals_ and \
                    len(ctx.locals_[e.id]) == 1:
                return self._descriptor(ctx.locals_[e.id][0], ctx,
                                        _depth + 1)
            return ("var",)
        if isinstance(e, ast.Call):
            fn = e.func
            if isinstance(fn, ast.Name) and fn.id == "tuple" and e.args \
                    and isinstance(e.args[0], ast.Name) and \
                    e.args[0].id in ctx.point_vars:
                return ("point",)
            return ("var",)
        return ("var",)

    @staticmethod
    def _param_type_token(fn: ast.FunctionDef, name: str) -> Optional[str]:
        for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
            if a.arg == name and isinstance(a.annotation, ast.Name):
                return a.annotation.id
        return None


def _definitely_disjoint(s1: Tuple, s2: Tuple) -> bool:
    if len(s1) != len(s2):
        return True
    for d1, d2 in zip(s1, s2):
        if d1[0] == "lit" and d2[0] == "lit" and d1[1] != d2[1]:
            return True
        for a, b in ((d1, d2), (d2, d1)):
            if a[0] == "type" and b[0] == "lit" and a[1] != b[2]:
                return True
    return False


def _find_sites(analyzer: _Analyzer, proj: Project, mod: ModuleInfo,
                ci) -> List[_Site]:
    """Membership-test cache sites + helper call sites within one class."""
    sites: List[_Site] = []
    helpers: List[Tuple[FuncInfo, str]] = []     # (helper method, dict attr)
    for fi in ci.methods.values():
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.ops[0], (ast.In, ast.NotIn))):
                continue
            comp = node.comparators[0]
            if not (isinstance(comp, ast.Attribute) and
                    isinstance(comp.value, ast.Name) and
                    comp.value.id == "self"):
                continue
            dict_attr = comp.attr
            key = node.left
            if isinstance(key, ast.Name):
                params = {a.arg for a in fi.node.args.args}
                pv = analyzer._point_vars(fi.node)
                if key.id in params and key.id not in pv:
                    # generic helper (e.g. _cached_plan): sites live at
                    # its call sites
                    helpers.append((fi, dict_attr))
                    continue
                if key.id in pv:
                    sites.append(_Site(fi, dict_attr, key))
                    continue
                # local assignment(s): one branch-scoped site each
                assigns = _key_assignments(fi.node, key.id)
                for i, (value, excluded) in enumerate(assigns):
                    sites.append(_Site(fi, dict_attr, value, variant=i,
                                       excluded=excluded))
                continue
            sites.append(_Site(fi, dict_attr, key))
    # helper call sites
    for helper_fi, dict_attr in helpers:
        hname = helper_fi.node.name
        for fi in ci.methods.values():
            if fi.qualname == helper_fi.qualname:
                continue
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == "self" and \
                        node.func.attr == hname and node.args:
                    sites.append(_Site(fi, dict_attr, node.args[0],
                                       build_exprs=tuple(node.args[1:])))
    return sites


def _key_assignments(fn: ast.FunctionDef, name: str):
    """[(value_expr, excluded_stmt_ids)] for each `name = ...` in fn.

    `excluded` holds the first-statement ids of every if/else branch that
    does NOT lie on the path to this assignment, so branch-local reads
    are only charged against their own key variant.
    """
    out = []

    def visit(stmts, path_excl: Set[int]):
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == name:
                        out.append((stmt.value, frozenset(path_excl)))
            if isinstance(stmt, ast.If):
                for branch, other in ((stmt.body, stmt.orelse),
                                      (stmt.orelse, stmt.body)):
                    if not branch:
                        continue
                    excl = set(path_excl)
                    if other:
                        excl.add(id(other[0]))
                    visit(branch, excl)
            elif isinstance(stmt, (ast.For, ast.While, ast.With, ast.Try)):
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.stmt):
                        visit([child], set(path_excl))
    visit(fn.body, set())
    return out


def check(proj: Project, modules: Optional[Sequence[str]] = None,
          point_classes: Sequence[str] = POINT_CLASSES,
          point_names: FrozenSet[str] = POINT_NAMES,
          collection_names: FrozenSet[str] = COLLECTION_NAMES
          ) -> List[Finding]:
    if modules is None:
        modules = proj.quals(DEFAULT_MODULES)
    analyzer = _Analyzer(proj, point_classes, point_names, collection_names)
    out: List[Finding] = []
    for modname in modules:
        mod = proj.modules.get(modname)
        if mod is None:
            continue
        for ci in [c for c in proj.classes.values() if c.module == modname]:
            sites = _find_sites(analyzer, proj, mod, ci)
            if not sites:
                continue
            rel = proj.rel(mod)
            # --- unkeyed attribute reads
            for site in sites:
                ctx = _ReadCtx(mod, ci.node.name, site.method.node,
                               analyzer._point_vars(site.method.node),
                               excluded=site.excluded,
                               locals_=analyzer._locals_map(
                                   site.method.node))
                covered = analyzer.key_coverage(site.key_node, ctx)
                if _FULL in covered:
                    continue
                if site.build_exprs:
                    reads: Set[str] = set()
                    for be in site.build_exprs:
                        body = be.body if isinstance(be, ast.Lambda) else be
                        reads |= analyzer.expr_reads(body, ctx)
                else:
                    reads = analyzer.func_reads(ctx)
                missing = sorted(reads - covered - {_FULL})
                symbol = f"{ci.node.name}.{site.method.node.name}"
                for attr in missing:
                    out.append(Finding(
                        "CK", "unkeyed-attr", Severity.ERROR, rel, symbol,
                        f"cache '{site.dict_attr}' key (variant "
                        f"{site.variant}) does not cover point attribute "
                        f"'{attr}' read by the cached computation",
                        line=getattr(site.key_node, "lineno", 0)))
                if _FULL in reads and _FULL not in covered:
                    out.append(Finding(
                        "CK", "unkeyed-point", Severity.ERROR, rel, symbol,
                        f"cache '{site.dict_attr}' key (variant "
                        f"{site.variant}) covers only "
                        f"{sorted(covered) or '[]'} but the computation "
                        f"consumes entire point objects",
                        line=getattr(site.key_node, "lineno", 0)))
            # --- shared-dict key-shape collisions
            by_dict: Dict[str, List[Tuple[_Site, Tuple]]] = {}
            for site in sites:
                ctx = _ReadCtx(mod, ci.node.name, site.method.node,
                               analyzer._point_vars(site.method.node),
                               locals_=analyzer._locals_map(
                                   site.method.node))
                shape = analyzer.key_shape(site.key_node, ctx)
                by_dict.setdefault(site.dict_attr, []).append((site, shape))
            for dict_attr, entries in by_dict.items():
                for i in range(len(entries)):
                    for j in range(i + 1, len(entries)):
                        (s1, sh1), (s2, sh2) = entries[i], entries[j]
                        m1 = s1.method.node.name
                        m2 = s2.method.node.name
                        if m1 == m2:
                            continue
                        if sh1 == (("point",),) and sh2 == (("point",),):
                            continue         # bare-point keys: consistent
                        if _definitely_disjoint(sh1, sh2):
                            continue
                        (a, fa), (b, fb) = sorted(
                            [(m1, _fmt(sh1)), (m2, _fmt(sh2))])
                        out.append(Finding(
                            "CK", "key-collision", Severity.WARNING, rel,
                            ci.node.name,
                            f"'{a}' and '{b}' share cache dict "
                            f"'{dict_attr}' with key shapes that may "
                            f"collide: {fa} vs {fb}",
                            line=ci.node.lineno))
    # dedupe
    seen, uniq = set(), []
    for f in out:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            uniq.append(f)
    return uniq


def _fmt(shape: Tuple[Tuple, ...]) -> str:
    return "(" + ", ".join(":".join(map(str, d)) for d in shape) + ")"
