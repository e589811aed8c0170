"""MU — cache-aliasing / mutation soundness for structural caches.

The Evaluator and LatticePricer memoize *structural* values — traffic
tables, pricing plans, system geometries, pre-gathered tech stacks — and
hand them to callers by reference. The shared-LRU serving engine
(ROADMAP: DSE-as-a-service) is only sound if no array reachable from a
cache can be mutated after it is cached; this checker is the static
precondition for that design.

Machinery:

* **Mutation summaries** per function, computed bottom-up over the call
  graph (`Project.fixpoint`). A summary is a frozenset of tokens:
  ``p:<param>`` (parameter's reachable state mutated), ``s:<attr>``
  (``self.<attr>`` content mutated), ``f:<attr>`` (``self.<attr>``
  frozen via ``setflags(write=False)``), ``r:<attr>`` (returns/yields a
  value rooted in ``self.<attr>``), and ``F`` (applies
  ``setflags(write=False)`` to anything — reached transitively from a
  ``__post_init__``, this marks a *frozen record class*). Local events:
  subscript/attribute stores, in-place numpy ops (``np.add.at``,
  ``.fill``/``.sort``/..., ``setflags(write=True)``), dataclass field
  writes, plus everything a resolved callee's summary implies through
  `call_arg_map` aliasing.

* **Allowed idiom**: a *single-level* subscript store or aug-assign on a
  ``self`` attribute (``self._plans[key] = v``, ``self.stats[k] += 1``)
  is cache insertion, not content mutation. Deeper stores, or stores
  through an alias of a retrieved cache value, count as mutation.
  ``__init__``/``__post_init__`` may write ``self`` fields
  (``object.__setattr__`` canonicalization included).

* **Build phase**: a cache class's ``__init__``/``__post_init__`` plus
  every method transitively self-called from them (`_compile` filling
  ``self._g_of``). Mutations there construct the cache and are exempt.

Rules:

* ``cache-mutation`` (ERROR) — a non-build method of a cache class
  mutates the content of an array-bearing cache attribute.
* ``cache-escape`` (WARNING) — an array-bearing cached value escapes
  (return/yield rooted in a cache attr, or a cache-rooted array embedded
  in a constructed object) without the read-only guarantee: the raw
  attr is not frozen in the build phase and the value/target class does
  not freeze its arrays in ``__post_init__``.
* ``escape-mutation`` (ERROR) — any caller anywhere in the project
  binds the result of a cache-returning method and mutates it (directly
  or by passing it to a callee whose summary mutates that parameter).

"Array-bearing" keeps the signal high: an attr qualifies if its
annotation mentions ``ndarray``, resolves to a class with ndarray
fields, or it is assigned a numpy expression in the build phase.
Unknown-class caches are skipped optimistically.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field as dc_field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import (ClassInfo, FuncInfo, ModuleInfo, Project,
                                    annotation_tokens, call_arg_map)

DEFAULT_CACHE_CLASSES = (
    "core.experiment.Evaluator",
    "search.stream.LatticePricer",
)

_MUTATING_METHODS = frozenset({"fill", "sort", "partition", "put",
                               "itemset", "resize", "byteswap"})
_NP_INPLACE = frozenset({"add.at", "subtract.at", "multiply.at",
                         "maximum.at", "minimum.at", "put", "place",
                         "putmask", "copyto"})
_INIT_METHODS = ("__init__", "__post_init__")


def _src(node: ast.AST, limit: int = 48) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        text = "<expr>"
    return text if len(text) <= limit else text[:limit - 3] + "..."


@dataclass
class _Local:
    """One function's mutation/alias walk."""

    an: "_Analyzer"
    fi: FuncInfo
    summaries: Dict[str, FrozenSet[str]]
    #: var name -> root token ("self", "p:x", "s:attr", "c:<cls>.<meth>")
    roots: Dict[str, str] = dc_field(default_factory=dict)
    events: Set[str] = dc_field(default_factory=set)
    #: (call node, root token) for cache-rooted ctor embeddings
    embeds: List[Tuple[ast.Call, str, str]] = dc_field(default_factory=list)
    #: (node, root token) mutations of cache-returning call results
    ret_mutations: List[Tuple[ast.AST, str]] = dc_field(default_factory=list)

    def __post_init__(self) -> None:
        self.mod = self.an.proj.modules[self.fi.module]
        #: var name -> cache-class qualname (for receiver resolution)
        self.classes: Dict[str, str] = {}
        args = self.fi.node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.arg == "self" and self.fi.cls is not None:
                self.roots[a.arg] = "self"
            else:
                self.roots[a.arg] = f"p:{a.arg}"
            for tok in annotation_tokens(a.annotation):
                ci = self.an.proj.resolve_class(self.mod, tok)
                if ci is not None and ci.qualname in self.an.cache_classes:
                    self.classes[a.arg] = ci.qualname
                    break
        self.is_init = self.fi.cls is not None and \
            self.fi.node.name in _INIT_METHODS

    # ----------------------------------------------------------------- roots

    def root_of(self, e: ast.expr, depth: int = 0) -> Optional[str]:
        if depth > 8:
            return None
        if isinstance(e, ast.Name):
            return self.roots.get(e.id)
        if isinstance(e, ast.Subscript):
            base = self.root_of(e.value, depth + 1)
            if base == "self" and isinstance(e.value, ast.Attribute):
                return self.root_of(e.value, depth + 1)
            return base
        if isinstance(e, ast.Attribute):
            base = self.root_of(e.value, depth + 1)
            if base == "self":
                return f"s:{e.attr}"
            return base
        if isinstance(e, ast.Call):
            return self.call_root(e, depth + 1)
        if isinstance(e, (ast.IfExp,)):
            return self.root_of(e.body, depth + 1) or \
                self.root_of(e.orelse, depth + 1)
        if isinstance(e, ast.Starred):
            return self.root_of(e.value, depth + 1)
        return None

    def call_root(self, call: ast.Call, depth: int = 0) -> Optional[str]:
        """Root of a call result: view-returning methods keep the receiver
        root; self-methods whose summary returns cache content root at
        that cache attr; cache-class methods root at 'c:<cls>.<meth>'."""
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in ("copy", "astype", "tolist", "deepcopy"):
                return None                       # fresh storage
            if fn.attr in ("ravel", "reshape", "view", "squeeze",
                           "transpose", "clip"):
                return self.root_of(fn.value, depth + 1)
            recv_root = self.root_of(fn.value, depth + 1)
            target = self.an.resolve_method(self, call)
            if target is not None:
                summ = self.summaries.get(target.qualname) or frozenset()
                rets = sorted(t[2:] for t in summ if t.startswith("r:"))
                if rets:
                    if recv_root == "self":
                        return f"s:{rets[0]}"
                    cls_qual = self.an.receiver_class(self, fn.value)
                    if cls_qual in self.an.cache_classes:
                        return f"c:{cls_qual}.{fn.attr}"
        return None

    # ----------------------------------------------------------- mutations

    def mutate(self, root: Optional[str], node: ast.AST) -> None:
        if root is None:
            return
        if root == "self":
            return
        if root.startswith("c:"):
            self.ret_mutations.append((node, root))
            return
        if root.startswith(("p:", "s:")):
            if self.is_init and root.startswith("s:"):
                return                    # constructing, not mutating
            self.events.add(root)

    def freeze(self, root: Optional[str]) -> None:
        self.events.add("F")
        if root is not None and root.startswith("s:"):
            self.events.add(f"f:{root[2:]}")

    # ------------------------------------------------------------ statements

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value)
            for t in stmt.targets:
                self._store(t, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_expr(stmt.value)
            self._store(stmt.target, stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            self._scan_expr(stmt.value)
            self._aug_store(stmt.target)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._scan_expr(stmt.value)
                self._escape(stmt.value)
        elif isinstance(stmt, ast.Expr):
            if isinstance(stmt.value, (ast.Yield, ast.YieldFrom)):
                inner = stmt.value.value
                if inner is not None:
                    self._scan_expr(inner)
                    self._escape(inner)
            else:
                self._scan_expr(stmt.value)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr(child)
                elif isinstance(child, ast.stmt):
                    self._stmt(child)

    def _escape(self, e: ast.expr) -> None:
        """Record cache-content roots escaping via return/yield."""
        parts = e.elts if isinstance(e, (ast.Tuple, ast.List)) else [e]
        for p in parts:
            root = self.root_of(p)
            if root is not None and root.startswith("s:"):
                self.events.add(f"r:{root[2:]}")

    def _store(self, target: ast.expr, value: ast.expr) -> None:
        if isinstance(target, ast.Name):
            root = self.root_of(value)
            if root is not None:
                self.roots[target.id] = root
            else:
                self.roots.pop(target.id, None)
            cls_qual = None
            if isinstance(value, ast.Call):
                cls_qual = self.an.ctor_qual(self.mod, value.func)
            if cls_qual is not None and cls_qual in self.an.cache_classes:
                self.classes[target.id] = cls_qual
            else:
                self.classes.pop(target.id, None)
            return
        if isinstance(target, ast.Tuple):
            vals = value.elts if isinstance(value, ast.Tuple) and \
                len(value.elts) == len(target.elts) else \
                [None] * len(target.elts)
            for t, v in zip(target.elts, vals):
                if v is not None:
                    self._store(t, v)
                elif isinstance(t, ast.Name):
                    self.roots.pop(t.id, None)
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            if self._is_self_attr(base):
                return                    # self._x[k] = v: cache insertion
            self.mutate(self.root_of(base), target)
            return
        if isinstance(target, ast.Attribute):
            base_root = self.root_of(target.value)
            if base_root == "self":
                return                    # attr rebind: FZ's domain
            self.mutate(base_root, target)

    def _aug_store(self, target: ast.expr) -> None:
        if isinstance(target, ast.Subscript):
            base = target.value
            if self._is_self_attr(base):
                return                    # self.stats[k] += 1: counter
            self.mutate(self.root_of(base), target)
        elif isinstance(target, ast.Attribute):
            base_root = self.root_of(target.value)
            if base_root != "self":
                self.mutate(base_root, target)

    @staticmethod
    def _is_self_attr(e: ast.expr) -> bool:
        return isinstance(e, ast.Attribute) and \
            isinstance(e.value, ast.Name) and e.value.id == "self"

    # ------------------------------------------------------------------ calls

    def _scan_expr(self, e: ast.expr) -> None:
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                self._call_events(node)

    def _call_events(self, call: ast.Call) -> None:
        fn = call.func
        # object.__setattr__(x, "f", v)
        if isinstance(fn, ast.Attribute) and fn.attr == "__setattr__" and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "object" and call.args:
            root = self.root_of(call.args[0])
            if not (self.is_init and root == "self"):
                if root == "self":
                    return                # setattr on self outside init: FZ
                self.mutate(root, call)
            return
        if isinstance(fn, ast.Attribute):
            if fn.attr == "setflags":
                write = None
                for kw in call.keywords:
                    if kw.arg == "write" and isinstance(kw.value,
                                                       ast.Constant):
                        write = kw.value.value
                root = self.root_of(fn.value)
                if write is False:
                    self.freeze(root)
                elif write is True:
                    self.mutate(root, call)
                return
            if fn.attr in _MUTATING_METHODS:
                self.mutate(self.root_of(fn.value), call)
                return
            npname = self.an.np_name(self.mod, fn)
            if npname in _NP_INPLACE and call.args:
                self.mutate(self.root_of(call.args[0]), call)
                return
        # constructor embedding a cache-rooted array into a record object
        if isinstance(fn, (ast.Name, ast.Attribute)):
            cls_qual = self.an.ctor_qual(self.mod, fn)
            if cls_qual is not None:
                arg_exprs = list(call.args) + \
                    [kw.value for kw in call.keywords]
                for aexpr in arg_exprs:
                    root = self.root_of(aexpr)
                    if root is not None and root.startswith(("s:", "c:")):
                        self.embeds.append((call, root, cls_qual))
                return
        # resolved project call: apply callee summary through the arg map
        target = self.an.resolve_method(self, call)
        if target is None:
            return
        summ = self.summaries.get(target.qualname) or frozenset()
        if not summ:
            return
        argmap = call_arg_map(call, target.node,
                              skip_self=target.cls is not None)
        recv_root = None
        if isinstance(fn, ast.Attribute):
            recv_root = self.root_of(fn.value)
        for token in summ:
            if token.startswith("p:"):
                aexpr = argmap.get(token[2:])
                if aexpr is not None:
                    self.mutate(self.root_of(aexpr), call)
            elif token.startswith(("s:", "f:")) and recv_root == "self":
                # self.m() touching self._x touches our self._x too
                if token.startswith("s:"):
                    self.mutate(token, call)
                else:
                    self.events.add(token)
            elif token.startswith("s:") and recv_root is not None and \
                    recv_root.startswith("p:"):
                self.mutate(recv_root, call)
            elif token == "F":
                self.events.add("F")


@dataclass
class _AttrInfo:
    is_array: bool                       # array-bearing by any evidence
    raw_np: bool                         # assigned a bare numpy expression
    value_classes: Tuple[ClassInfo, ...]  # annotated record classes


class _Analyzer:
    """Project-wide mutation-summary computation + rule evaluation."""

    def __init__(self, proj: Project, cache_classes: Sequence[str]) -> None:
        self.proj = proj
        self.cache_classes = frozenset(cache_classes)
        self.summaries: Dict[str, FrozenSet[str]] = {}
        self._locals: Dict[str, _Local] = {}

    # ------------------------------------------------------------- resolve

    def np_name(self, mod: ModuleInfo, fn: ast.expr) -> Optional[str]:
        """Dotted numpy attr ("add.at") if rooted at a numpy import."""
        parts: List[str] = []
        node = fn
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name) and \
                mod.imports.get(node.id) == "numpy":
            return ".".join(reversed(parts))
        return None

    def ctor_qual(self, mod: ModuleInfo, fn: ast.expr) -> Optional[str]:
        """Class qualname for a ctor call func: Name or module.Class."""
        if isinstance(fn, ast.Name):
            target = self.proj.resolve_name(mod, fn.id)
            return target if target in self.proj.classes else None
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            base = self.proj.resolve_name(mod, fn.value.id)
            if base is not None and f"{base}.{fn.attr}" in self.proj.classes:
                return f"{base}.{fn.attr}"
        return None

    def resolve_method(self, loc: _Local, call: ast.Call) \
            -> Optional[FuncInfo]:
        target = self.proj.resolve_call(loc.mod, loc.fi.cls, call)
        if target is not None:
            return target
        fn = call.func
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            cls_qual = loc.classes.get(fn.value.id)
            if cls_qual is not None:
                ci = self.proj.classes.get(cls_qual)
                if ci is not None:
                    return ci.methods.get(fn.attr)
        return None

    def receiver_class(self, loc: _Local, expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and loc.fi.cls is not None:
                return f"{loc.fi.module}.{loc.fi.cls}"
            return loc.classes.get(expr.id)
        return None

    # ------------------------------------------------------------ fixpoint

    def transfer(self, fi: FuncInfo,
                 summaries: Dict[str, FrozenSet[str]]) -> FrozenSet[str]:
        loc = _Local(self, fi, summaries)
        loc.run()
        self._locals[fi.qualname] = loc
        return frozenset(loc.events)

    def summary(self, fi: Optional[FuncInfo]) -> FrozenSet[str]:
        if fi is None:
            return frozenset()
        return self.summaries.get(fi.qualname) or frozenset()

    # ------------------------------------------------------- cache classes

    def build_phase(self, ci: ClassInfo) -> Set[str]:
        """__init__/__post_init__ plus transitively self-called methods."""
        phase = {m for m in _INIT_METHODS if m in ci.methods}
        frontier = list(phase)
        while frontier:
            fi = ci.methods[frontier.pop()]
            for _, target in self.proj.call_sites(fi):
                if target.cls == ci.node.name and \
                        target.module == ci.module and \
                        target.node.name not in phase and \
                        target.node.name in ci.methods:
                    phase.add(target.node.name)
                    frontier.append(target.node.name)
        return phase

    def class_has_arrays(self, ci: ClassInfo) -> bool:
        return any(isinstance(stmt, ast.AnnAssign) and
                   "ndarray" in annotation_tokens(stmt.annotation)
                   for stmt in ci.node.body)

    def class_frozen(self, ci: ClassInfo) -> bool:
        """Record classes that freeze their arrays in __post_init__."""
        return "F" in self.summary(ci.methods.get("__post_init__"))

    def cache_attrs(self, ci: ClassInfo,
                    phase: Set[str]) -> Dict[str, _AttrInfo]:
        """self-attrs assigned during the build phase, with array evidence."""
        mod = self.proj.modules[ci.module]
        out: Dict[str, _AttrInfo] = {}
        for mname in sorted(phase):
            fi = ci.methods[mname]
            for stmt in ast.walk(fi.node):
                target = ann = value = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    target, value = stmt.targets[0], stmt.value
                elif isinstance(stmt, ast.AnnAssign):
                    target, ann, value = stmt.target, stmt.annotation, \
                        stmt.value
                if not (isinstance(target, ast.Attribute) and
                        isinstance(target.value, ast.Name) and
                        target.value.id == "self"):
                    continue
                raw_np = value is not None and any(
                    self.np_name(mod, n) is not None
                    for n in ast.walk(value)
                    if isinstance(n, ast.Attribute))
                vcs = []
                for tok in annotation_tokens(ann):
                    vci = self.proj.resolve_class(mod, tok)
                    if vci is not None and self.class_has_arrays(vci):
                        vcs.append(vci)
                is_array = raw_np or bool(vcs) or \
                    "ndarray" in annotation_tokens(ann)
                prev = out.get(target.attr)
                if prev is not None:
                    is_array = is_array or prev.is_array
                    raw_np = raw_np or prev.raw_np
                    vcs = list(dict.fromkeys(prev.value_classes +
                                             tuple(vcs)))
                out[target.attr] = _AttrInfo(is_array, raw_np, tuple(vcs))
        return out

    def attr_frozen(self, ci: ClassInfo, phase: Set[str],
                    attr: str) -> bool:
        return any(f"f:{attr}" in self.summary(ci.methods.get(m))
                   for m in phase)

    def guaranteed(self, ci: ClassInfo, phase: Set[str], attr: str,
                   info: _AttrInfo) -> bool:
        """Read-only guarantee: attr frozen during build, or every
        array-bearing value class freezes its arrays in __post_init__."""
        if self.attr_frozen(ci, phase, attr):
            return True
        if info.raw_np and not info.value_classes:
            return False
        return bool(info.value_classes) and \
            all(self.class_frozen(vc) for vc in info.value_classes)


def check(proj: Project,
          cache_classes: Optional[Sequence[str]] = None) -> List[Finding]:
    if cache_classes is None:
        cache_classes = proj.quals(DEFAULT_CACHE_CLASSES)
    an = _Analyzer(proj, cache_classes)
    an.summaries = proj.fixpoint(an.transfer, bottom=None, max_rounds=8)
    out: List[Finding] = []

    cache_infos = {}
    for cq in sorted(an.cache_classes):
        ci = proj.classes.get(cq)
        if ci is None:
            continue
        phase = an.build_phase(ci)
        cache_infos[cq] = (ci, phase, an.cache_attrs(ci, phase))

    for ci, phase, attrs in cache_infos.values():
        mod = proj.modules[ci.module]
        path = proj.rel(mod)
        for mname in sorted(ci.methods):
            fi = ci.methods[mname]
            sym = fi.qualname.removeprefix(mod.name + ".")
            summ = an.summary(fi)
            in_build = mname in phase
            for token in sorted(summ):
                attr = token[2:]
                info = attrs.get(attr)
                if info is None or not info.is_array:
                    continue
                if token.startswith("s:") and not in_build:
                    out.append(Finding(
                        checker="MU", rule="cache-mutation",
                        severity=Severity.ERROR, path=path, symbol=sym,
                        message=(f"mutates content of array-bearing cache "
                                 f"attribute 'self.{attr}' outside the "
                                 f"build phase; shared-LRU serving needs "
                                 f"cached arrays immutable once built"),
                        line=fi.node.lineno))
                elif token.startswith("r:") and \
                        not an.guaranteed(ci, phase, attr, info):
                    out.append(Finding(
                        checker="MU", rule="cache-escape",
                        severity=Severity.WARNING, path=path, symbol=sym,
                        message=(f"returns a value rooted in array-bearing "
                                 f"cache 'self.{attr}' without a read-only "
                                 f"guarantee (freeze the arrays in the "
                                 f"build phase or in the value class's "
                                 f"__post_init__)"),
                        line=fi.node.lineno))
            loc = an._locals.get(fi.qualname)
            for call, root, tcls in (loc.embeds if loc else ()):
                if not root.startswith("s:"):
                    continue
                attr = root[2:]
                info = attrs.get(attr)
                tci = proj.classes.get(tcls)
                if info is None or not info.is_array:
                    continue
                if an.attr_frozen(ci, phase, attr) or \
                        (tci is not None and an.class_frozen(tci)):
                    continue
                tname = tcls.rsplit(".", 1)[-1]
                out.append(Finding(
                    checker="MU", rule="cache-escape",
                    severity=Severity.WARNING, path=path, symbol=sym,
                    message=(f"embeds a view of cached array 'self.{attr}' "
                             f"into {tname}(...) and neither the cache "
                             f"attr nor {tname} freezes its arrays"),
                    line=call.lineno))

    # escape-mutation: project-wide — callers mutating cache-returned arrays
    for qual in sorted(an._locals):
        loc = an._locals[qual]
        fi = loc.fi
        mod = proj.modules[fi.module]
        sym = fi.qualname.removeprefix(mod.name + ".")
        for node, root in loc.ret_mutations:
            ref = root[2:]                       # "<cls_qual>.<meth>"
            cls_qual, meth = ref.rsplit(".", 1)
            cname = cls_qual.rsplit(".", 1)[-1]
            out.append(Finding(
                checker="MU", rule="escape-mutation",
                severity=Severity.ERROR, path=proj.rel(mod), symbol=sym,
                message=(f"mutates an array obtained from cache-returning "
                         f"{cname}.{meth}() (`{_src(node)}`); cached "
                         f"arrays are shared across callers"),
                line=getattr(node, "lineno", 0)))

    seen, uniq = set(), []
    for f in out:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            uniq.append(f)
    return uniq
