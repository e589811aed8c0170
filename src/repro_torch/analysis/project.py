"""AST project model: module loading, symbol index, call resolution.

Loads every ``*.py`` under a package root (and optional extra roots like
``tests/``) into :class:`ModuleInfo` records and builds a flat qualname
index of functions and classes so checkers can resolve ``self.foo()``,
``module.func()`` and imported names to their defining AST nodes.

On top of the symbol index sits the interprocedural engine shared by the
CK/SH/MU checkers: :meth:`Project.call_sites` resolves every call inside
a function, :meth:`Project.call_graph` assembles the project-wide callee
map, and :meth:`Project.fixpoint` drives bottom-up per-function summary
computation (callees-first, iterated to a fixed point so call cycles
converge instead of recursing).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)


@dataclass
class FuncInfo:
    qualname: str                # "repro_torch.core.experiment.Evaluator.plan"
    module: str                  # dotted module name
    cls: Optional[str]           # enclosing class name, or None
    node: ast.FunctionDef
    is_property: bool = False


@dataclass
class ClassInfo:
    qualname: str
    module: str
    node: ast.ClassDef
    methods: Dict[str, FuncInfo] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    name: str                    # dotted module name
    path: Path
    source: str
    tree: ast.Module
    # local name -> fully qualified target ("dev" -> "repro_torch.core.devices")
    imports: Dict[str, str] = field(default_factory=dict)

    def rel_path(self, root: Path) -> str:
        try:
            return self.path.relative_to(root).as_posix()
        except ValueError:
            return self.path.as_posix()


def decorator_names(node) -> List[str]:
    """Rightmost dotted names of a def/class node's decorators."""
    out = []
    for dec in node.decorator_list:
        base = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(base, ast.Attribute):
            out.append(base.attr)
        elif isinstance(base, ast.Name):
            out.append(base.id)
    return out


class Project:
    """Parsed view of one or more source trees."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        # repo root used for repo-relative finding paths
        self.root: Path = Path(".")
        # dotted name of the loaded package ("" for a hand-built project)
        self.package: str = ""
        # qualname -> resolved call sites, built lazily by call_sites()
        self._call_sites: Dict[str, List[Tuple[ast.Call, FuncInfo]]] = {}

    # ------------------------------------------------------------- loading

    @classmethod
    def load(cls, package_root: Path, package_name: str,
             repo_root: Optional[Path] = None) -> "Project":
        """Parse every .py under `package_root` as package `package_name`."""
        proj = cls()
        proj.root = repo_root if repo_root is not None else package_root
        proj.package = package_name
        proj.add_tree(package_root, package_name)
        return proj

    def qual(self, rel: str) -> str:
        """Package-relative dotted name ("core.experiment") -> the loaded
        package's qualname ("repro_torch.core.experiment"); unchanged in a
        hand-built project."""
        return f"{self.package}.{rel}" if self.package else rel

    def quals(self, rels: Sequence[str]) -> Tuple[str, ...]:
        return tuple(self.qual(r) for r in rels)

    def local(self, qual: str) -> str:
        """The inverse of :meth:`qual`: a qualname relative to the loaded
        package (unchanged outside it), the key of the checkers' tables."""
        return qual.removeprefix(f"{self.package}.") if self.package \
            else qual

    def add_tree(self, root: Path, package_name: str) -> None:
        for path in sorted(root.rglob("*.py")):
            rel = path.relative_to(root)
            parts = list(rel.with_suffix("").parts)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            modname = ".".join([package_name] + parts) if parts else \
                package_name
            self.add_module(path, modname)

    def add_module(self, path: Path, modname: str,
                   source: Optional[str] = None) -> ModuleInfo:
        src = source if source is not None else path.read_text()
        tree = ast.parse(src, filename=str(path))
        mod = ModuleInfo(name=modname, path=path, source=src, tree=tree)
        self._index_imports(mod)
        self.modules[modname] = mod
        self._index_symbols(mod)
        # new symbols can change how previously-cached calls resolve
        self._call_sites.clear()
        return mod

    def _index_imports(self, mod: ModuleInfo) -> None:
        pkg_parts = mod.name.split(".")
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    mod.imports[local] = target
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    # relative import: resolve against this module's package
                    base_parts = pkg_parts[:-node.level] if node.level <= \
                        len(pkg_parts) else []
                    base = ".".join(base_parts)
                    src_mod = f"{base}.{node.module}" if node.module else base
                else:
                    src_mod = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    mod.imports[local] = f"{src_mod}.{alias.name}"

    def _index_symbols(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(node, ast.FunctionDef):
                    fi = FuncInfo(f"{mod.name}.{node.name}", mod.name, None,
                                  node)
                    self.functions[fi.qualname] = fi
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(f"{mod.name}.{node.name}", mod.name, node)
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        fi = FuncInfo(f"{ci.qualname}.{sub.name}", mod.name,
                                      node.name, sub,
                                      is_property="property" in
                                      decorator_names(sub))
                        ci.methods[sub.name] = fi
                        self.functions[fi.qualname] = fi
                self.classes[ci.qualname] = ci

    # ----------------------------------------------------------- resolution

    def resolve_name(self, mod: ModuleInfo, name: str) -> Optional[str]:
        """Local name -> fully qualified target, if known."""
        if f"{mod.name}.{name}" in self.functions:
            return f"{mod.name}.{name}"
        if f"{mod.name}.{name}" in self.classes:
            return f"{mod.name}.{name}"
        return mod.imports.get(name)

    def resolve_call(self, mod: ModuleInfo, cls_name: Optional[str],
                     call: ast.Call) -> Optional[FuncInfo]:
        """Resolve a call expression to a FuncInfo when statically possible.

        Handles ``self.m(..)`` (within `cls_name`), module-level names,
        imported names, and ``module_alias.func(..)``.
        """
        fn = call.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name) and base.id == "self" and cls_name:
                ci = self.classes.get(f"{mod.name}.{cls_name}")
                if ci and fn.attr in ci.methods:
                    return ci.methods[fn.attr]
                return None
            if isinstance(base, ast.Name):
                target = self.resolve_name(mod, base.id)
                if target is None:
                    return None
                # module alias: dev.mem_energy_pj_per_bit
                cand = f"{target}.{fn.attr}"
                if cand in self.functions:
                    return self.functions[cand]
                # class attr: Placement.sram (classmethod/constructor)
                if target in self.classes:
                    return self.classes[target].methods.get(fn.attr)
            return None
        if isinstance(fn, ast.Name):
            target = self.resolve_name(mod, fn.id)
            if target and target in self.functions:
                return self.functions[target]
            return None
        return None

    def resolve_class(self, mod: ModuleInfo, name: str) -> \
            Optional[ClassInfo]:
        target = self.resolve_name(mod, name)
        if target and target in self.classes:
            return self.classes[target]
        # fall back: unique class with this terminal name
        hits = [c for q, c in self.classes.items()
                if q.rsplit(".", 1)[-1] == name]
        return hits[0] if len(hits) == 1 else None

    # -------------------------------------------------------- interprocedural

    def call_sites(self, fi: FuncInfo) -> List[Tuple[ast.Call, FuncInfo]]:
        """Every call inside `fi` that resolves statically, in source order.

        Nested defs/lambdas are included (ast.walk); checkers that need
        stricter scoping filter on the call node themselves.
        """
        cached = self._call_sites.get(fi.qualname)
        if cached is None:
            mod = self.modules[fi.module]
            cached = []
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    target = self.resolve_call(mod, fi.cls, node)
                    if target is not None:
                        cached.append((node, target))
            self._call_sites[fi.qualname] = cached
        return cached

    def call_graph(self) -> Dict[str, Tuple[str, ...]]:
        """qualname -> statically-resolved callee qualnames (deduplicated)."""
        out: Dict[str, Tuple[str, ...]] = {}
        for qual, fi in self.functions.items():
            out[qual] = tuple(dict.fromkeys(
                t.qualname for _, t in self.call_sites(fi)))
        return out

    def postorder(self) -> List[str]:
        """Callees-first ordering of all functions (cycles broken at the
        first revisit) — the seed order that lets `fixpoint` converge in
        one round on acyclic call chains."""
        graph = self.call_graph()
        seen: set = set()
        order: List[str] = []
        # iterative DFS: (qualname, child cursor) frames
        for root in sorted(graph):
            if root in seen:
                continue
            seen.add(root)
            stack: List[Tuple[str, int]] = [(root, 0)]
            while stack:
                qual, i = stack[-1]
                kids = graph.get(qual, ())
                if i < len(kids):
                    stack[-1] = (qual, i + 1)
                    kid = kids[i]
                    if kid not in seen:
                        seen.add(kid)
                        stack.append((kid, 0))
                else:
                    order.append(qual)
                    stack.pop()
        return order

    def fixpoint(self, transfer: Callable[[FuncInfo, Dict[str, Any]], Any],
                 bottom: Any = None, max_rounds: int = 8) -> Dict[str, Any]:
        """Bottom-up per-function summaries over the call graph.

        ``transfer(fi, summaries)`` computes one function's summary from
        the current summary map; callee entries may still be ``bottom``
        inside call cycles, so transfer functions must treat missing
        summaries optimistically. Iterates callees-first until one full
        round changes nothing (``max_rounds`` bounds pathological cycles).
        Shared by the CK/SH/MU checkers.
        """
        order = self.postorder()
        summaries: Dict[str, Any] = {q: bottom for q in order}
        for _ in range(max_rounds):
            changed = False
            for qual in order:
                fi = self.functions.get(qual)
                if fi is None:
                    continue
                new = transfer(fi, summaries)
                if new != summaries[qual]:
                    summaries[qual] = new
                    changed = True
            if not changed:
                break
        return summaries

    # ------------------------------------------------------------ iteration

    def iter_functions(self, module: str) -> Iterator[FuncInfo]:
        for fi in self.functions.values():
            if fi.module == module:
                yield fi

    def rel(self, mod: ModuleInfo) -> str:
        return mod.rel_path(self.root)


def param_names(node: ast.FunctionDef) -> List[str]:
    args = node.args
    names = [a.arg for a in args.posonlyargs] + [a.arg for a in args.args]
    if args.vararg:
        names.append(args.vararg.arg)
    names += [a.arg for a in args.kwonlyargs]
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def annotation_tokens(ann: Optional[ast.expr]) -> List[str]:
    """All bare name tokens appearing in an annotation expression."""
    if ann is None:
        return []
    out: List[str] = []
    for node in ast.walk(ann):
        if isinstance(node, ast.Name):
            out.append(node.id)
        elif isinstance(node, ast.Attribute):
            out.append(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # string annotations: crude token split is enough for our use
            for tok in node.value.replace("[", " ").replace("]", " ") \
                    .replace(",", " ").replace(".", " ").split():
                out.append(tok)
    return out


def call_arg_map(call: ast.Call, callee: ast.FunctionDef,
                 skip_self: bool) -> Dict[str, ast.expr]:
    """Map callee parameter names -> argument expressions at this call."""
    params = [a.arg for a in callee.args.args]
    if skip_self and params and params[0] in ("self", "cls"):
        params = params[1:]
    out: Dict[str, ast.expr] = {}
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(params):
            out[params[i]] = arg
    for kw in call.keywords:
        if kw.arg is not None:
            out[kw.arg] = kw.value
    return out
