"""PO — parity-oracle coverage of the columnar hot path.

The vectorized pricing core (`core/columns.py`) is guarded by
scalar-vs-columnar parity tests; a public columnar symbol that no test
references has silently lost its oracle. This checker lists every
public module-level function and every public method/property of public
classes in the columns module, then scans the test tree's ASTs for any
reference (bare name or attribute access) to each symbol.

Matching is by terminal name, which slightly over-counts coverage (a
test touching an unrelated `.row()` counts for `AreaTable.row`) — the
cheap, zero-false-positive direction for a gate. The port's gate reads
only its own tests (``test_torch_*.py``): the reference's tests name
symbols of the same names, and counting them would empty the gate.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import Project

DEFAULT_MODULE = "core.columns"      # relative to the analysed package
DEFAULT_PATTERN = "test_torch_*.py"


def _public_symbols(proj: Project, modname: str) -> List[Tuple[str, str, int]]:
    """[(display_name, terminal_name, lineno)] of the module's public API."""
    mod = proj.modules[modname]
    out: List[Tuple[str, str, int]] = []
    for node in mod.tree.body:
        if isinstance(node, ast.FunctionDef) and not \
                node.name.startswith("_"):
            out.append((node.name, node.name, node.lineno))
        elif isinstance(node, ast.ClassDef) and not \
                node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and not \
                        sub.name.startswith("_"):
                    out.append((f"{node.name}.{sub.name}", sub.name,
                                sub.lineno))
    return out


def _referenced_names(test_paths: Sequence[Path]) -> Set[str]:
    names: Set[str] = set()
    for path in test_paths:
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                names.add(node.id)
            elif isinstance(node, ast.Attribute):
                names.add(node.attr)
    return names


def check(proj: Project, tests_dir: Path, module: Optional[str] = None,
          pattern: str = DEFAULT_PATTERN) -> List[Finding]:
    if module is None:
        module = proj.qual(DEFAULT_MODULE)
    if module not in proj.modules:
        return []
    mod = proj.modules[module]
    rel = proj.rel(mod)
    test_paths = sorted(tests_dir.glob(pattern)) if \
        tests_dir.is_dir() else []
    referenced = _referenced_names(test_paths)
    out: List[Finding] = []
    for display, terminal, lineno in _public_symbols(proj, module):
        if terminal in referenced:
            continue
        out.append(Finding(
            "PO", "uncovered-columnar", Severity.WARNING, rel, display,
            f"public columnar symbol '{display}' is not referenced by any "
            f"test under {tests_dir.name}/ — its scalar-parity oracle is "
            f"gone", line=lineno))
    return out
