"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the port either. Top-level module names are
compared whole, so ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: Path) -> set:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_sources_found():
    assert any(p.name == "run.py" for p in SOURCES)
    assert any("reference" in p.parts for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_imports_no_port(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_whole_names(tmp_path):
    """The check names the forbidden package, not a prefix of it."""
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom repro_torch import ops\n")
    assert imported(src) == {"repro_torch"}
    src.write_text("from repro.models import xr\n")
    assert imported(src) & FORBIDDEN == {"repro"}


def test_run_refuses_jax_modules(monkeypatch):
    """``run.py`` looks at ``sys.modules`` after the window by whole
    top-level names."""
    import sys
    import types

    from portbench.lib import env
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("x"))
    assert "repro" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert "jax" in env.forbidden_modules()
