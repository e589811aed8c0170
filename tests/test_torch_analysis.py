"""The port's static-analysis checkers (``repro_torch.analysis``) against
the reference's (``repro.analysis``): the same findings on every seeded-bad
fixture of the reference's tests, over the reference's own tree, and over
the port's tree once its paths and names are renamed; the reverted-fix
regressions on the port's tree; the port's baseline and CLI.

Each tree is loaded and analysed once per module (the ``*_findings``
fixtures): a whole run takes a few seconds.
"""
import importlib.util
import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis import ck as ref_ck
from repro.analysis import fz as ref_fz
from repro.analysis import mu as ref_mu
from repro.analysis import po as ref_po
from repro.analysis import sh as ref_sh
from repro.analysis import un as ref_un
from repro.analysis.project import Project as RefProject
from repro.analysis.runner import run_analysis as ref_run_analysis
from repro_torch.analysis import ck, fz, mu, po, sh, un
from repro_torch.analysis.findings import Baseline, Severity
from repro_torch.analysis.project import Project
from repro_torch.analysis.runner import (CHECKERS, main, run_analysis,
                                         validate_justification)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
BASELINE = PORT / "analysis" / "baseline.json"


def _load_ref_tests(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


T1 = _load_ref_tests("test_analysis")
T2 = _load_ref_tests("test_analysis_shmu")


def _fixture(cls, source):
    proj = cls()
    proj.add_module(Path("fix", "mod.py"), "fix.mod",
                    source=textwrap.dedent(source))
    return proj


def _rows(findings):
    return [(f.checker, f.rule, f.severity.value, f.path, f.symbol,
             f.message, f.fingerprint, f.line) for f in findings]


# --- (a) every seeded-bad fixture, both packages ----------------------------

FIXTURES = {
    "ck": (T1.CK_BAD, lambda m, p: m.check(p, modules=("fix.mod",))),
    "un": (T1.UN_BAD, lambda m, p: m.check(p, modules=("fix.mod",))),
    "fz": (T1.FZ_BAD, lambda m, p: m.check(
        p, axis_classes=("fix.mod.DesignPoint",), evaluator_classes=())),
    "sh": (T2.SH_BAD, lambda m, p: m.check(p, modules=("fix.mod",))),
    "mu-bad": (T2.MU_BAD, lambda m, p: m.check(
        p, cache_classes=("fix.mod.Pricer",))),
    "mu-good": (T2.MU_GOOD, lambda m, p: m.check(
        p, cache_classes=("fix.mod.Pricer",))),
}
MODULES = {"ck": (ref_ck, ck), "un": (ref_un, un), "fz": (ref_fz, fz),
           "sh": (ref_sh, sh), "mu-bad": (ref_mu, mu),
           "mu-good": (ref_mu, mu)}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_findings_equal_the_reference(name):
    source, run = FIXTURES[name]
    ref_mod, port_mod = MODULES[name]
    want = _rows(run(ref_mod, _fixture(RefProject, source)))
    got = _rows(run(port_mod, _fixture(Project, source)))
    assert got == want
    if name != "mu-good":
        assert want, f"the {name} fixture found nothing"


def test_po_fixture_findings_equal_the_reference(tmp_path):
    # the file name matches both packages' test globs
    (tmp_path / "test_torch_fixture.py").write_text(
        "from fix.mod import covered_fn\n\n"
        "def test_covered():\n    assert covered_fn(1) == 1\n")
    want = ref_po.check(_fixture(RefProject, T1.PO_BAD), tests_dir=tmp_path,
                        module="fix.mod")
    got = po.check(_fixture(Project, T1.PO_BAD), tests_dir=tmp_path,
                   module="fix.mod")
    assert _rows(got) == _rows(want)
    assert [f.symbol for f in got] == ["orphan_fn"]


def test_po_reads_only_the_ports_tests(tmp_path):
    (tmp_path / "test_ref.py").write_text("covered_fn\norphan_fn\n")
    (tmp_path / "test_torch_port.py").write_text("covered_fn\n")
    got = po.check(_fixture(Project, T1.PO_BAD), tests_dir=tmp_path,
                   module="fix.mod")
    assert [f.symbol for f in got] == ["orphan_fn"]
    assert po.check(_fixture(Project, T1.PO_BAD), tests_dir=tmp_path,
                    module="fix.mod", pattern="test_*.py") == []


# --- (b) the reference's tree, (c) the port's tree ---------------------------

@pytest.fixture(scope="module")
def ref_findings():
    return ref_run_analysis()


@pytest.fixture(scope="module")
def port_over_ref_findings():
    return run_analysis(package_root=REF, tests_pattern="test_*.py")


@pytest.fixture(scope="module")
def port_findings():
    return run_analysis()


@pytest.mark.parametrize("checker", list(CHECKERS))
def test_port_over_the_reference_tree_equals_the_reference(
        checker, ref_findings, port_over_ref_findings):
    want = [f.to_json() for f in ref_findings if f.checker == checker]
    got = [f.to_json() for f in port_over_ref_findings
           if f.checker == checker]
    assert got == want


def test_reference_baseline_fingerprints_reproduced(port_over_ref_findings):
    data = json.loads((ROOT / "tools" / "analysis_baseline.json").read_text())
    want = {e["fingerprint"] for e in data["findings"]}
    assert want and want <= {f.fingerprint for f in port_over_ref_findings}


def _renamed(f):
    """A reference finding as it reads once src/repro/ is src/repro_torch/
    and the package ``repro`` is ``repro_torch``."""
    d = f.to_json()
    d["path"] = d["path"].replace("src/repro/", "src/repro_torch/")
    d["message"] = d["message"].replace("repro.", "repro_torch.")
    d.pop("line")
    d.pop("fingerprint")
    return d


@pytest.mark.parametrize("checker", list(CHECKERS))
def test_port_tree_findings_equal_the_renamed_reference(
        checker, ref_findings, port_findings):
    want = [_renamed(f) for f in ref_findings if f.checker == checker]
    got = [f.to_json() for f in port_findings if f.checker == checker]
    for d in got:
        d.pop("line")
        d.pop("fingerprint")
    assert got == want


def test_port_tree_reports_the_two_ck_findings_and_no_po(port_findings):
    assert sorted((f.checker, f.rule, f.symbol) for f in port_findings) == [
        ("CK", "key-collision", "Evaluator"),
        ("CK", "unkeyed-attr", "Evaluator.base_arch")]
    assert all(f.path == "src/repro_torch/core/experiment.py"
               for f in port_findings)


# --- (d) the reverted fixes on the port's tree ------------------------------
# (the unreverted tree is clean under every checker: the tests above)

@pytest.fixture(scope="module")
def port_project():
    return Project.load(PORT, "repro_torch", repo_root=ROOT)


def _with_sources(proj, replaced):
    """Re-add each (module, path, source) to ``proj``; returns the undo."""
    originals = [(m, proj.modules[m].path, proj.modules[m].source)
                 for m, _, _ in replaced]
    for m, path, src in replaced:
        proj.add_module(path, m, source=src)
    return lambda: [proj.add_module(p, m, source=s) for m, p, s in originals]


def test_sh_port_tree_catches_reverted_empty_plan_bug(port_project):
    path = PORT / "core" / "columns.py"
    fixed = path.read_text()
    assert "np.zeros((0, L))" in fixed
    undo = _with_sources(port_project, [(
        "repro_torch.core.columns", path,
        fixed.replace("np.zeros((0, L))", "np.zeros((0, 0))"))])
    try:
        found = sh.check(port_project)
    finally:
        undo()
    assert any(f.rule == "ctor-shape" and f.symbol == "price"
               and f.severity == Severity.ERROR
               and f.path == "src/repro_torch/core/columns.py"
               for f in found), [f.render() for f in found]


def test_mu_port_tree_catches_reverted_cache_freeze(port_project):
    cols_path = PORT / "core" / "columns.py"
    stream_path = PORT / "search" / "stream.py"
    cols, stream = cols_path.read_text(), stream_path.read_text()
    assert cols.count("freeze_arrays(self)") >= 5
    assert "self._gstack.setflags(write=False)" in stream
    undo = _with_sources(port_project, [
        ("repro_torch.core.columns", cols_path,
         cols.replace("        freeze_arrays(self)", "        pass")),
        ("repro_torch.search.stream", stream_path,
         stream.replace("self._gstack.setflags(write=False)", "pass"))])
    try:
        found = mu.check(port_project)
    finally:
        undo()
    assert any(f.rule == "cache-escape" and f.symbol == "Evaluator.traffic"
               for f in found), [f.render() for f in found]
    assert any(f.rule == "cache-escape" and f.symbol == "LatticePricer._plan"
               and "_gstack" in f.message for f in found)


def test_tables_resolve_in_the_ports_package(port_project):
    """Every package-relative table entry of the checkers names a symbol of
    the port (a renamed module would silently drop a registry seed)."""
    known = set(port_project.functions) | set(port_project.classes) | set(
        port_project.modules)
    for rel in (ck.DEFAULT_MODULES + un.DEFAULT_MODULES + sh.DEFAULT_MODULES
                + fz.DEFAULT_AXIS_CLASSES + fz.DEFAULT_EVALUATOR_CLASSES
                + mu.DEFAULT_CACHE_CLASSES + (po.DEFAULT_MODULE,)
                + tuple(sh.PARAM_VALS) + tuple(sh.RETURN_VALS)
                + tuple(sh.PARAM_SUBST)):
        assert port_project.qual(rel) in known, rel


# --- (e) the baseline and the CLI -------------------------------------------

def test_port_clean_modulo_its_baseline(port_findings):
    baseline = Baseline.load(BASELINE)
    new, suppressed, stale = baseline.split(port_findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert not stale and len(suppressed) == 2
    ref_just = {(e["checker"], e["rule"], e["symbol"]): e["justification"]
                for e in json.loads((ROOT / "tools" /
                                     "analysis_baseline.json").read_text())
                ["findings"]}
    for entry in json.loads(BASELINE.read_text())["findings"]:
        assert "TODO" not in entry["justification"].upper()
        assert validate_justification(entry["justification"])
        assert entry["justification"] == ref_just[
            entry["checker"], entry["rule"], entry["symbol"]]


def test_cli_check_exits_zero_and_stats(capsys):
    assert main(["--check", "--only", "CK,UN,FZ", "--stats"]) == 0
    out = capsys.readouterr().out
    assert "0 new finding(s), 2 baselined, 0 stale" in out
    assert "checker" in out and "all" in out
    assert main(["--only", "NOPE"]) == 2
    assert "unknown checker" in capsys.readouterr().err


@pytest.fixture
def tiny_root(tmp_path):
    """A package ``tiny`` whose ``core/experiment.py`` is the CK fixture:
    the CLI's default checkers find its one unkeyed attribute."""
    pkg = tmp_path / "tiny"
    (pkg / "core").mkdir(parents=True)
    (pkg / "core" / "experiment.py").write_text(textwrap.dedent(T1.CK_BAD))
    return pkg


def test_cli_check_fails_on_a_new_finding(tiny_root, tmp_path, capsys):
    base = tmp_path / "baseline.json"
    args = ["--root", str(tiny_root), "--baseline", str(base)]
    assert main(args + ["--check"]) == 2
    out = capsys.readouterr().out
    assert "CK/unkeyed-attr" in out and "1 new finding(s)" in out
    assert main(args + ["--write-baseline", "--justify", "accepted"]) == 0
    capsys.readouterr()
    assert main(args + ["--check", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["new"] == [] and len(doc["baselined"]) == 1


def test_write_baseline_refuses_new_entries_without_justify(tiny_root,
                                                            tmp_path,
                                                            capsys):
    baseline = tmp_path / "baseline.json"
    args = ["--root", str(tiny_root), "--baseline", str(baseline),
            "--write-baseline"]
    assert main(args) == 2
    assert "justif" in capsys.readouterr().err
    assert not baseline.exists()
    assert main(args + ["--justify", "TODO: justify or fix"]) == 2
    assert not baseline.exists()
    assert main(args + ["--justify", "accepted for this test run"]) == 0
    data = json.loads(baseline.read_text())
    assert len(data["findings"]) == 1
    assert data["findings"][0]["path"].endswith("tiny/core/experiment.py")
    assert all(e["justification"] == "accepted for this test run"
               for e in data["findings"])
    assert main(args) == 0
    assert json.loads(baseline.read_text()) == data
