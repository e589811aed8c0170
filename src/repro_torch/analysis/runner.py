"""Orchestration + CLI for the static-analysis pass, port of
``repro.analysis.runner``.

``run_analysis`` loads the source tree into one :class:`Project`, as the
package its root directory names (``src/repro_torch`` as ``repro_torch``
by default, ``--root src/repro`` as ``repro``), and runs the registered
checkers; ``main`` wraps it with baseline handling:

* default       — print every finding with its baseline status
* ``--check``   — exit 2 if any finding is not in the baseline
* ``--write-baseline`` — accept the current findings into the baseline;
  NEW entries require ``--justify`` with a real (non-TODO) justification
* ``--only CK,SH`` — restrict the run to a subset of checkers
* ``--stats``   — print a findings-per-checker/severity summary
* ``--json``    — machine-readable output
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis import ck, fz, mu, po, sh, un
from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.project import Project

_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}

# name -> runner; the registry order is the run order (interprocedural
# checkers share the Project's lazily-built call-site cache, so running
# them on one Project instance amortizes the fixpoint substrate)
CHECKERS = {
    "CK": lambda proj, tests_dir, pattern: ck.check(proj),
    "UN": lambda proj, tests_dir, pattern: un.check(proj),
    "FZ": lambda proj, tests_dir, pattern: fz.check(proj),
    "PO": lambda proj, tests_dir, pattern: po.check(proj, tests_dir,
                                                    pattern=pattern),
    "SH": lambda proj, tests_dir, pattern: sh.check(proj),
    "MU": lambda proj, tests_dir, pattern: mu.check(proj),
}


def parse_only(spec: Optional[str]) -> List[str]:
    """Validate a ``--only CK,SH`` spec against the registry."""
    if spec is None:
        return list(CHECKERS)
    names = [tok.strip().upper() for tok in spec.split(",") if tok.strip()]
    unknown = [n for n in names if n not in CHECKERS]
    if not names or unknown:
        raise ValueError(
            f"unknown checker(s) {unknown or spec!r}; "
            f"available: {','.join(CHECKERS)}")
    return names


def stats_table(findings: Sequence[Finding]) -> str:
    """Findings-per-checker/severity summary (one line per checker)."""
    sevs = list(_SEV_ORDER)
    counts: Dict[str, Dict[str, int]] = {}
    for f in findings:
        counts.setdefault(f.checker, dict.fromkeys(sevs, 0))
        counts[f.checker][f.severity.value] += 1
    lines = [f"{'checker':8s} " + " ".join(f"{s:>8s}" for s in sevs)
             + f" {'total':>8s}"]
    for name in sorted(counts):
        row = counts[name]
        lines.append(f"{name:8s} "
                     + " ".join(f"{row[s]:8d}" for s in sevs)
                     + f" {sum(row.values()):8d}")
    total = dict.fromkeys(sevs, 0)
    for row in counts.values():
        for s in sevs:
            total[s] += row[s]
    lines.append(f"{'all':8s} "
                 + " ".join(f"{total[s]:8d}" for s in sevs)
                 + f" {sum(total.values()):8d}")
    return "\n".join(lines)


def validate_justification(text: Optional[str]) -> str:
    """A baseline justification must be real prose: non-empty and not a
    TODO placeholder (the tests hold justification-not-TODO for the
    checked-in baseline, so a placeholder would fail CI later anyway).
    Returns the stripped text; raises ``ValueError`` otherwise."""
    if text is None or not text.strip():
        raise ValueError("baseline justification must be non-empty")
    text = text.strip()
    if "TODO" in text.upper().replace(" ", ""):
        raise ValueError(f"baseline justification must not be a TODO "
                         f"placeholder, got {text!r}")
    return text


def _default_roots():
    """(package_root, repo_root, tests_dir) inferred from this file."""
    pkg = Path(__file__).resolve().parent.parent        # .../src/repro_torch
    repo = pkg.parent.parent                            # .../
    return pkg, repo, repo / "tests"


def run_analysis(package_root: Optional[Path] = None,
                 tests_dir: Optional[Path] = None,
                 repo_root: Optional[Path] = None,
                 only: Optional[Sequence[str]] = None,
                 tests_pattern: str = po.DEFAULT_PATTERN) -> List[Finding]:
    """Run the registered checkers over the package at ``package_root``
    (``repro_torch`` by default), named after its directory; sorted
    findings.

    ``only`` restricts to a subset of :data:`CHECKERS` names (all by
    default); unknown names raise ``ValueError``. ``tests_pattern`` is
    the glob of the test files PO reads (the port's own tests by
    default; ``"test_*.py"`` is the reference's setting).
    """
    pkg_default, repo_default, tests_default = _default_roots()
    package_root = Path(package_root or pkg_default).resolve()
    repo_root = repo_root or repo_default
    tests_dir = tests_dir or tests_default
    names = list(CHECKERS) if only is None else list(only)
    unknown = [n for n in names if n not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown checker(s) {unknown}; "
                         f"available: {','.join(CHECKERS)}")
    proj = Project.load(package_root, package_root.name,
                        repo_root=repo_root)
    findings: List[Finding] = []
    for name in CHECKERS:
        if name in names:
            findings += CHECKERS[name](proj, tests_dir, tests_pattern)
    findings.sort(key=lambda f: (_SEV_ORDER.get(f.severity.value, 9),
                                 f.checker, f.rule, f.path, f.symbol,
                                 f.fingerprint))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    pkg_default, repo_default, tests_default = _default_roots()
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="Static analysis for the pricing stack "
                    "(CK cache keys, UN units, FZ frozen axes, "
                    "PO parity coverage, SH symbolic shapes, "
                    "MU cache-aliasing/mutation).")
    ap.add_argument("--root", type=Path, default=pkg_default,
                    help="package root to analyze, named after its "
                         "directory (default: src/repro_torch)")
    ap.add_argument("--tests", type=Path, default=tests_default,
                    help="tests directory for PO coverage")
    ap.add_argument("--baseline", type=Path,
                    default=Path(__file__).resolve().parent /
                    "baseline.json",
                    help="baseline file of accepted findings")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on any non-baselined finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline file "
                         "(new entries require --justify)")
    ap.add_argument("--justify", metavar="TEXT",
                    help="justification recorded on NEW baseline entries; "
                         "must be real prose, not empty/TODO")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--only", metavar="NAMES",
                    help="comma-separated checker subset to run "
                         f"(available: {','.join(CHECKERS)})")
    ap.add_argument("--stats", action="store_true",
                    help="print a findings-per-checker/severity summary")
    args = ap.parse_args(argv)

    try:
        only = parse_only(args.only)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    findings = run_analysis(package_root=args.root, tests_dir=args.tests,
                            repo_root=repo_default, only=only)
    baseline = Baseline.load(args.baseline)
    new, suppressed, stale = baseline.split(findings)

    if args.write_baseline:
        if new:
            if args.justify is None:
                print(f"error: --write-baseline would accept {len(new)} NEW "
                      f"finding(s); pass --justify with a real "
                      f"justification for them", file=sys.stderr)
                return 2
            try:
                justification = validate_justification(args.justify)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        else:
            justification = args.justify or ""
        merged = Baseline.from_findings(findings,
                                        justification=justification)
        # keep existing justifications for entries that persist
        for fp, entry in baseline.entries.items():
            if fp in merged.entries:
                merged.entries[fp] = entry
        merged.save(args.baseline)
        print(f"wrote {len(merged.entries)} entries to {args.baseline} "
              f"({len(new)} new)")
        return 0

    if args.as_json:
        doc = {"new": [f.to_json() for f in new],
               "baselined": [f.to_json() for f in suppressed],
               "stale_baseline": stale}
        print(json.dumps(doc, indent=2))
    else:
        for f in new:
            print(f.render())
        if suppressed:
            print(f"-- {len(suppressed)} baselined finding(s) suppressed "
                  f"({args.baseline.name})")
        for fp in stale:
            entry = baseline.entries[fp]
            print(f"-- stale baseline entry {fp} "
                  f"({entry.get('checker', '?')}/{entry.get('rule', '?')} "
                  f"{entry.get('symbol', '')}): no longer reported — "
                  f"remove it")
        print(f"{len(new)} new finding(s), {len(suppressed)} baselined, "
              f"{len(stale)} stale")

    if args.stats:
        print(stats_table(findings))

    if args.check and new:
        return 2
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
