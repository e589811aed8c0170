"""Static analysis for the pricing stack (stdlib ``ast`` only), port of
``repro.analysis``: the same six checkers, rules, messages and
fingerprints, run over ``src/repro_torch`` by default.

Six checkers guard the bug classes that have bitten this repo before:

* **CK** (`ck.py`) — cache-key soundness: every ``DesignPoint`` /
  ``SystemPoint`` attribute a memoized computation reads must be folded
  into its cache key, and caches sharing one dict must have
  non-colliding key shapes.
* **UN** (`un.py`) — unit/dimension analysis over the energy algebra:
  no pJ+W additions, no kB x pJ/bit products assigned to ``*_pj`` names
  without the x8192 conversion.
* **FZ** (`fz.py`) — frozen-axis invariants: DSE-axis dataclasses must
  be ``frozen=True`` with recursively hashable fields; memoizing
  classes may not mutate ``self`` outside their declared cache dicts.
* **PO** (`po.py`) — parity-oracle coverage: every public columnar
  symbol in ``core/columns.py`` must be referenced by at least one of the
  port's tests (``tests/test_torch_*.py``).
* **SH** (`sh.py`) — symbolic shape/broadcast dataflow over the
  (P, L, G, N, W, S, R, K, Q) axis vocabulary: incompatible broadcasts,
  unintended rank promotion, axis-mismatched reductions / ``bincount``
  lengths, reshapes that don't factor, ctor/return shape contracts.
* **MU** (`mu.py`) — cache-aliasing / mutation soundness: per-function
  mutation summaries over the call graph; arrays reachable from
  Evaluator/LatticePricer caches must not escape to mutating callers
  (the static precondition for the shared-LRU serving engine).

SH and MU are interprocedural: they run on per-function summaries
computed bottom-up over the resolved call graph (``Project.fixpoint``).

The checkers' tables name modules and symbols relative to the package
(``"core.experiment"``); the package's name comes from the root that is
loaded, so the same checkers analyse either tree:

    PYTHONPATH=src python -m repro_torch.analysis [--check] [--stats]
    PYTHONPATH=src python -m repro_torch.analysis --root src/repro \
        --baseline tools/analysis_baseline.json

Accepted findings of the port live in ``analysis/baseline.json`` beside
this module (see ``runner.py``); anything *new* fails ``--check``. Useful
flags: ``--only CK,SH`` to run a subset, ``--stats`` for a
per-checker/severity summary.
"""
from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.runner import main, run_analysis

__all__ = ["Finding", "Severity", "main", "run_analysis"]
