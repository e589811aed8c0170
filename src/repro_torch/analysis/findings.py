"""Finding records, stable fingerprints, and the baseline file format.

A fingerprint identifies a finding across reformatting: it hashes the
checker, rule, repo-relative path, symbol (dotted qualname inside the
module), and message — never line numbers. Moving code within a file or
inserting comments/blank lines keeps fingerprints stable; renaming the
symbol or changing what is wrong about it produces a new fingerprint, so
stale baseline entries age out visibly instead of masking new bugs.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Dict, List, Optional, Sequence


class Severity(str, Enum):
    ERROR = "error"          # soundness hole: wrong results possible
    WARNING = "warning"      # plausible hazard; needs a human verdict
    INFO = "info"            # coverage / hygiene

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return self.value


_SEP = "\x1f"  # unit separator: cannot appear in any component


def fingerprint(checker: str, rule: str, path: str, symbol: str,
                message: str) -> str:
    """16-hex-char stable id. Line numbers are deliberately excluded."""
    blob = _SEP.join((checker, rule, path, symbol, message))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


@dataclass(frozen=True)
class Finding:
    checker: str             # "CK" | "UN" | "FZ" | "PO"
    rule: str                # e.g. "unkeyed-attr", "add-mismatch"
    severity: Severity
    path: str                # repo-relative posix path
    symbol: str              # dotted symbol inside the file ("" = module)
    message: str             # human text; MUST NOT embed line numbers
    line: int = 0            # display only; not part of the fingerprint

    @property
    def fingerprint(self) -> str:
        return fingerprint(self.checker, self.rule, self.path, self.symbol,
                           self.message)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.severity.value.upper():7s} {self.checker}/"
                f"{self.rule} {loc}{sym}: {self.message} "
                f"(fp {self.fingerprint})")

    def to_json(self) -> Dict:
        return {
            "fingerprint": self.fingerprint,
            "checker": self.checker,
            "rule": self.rule,
            "severity": self.severity.value,
            "path": self.path,
            "symbol": self.symbol,
            "message": self.message,
            "line": self.line,
        }


@dataclass
class Baseline:
    """Accepted findings. Matching is by fingerprint only; the rest of
    each entry is a human-readable record of what was accepted and why."""

    entries: Dict[str, Dict] = field(default_factory=dict)
    path: Optional[Path] = None

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls(path=path)
        data = json.loads(path.read_text())
        entries = {e["fingerprint"]: e for e in data.get("findings", [])}
        return cls(entries=entries, path=path)

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      justification: str = "accepted") -> "Baseline":
        entries = {}
        for f in findings:
            e = f.to_json()
            e.pop("line", None)
            e["justification"] = justification
            entries[f.fingerprint] = e
        return cls(entries=entries)

    def save(self, path: Path) -> None:
        doc = {
            "version": 1,
            "findings": sorted(self.entries.values(),
                               key=lambda e: (e["checker"], e["rule"],
                                              e["path"], e["fingerprint"])),
        }
        path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")

    def split(self, findings: Sequence[Finding]):
        """-> (new, suppressed, stale_fingerprints)."""
        seen = set()
        new: List[Finding] = []
        suppressed: List[Finding] = []
        for f in findings:
            if f.fingerprint in self.entries:
                seen.add(f.fingerprint)
                suppressed.append(f)
            else:
                new.append(f)
        stale = sorted(set(self.entries) - seen)
        return new, suppressed, stale
