"""The finding record and the reasoned baseline of the port's trace-level
checks (the part of ``repro.analysis.findings`` they need).

A :class:`Finding` is one rule violation.  A committed file may carry it
as accepted, keyed by ``(check, path, symbol)`` — never a line number, so
the gate survives unrelated edits — and every such entry must say why:
:func:`reasoned_entries` refuses one without a reason.
:func:`apply_baseline` marks the carried findings and returns the entries
that matched nothing (stale: the debt they document is gone).

The reference's inline suppressions (and the record's fields for them),
its AST checks and their reports are not copied: ``python -m
repro.analysis`` scans the port's sources as well.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple


@dataclasses.dataclass
class Finding:
    check: str
    path: str                 # repo-relative posix path
    line: int
    col: int
    symbol: str               # the key the baseline matches
    message: str
    baselined: bool = False

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.check, self.path, self.symbol)

    @property
    def active(self) -> bool:
        """True when the finding gates (not baselined)."""
        return not self.baselined

    def __str__(self) -> str:
        tag = "  [baselined]" if self.baselined else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.check} "
                f"({self.symbol}) {self.message}{tag}")


def reasoned_entries(entries: Iterable[dict], source) -> List[dict]:
    """The entries of a committed baseline, each checked for a written
    ``reason``; an entry without one is a ``ValueError``."""
    out = []
    for e in entries:
        if not str(e.get("reason", "")).strip():
            raise ValueError(
                f"entry without a reason in {source}: {e.get('symbol')!r} "
                f"— every accepted finding must say why")
        out.append(e)
    return out


def apply_baseline(findings: Iterable[Finding],
                   baseline: Dict[Tuple[str, str, str], str]
                   ) -> List[Tuple[str, str, str]]:
    """Mark baselined findings in place; return stale baseline keys (entries
    that matched nothing — candidates for deletion)."""
    hit = set()
    for f in findings:
        if f.key in baseline:
            f.baselined = True
            hit.add(f.key)
    return [k for k in baseline if k not in hit]
