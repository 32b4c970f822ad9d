"""repro_torch.analysis — the port's trace-level checks (the counterparts
of ``repro.analysis``'s).

    python -m repro_torch.analysis [--device cuda|cpu]
        [--precision-audit PATH] [--write-precision-audit]

runs, over the registered hot paths (``precision.HOT_PATHS``):

* the aten-graph precision-provenance audit (``precision-widening``),
  baselined by the committed ``PRECISION_audit_torch.json`` — every entry
  with a written reason; ``--write-precision-audit`` regenerates it,
  keeping the reasons;
* the steady-state ``retrace`` check: each hot path re-called with fresh
  same-shape tensors after a warm-up must build and load no kernel
  library (``retrace.RetraceSentinel``).

Exit 0: every widening is in the audit and no warm window compiled; 1:
an unbaselined widening or a compile event in a warm window; 2: the audit
file is rotten (another schema, a reasonless entry, or a stale entry whose
widening no longer fires).

The AST checks (``silent-fallback``, ``canonical-selection``, …) and the
runtime race tracer are not copied: ``python -m repro.analysis src/
benchmarks/ examples/`` already scans the port's sources, and the port's
concurrency tests use ``repro.analysis.races``' tracer.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, apply_baseline
from repro_torch.analysis.retrace import RetraceSentinel, steady_state_findings

__all__ = ["Finding", "RetraceSentinel", "main", "run_trace_checks",
           "steady_state_findings"]


def run_trace_checks(*, device="cpu", audit_path=None
                     ) -> Tuple[List[Finding], List[tuple]]:
    """The precision audit against ``audit_path`` (default
    ``PRECISION_audit_torch.json``) and the steady-state retrace check, on
    ``device``.  Returns ``(findings, stale audit keys)``; a rotten audit
    file raises ``ValueError``."""
    from repro_torch.analysis import precision as P
    fs = P.widening_findings(P.run_precision_audit(device=device))
    stale = apply_baseline(fs, P.load_audit(audit_path or P.AUDIT_FILE))
    fs.extend(steady_state_findings(device=device))
    return fs, stale


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.analysis import precision as P
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's trace-level checks: the precision audit "
                    "and the steady-state retrace sentinel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision-audit", default=P.AUDIT_FILE,
                    metavar="PATH",
                    help=f"committed precision-widening audit/baseline "
                         f"(default {P.AUDIT_FILE})")
    ap.add_argument("--write-precision-audit", action="store_true",
                    help="re-trace every hot path and rewrite the audit, "
                         "keeping existing reasons (new entries get TODO)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)

    if args.write_precision_audit:
        try:
            old = P.load_audit(args.precision_audit)
        except ValueError as e:
            print(f"repro_torch.analysis: previous audit unreadable, "
                  f"its reasons are dropped: {e}", file=sys.stderr)
            old = {}
        reasons = {sym: reason for (_, _, sym), reason in old.items()}
        n = P.write_audit(args.precision_audit,
                          P.run_precision_audit(device=dev), reasons)
        print(f"repro_torch.analysis: wrote {n} widening(s) to "
              f"{args.precision_audit} — replace every TODO reason before "
              f"committing")
        return 0

    try:
        fs, stale = run_trace_checks(device=dev,
                                     audit_path=args.precision_audit)
    except ValueError as e:
        print(f"repro_torch.analysis: bad precision audit: {e}",
              file=sys.stderr)
        return 2
    active = [f for f in fs if f.active]
    for f in sorted(active, key=lambda f: (f.path, f.symbol)):
        print(f)
    for key in stale:
        print(f"repro_torch.analysis: ERROR stale audit entry — {key[2]} "
              f"no longer fires; delete the entry (or fix the symbol)",
              file=sys.stderr)
    n_base = sum(1 for f in fs if f.baselined)
    n_retrace = sum(1 for f in active if f.check == "retrace")
    print(f"repro_torch.analysis: {len(active)} finding(s) ({n_base} "
          f"widening(s) in the audit, {n_retrace} warm window(s) with a "
          f"compile event) over {len(P.HOT_PATHS)} hot path(s) on {dev}")
    if stale:
        return 2
    return 1 if active else 0
