"""Orchestration for ``python -m repro_torch.analysis``: run every rule
family over a set of paths, apply the (normally empty) baseline, and
report.

Rule families:
  * PRNG-*    salt-registry audit of PRNG key creations (AST)
  * PRNG-FOLDIN-*  fold_in argument-tuple discipline per salt chain
              (duplicate constants, const/variable mixing,
              conflicting variable addresses — AST)
  * PURITY-*  host-world constructs inside what torch traces or re-runs
              (AST)
  * STRUCT-*  DeviceCohortState spec coverage against
              ``cohort_pspecs`` and dtype discipline (introspection of a
              tiny engine built on ``device``, the card by default;
              skipped with ``structure=False``)
  * INV-*     protocol invariants over a JSONL telemetry trace
              (only when ``trace=`` is given)
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.base import (Violation, apply_baseline,
                                       iter_py_files, load_baseline)


def run_analysis(paths: Sequence[str], *,
                 baseline: Optional[str] = None,
                 structure: bool = True,
                 trace: Optional[str] = None,
                 trace_d: Optional[int] = None,
                 device=None,
                 ) -> Tuple[List[Violation], List[Violation]]:
    """-> (all violations, violations remaining after the baseline)."""
    from repro_torch.analysis import (foldin, invariants, prng, purity,
                                      salts, structure as structure_mod)

    files = iter_py_files(paths) if paths else []
    violations: List[Violation] = []
    violations.extend(salts.check_registry())
    violations.extend(prng.check_files(files))
    violations.extend(foldin.check_files(files))
    violations.extend(purity.check_files(files))
    if structure:
        violations.extend(structure_mod.check_cohort_structure(device))
    if trace is not None:
        violations.extend(invariants.check_trace(trace, d=trace_d))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    keys = load_baseline(baseline) if baseline else []
    return violations, apply_baseline(violations, keys)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Parity sanitizer: PRNG salt audit, traced-code "
                    "purity, state dtype discipline, and protocol trace "
                    "invariants.")
    ap.add_argument("paths", nargs="*",
                    help=".py files or directories to lint "
                         "(e.g. src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="file of Violation keys to tolerate "
                         "(the pass ships an empty one)")
    ap.add_argument("--no-structure", action="store_true",
                    help="skip the DeviceCohortState introspection check")
    ap.add_argument("--device", default=None,
                    help="torch device of the introspected state "
                         "(default: the card; 'cpu' without one)")
    ap.add_argument("--trace", default=None,
                    help="also model-check a JSONL telemetry trace")
    ap.add_argument("--d", type=int, default=None, dest="trace_d",
                    help="the run's broadcast-lag gate d, enabling the "
                         "τ ≤ d-1 trace checks")
    ap.add_argument("--list-salts", action="store_true",
                    help="print the salt registry and exit")
    args = ap.parse_args(argv)

    if args.list_salts:
        from repro_torch.analysis.salts import REGISTRY
        for s in sorted(REGISTRY.values(), key=lambda s: s.value):
            print(f"{s.value:#10x}  {s.name:<12} {s.chain}")
            for site in s.sites:
                print(f"{'':12}  {'':<12} site: {site}")
        return 0

    if not args.paths and args.trace is None:
        ap.error("give at least one path to lint (or --trace/"
                 "--list-salts)")

    all_v, new_v = run_analysis(
        args.paths, baseline=args.baseline,
        structure=not args.no_structure,
        trace=args.trace, trace_d=args.trace_d, device=args.device)
    for v in new_v:
        print(v.format())
    suppressed = len(all_v) - len(new_v)
    if suppressed:
        print(f"({suppressed} baselined finding(s) suppressed)")
    if new_v:
        print(f"FAILED: {len(new_v)} finding(s)")
        return 1
    print(f"OK: {len(iter_py_files(args.paths)) if args.paths else 0} "
          f"file(s) clean")
    return 0
