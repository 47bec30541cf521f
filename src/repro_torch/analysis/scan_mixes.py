"""CI gate: compile the benchmark model mixes and run the static plan
analyzer over every schedule the session emits.

For each mix recorded in ``benchmarks/baseline.json`` (the same four
MLPerf-Tiny mixes ``benchmarks.multi_tenant`` reports on), this tool
compiles the mix onto the Carfield SoC, then analyzes

  * the full-house co-schedule,
  * every partial-occupancy co-schedule ``plan_for`` serves (all
    non-empty tenant subsets, which also exercises the PlanStore's
    lazy subset compiles), and
  * each tenant's compile-alone plan,

and exits non-zero if any plan carries an ERROR-severity diagnostic
(PA001-PA008 — see :mod:`repro_torch.analysis.plan_analyzer`).  WARNING-level
findings (e.g. PA006 soft-budget peaks) are printed but do not fail the
gate.  The session itself runs in ``"warn"`` analysis mode here so a
hazardous plan is reported by this scanner rather than aborting the
compile mid-mix.

    PYTHONPATH=src python -m repro_torch.analysis.scan_mixes \
        [--baseline benchmarks/baseline.json] [--time-budget 0.5]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis import Severity, analyze, summarize


def mixes_from_baseline(path: str) -> List[Tuple[str, ...]]:
    """The distinct model mixes recorded under the baseline's ``mixes``
    section, in recorded order."""
    with open(path) as f:
        base = json.load(f)
    out: List[Tuple[str, ...]] = []
    for row in base.get("mixes", []):
        mix = tuple(row["mix"])
        if mix not in out:
            out.append(mix)
    return out


def plans_for_mix(mix: Tuple[str, ...], time_budget_s: float
                  ) -> Iterable[Tuple[str, object]]:
    """Yield ``(label, plan)`` for every schedule the session emits for
    ``mix``: full house, every non-empty occupancy, and each tenant's
    compile-alone plan."""
    from repro_torch.core.api import compile_multi
    from repro_torch.models import edge
    from repro_torch.soc.carfield import carfield_patterns, carfield_soc

    graphs = [edge.ALL_MODELS[m]() for m in mix]
    mc = compile_multi(graphs, carfield_soc(), carfield_patterns(),
                       time_budget_s=time_budget_s, analysis="warn")
    yield "full-house", mc.plan
    n = len(mix)
    for r in range(1, n):
        for ids in itertools.combinations(range(n), r):
            yield f"occupancy {list(ids)}", mc.plan_for(list(ids))
    for name, cm in zip(mix, mc.singles):
        yield f"single {name}", cm.plan


def scan(mixes: List[Tuple[str, ...]], time_budget_s: float,
         out=sys.stdout) -> int:
    """Analyze every plan of every mix; returns the total ERROR count."""
    total_errors = 0
    for mix in mixes:
        print(f"mix: {' + '.join(mix)}", file=out)
        for label, plan in plans_for_mix(mix, time_budget_s):
            diags = analyze(plan)
            errs = [d for d in diags if d.severity >= Severity.ERROR]
            total_errors += len(errs)
            counts: Dict[str, int] = summarize(diags)
            tag = ("clean" if not diags
                   else " ".join(f"{r}x{c}" for r, c in sorted(
                       counts.items())))
            print(f"  {label:28s} {tag}", file=out)
            for d in diags:
                print(f"    {d}", file=out)
    return total_errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="static plan analysis over the benchmark mixes")
    ap.add_argument("--baseline", default="benchmarks/baseline.json",
                    help="baseline JSON whose 'mixes' section names the "
                         "model mixes to scan")
    ap.add_argument("--time-budget", type=float, default=0.5,
                    help="per-tenant stage-1 tiling budget (seconds)")
    args = ap.parse_args(argv)
    mixes = mixes_from_baseline(args.baseline)
    if not mixes:
        print(f"no mixes found in {args.baseline}", file=sys.stderr)
        return 2
    errors = scan(mixes, args.time_budget)
    if errors:
        print(f"scan_mixes: {errors} ERROR diagnostic(s)", file=sys.stderr)
        return 1
    print("scan_mixes: all plans clean (no ERROR diagnostics)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
