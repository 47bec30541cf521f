"""The PyTorch port's twin of ``examples/multi_tenant.py``: two DNNs
co-compiled onto ONE Carfield SoC through the deployment-session API of
``repro_torch`` and served concurrently at varying occupancy -- the
co-scheduled plan checked against each tenant alone, and the serving
engine's rounds executed numerically on the CUDA card by default (the
hand-written GEMM and RMSNorm kernels), or on the CPU with ``--device
cpu`` (their plain versions).  ``examples/multi_tenant.py``'s docstring
describes the session, the incremental re-solve, the compile pipeline,
the SLO layers and the static plan analyzer, which the port keeps as
copies of the JAX package's modules.

    python examples/multi_tenant_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.api import compile_multi  # noqa: E402
from repro_torch.core.deploy import (CompileRequest,  # noqa: E402
                                     DeploymentSession, Objective)
from repro_torch.core.runtime import multi_plan_matches_oracle  # noqa: E402
from repro_torch.models import edge  # noqa: E402
from repro_torch.serve.admission import Priority, RoundComposer  # noqa: E402
from repro_torch.serve.engine import MultiModelEngine  # noqa: E402
from repro_torch.soc.carfield import (carfield_patterns,  # noqa: E402
                                      carfield_soc)


def co_compile(graphs, soc, patterns, device, time_budget_s: float = 3.0):
    """The session API: one ``DeploymentSession`` over the tenants, its
    full house and each tenant alone compiled, the co-scheduled plan held
    to each tenant executed alone on ``device``.  Returns (session,
    compiled)."""
    request = CompileRequest(graphs=graphs, soc=soc, patterns=patterns,
                             mode="matcha", time_budget_s=time_budget_s)
    objective = Objective()            # makespan, evictions as tie-break
    session = DeploymentSession(request, objective)

    print("co-compiling", " + ".join(g.name for g in graphs),
          "onto", soc.name, "...")
    # pre-compile the useful partial occupancies alongside the full house
    mc = session.compile(precompile=[[0], [1]])
    # co-exec == each alone
    assert multi_plan_matches_oracle(mc.plan, device=device)

    print(f"\n{'model':14s} {'alone (ms)':>11s} {'co-scheduled (ms)':>18s}")
    for i, g in enumerate(graphs):
        alone = soc.cycles_to_ms(mc.singles[i].plan.makespan)
        print(f"{g.name:14s} {alone:11.2f} {mc.tenant_latency_ms(i):18.2f}")
    seq_ms = soc.cycles_to_ms(mc.sequential_makespan_cycles)
    pr1_ms = soc.cycles_to_ms(mc.baseline_makespan_cycles)
    br_ms = soc.cycles_to_ms(mc.best_response_makespan_cycles)
    print(f"\nround makespan: {seq_ms:.2f} ms sequential -> "
          f"{pr1_ms:.2f} ms co-scheduled -> "
          f"{br_ms:.2f} ms best-response re-tiled -> "
          f"{mc.runtime_ms:.2f} ms joint "
          f"({mc.speedup:.2f}x, origin={mc.plan.origin}, "
          f"{session.hint_rounds} hint round(s), "
          f"joint={mc.joint_stats()}, L2 budgets = "
          f"{[b // 1024 for b in mc.plan.budgets]} KiB)")
    util = mc.plan.utilization()
    print("utilization: " + "  ".join(f"{d}={u:.0%}"
                                      for d, u in sorted(util.items())))
    return session, mc


def replay_occupancies(session, graphs, soc) -> None:
    """Any occupancy gets a validated co-schedule from the plan store;
    replaying a churny trace (tenants leaving/returning one at a time)
    only compiles each occupancy once."""
    for active in ([0, 1], [0], [1], [0, 1], [0], [1]):
        plan = session.plan_for(active)
        names = " + ".join(graphs[i].name for i in active)
        print(f"plan_for({active}): {names:28s} "
              f"{soc.cycles_to_ms(plan.makespan):8.2f} ms")

    # incremental re-solve: each subset miss above warm-started from the
    # Hamming-nearest cached occupancy's tiling solutions (here the full
    # house — recorded in the plan store's non-evicting sidecar) instead
    # of re-tiling from scratch
    for ev in session.miss_events:
        print(f"miss {ev['occupancy']}: warm={ev['warm']} "
              f"neighbor={ev['neighbor']} origin={ev['origin']} "
              f"compiled in {ev['wall_s'] * 1e3:.0f} ms")
    lat = session.compile_latency_stats()
    print(f"miss compile latency: p50 {lat['p50_ms']:.0f} ms  "
          f"p99 {lat['p99_ms']:.0f} ms  "
          f"({lat['warm']['count']} warm / {lat['cold']['count']} cold; "
          f"L2 split wins: proportional {lat['prop_split_wins']}, "
          f"equal {lat['equal_split_wins']})")


def serve_mixed(mc, device) -> dict:
    """Serve a mixed-tenant workload, each round executed numerically on
    ``device``; the uneven tail is a real (cached) occupancy-1 dispatch,
    not a compile-alone fallback.  Returns the engine's report."""
    eng = MultiModelEngine(mc, device=device)
    for _ in range(3):
        eng.submit("autoencoder")
        eng.submit("ds_cnn")
    eng.submit("autoencoder")           # one tenant deeper than the other
    eng.run()
    rep = eng.report()
    print(f"\nserved {rep['served']} requests: "
          f"{rep['co_rounds']} co-scheduled rounds "
          f"({rep['subset_co_rounds']} at partial occupancy) + "
          f"{rep['solo_dispatches']} solo dispatches, "
          f"{rep['throughput_inf_per_s']:.1f} inf/s aggregate")
    for t in rep["per_tenant"]:
        print(f"  {t['model']:14s} served={t['served']}  "
              f"mean latency {t['mean_latency_ms']:.2f} ms")
    print(f"plan store: {rep['plan_store']}")
    ana = rep["analysis"]
    print(f"plan analysis ({ana['mode']}): {ana['plans_analyzed']} plans "
          f"analyzed, {ana['errors']} errors, "
          f"{ana['warnings']} warnings ({ana['by_rule'] or 'clean'})")
    return rep


def serve_slo(mc, soc, device) -> dict:
    """SLO-aware serving: priorities, deadlines, async compiles.  The
    autoencoder is latency-critical (HIGH, deadline between its
    compile-alone latency and its co-scheduled completion); ds_cnn
    submits a deadline-less backlog.  The deadline-driven composer
    fast-paths the HIGH requests where FIFO would co-schedule them behind
    the backlog.  Returns the engine's report."""
    alone_s = soc.cycles_to_ms(mc.singles[0].plan.makespan) / 1e3
    co_s = soc.cycles_to_ms(mc.plan.tenant_makespans[0]) / 1e3
    deadline_s = 0.5 * (alone_s + co_s)
    slo = MultiModelEngine(mc, composer=RoundComposer(), execute=False,
                           device=device)
    for _ in range(4):
        slo.submit("ds_cnn")
    for _ in range(3):
        slo.submit("autoencoder", priority=Priority.HIGH,
                   deadline_s=deadline_s)
    slo.run()
    srep = slo.report()
    high = srep["per_class"]["HIGH"]
    print(f"\nSLO serving: HIGH deadline {deadline_s * 1e3:.2f} ms -> "
          f"attainment {high['slo_attainment']:.0%} "
          f"(p99 e2e {high['p99_e2e_ms']:.2f} ms), "
          f"{srep['starvation_events']} starvation events, "
          f"composer {srep['composer']}")
    return srep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the plans execute: cuda, or cpu")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")

    soc = carfield_soc()
    patterns = carfield_patterns()
    graphs = [edge.autoencoder(), edge.ds_cnn()]
    session, mc = co_compile(graphs, soc, patterns, args.device)
    replay_occupancies(session, graphs, soc)
    rep = serve_mixed(mc, args.device)
    srep = serve_slo(mc, soc, args.device)

    # -- legacy wrapper, still working ------------------------------------
    mc2 = compile_multi(graphs, soc, patterns, time_budget_s=3.0)
    print(f"\ncompile_multi wrapper: same winning makespan = "
          f"{mc2.runtime_ms:.2f} ms "
          f"(session-backed: {mc2.session is not None})")
    return {"compiled": mc, "session": session, "report": rep,
            "slo_report": srep}


if __name__ == "__main__":
    main()
