"""The PyTorch port's twin of ``examples/fleet.py``, through
``repro_torch.fleet``: place tenants across a rack of SoCs, route an
open-loop trace, kill a SoC mid-trace, and watch the fleet re-host its
tenants without dropping a request.  Like the original it runs the
analytic timing model by default; ``--execute`` also runs every served
round numerically, on the CUDA card unless ``--device cpu`` puts it on the
CPU (``FleetConfig(execute=..., device=...)``).

MATCHA co-schedules N tenants on ONE multi-accelerator SoC; the fleet
layer (``repro_torch.fleet``) asks the level-up question: given a rack of
identical SoCs, which co-residency sets should exist at all, which SoC
serves each request, and what happens when a SoC dies.

The three layers, in the order this demo exercises them:

``placement``
    :func:`~repro.fleet.place_contention_aware` chooses the co-residency
    sets.  Edge weights come from measured pair contention — the
    :class:`~repro.fleet.ContentionModel` compiles each pair's joint
    plan and scores the makespan excess over the heavier member alone.
    The objective is *bottleneck utilization under balanced demand*
    (:func:`~repro.fleet.balanced_utilization`): the analytic mirror of
    the engines' co-scheduled rounds, minimized by a greedy seed, a CP
    polish (the ``meshplan`` coverage/capacity constraint shape with
    SoCs as devices and tenants as tiles), and move/swap local search.

``router``
    :class:`~repro.fleet.FleetRouter` dispatches each request to the
    accepting host with the lowest *round-structured* completion
    estimate (own-queue depth x joint-round cost, plus the round
    dilation the request inflicts on queued co-residents), warm cached
    plans attracting traffic.  The placement hands the router its
    ``demand_split`` — the per-SoC demand shares whose bottleneck
    utilization the placement optimized — and the router paces dispatch
    toward those shares.

``rebalance``
    :class:`~repro.fleet.FleetRebalancer` handles drain/failure: queued
    work on a dead SoC is drained and requeued through the router with
    absolute deadlines preserved, orphaned classes re-host on the
    surviving SoC that dilutes capacity least (cache-hit rebind, or a
    fresh compile warm-started from the solutions sidecars donated by
    the dead SoC's session), and per-event recovery latency is measured
    in the same shape as the training supervisor's ``RunReport``.

Run:  python examples/fleet_torch.py [--execute] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.fleet import (ContentionModel, FailureEvent,  # noqa: E402
                               Fleet, FleetConfig, FleetRebalancer,
                               FleetRouter, PlanCache,
                               place_contention_aware, replay_open_loop)
from repro_torch.models import edge  # noqa: E402
from repro_torch.serve.admission import Priority  # noqa: E402
from repro_torch.soc.carfield import (carfield_patterns,  # noqa: E402
                                      carfield_soc)

CLASSES = ("autoencoder", "ds_cnn", "mobilenet", "resnet")
HIGH = "mobilenet"                        # deadline-carrying class


def make_config(n_socs: int = 4, execute: bool = False,
                device="cuda") -> FleetConfig:
    return FleetConfig(
        soc_factory=lambda: (carfield_soc(), carfield_patterns()),
        n_socs=n_socs, capacity=2, requested_tiles=8,
        time_budget_s=0.5, joint_time_budget_s=1.0,
        lazy_joint_time_budget_s=0.5, incremental_time_budget_s=0.5,
        execute=execute, device=device)


def place(config: FleetConfig, classes=CLASSES):
    """(the classes' graphs, plan cache, contention model, placement) of
    one replica of each class over the config's SoCs."""
    graphs = [edge.ALL_MODELS[m]() for m in classes]
    cache = PlanCache(config, graphs)
    contention = ContentionModel(cache)
    placement = place_contention_aware(list(classes), config.n_socs,
                                       config.capacity, contention)
    return graphs, cache, contention, placement


def make_trace(contention, classes=CLASSES, high: str = HIGH,
               horizon_s: float = 8.0):
    """Each class at ~1/3 of its alone rate until ``horizon_s``, ``high``
    HIGH with a deadline of 2.5 x its alone time."""
    deadline_s = 2.5 * contention.alone_s(high)
    trace = []
    for c in classes:
        period = 3.0 * contention.alone_s(c)      # ~1/3 utilization each
        t = 0.4 * period
        while t < horizon_s:
            trace.append((t, c, Priority.HIGH if c == high
                          else Priority.NORMAL,
                          deadline_s if c == high else None))
            t += period
    return trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--execute", action="store_true",
                    help="run every served round numerically, not just "
                         "the analytic timing model")
    ap.add_argument("--device", default="cuda",
                    help="where the parameters live and --execute runs: "
                         "cuda, or cpu")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    config = make_config(execute=args.execute, device=args.device)

    # -- placement: one replica of each class over 4 SoCs ------------------
    graphs, cache, contention, placement = place(config)
    print("measured pair contention (round excess over heavier alone):")
    for pair, stats in contention.edges().items():
        print(f"  {pair:26s} excess {stats['excess_s'] * 1e3:7.3f} ms   "
              f"slowdown {stats['slowdown']:.2f}x")
    print(f"\ncontention-aware placement (max rho "
          f"{placement.max_rho:.3f}):")
    for soc_id, names in enumerate(placement.assignment):
        print(f"  soc{soc_id}: {' + '.join(names) if names else '(spare)'}")

    # -- route an open-loop trace, killing a SoC halfway -------------------
    fleet = Fleet(config, graphs, cache=cache, contention=contention)
    fleet.apply_placement(placement)
    router = FleetRouter(fleet, split=placement.demand_split)
    rebalancer = FleetRebalancer(fleet, router)

    trace = make_trace(contention)
    victim = fleet.hosts_of(HIGH)[0].soc_id
    t_fail = 4.0
    print(f"\nreplaying {len(trace)} requests over 8s; "
          f"SoC {victim} (hosting {HIGH}) dies at t={t_fail:.1f}s ...")
    summary = replay_open_loop(
        fleet, router, trace,
        failures=[FailureEvent(at_s=t_fail, soc_id=victim, kind="fail")],
        rebalancer=rebalancer)

    # -- what happened -----------------------------------------------------
    audit = summary["router"]
    print(f"\nserved {summary['served']}, dropped {audit['dropped']}, "
          f"requeued {audit['requeued']} "
          f"(warm routes {audit['warm_routes']}, cold "
          f"{audit['cold_routes']})")
    att = summary["per_class"]["HIGH"]["slo_attainment"]
    print(f"HIGH-class deadline attainment: "
          f"{'-' if att is None else format(att, '.1%')}")
    for m in rebalancer.stats()["records"]:
        how = ("cache-hit rebind" if m["cache_hit"] else
               f"fresh compile, {m['seeded_occupancies']} sidecar "
               f"occupancies seeded")
        print(f"migration: {m['class_name']} soc{m['src_soc']} -> "
              f"soc{m['dst_soc']} at t={m['at_s']:.2f}s ({how}, "
              f"recovery {m['recovery_s'] * 1e3:.1f} ms, analyzer "
              f"errors {m['analyzer_errors']})")
    print(f"fleet makespan: {fleet.makespan_s():.3f} s")
    return summary


if __name__ == "__main__":
    main()
