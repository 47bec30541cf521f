"""Mutation harness: prove every analyzer rule has teeth.

A validator that only ever sees valid plans proves nothing — a rule
could be dead code (always returning clean) and the test suite would
stay green.  This module injects one seeded, *minimal* instance of each
hazard class into a known-good plan and asserts the corresponding rule
fires.  ``check_rules(plan)`` runs the whole battery; a rule that fails
to flag its own mutation is a regression in the analyzer, not the plan.

Mutations operate on a structural clone (nodes, dmas, memory rectangles
are copied; the tiled graphs are shared read-only), so the input plan is
never modified.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List

from repro_torch.analysis.plan_analyzer import analyze, summarize


def clone_plan(plan):
    """Structural deep-ish copy: everything the analyzer (and a mutator)
    touches is fresh; the tenant/tiled graphs are shared read-only."""
    nodes = {k: dataclasses.replace(
        v, preds=list(v.preds), reads=list(v.reads),
        writes=list(v.writes), l3_traffic=list(v.l3_traffic))
        for k, v in plan.nodes.items()}
    memory = dataclasses.replace(
        plan.memory,
        allocations=[dataclasses.replace(a)
                     for a in plan.memory.allocations],
        swaps=list(plan.memory.swaps))
    fields = dict(nodes=nodes, order=list(plan.order),
                  dmas=[dataclasses.replace(d) for d in plan.dmas],
                  memory=memory, busy=dict(plan.busy))
    if hasattr(plan, "tenants"):
        fields.update(tenants=list(plan.tenants),
                      tenant_makespans=list(plan.tenant_makespans),
                      budgets=list(plan.budgets))
    return dataclasses.replace(plan, **fields)


def _dma_cls(plan):
    """The plan's ScheduledDma type without importing the scheduler."""
    if plan.dmas:
        return type(plan.dmas[0])
    from repro_torch.core.schedule import ScheduledDma
    return ScheduledDma


def _pick(rng: random.Random, items: list):
    if not items:
        raise ValueError("no mutation site in this plan")
    return items[rng.randrange(len(items))]


# --- one mutator per rule --------------------------------------------------
# Each takes (plan_clone, rng), mutates in place, and must make its rule
# fire.  Collateral findings under other rules are fine — the harness
# asserts the *target* rule is among those that fire.


def _mut_precedence(plan, rng) -> None:
    """Slide a node to start strictly before one of its preds ends."""
    sites = [n for n in plan.nodes.values()
             if n.start >= 0 and any(
                 plan.nodes[p].end > 1e-3 for p in n.preds)]
    n = _pick(rng, sites)
    p = max((plan.nodes[p] for p in n.preds), key=lambda m: m.end)
    n.start = p.end - max(p.duration, 1.0) / 2.0
    n.end = n.start + n.duration


def _mut_resource_overlap(plan, rng) -> None:
    """Slide a node onto its same-resource predecessor-in-time."""
    by_res: Dict[str, list] = {}
    for n in plan.nodes.values():
        if n.start >= 0 and n.duration > 1e-3:
            by_res.setdefault(n.resource, []).append(n)
    pairs = []
    for ns in by_res.values():
        ns.sort(key=lambda n: n.start)
        pairs.extend(zip(ns, ns[1:]))
    a, b = _pick(rng, pairs)
    b.start = a.start + a.duration / 2.0
    b.end = b.start + b.duration


def _mut_data_hazard(plan, rng) -> None:
    """Inject a swap-out of a tensor mid-way through a node reading it."""
    streamed = {t for n in plan.nodes.values() for t, _, _ in n.l3_traffic}
    sites = [n for n in plan.nodes.values()
             if n.start >= 0 and n.duration > 1e-3
             and any(t not in streamed for t in n.reads)]
    n = _pick(rng, sites)
    t = next(t for t in n.reads if t not in streamed)
    mid0 = n.start + n.duration / 4.0
    mid1 = n.start + n.duration / 2.0
    plan.dmas.append(_dma_cls(plan)(t, "out", mid0, mid1, 64))


def _mut_use_after_evict(plan, rng) -> None:
    """Close a read tensor's residency rectangle mid-read."""
    rects: Dict[str, list] = {}
    for a in plan.memory.allocations:
        rects.setdefault(a.tensor, []).append(a)
    sites = []
    for n in plan.nodes.values():
        if n.start < 0 or n.duration <= 1e-3:
            continue
        for t in n.reads:
            for a in rects.get(t, ()):
                if a.t_alloc <= n.start and n.end <= a.t_free:
                    sites.append((n, a))
    n, a = _pick(rng, sites)
    cut = (n.start + n.end) / 2.0
    for b in rects[a.tensor]:                 # no other rect may cover it
        if b.t_free > cut:
            b.t_free = cut


def _mut_aliasing(plan, rng) -> None:
    """Re-address one allocation on top of a concurrently-live one."""
    allocs = [a for a in plan.memory.allocations if a.size > 0]
    pairs = [(a, b) for i, a in enumerate(allocs)
             for b in allocs[i + 1:]
             if a.t_alloc < b.t_free - 1e-6
             and b.t_alloc < a.t_free - 1e-6
             and a.tensor != b.tensor]
    if pairs:
        a, b = _pick(rng, pairs)
        b.addr = a.addr
    else:                                     # no co-live pair: make one
        a, b = _pick(rng, [(a, b) for i, a in enumerate(allocs)
                           for b in allocs[i + 1:] if a.tensor != b.tensor])
        b.addr, b.t_alloc, b.t_free = a.addr, a.t_alloc, a.t_free


def _mut_isolation(plan, rng) -> None:
    """Tag an allocation with a co-resident tenant's owner id."""
    if not hasattr(plan, "tenants"):
        raise ValueError("PA006 applies to multi-tenant plans only")
    a = _pick(rng, list(plan.memory.allocations))
    a.owner = (a.owner + 1) % max(len(plan.tenants), 2)


def _mut_cycle(plan, rng) -> None:
    """Close a 2-cycle between a node and one of its predecessors."""
    sites = [n for n in plan.nodes.values() if n.preds]
    n = _pick(rng, sites)
    plan.nodes[n.preds[0]].preds.append(n.name)


def _mut_double_buffer(plan, rng) -> None:
    """Schedule a planned load into a buffer outside its residency."""
    horizon = plan.makespan + 100.0
    a = _pick(rng, [a for a in plan.memory.allocations
                    if a.t_free < horizon])
    plan.dmas.append(_dma_cls(plan)(
        a.tensor, "in", horizon + 10.0, horizon + 20.0, a.size or 64))


MUTATORS: Dict[str, Callable] = {
    "PA001": _mut_precedence,
    "PA002": _mut_resource_overlap,
    "PA003": _mut_data_hazard,
    "PA004": _mut_use_after_evict,
    "PA005": _mut_aliasing,
    "PA006": _mut_isolation,
    "PA007": _mut_cycle,
    "PA008": _mut_double_buffer,
}


def mutate(plan, rule: str, seed: int = 0):
    """A fresh clone of ``plan`` with ``rule``'s hazard injected."""
    mutant = clone_plan(plan)
    MUTATORS[rule](mutant, random.Random((seed, rule).__hash__()))
    return mutant


def check_rules(plan, seed: int = 0,
                rules: List[str] = None) -> Dict[str, bool]:
    """Run the battery: for each rule, inject its hazard and ask whether
    the analyzer flags it.  Returns rule -> fired."""
    rules = list(rules or MUTATORS)
    out: Dict[str, bool] = {}
    for rule in rules:
        if rule == "PA006" and not hasattr(plan, "tenants"):
            continue
        fired = summarize(analyze(mutate(plan, rule, seed)))
        out[rule] = rule in fired
    return out
