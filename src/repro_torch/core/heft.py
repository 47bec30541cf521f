"""HEFT-style all-or-nothing device assignment (an async-aware candidate).

The stage-1 CP objective (max per-device load) assumes perfect overlap and
is blind to dependency chains, so for *layer-granularity* async offloading
(MATCHA-no-tiling) it tends to balance loads in ways that stage-2 cannot
overlap.  This module produces the classic HEFT assignment instead: chain
groups are ranked by upward rank and greedily placed on the device that
minimizes their *finish time* given device availability and predecessor
completion — which is exactly what discovers "shortcut conv on PULP while
the main path runs on Spatz" graph-level parallelism (§1).

The result is packaged as a TilingSolution (every group keeps all its tiles
on one device), so the standard rewrite -> schedule -> arbitration pipeline
applies unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import Graph
from repro_torch.core.patterns import Pattern
from repro_torch.core.tiling import (Assignment, TilingSolution, _MVar,
                               build_match_vars, chain_groups)
from repro_torch.soc.device import SoC


def heft_solution(g: Graph, soc: SoC, patterns: Sequence[Pattern],
                  requested_tiles: int = 16,
                  fuse_joins: bool = True) -> TilingSolution:
    mvars = build_match_vars(g, soc, patterns, requested_tiles)
    groups = chain_groups(g, mvars, fuse_joins=fuse_joins)

    # group graph: group index -> predecessor group indices
    op2group: Dict[str, int] = {}
    for gi, (ops, _) in enumerate(groups):
        for o in ops:
            op2group[o] = gi
    preds: List[set] = [set() for _ in groups]
    for gi, (ops, _) in enumerate(groups):
        for o in ops:
            for p in g.predecessors(g.ops[o]):
                pg = op2group[p.name]
                if pg != gi:
                    preds[gi].add(pg)

    # durations per device (best match per device, all tiles)
    durs: List[Dict[str, Tuple[float, _MVar]]] = []
    for ops, cands in groups:
        by_dev: Dict[str, Tuple[float, _MVar]] = {}
        for mv in cands:
            d = mv.match.pattern.device
            dur = mv.slope * mv.T + mv.delta
            if d not in by_dev or dur < by_dev[d][0]:
                by_dev[d] = (dur, mv)
        durs.append(by_dev)

    # upward ranks on the group DAG
    succs: List[set] = [set() for _ in groups]
    for gi, ps in enumerate(preds):
        for p in ps:
            succs[p].add(gi)
    rank = [0.0] * len(groups)
    topo = sorted(range(len(groups)),
                  key=lambda gi: min((g._order.index(o) for o in groups[gi][0]
                                      if o in g._order), default=0))
    for gi in reversed(topo):
        avg = sum(d for d, _ in durs[gi].values()) / max(len(durs[gi]), 1)
        rank[gi] = avg + max((rank[s] for s in succs[gi]), default=0.0)

    # HEFT list scheduling: insertion-free (end-of-queue) variant
    avail: Dict[str, float] = {d: 0.0 for d in soc.devices}
    finish = [0.0] * len(groups)
    choice: List[Optional[_MVar]] = [None] * len(groups)
    for gi in sorted(range(len(groups)), key=lambda i: -rank[i]):
        ready = max((finish[p] for p in preds[gi]), default=0.0)
        best_d, best_ft, best_mv = None, None, None
        for d, (dur, mv) in durs[gi].items():
            ft = max(ready, avail[d]) + dur
            if best_ft is None or ft < best_ft:
                best_d, best_ft, best_mv = d, ft, mv
        avail[best_d] = best_ft
        finish[gi] = best_ft
        choice[gi] = best_mv

    assignments = [Assignment(mv.match, mv.T) for mv in choice
                   if mv is not None]
    tiles_per_op: Dict[str, int] = {}
    for (ops, _), mv in zip(groups, choice):
        for o in ops:
            tiles_per_op[o] = mv.T
    return TilingSolution(mode="matcha_nt", assignments=assignments,
                          tiles_per_op=tiles_per_op,
                          objective=max(finish, default=0.0),
                          optimal=False, solver_nodes=0, wall_s=0.0)
