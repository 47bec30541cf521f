"""Tile-centric pattern matching + device allocation (paper §3.1, Eqs. 1-2).

Every IR operator ``v`` is partitioned into ``T_v`` equal tiles along its
tiling axis (feature-map rows for convolutions, output neurons for dense
layers).  For each pattern match ``m`` of pattern ``p`` a nonnegative integer
variable ``t_{p,m}`` counts the tiles assigned to it; Eq. (1) conserves tiles
per operator and Eq. (2) prices a match linearly:

    L_{p,m}(t) = t * (sum_u Ops_{h_m(u)} / T_{h_m(u)}) * alpha_{d_p} / eta_p
                 + delta_p        (charged only when the match is instantiated)

The objective is the makespan = max over devices of the summed match
latencies (stage 1 assumes perfect asynchronous overlap; the exact DAG
schedule with helper/DMA costs is stage 2, core.schedule).  The fixed charge
delta_p is linearised with a 0/1 indicator ``y`` and ``t <= T * y``.

Modes reproduce the paper's four toolchains:
  * ``tvm``       — host wildcard only, sequential (objective = total time),
  * ``match``     — best device per fused pattern, all-or-nothing, sequential,
  * ``matcha_nt`` — all-or-nothing + asynchronous makespan (no tiling),
  * ``matcha``    — full tile-centric optimization (this paper).

Slice/concat helper work for partial conv-family matches is charged to the
host load with a linear approximation here; the stage-2 scheduler models the
helpers exactly, and ``compile_model`` (core.api) keeps the best of the
candidate plans under the exact model — tiling therefore never loses to the
all-or-nothing corner case (§3.1: layer-device assignment *is* a corner case
of this optimization).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import cpsolver
from repro_torch.core.ir import (Graph, Op, max_tiles, needs_input_slice, op_arith,
                           tile_axis, tile_halo_rows)
from repro_torch.core.patterns import Match, Pattern, find_matches
from repro_torch.soc.device import SoC

DELTA_HELPER = 400.0  # fixed host cycles per slice/concat invocation


@dataclasses.dataclass(frozen=True)
class Contention:
    """Co-residency context for contention-aware re-tiling.

    Stage 1 normally prices each model as if it owned the whole SoC; in a
    multi-tenant compile the co-residents consume device time, shared-L2
    space, and system-DMA bandwidth.  ``core.schedule.contention_hints``
    summarizes a merged co-schedule into one of these per tenant, and
    :func:`optimize_tiling` re-prices Eq. (2) with it (cf. the shared-
    memory-contention-aware scheduling of Dagli & Belviranli,
    arXiv:2308.05869):

      * ``l2_budget`` — this tenant's slice of the shared L2 scratchpad
        (from the ``SharedL2Allocator`` budgets); chains whose working set
        exceeds it pay the swap round-trip as a fixed charge,
      * ``dma_scale`` — >= 1; multiplier on every DMA-traffic slope term
        (co-resident traffic serializes on the shared memory system),
      * ``device_load`` — co-residents' busy fraction per device in the
        merged schedule; devices loaded by co-residents get proportionally
        slower, which steers tile shares toward idler devices (the
        device-affinity hint).
    """
    l2_budget: Optional[int] = None
    dma_scale: float = 1.0
    device_load: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def device_scale(self, device: str) -> float:
        return 1.0 + max(float(self.device_load.get(device, 0.0)), 0.0)


@dataclasses.dataclass(frozen=True)
class Assignment:
    match: Match
    tiles: int


@dataclasses.dataclass
class TilingSolution:
    mode: str
    assignments: List[Assignment]
    tiles_per_op: Dict[str, int]          # T_v
    objective: float                       # stage-1 makespan estimate (cycles)
    optimal: bool
    solver_nodes: int
    wall_s: float
    # solver telemetry, mirrored from ``cpsolver.Solution`` so the
    # session can aggregate per-solve budget-exhaustion / incumbent
    # provenance without holding onto raw solver objects
    budget_exhausted: bool = False
    incumbent_source: str = "search"

    def per_device_load(self) -> Dict[str, float]:
        load: Dict[str, float] = {}
        for a in self.assignments:
            d = a.match.pattern.device
            load[d] = load.get(d, 0.0)
        return load


@dataclasses.dataclass
class _MVar:
    match: Match
    T: int
    slope: float          # cycles per tile (Eq. 2 inner term * alpha/eta)
    delta: float
    helper_slope: float   # host cycles per tile for slice+concat copies
    helper_fix: float     # host cycles fixed per helper pair
    t_var: int = -1
    y_var: int = -1


def tile_granularities(requested_tiles: int) -> List[int]:
    """Strategy hook: the tile-count ladder the tile-centric candidate
    strategy (``core.deploy.TileCentricStrategy``) evaluates — the
    requested granularity plus one coarser halving.  The exact stage-2
    model arbitrates between them (§3.1); extending the ladder here widens
    every deployment session's search without touching the session code."""
    return [requested_tiles, requested_tiles // 2]


def _match_tiles(g: Graph, m: Match, requested: int) -> Optional[int]:
    """Common T for all ops of the chain (None => invalid multi-op match)."""
    ts = [max_tiles(g, g.ops[name], requested) for name in m.ops]
    if len(set(ts)) != 1:
        return None
    return ts[0]


def _match_slope(g: Graph, m: Match, soc: SoC, T: int,
                 contention: Optional[Contention] = None) -> float:
    """Cycles per tile.  The paper's Eq. (2) uses the pure arithmetic model;
    we refine the slope with the ZigZag L1<->L2 traffic term so stage-1
    splits balance under the same cost model stage-2 evaluates (the eta of
    the paper 'absorbs memory-system stalls' — here the absorption is
    explicit and shape-aware).  Under ``contention`` the DMA-traffic term
    is congestion-scaled and the whole slope is inflated by the
    co-residents' load on this device (the device-affinity hint)."""
    from repro_torch.core.zigzag import refined_tile_slope
    dma_scale = contention.dma_scale if contention is not None else 1.0
    slope = refined_tile_slope(g, m.ops, m.pattern.device, m.pattern.eta,
                               T, soc, dma_scale=dma_scale)
    if contention is not None:
        slope *= contention.device_scale(m.pattern.device)
    return slope


def _helper_cost(g: Graph, m: Match, soc: SoC, T: int,
                 contention: Optional[Contention] = None
                 ) -> Tuple[float, float]:
    """(host cycles per tile, fixed cycles) for slice+concat of a partial
    conv-family match.  Dense/matmul tiling folds into the weight layout
    (zero runtime overhead, §4).  Helper copies run on the host, so under
    contention they are slowed by the co-residents' host load."""
    head = g.ops[m.ops[0]]
    tail = g.ops[m.ops[-1]]
    if not needs_input_slice(g, head):
        return 0.0, 0.0
    host = soc.host
    acts = g.act_inputs(head)
    in_bytes_per_tile = sum(t.bytes for t in acts) / T
    ax = tile_axis(g, head)
    halo = tile_halo_rows(g, head)
    halo_bytes = 0.0
    if acts and ax is not None and len(acts[0].shape) > ax:
        rows = max(acts[0].shape[ax], 1)
        halo_bytes = sum(t.bytes for t in acts) * halo / rows
    out_bytes_per_tile = g.tensors[tail.output].bytes / T
    slope = (in_bytes_per_tile + halo_bytes + out_bytes_per_tile) \
        / host.copy_bandwidth
    if contention is not None:
        slope *= contention.device_scale(host.name)
    return slope, 2.0 * DELTA_HELPER


def _match_ws_parts(g: Graph, m: Match) -> Tuple[float, float, float]:
    """(activation-input, param, output) bytes of a chain match — THE
    footprint definition shared by the best-response spill pricing
    (:func:`_spill_delta` via :func:`_match_working_set`) and the joint
    CP's shared-L2 capacity terms (:func:`_match_ws_linear`); the two cost
    models only agree as long as both build from these parts."""
    head = g.ops[m.ops[0]]
    tail = g.ops[m.ops[-1]]
    acts = float(sum(t.bytes for t in g.act_inputs(head)))
    params = float(sum(sum(t.bytes for t in g.param_tensors(g.ops[n]))
                       for n in m.ops))
    out = float(g.tensors[tail.output].bytes)
    return acts, params, out


def _match_working_set(g: Graph, m: Match) -> float:
    """Full L2 footprint of a chain match while it executes: the head's
    activation inputs + every covered op's params + the tail's output."""
    return sum(_match_ws_parts(g, m))


def _match_ws_linear(g: Graph, m: Match, T: int) -> Tuple[float, float]:
    """Linearized working set of a match: ``(per-tile, fixed)`` bytes so the
    footprint of a *partial* instantiation is ``per_tile * t + fixed * y``.

    Neuron-tiled chains (dense/matmul on the output-feature axis) slice
    their weights with the tile share but read the full input; row-tiled
    chains (conv family) slice activations but need the full weights — the
    same split :func:`repro.core.zigzag._chain_bytes` uses for L1 traffic.
    The joint CP's shared-L2 capacity constraint is built from these terms,
    which is what lets it see that *splitting* a neuron-tiled layer across
    devices does not duplicate its weights."""
    from repro_torch.core.ir import tile_axis
    head = g.ops[m.ops[0]]
    acts, params, out = _match_ws_parts(g, m)
    ax = tile_axis(g, head)
    out_rank = len(g.tensors[head.output].shape)
    neuron = ax is not None and ax == out_rank - 1
    if neuron:
        per_tile = (params + out) / max(T, 1)
        fixed = acts
    else:
        per_tile = (acts + out) / max(T, 1)
        fixed = params
    return per_tile, fixed


def solution_ws_bytes(g: Graph, sol: "TilingSolution") -> float:
    """Linearized shared-L2 working set of a whole tiling solution: the
    joint CP's capacity terms (:func:`_match_ws_linear`) evaluated at the
    solution's assignments.  This is the per-tenant weight the deployment
    session's *proportional* L2 re-split uses — a tenant whose chosen
    tiling touches more L2-resident bytes gets a proportionally larger
    slice of the shared scratchpad (DORY-style memory splitting), instead
    of the blind equal split."""
    total = 0.0
    for a in sol.assignments:
        T = max((sol.tiles_per_op.get(op, 1) for op in a.match.ops),
                default=1)
        per_tile, fixed = _match_ws_linear(g, a.match, T)
        total += per_tile * a.tiles + fixed
    return total


def _spill_delta(g: Graph, m: Match, soc: SoC, c: Contention) -> float:
    """Fixed charge for instantiating a match whose working set overflows
    this tenant's shared-L2 slice.  Stage 2 keeps whole tensors L2-resident
    while a chain executes (tiles are stitched into full buffers), so the
    relevant footprint is the chain's full activations + params + output;
    bytes beyond the slice swap to L3 and back through the congested system
    DMA.  Charged once per instantiation (on the y indicator), which steers
    the CP away from spreading a constrained mix across many concurrent
    chains."""
    if c.l2_budget is None:
        return 0.0
    excess = _match_working_set(g, m) - float(c.l2_budget)
    if excess <= 0.0:
        return 0.0
    return 2.0 * excess / soc.dma_l3_bandwidth * c.dma_scale


def build_match_vars(g: Graph, soc: SoC, patterns: Sequence[Pattern],
                     requested_tiles: int,
                     device_allow: Optional[Sequence[str]] = None,
                     contention: Optional[Contention] = None
                     ) -> List[_MVar]:
    mvars: List[_MVar] = []
    seen: Dict[Tuple[str, Tuple[str, ...]], _MVar] = {}
    for m in find_matches(g, patterns):
        if device_allow is not None and m.pattern.device not in device_allow:
            continue
        T = _match_tiles(g, m, requested_tiles)
        if T is None:
            continue
        slope = _match_slope(g, m, soc, T, contention)
        hs, hf = _helper_cost(g, m, soc, T, contention)
        delta = m.pattern.delta
        if contention is not None:
            delta += _spill_delta(g, m, soc, contention)
        key = (m.pattern.device, m.ops)
        cand = _MVar(m, T, slope, delta, hs, hf)
        prev = seen.get(key)
        if prev is None or (cand.slope, cand.delta) < (prev.slope, prev.delta):
            seen[key] = cand                 # drop dominated duplicates
    mvars = list(seen.values())
    return mvars


def optimize_tiling(g: Graph, soc: SoC, patterns: Sequence[Pattern],
                    mode: str = "matcha", requested_tiles: int = 16,
                    node_limit: int = 150_000, time_budget_s: float = 10.0,
                    host_tiles: bool = True,
                    contention: Optional[Contention] = None
                    ) -> TilingSolution:
    """``host_tiles=False`` forbids host tile participation on operators that
    have accelerator coverage (the host still runs unsupported ops via the
    wildcard).  The stage-1 makespan objective cannot see that host work on a
    dependency chain serializes against both accelerators, so the compiler
    evaluates both variants under the exact stage-2 model (core.api).

    ``contention`` re-prices every match for a multi-tenant co-compile
    (shrunk L2 slice, congested DMA, loaded devices — see
    :class:`Contention`); the solution shape is unchanged, only the cost
    surface the CP optimizes over."""
    assert mode in ("tvm", "match", "matcha_nt", "matcha")
    g.validate()
    device_allow = [soc.host.name] if mode == "tvm" else None
    mvars = build_match_vars(g, soc, patterns, requested_tiles, device_allow,
                             contention)
    if not host_tiles:
        accel_covered = set()
        for mv in mvars:
            if not soc.device(mv.match.pattern.device).is_host:
                accel_covered.update(mv.match.ops)
        mvars = [mv for mv in mvars
                 if not soc.device(mv.match.pattern.device).is_host
                 or any(o not in accel_covered for o in mv.match.ops)]

    # T_v per op = the T of any covering match (equal by construction for
    # multi-op matches; wildcard matches use the op's own T).
    tiles_per_op: Dict[str, int] = {}
    for op in g.topo_ops():
        tiles_per_op[op.name] = max_tiles(g, op, requested_tiles)

    model = cpsolver.CpModel()
    for mv in mvars:
        mv.t_var = model.new_int(0, mv.T, f"t[{mv.match!r}]")
        mv.y_var = model.new_int(0, 1, f"y[{mv.match!r}]")
        # t <= T * y  (instantiation indicator)
        model.add_le({mv.t_var: 1.0, mv.y_var: -float(mv.T)})
        if mode in ("tvm", "match", "matcha_nt"):
            # all-or-nothing: t == T * y
            model.add_eq({mv.t_var: 1.0, mv.y_var: -float(mv.T)})

    # Eq. (1): tile conservation per operator.
    cover: Dict[str, List[_MVar]] = {op.name: [] for op in g.topo_ops()}
    for mv in mvars:
        for name in mv.match.ops:
            cover[name].append(mv)
    for op in g.topo_ops():
        mvs = cover[op.name]
        if not mvs:
            raise ValueError(f"op {op.name} ({op.op_type}) matches no pattern "
                             f"(wildcard missing from the catalogue?)")
        model.add_eq({mv.t_var: 1.0 for mv in mvs},
                     -float(tiles_per_op[op.name]))

    # Loads.  Sequential modes: one combined load (sum of all latencies).
    # Async modes: one load per device + helper work on the host.
    host = soc.host.name
    dev_loads: Dict[str, Dict[int, float]] = {d: {} for d in soc.devices}
    for mv in mvars:
        d = mv.match.pattern.device
        dev_loads[d][mv.t_var] = dev_loads[d].get(mv.t_var, 0.0) + mv.slope
        dev_loads[d][mv.y_var] = dev_loads[d].get(mv.y_var, 0.0) + mv.delta
        if mode == "matcha" and mv.helper_slope > 0.0:
            hl = dev_loads[host]
            hl[mv.t_var] = hl.get(mv.t_var, 0.0) + mv.helper_slope
            hl[mv.y_var] = hl.get(mv.y_var, 0.0) + mv.helper_fix
        if not soc.device(d).is_host:
            # mailbox dispatch is host work in the async runtime (§3.3)
            hl = dev_loads[host]
            hl[mv.y_var] = hl.get(mv.y_var, 0.0) + soc.mailbox_latency

    if mode in ("tvm", "match"):
        combined: Dict[int, float] = {}
        for d, coeffs in dev_loads.items():
            for v, c in coeffs.items():
                combined[v] = combined.get(v, 0.0) + c
        model.add_load(combined)
    else:
        for d, coeffs in dev_loads.items():
            if coeffs:
                model.add_load(coeffs)

    hint = _greedy_hint(g, mvars, tiles_per_op, model.num_vars, mode, soc)
    if mode == "matcha":
        split = _split_hint(g, mvars, tiles_per_op, model.num_vars, soc)
        if split is not None and model._feasible(split) and \
                model._obj_value(split) < model._obj_value(hint):
            hint = split
    sol = model.solve(hint=hint, node_limit=node_limit,
                      time_budget_s=time_budget_s)
    values = sol.values
    if mode == "matcha":
        values = _local_search(model, mvars, values)

    assignments = [Assignment(mv.match, values[mv.t_var])
                   for mv in mvars if values[mv.t_var] > 0]
    return TilingSolution(mode=mode, assignments=assignments,
                          tiles_per_op=tiles_per_op,
                          objective=model._obj_value(values),
                          optimal=sol.optimal,
                          solver_nodes=sol.nodes, wall_s=sol.wall_s,
                          budget_exhausted=sol.budget_exhausted,
                          incumbent_source=sol.incumbent_source)


def _greedy_hint(g: Graph, mvars: List[_MVar], tiles: Dict[str, int],
                 num_vars: int, mode: str, soc: SoC) -> List[int]:
    """Warm start: the MATCH solution — greedily pick, per op, the cheapest
    full-coverage chain (longest fused chains first), everything else 0."""
    hint = [0] * num_vars
    covered: Dict[str, bool] = {op.name: False for op in g.topo_ops()}
    # longest chains first, then cheapest total latency
    order = sorted(mvars, key=lambda mv: (-len(mv.match.ops),
                                          mv.slope * mv.T + mv.delta))
    for mv in order:
        if any(covered[name] for name in mv.match.ops):
            continue
        hint[mv.t_var] = mv.T
        hint[mv.y_var] = 1
        for name in mv.match.ops:
            covered[name] = True
    return hint


def chain_groups(g: Graph, mvars: List[_MVar], fuse_joins: bool = True
                 ) -> List[Tuple[Tuple[str, ...], List[_MVar]]]:
    """Topo-anchored chain decomposition: walk operators in topological
    order; at each uncovered op take the longest match anchored there whose
    ops are all uncovered.  Anchoring at the *earliest* op of a chain keeps
    independent branches separate (a shortcut conv is not fused into the
    `add` that joins it with the main path, which would serialize the
    branches the paper exploits for graph-level parallelism).

    ``fuse_joins=False`` additionally refuses chains in which a non-anchor
    op reads an activation produced outside the chain (e.g. conv+add+relu
    where `add` joins a residual): such fusion makes the whole chain wait
    for the *latest* branch, which can serialize an otherwise-parallel DAG.
    Both decompositions are offered as candidates; stage-2 arbitrates."""
    def join_free(mv: _MVar) -> bool:
        outs = {g.ops[o].output for o in mv.match.ops}
        for o in mv.match.ops[1:]:
            for t in g.ops[o].inputs:
                ti = g.tensors[t]
                if ti.kind == "param" or t in outs:
                    continue
                return False
        return True

    by_anchor: Dict[str, List[_MVar]] = {}
    for mv in mvars:
        by_anchor.setdefault(mv.match.ops[0], []).append(mv)
    covered: Dict[str, bool] = {op.name: False for op in g.topo_ops()}
    groups: List[Tuple[Tuple[str, ...], List[_MVar]]] = []
    for op in g.topo_ops():
        if covered[op.name]:
            continue
        cands = [mv for mv in by_anchor.get(op.name, [])
                 if not any(covered[o] for o in mv.match.ops)
                 and (fuse_joins or join_free(mv))]
        if not cands:
            continue
        best = max(cands, key=lambda mv: (len(mv.match.ops),
                                          -(mv.slope * mv.T + mv.delta)))
        for o in best.match.ops:
            covered[o] = True
        same = [o for o in mvars if o.match.ops == best.match.ops]
        groups.append((best.match.ops, same))
    return groups


def _split_hint(g: Graph, mvars: List[_MVar], tiles: Dict[str, int],
                num_vars: int, soc: SoC) -> Optional[List[int]]:
    """Tile-splitting warm start: walk the graph in the greedy chain
    decomposition, and for each chain group enumerate all ways to split its
    T tiles over the best match per device (LPT-style, accounting for the
    accumulated per-device loads, helper work on the host, and the fixed
    charges delta/mailbox).  This is the paper's intended solution shape —
    the B&B then polishes it."""
    hint = [0] * num_vars
    host = soc.host.name
    load: Dict[str, float] = {d: 0.0 for d in soc.devices}
    groups = chain_groups(g, mvars)

    for ops, cands in groups:
        # best candidate per device for this exact op set
        by_dev: Dict[str, _MVar] = {}
        for mv in cands:
            d = mv.match.pattern.device
            cur = by_dev.get(d)
            if cur is None or (mv.slope, mv.delta) < (cur.slope, cur.delta):
                by_dev[d] = mv
        devs = list(by_dev.values())
        T = devs[0].T
        best_alloc, best_obj = None, None

        def charge(mv: _MVar, t: int, ld: Dict[str, float]) -> None:
            if t <= 0:
                return
            d = mv.match.pattern.device
            ld[d] = ld.get(d, 0.0) + mv.slope * t + mv.delta
            if mv.helper_slope > 0.0:
                ld[host] = ld.get(host, 0.0) \
                    + mv.helper_slope * t + mv.helper_fix
            if not soc.device(d).is_host:
                ld[host] = ld.get(host, 0.0) + soc.mailbox_latency

        def enum(i: int, left: int, alloc: List[int]) -> None:
            nonlocal best_alloc, best_obj
            if i == len(devs) - 1:
                alloc = alloc + [left]
                ld = dict(load)
                for mv, t in zip(devs, alloc):
                    charge(mv, t, ld)
                obj = max(ld.values())
                if best_obj is None or obj < best_obj:
                    best_obj, best_alloc = obj, list(alloc)
                return
            for t in range(left + 1):
                enum(i + 1, left - t, alloc + [t])

        if len(devs) == 1:
            best_alloc = [T]
        else:
            enum(0, T, [])
        for mv, t in zip(devs, best_alloc):
            hint[mv.t_var] = t
            hint[mv.y_var] = 1 if t > 0 else 0
            charge(mv, t, load)
    return hint


def _local_search(model: cpsolver.CpModel, mvars: List[_MVar],
                  values: List[int], rounds: int = 200) -> List[int]:
    """Hill-climb polish: move k tiles between matches covering the *same*
    op set (conservation-preserving by construction); accept improving
    feasible moves."""
    by_ops: Dict[Tuple[str, ...], List[_MVar]] = {}
    for mv in mvars:
        by_ops.setdefault(mv.match.ops, []).append(mv)
    x = list(values)
    obj = model._obj_value(x)
    for _ in range(rounds):
        improved = False
        for group in by_ops.values():
            if len(group) < 2:
                continue
            for a in group:
                if x[a.t_var] == 0:
                    continue
                for b in group:
                    if b is a:
                        continue
                    for k in (x[a.t_var], (x[a.t_var] + 1) // 2, 1):
                        if k == 0 or x[b.t_var] + k > b.T:
                            continue
                        x[a.t_var] -= k
                        x[b.t_var] += k
                        ya, yb = x[a.y_var], x[b.y_var]
                        x[a.y_var] = 1 if x[a.t_var] > 0 else 0
                        x[b.y_var] = 1
                        cand = model._obj_value(x)
                        if cand < obj - 1e-9 and model._feasible(x):
                            obj = cand
                            improved = True
                            break
                        x[a.t_var] += k
                        x[b.t_var] -= k
                        x[a.y_var], x[b.y_var] = ya, yb
                    else:
                        continue
                    break
        if not improved:
            break
    return x


# ---------------------------------------------------------------------------
# Joint cross-tenant tiling: one CP over all co-resident tenants
# ---------------------------------------------------------------------------


L2_QUANTUM = 4096              # granularity of the shared-L2 overflow var


class JointTilingProblem:
    """ONE constraint program over every co-resident tenant's tile
    variables (the MATCHA stage-1 model lifted from "fixed hints in -> one
    tenant out" to a joint solve, cf. HaX-CoNN's single SMT over all
    co-located networks).

    Per tenant: the usual Eq. (1) tile-conservation constraints and
    ``t <= T * y`` indicators over that tenant's match variables.  The
    *joint* couplings, built on :class:`repro.core.cpsolver.JointCpModel`:

      * **per-device load balance** — every device's makespan term sums the
        match latencies of ALL tenants assigned to it, so the objective is
        the true co-resident makespan, not N independent ones;
      * **one shared-L2 capacity constraint** — the linearized working
        sets (:func:`_match_ws_linear`) of every tenant's instantiated
        matches share the single ``soc.l2`` budget; a quantized overflow
        variable absorbs any excess so the model is never infeasible;
      * **congested-DMA coupling** — one ``dma`` makespan term accumulates
        every tenant's planned-load traffic plus the overflow's swap
        round-trips, so L2 pressure from one tenant surfaces as DMA time
        charged against the whole mix.

    ``solve`` warm-starts from per-tenant compile-alone / incumbent
    :class:`TilingSolution`\\ s (always feasible — the overflow variable
    absorbs their combined footprint) under a caller-supplied time budget;
    the deployment session falls back to per-tenant best-response re-tiling
    when the budget is exhausted."""

    def __init__(self, graphs: Sequence[Graph], soc: SoC,
                 patterns: Sequence[Pattern], requested_tiles: int = 16,
                 mode: str = "matcha", l2_budget: Optional[float] = None,
                 dma_scale: float = 1.0) -> None:
        """``l2_budget`` caps this problem's shared-L2 slice (default the
        whole ``soc.l2``) and ``dma_scale`` (>= 1) inflates its DMA time
        terms — together they let the decomposition layer
        (``core.decompose``) build a per-device-cluster subproblem that
        only owns its *split* of the shared resources, so concurrent
        cluster solves cannot jointly overcommit the L2 or the DMA
        engine."""
        assert mode in ("matcha", "matcha_nt")
        assert dma_scale >= 1.0, f"dma_scale must be >= 1: {dma_scale}"
        self.graphs = list(graphs)
        self.soc = soc
        self.mode = mode
        self.requested_tiles = requested_tiles
        self.dma_scale = float(dma_scale)
        self.joint = cpsolver.JointCpModel()
        self.mvars: List[List[_MVar]] = []
        self.tiles_per_op: List[Dict[str, int]] = []
        host = soc.host.name

        cap_coeffs: Dict[int, float] = {}
        max_ws = 0.0
        dma_const = 0.0
        for i, g in enumerate(self.graphs):
            g.validate()
            mvars = build_match_vars(g, soc, patterns, requested_tiles)
            self.mvars.append(mvars)
            tiles = {op.name: max_tiles(g, op, requested_tiles)
                     for op in g.topo_ops()}
            self.tiles_per_op.append(tiles)
            for mv in mvars:
                mv.t_var = self.joint.new_int(i, 0, mv.T,
                                              f"t{i}[{mv.match!r}]")
                mv.y_var = self.joint.new_int(i, 0, 1, f"y{i}[{mv.match!r}]")
                self.joint.add_le({mv.t_var: 1.0, mv.y_var: -float(mv.T)})
                if mode != "matcha":
                    self.joint.add_eq({mv.t_var: 1.0,
                                       mv.y_var: -float(mv.T)})
                d = mv.match.pattern.device
                self.joint.add_load(f"dev:{d}", {mv.t_var: mv.slope,
                                                 mv.y_var: mv.delta})
                if mode == "matcha" and mv.helper_slope > 0.0:
                    self.joint.add_load(f"dev:{host}",
                                        {mv.t_var: mv.helper_slope,
                                         mv.y_var: mv.helper_fix})
                if not soc.device(d).is_host:
                    self.joint.add_load(f"dev:{host}",
                                        {mv.y_var: soc.mailbox_latency})
                per_tile, fixed = _match_ws_linear(g, mv.match, mv.T)
                if per_tile > 0.0:
                    cap_coeffs[mv.t_var] = per_tile
                if fixed > 0.0:
                    cap_coeffs[mv.y_var] = fixed
                max_ws += per_tile * mv.T + fixed
            # Eq. (1) per tenant
            cover: Dict[str, List[_MVar]] = {op.name: []
                                             for op in g.topo_ops()}
            for mv in mvars:
                for name in mv.match.ops:
                    cover[name].append(mv)
            for op in g.topo_ops():
                mvs = cover[op.name]
                if not mvs:
                    raise ValueError(
                        f"tenant {i}: op {op.name} ({op.op_type}) matches "
                        f"no pattern (wildcard missing?)")
                self.joint.add_eq({mv.t_var: 1.0 for mv in mvs},
                                  -float(tiles[op.name]))
            dma_const += (self._planned_load_bytes(g) * self.dma_scale
                          / soc.dma_l3_bandwidth)

        # one shared-L2 capacity constraint over all tenants, with a
        # quantized overflow variable priced as swap round-trips on the
        # shared system DMA
        cap = float(l2_budget) if l2_budget is not None \
            else float(soc.l2.size)
        self.l2_cap = cap
        o_hi = max(int(math.ceil(max(max_ws - cap, 0.0) / L2_QUANTUM)), 0)
        self.o_var = self.joint.new_int(-1, 0, o_hi, "l2_overflow")
        cap_coeffs[self.o_var] = -float(L2_QUANTUM)
        self.joint.add_capacity(cap_coeffs, cap)
        self._cap_coeffs = dict(cap_coeffs)
        self.joint.add_load(
            "dma", {self.o_var: 2.0 * L2_QUANTUM * self.dma_scale
                    / soc.dma_l3_bandwidth},
            const=dma_const)

    def _planned_load_bytes(self, g: Graph) -> float:
        """Tenant traffic that rides the shared system DMA regardless of
        tiling: non-static parameter planned loads plus graph input/output
        transfers (L3-resident tensors stream instead — still DMA)."""
        from repro_torch.core.schedule import static_params
        statics = static_params(g, self.soc,
                                self.soc.l2.size // max(len(self.graphs), 1))
        total = 0.0
        for t, ti in g.tensors.items():
            if ti.kind == "param" and t not in statics:
                total += ti.bytes
        total += sum(g.tensors[t].bytes for t in g.inputs)
        total += sum(g.tensors[t].bytes for t in g.outputs)
        return total

    def _map_tenant_hint(self, i: int, sol: TilingSolution,
                         hint: List[int]) -> bool:
        """Write tenant ``i``'s solution into ``hint`` (matched by
        (device, op-chain) key); False when the solution was built at a
        foreign granularity and cannot be mapped (hint left zeroed for
        this tenant's variables)."""
        by_key = {(mv.match.pattern.device, mv.match.ops): mv
                  for mv in self.mvars[i]}
        staged: Dict[int, int] = {}
        ys: Dict[int, int] = {}
        for a in sol.assignments:
            mv = by_key.get((a.match.pattern.device, a.match.ops))
            if mv is None:
                return False             # foreign granularity: no mapping
            staged[mv.t_var] = staged.get(mv.t_var, 0) + a.tiles
            ys[mv.y_var] = 1
        got: Dict[str, int] = {op: 0 for op in self.tiles_per_op[i]}
        for mv in self.mvars[i]:
            for op in mv.match.ops:
                got[op] += staged.get(mv.t_var, 0)
        if got != self.tiles_per_op[i]:
            return False                 # conservation mismatch (other T)
        for v, t in staged.items():
            hint[v] = min(t, self.joint.model._hi[v])
        for v, y in ys.items():
            hint[v] = y
        return True

    def _greedy_tenant_hint(self, i: int, hint: List[int]) -> None:
        """MATCH-style greedy cover for tenant ``i`` (:func:`_greedy_hint`
        over this tenant's match variables, whose indices already live in
        the joint space) — the always-available warm start when no
        per-tenant solution maps onto the joint variable space."""
        sub = _greedy_hint(self.graphs[i], self.mvars[i],
                           self.tiles_per_op[i], self.joint.num_vars,
                           self.mode, self.soc)
        for mv in self.mvars[i]:
            hint[mv.t_var] = sub[mv.t_var]
            hint[mv.y_var] = sub[mv.y_var]

    def _set_overflow(self, hint: List[int]) -> None:
        used = sum(c * hint[v] for v, c in self._cap_coeffs.items()
                   if v != self.o_var)
        over = max(used - self.l2_cap, 0.0)
        hint[self.o_var] = min(int(math.ceil(over / L2_QUANTUM)),
                               self.joint.model._hi[self.o_var])

    def add_overflow_cut(self, max_quanta: int) -> None:
        """Benders-style allocation cut from the decomposition layer:
        bound this subproblem's L2 overflow at ``max_quanta`` quanta.  A
        cluster whose stage-2 realized makespan exceeded its relaxation
        was under-pricing the shared L2/DMA it spills onto; the cut
        forces the re-solve toward tilings that live within (close to)
        the cluster's allocation instead."""
        self.joint.add_cut({self.o_var: 1.0}, float(max(max_quanta, 0)))

    def warm_start(self, solutions: Optional[Sequence[TilingSolution]]
                   ) -> Optional[List[int]]:
        """Joint warm start: each tenant's solution is mapped onto the
        joint variable space where possible, with the greedy cover filling
        in for tenants whose solutions were built at a foreign granularity
        (or when ``solutions`` is None); the overflow variable absorbs the
        combined footprint, so the start is always capacity-feasible."""
        hint = [0] * self.joint.num_vars
        for i in range(len(self.graphs)):
            sol = (solutions[i] if solutions is not None
                   and len(solutions) == len(self.graphs) else None)
            if sol is None or not self._map_tenant_hint(i, sol, hint):
                self._greedy_tenant_hint(i, hint)
        self._set_overflow(hint)
        return hint

    def solve(self, warm: Optional[Sequence[TilingSolution]] = None,
              time_budget_s: float = 10.0,
              node_limit: int = 200_000,
              seeds: Optional[Sequence[Sequence[TilingSolution]]] = None
              ) -> List[TilingSolution]:
        """One joint solve; returns coordinated per-tenant solutions (the
        shared objective value is the joint co-resident makespan bound).
        ``seeds`` supplies *additional* per-tenant solution lists (e.g.
        the compile-alone tilings when ``warm`` came from a neighboring
        occupancy's cached solve): each is mapped onto the joint variable
        space like ``warm`` and re-seeds the solver's incumbent, so an
        incremental re-solve never starts worse than the best start it
        was handed.  Raises :class:`repro.core.cpsolver.Infeasible` when
        no solution is found within the budget (callers fall back to
        best-response)."""
        hint = self.warm_start(warm)
        seed_hints = [self.warm_start(s) for s in seeds or []]
        sol = self.joint.solve(hint=hint, node_limit=node_limit,
                               time_budget_s=time_budget_s,
                               seeds=seed_hints)
        out: List[TilingSolution] = []
        for i in range(len(self.graphs)):
            assignments = [Assignment(mv.match, sol.values[mv.t_var])
                           for mv in self.mvars[i]
                           if sol.values[mv.t_var] > 0]
            out.append(TilingSolution(
                mode=self.mode, assignments=assignments,
                tiles_per_op=dict(self.tiles_per_op[i]),
                objective=sol.objective, optimal=sol.optimal,
                solver_nodes=sol.nodes, wall_s=sol.wall_s,
                budget_exhausted=sol.budget_exhausted,
                incumbent_source=sol.incumbent_source))
        return out


def conservation_ok(g: Graph, sol: TilingSolution) -> bool:
    got: Dict[str, int] = {op.name: 0 for op in g.topo_ops()}
    for a in sol.assignments:
        for name in a.match.ops:
            got[name] += a.tiles
    return all(got[op.name] == sol.tiles_per_op[op.name]
               for op in g.topo_ops())
