"""IR rewrite: instantiate fused supernodes + slice/concat helpers (§3.1).

Based on the CP optimizer's output, operators are split according to the
chosen tiling, fused kernel supernodes are created, and auxiliary operators
(tensor slicing and concatenation) are added; the graph is partitioned so
each supernode is bound to its device.

Tile-range allocation: every instantiated match must own the *same* set of
tile indices for every operator it covers (the fused kernel computes tile i
of the whole chain).  Multi-op matches are allocated first (most-constrained
operator first); single-op matches fill the remaining indices, possibly as
several contiguous segments (each segment is a separate kernel invocation).
If greedy allocation cannot place a multi-op match (overlap pathologies),
the surplus tiles are repaired onto the host wildcard so tile conservation
always holds — the repair is counted and surfaced for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ir import Graph, Op, needs_input_slice, tile_axis, \
    tile_halo_rows
from repro_torch.core.patterns import Match
from repro_torch.core.tiling import Assignment, TilingSolution
from repro_torch.soc.device import SoC


@dataclasses.dataclass
class Supernode:
    """One kernel invocation: a fused chain on one device over one
    contiguous tile segment [tile_lo, tile_hi) of each covered op."""
    name: str
    match: Match
    op_names: Tuple[str, ...]
    device: str
    tile_lo: int
    tile_hi: int
    T: int

    @property
    def tiles(self) -> int:
        return self.tile_hi - self.tile_lo

    @property
    def full(self) -> bool:
        return self.tiles == self.T


@dataclasses.dataclass
class HelperNode:
    """Host-resident slice or concat helper op."""
    name: str
    kind: str                 # "slice" | "concat"
    super_name: str           # supernode this helper serves
    tensor: str               # full tensor being sliced / produced
    bytes_moved: float


@dataclasses.dataclass
class TiledGraph:
    """The rewritten, device-partitioned graph."""
    graph: Graph
    solution: TilingSolution
    supernodes: List[Supernode]
    helpers: List[HelperNode]
    # op name -> list of supernode names covering it (tile-sorted)
    op_cover: Dict[str, List[str]]
    repairs: int = 0

    def supernode(self, name: str) -> Supernode:
        for s in self.supernodes:
            if s.name == name:
                return s
        raise KeyError(name)


def _alloc_sets(g: Graph, sol: TilingSolution
                ) -> Tuple[List[Tuple[Assignment, Set[int]]], int]:
    """Assign each instantiated match a set of tile indices per the rules in
    the module docstring.  Returns (match, tile-index set) pairs + repair
    count (tiles pushed back to host wildcards)."""
    free: Dict[str, Set[int]] = {
        op: set(range(T)) for op, T in sol.tiles_per_op.items()}
    multi = [a for a in sol.assignments if len(a.match.ops) > 1]
    single = [a for a in sol.assignments if len(a.match.ops) == 1]
    # most-constrained first: fewest free tiles across covered ops
    placed: List[Tuple[Assignment, Set[int]]] = []
    repairs = 0
    for a in sorted(multi, key=lambda a: min(len(free[o]) for o in a.match.ops)):
        inter = set.intersection(*(free[o] for o in a.match.ops))
        take = sorted(inter)[: a.tiles]
        if len(take) < a.tiles:
            repairs += a.tiles - len(take)
        s = set(take)
        for o in a.match.ops:
            free[o] -= s
        placed.append((a, s))
    for a in single:
        o = a.match.ops[0]
        take = sorted(free[o])[: a.tiles]
        if len(take) < a.tiles:
            repairs += a.tiles - len(take)
        s = set(take)
        free[o] -= s
        placed.append((a, s))
    # repair: any leftover free tiles go to (possibly new) host entries —
    # conservation guaranteed.  Leftovers only exist when repairs > 0.
    leftover = {o: f for o, f in free.items() if f}
    if leftover:
        for o, f in leftover.items():
            owner = next((i for i, (a, s) in enumerate(placed)
                          if a.match.ops == (o,)), None)
            if owner is not None:
                placed[owner][1].update(f)
            else:
                repairs += len(f)
    return placed, repairs


def _segments(idx: Set[int]) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) segments of a tile-index set."""
    out: List[Tuple[int, int]] = []
    run: List[int] = []
    for i in sorted(idx):
        if run and i != run[-1] + 1:
            out.append((run[0], run[-1] + 1))
            run = []
        run.append(i)
    if run:
        out.append((run[0], run[-1] + 1))
    return out


def rewrite(g: Graph, soc: SoC, sol: TilingSolution) -> TiledGraph:
    placed, repairs = _alloc_sets(g, sol)
    supernodes: List[Supernode] = []
    helpers: List[HelperNode] = []
    op_cover: Dict[str, List[str]] = {op.name: [] for op in g.topo_ops()}

    for k, (a, idx) in enumerate(placed):
        if not idx:
            continue
        T = sol.tiles_per_op[a.match.ops[0]]
        for si, (lo, hi) in enumerate(_segments(idx)):
            name = f"sn{k}_{si}_{a.match.pattern.name}"
            sn = Supernode(name=name, match=a.match, op_names=a.match.ops,
                           device=a.match.pattern.device,
                           tile_lo=lo, tile_hi=hi, T=T)
            supernodes.append(sn)
            for o in a.match.ops:
                op_cover[o].append(name)
            # Helper ops: a partial conv-family supernode needs its input
            # sliced (with halo) and its output concatenated back (§3.1/§4).
            head = g.ops[a.match.ops[0]]
            tail = g.ops[a.match.ops[-1]]
            if not sn.full and needs_input_slice(g, head):
                frac = sn.tiles / T
                acts = g.act_inputs(head)
                ax = tile_axis(g, head)
                halo = tile_halo_rows(g, head)
                in_b = 0.0
                for t in acts:
                    b = t.bytes * frac
                    if ax is not None and len(t.shape) > ax and t.shape[ax]:
                        b += t.bytes * halo / t.shape[ax]
                    in_b += b
                helpers.append(HelperNode(f"{name}:slice", "slice", name,
                                          head.inputs[0], in_b))
                out_b = g.tensors[tail.output].bytes * frac
                helpers.append(HelperNode(f"{name}:concat", "concat", name,
                                          tail.output, out_b))

    for o in op_cover:
        op_cover[o].sort(key=lambda n: next(
            s.tile_lo for s in supernodes if s.name == n))

    return TiledGraph(graph=g, solution=sol, supernodes=supernodes,
                      helpers=helpers, op_cover=op_cover, repairs=repairs)
