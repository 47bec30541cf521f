"""Operator patterns and chain pattern-matching (paper §3.1).

A pattern is a path (chain) graph of length ``l_p`` with node-level
constraints; a match is an injective graph homomorphism ``h: V_p -> V`` such
that consecutive pattern nodes map to producer->consumer operator pairs whose
intermediate tensor has no other consumer (fusion validity).  Each pattern is
bound to a device ``d_p`` and carries the analytical-model parameters
``eta_p`` (efficiency in (0,1]) and ``delta_p`` (fixed per-invocation
overhead, cycles).

MATCHA always includes a *wildcard* pattern per operator so unmatched tiles
can run on the host via a TVM-generated kernel (§3.1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import Graph, Op

WILDCARD = "*"


@dataclasses.dataclass(frozen=True)
class PatternNode:
    """Constraint on a single IR operator: op type (or wildcard) + predicate."""
    op_type: str = WILDCARD
    where: Optional[Callable[[Graph, Op], bool]] = None

    def matches(self, g: Graph, op: Op) -> bool:
        if self.op_type != WILDCARD and op.op_type != self.op_type:
            return False
        if self.where is not None and not self.where(g, op):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class Pattern:
    name: str
    device: str                      # d_p
    nodes: Tuple[PatternNode, ...]   # chain, executed in order
    eta: float                       # efficiency factor in (0, 1]
    delta: float                     # fixed per-invocation overhead (cycles)
    is_wildcard: bool = False

    def __post_init__(self) -> None:
        if not (0.0 < self.eta <= 1.0):
            raise ValueError(f"{self.name}: eta must be in (0,1]")

    @property
    def length(self) -> int:
        return len(self.nodes)


@dataclasses.dataclass(frozen=True)
class Match:
    """One injective homomorphism h_m: pattern chain -> ops of the graph."""
    pattern: Pattern
    ops: Tuple[str, ...]             # op names, in chain order

    @property
    def anchor(self) -> str:
        return self.ops[0]

    def __repr__(self) -> str:
        return f"Match({self.pattern.name}@{self.pattern.device}:{'+'.join(self.ops)})"


def chain(device: str, name: str, op_types: Sequence[str], eta: float,
          delta: float) -> Pattern:
    return Pattern(name=name, device=device,
                   nodes=tuple(PatternNode(t) for t in op_types),
                   eta=eta, delta=delta)


def wildcard(device: str, eta: float, delta: float) -> Pattern:
    return Pattern(name=f"wildcard@{device}", device=device,
                   nodes=(PatternNode(WILDCARD),), eta=eta, delta=delta,
                   is_wildcard=True)


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _chain_extensions(g: Graph, op: Op) -> List[Op]:
    """Ops that can extend a fused chain after ``op``: consumers of op.output
    where that tensor has no other consumer (so fusion does not duplicate
    work or break a dependence)."""
    consumers = g.consumers_of(op.output)
    if len(consumers) != 1 or op.output in g.outputs:
        return []
    return consumers


def find_matches(g: Graph, patterns: Sequence[Pattern]) -> List[Match]:
    """All matches of all patterns.  Matches may overlap; the CP tiling
    optimizer (core.tiling) decides which are instantiated and with how many
    tiles each."""
    out: List[Match] = []
    ops = g.topo_ops()
    for p in patterns:
        for op in ops:
            m = _match_from(g, p, op)
            if m is not None:
                out.append(m)
    return out


def _match_from(g: Graph, p: Pattern, op: Op) -> Optional[Match]:
    chain_ops: List[str] = []
    cur = op
    for i, node in enumerate(p.nodes):
        if cur is None or not node.matches(g, cur):
            return None
        chain_ops.append(cur.name)
        if i + 1 < len(p.nodes):
            ext = _chain_extensions(g, cur)
            cur = ext[0] if ext else None
    return Match(pattern=p, ops=tuple(chain_ops))


def matches_by_op(g: Graph, matches: Sequence[Match]) -> Dict[str, List[int]]:
    """op name -> indices of matches covering it (the I_{v,p,m} of Eq. 1)."""
    cover: Dict[str, List[int]] = {op.name: [] for op in g.topo_ops()}
    for i, m in enumerate(matches):
        for name in m.ops:
            cover[name].append(i)
    return cover
