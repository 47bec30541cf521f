"""A small constraint-programming solver (integer B&B + bounds propagation).

The paper uses OR-Tools CP solvers for both optimization stages (§4).  That
dependency is not available in this environment, so we implement the needed
fragment ourselves:

  * integer decision variables with finite domains,
  * linear (in)equality constraints with float coefficients,
  * a *makespan* objective  ``minimize  max_d  load_d(x)``  where every
    ``load_d`` is linear (Eq. 2 makes match latencies linear in the tile
    variables, which is exactly what keeps this tractable — §3.1),
  * depth-first branch & bound with bounds-consistency propagation, a value
    hint (warm start from a greedy heuristic) and node/time limits.

Solutions report whether they are proven optimal.  Small instances (the
MLPerf-Tiny graphs) solve to optimality in milliseconds; tests cross-check
against brute-force enumeration on tiny models.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

EPS = 1e-6


@dataclasses.dataclass
class Solution:
    values: List[int]
    objective: float
    optimal: bool
    nodes: int
    wall_s: float
    # -- solver telemetry: budget exhaustion is observable, not a
    # silent fallback.  ``budget_exhausted`` is True when the search hit
    # its node/time limit before proving optimality (== ``not optimal``
    # for a solve that returned; kept separate so callers can log it
    # without re-deriving).  ``incumbent_source`` names where the
    # returned incumbent came from: "hint" / "seed" (a warm start was
    # never improved by search) or "search" (B&B found it or improved on
    # every start).
    budget_exhausted: bool = False
    incumbent_source: str = "search"

    def telemetry(self) -> Tuple[int, float, bool, str]:
        """``(nodes, wall_s, budget_exhausted, incumbent_source)``."""
        return (self.nodes, self.wall_s, self.budget_exhausted,
                self.incumbent_source)


class Infeasible(Exception):
    pass


def split_time_budget(total_s: float, weights: Sequence[float],
                      min_frac: float = 0.10) -> List[float]:
    """Split one wall-clock solve budget across subproblems.

    The decomposed joint solve (``core.decompose``) runs one CP per
    device cluster; each gets a share of the total budget proportional
    to ``weights`` (typically variable counts — B&B effort scales with
    the search space), floored at ``min_frac`` of the equal share so a
    tiny cluster still gets enough time to prove optimality.  Degenerate
    weights fall back to the equal split.  Shares sum to ``total_s``."""
    n = len(weights)
    if n == 0:
        return []
    if n == 1:
        return [float(total_s)]
    total_w = sum(max(float(w), 0.0) for w in weights)
    if total_w <= 0.0:
        return [float(total_s) / n] * n
    floor = min_frac * total_s / n
    raw = [max(float(w), 0.0) / total_w * total_s for w in weights]
    out = [max(r, floor) for r in raw]
    scale = total_s / sum(out)
    return [r * scale for r in out]


@dataclasses.dataclass
class _Lin:
    """sum(coeffs[i] * x[i]) + const  (<= 0  or  == 0)."""
    coeffs: Dict[int, float]
    const: float
    is_eq: bool


class CpModel:
    def __init__(self) -> None:
        self._lo: List[int] = []
        self._hi: List[int] = []
        self._names: List[str] = []
        self._cons: List[_Lin] = []
        self._loads: List[Tuple[Dict[int, float], float]] = []  # makespan terms

    # -- model building -----------------------------------------------------
    def new_int(self, lo: int, hi: int, name: str = "") -> int:
        assert lo <= hi, f"empty domain for {name}"
        self._lo.append(int(lo))
        self._hi.append(int(hi))
        self._names.append(name or f"x{len(self._lo) - 1}")
        return len(self._lo) - 1

    def add_le(self, coeffs: Dict[int, float], const: float = 0.0) -> None:
        """sum(c_i * x_i) + const <= 0"""
        self._cons.append(_Lin(dict(coeffs), float(const), False))

    def add_ge(self, coeffs: Dict[int, float], const: float = 0.0) -> None:
        self.add_le({i: -c for i, c in coeffs.items()}, -const)

    def add_eq(self, coeffs: Dict[int, float], const: float = 0.0) -> None:
        self._cons.append(_Lin(dict(coeffs), float(const), True))

    def add_load(self, coeffs: Dict[int, float], const: float = 0.0) -> None:
        """One makespan term: the objective is max over all added loads."""
        self._loads.append((dict(coeffs), float(const)))

    @property
    def num_vars(self) -> int:
        return len(self._lo)

    # -- propagation ---------------------------------------------------------
    @staticmethod
    def _term_min(c: float, lo: int, hi: int) -> float:
        return c * lo if c >= 0 else c * hi

    @staticmethod
    def _term_max(c: float, lo: int, hi: int) -> float:
        return c * hi if c >= 0 else c * lo

    def _propagate(self, lo: List[int], hi: List[int]) -> None:
        """Bounds-consistency fixpoint; raises Infeasible."""
        cons = self._cons
        for _ in range(64):  # fixpoint iterations cap
            changed = False
            for con in cons:
                rounds = (False, True) if con.is_eq else (False,)
                for flipped in rounds:
                    sgn = -1.0 if flipped else 1.0
                    # constraint: sgn*(sum + const) <= 0
                    smin = sgn * con.const
                    smin_terms = {}
                    for i, c in con.coeffs.items():
                        t = self._term_min(sgn * c, lo[i], hi[i])
                        smin_terms[i] = t
                        smin += t
                    if smin > EPS:
                        raise Infeasible()
                    for i, c in con.coeffs.items():
                        cc = sgn * c
                        if cc == 0.0:
                            continue
                        rest = smin - smin_terms[i]
                        # cc * x_i <= -rest
                        bound = -rest / cc
                        if cc > 0:
                            nb = math.floor(bound + EPS)
                            if nb < hi[i]:
                                hi[i] = nb
                                changed = True
                        else:
                            nb = math.ceil(bound - EPS)
                            if nb > lo[i]:
                                lo[i] = nb
                                changed = True
                        if lo[i] > hi[i]:
                            raise Infeasible()
            if not changed:
                return

    def _obj_lb(self, lo: List[int], hi: List[int]) -> float:
        if not self._loads:
            return 0.0
        best = -math.inf
        for coeffs, const in self._loads:
            v = const + sum(self._term_min(c, lo[i], hi[i])
                            for i, c in coeffs.items())
            best = max(best, v)
        return best

    def _obj_value(self, x: List[int]) -> float:
        if not self._loads:
            return 0.0
        return max(const + sum(c * x[i] for i, c in coeffs.items())
                   for coeffs, const in self._loads)

    def _feasible(self, x: List[int]) -> bool:
        for con in self._cons:
            s = con.const + sum(c * x[i] for i, c in con.coeffs.items())
            if con.is_eq:
                if abs(s) > 1e-4:
                    return False
            elif s > 1e-4:
                return False
        return True

    def _clamp(self, x: Sequence[int]) -> List[int]:
        return [min(max(int(v), self._lo[i]), self._hi[i])
                for i, v in enumerate(x)]

    # -- search ---------------------------------------------------------------
    def solve(self, hint: Optional[Sequence[int]] = None,
              node_limit: int = 400_000,
              time_budget_s: float = 20.0,
              seeds: Optional[Sequence[Sequence[int]]] = None) -> Solution:
        """Branch & bound under node/time limits.

        ``hint`` is the primary warm start: if feasible it becomes the
        incumbent, and its values drive the dive branching order.
        ``seeds`` re-seeds the search with additional candidate value
        vectors (e.g. solutions of a *neighboring* problem instance mapped
        onto this variable space): each feasible seed competes for the
        incumbent, and when the best feasible start is a seed rather than
        the hint, the dive follows the seed — so an incremental re-solve
        starts from the best known neighbor solution instead of from
        scratch."""
        t0 = time.perf_counter()
        lo, hi = list(self._lo), list(self._hi)
        try:
            self._propagate(lo, hi)
        except Infeasible:
            raise Infeasible("model infeasible at the root")

        best_x: Optional[List[int]] = None
        best_obj = math.inf
        dive: Optional[List[int]] = \
            list(hint) if hint is not None else None
        starts: List[Tuple[str, Optional[Sequence[int]]]] = \
            [("hint", hint)] if hint is not None else []
        starts.extend(("seed", s) for s in (seeds or []))
        incumbent_source = "search"
        for source, start in starts:
            if start is None or len(start) != self.num_vars:
                continue
            hx = self._clamp(start)
            if self._feasible(hx):
                obj = self._obj_value(hx)
                if obj < best_obj:
                    best_x, best_obj = hx, obj
                    dive = list(start)
                    incumbent_source = source

        nodes = 0
        exhausted = True
        # Branch on the variable with the widest domain weighted by its
        # largest |coefficient| across makespan terms ("impact").
        impact = [0.0] * self.num_vars
        for coeffs, _ in self._loads:
            for i, c in coeffs.items():
                impact[i] = max(impact[i], abs(c))
        for con in self._cons:
            for i, c in con.coeffs.items():
                impact[i] = max(impact[i], 1e-3 * abs(c))

        hint_vals = dive

        stack: List[Tuple[List[int], List[int]]] = [(lo, hi)]
        while stack:
            if nodes >= node_limit or time.perf_counter() - t0 > time_budget_s:
                exhausted = False
                break
            lo, hi = stack.pop()
            nodes += 1
            try:
                self._propagate(lo, hi)
            except Infeasible:
                continue
            if self._obj_lb(lo, hi) >= best_obj - 1e-7:
                continue
            free = [i for i in range(self.num_vars) if lo[i] < hi[i]]
            if not free:
                x = lo
                if self._feasible(x):
                    obj = self._obj_value(x)
                    if obj < best_obj - 1e-9:
                        best_obj, best_x = obj, list(x)
                        incumbent_source = "search"
                continue
            i = max(free, key=lambda j: (hi[j] - lo[j]) * (impact[j] + 1e-9))
            if hint_vals is not None and lo[i] <= hint_vals[i] <= hi[i]:
                mid = hint_vals[i]
                # children: x==mid first (dive to hint), then the two sides
                l1, h1 = list(lo), list(hi)
                h1[i] = mid - 1
                l2, h2 = list(lo), list(hi)
                l2[i] = mid + 1
                l0, h0 = list(lo), list(hi)
                l0[i] = h0[i] = mid
                if mid + 1 <= hi[i]:
                    stack.append((l2, h2))
                if lo[i] <= mid - 1:
                    stack.append((l1, h1))
                stack.append((l0, h0))
            else:
                mid = (lo[i] + hi[i]) // 2
                l1, h1 = list(lo), list(hi)
                h1[i] = mid
                l2, h2 = list(lo), list(hi)
                l2[i] = mid + 1
                stack.append((l2, h2))
                stack.append((l1, h1))

        if best_x is None:
            raise Infeasible("no feasible solution found within limits")
        return Solution(values=best_x, objective=best_obj,
                        optimal=exhausted, nodes=nodes,
                        wall_s=time.perf_counter() - t0,
                        budget_exhausted=not exhausted,
                        incumbent_source=incumbent_source)


class JointCpModel:
    """Multi-tenant composition layer over :class:`CpModel` (§3.1 lifted to
    N co-resident networks, cf. HaX-CoNN's single SMT over all tenants).

    Every tenant's decision variables live in ONE variable space; what makes
    the model *joint* is how costs and capacities couple across tenants:

      * loads are **keyed** by shared resource (a device name, the system
        DMA engine): ``add_load(key, ...)`` contributions from different
        tenants accumulate into one makespan term per key, so the objective
        is the true co-resident makespan ``max_resource sum_tenants work``
        instead of N independent per-tenant makespans;
      * **capacity** constraints (the one shared-L2 budget) span every
        tenant's variables: ``add_capacity`` states
        ``sum(coeffs * x) <= cap`` over any mix of tenants' indicators.

    ``new_int`` tags each variable with its tenant, so a joint solution can
    be split back into per-tenant assignments (``tenant_values``).
    """

    def __init__(self) -> None:
        self.model = CpModel()
        self._keyed: Dict[str, Tuple[Dict[int, float], float]] = {}
        self._tenant_of: List[int] = []        # var index -> tenant
        self._finalized = False
        self.cuts = 0                          # Benders-style cuts added

    # -- building ------------------------------------------------------------
    def new_int(self, tenant: int, lo: int, hi: int, name: str = "") -> int:
        v = self.model.new_int(lo, hi, name)
        self._tenant_of.append(int(tenant))
        return v

    def add_le(self, coeffs: Dict[int, float], const: float = 0.0) -> None:
        self.model.add_le(coeffs, const)

    def add_eq(self, coeffs: Dict[int, float], const: float = 0.0) -> None:
        self.model.add_eq(coeffs, const)

    def add_capacity(self, coeffs: Dict[int, float], cap: float) -> None:
        """Shared capacity: sum(coeffs * x) <= cap (spans tenants)."""
        self.model.add_le(dict(coeffs), -float(cap))

    def add_cut(self, coeffs: Dict[int, float], bound: float) -> None:
        """A Benders-style cut: ``sum(coeffs * x) <= bound``.

        Structurally identical to a capacity constraint, but added *after*
        model construction by the decomposition layer's reconciliation
        loop (``core.decompose``) — a cluster whose stage-2 realized
        makespan exceeded its relaxation gets its shared-resource
        appetite bounded before the re-solve.  Counted in ``cuts`` for
        solver telemetry."""
        self.model.add_le(dict(coeffs), -float(bound))
        self.cuts += 1

    def add_load(self, key: str, coeffs: Dict[int, float],
                 const: float = 0.0) -> None:
        """Accumulate a contribution into the makespan term for ``key``.

        Contributions with the same key — typically one per (tenant, match)
        on the same device — are summed into a single load, which is what
        couples the tenants' tile variables in the objective."""
        cur, cur_const = self._keyed.setdefault(key, ({}, 0.0))
        for i, c in coeffs.items():
            cur[i] = cur.get(i, 0.0) + c
        self._keyed[key] = (cur, cur_const + float(const))

    @property
    def num_vars(self) -> int:
        return self.model.num_vars

    def load_keys(self) -> List[str]:
        return sorted(self._keyed)

    def tenant_values(self, values: Sequence[int], tenant: int
                      ) -> Dict[int, int]:
        """{var index -> value} restricted to one tenant's variables."""
        return {i: int(values[i]) for i in range(len(self._tenant_of))
                if self._tenant_of[i] == tenant}

    # -- solving -------------------------------------------------------------
    def _finalize(self) -> None:
        if not self._finalized:
            for key in self.load_keys():
                coeffs, const = self._keyed[key]
                self.model.add_load(coeffs, const)
            self._finalized = True

    def solve(self, hint: Optional[Sequence[int]] = None,
              node_limit: int = 200_000,
              time_budget_s: float = 10.0,
              seeds: Optional[Sequence[Sequence[int]]] = None) -> Solution:
        """One branch & bound over all tenants' variables.  ``seeds``
        passes extra warm value vectors through to :meth:`CpModel.solve`
        (the incremental re-solve path seeds the search with a neighboring
        occupancy's solution alongside the compile-alone hint).  A
        non-positive ``time_budget_s`` means the joint solve's budget is
        already spent: the caller's best-response fallback must engage, so
        we raise rather than silently return the warm start as a 'joint'
        optimum."""
        if time_budget_s <= 0.0:
            raise Infeasible("joint solve time budget exhausted")
        self._finalize()
        return self.model.solve(hint=hint, node_limit=node_limit,
                                time_budget_s=time_budget_s, seeds=seeds)


def brute_force(model: CpModel) -> Solution:
    """Exhaustive search for tests (tiny domains only)."""
    n = model.num_vars
    best_x, best_obj = None, math.inf
    x = [0] * n
    total = 1
    for i in range(n):
        total *= model._hi[i] - model._lo[i] + 1
    assert total <= 2_000_000, "brute_force domain too large"

    def rec(i: int) -> None:
        nonlocal best_x, best_obj
        if i == n:
            if model._feasible(x):
                obj = model._obj_value(x)
                if obj < best_obj:
                    best_obj, best_x = obj, list(x)
            return
        for v in range(model._lo[i], model._hi[i] + 1):
            x[i] = v
            rec(i + 1)

    rec(0)
    if best_x is None:
        raise Infeasible("brute force: infeasible")
    return Solution(best_x, best_obj, True, total, 0.0)
