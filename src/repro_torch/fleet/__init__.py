"""Fleet-scale serving: contention-aware tenant placement, request
routing and lifecycle management over many simulated SoC instances.

MATCHA maximizes utilization *within* one multi-accelerator SoC; this
package asks the level-up question production traffic forces: given N
tenant models and a rack of identical SoCs, which co-residency sets
should exist at all (:mod:`repro_torch.fleet.placement`), which SoC should
each request land on (:mod:`repro_torch.fleet.router`), and what happens when
a SoC drains or dies mid-trace (:mod:`repro_torch.fleet.rebalance`).
"""

from repro_torch.fleet.placement import (ContentionModel, Fleet, FleetConfig,
                                   Placement, PlanCache, SoCInstance,
                                   balanced_utilization, capacity_ratio,
                                   default_demand, effective_replicas,
                                   place_contention_aware,
                                   place_random, place_round_robin,
                                   soc_utilization, transplant_solutions)
from repro_torch.fleet.rebalance import FleetRebalancer, MigrationRecord
from repro_torch.fleet.router import (FailureEvent, FleetRouter, RoutedRequest,
                                replay_open_loop)

__all__ = [
    "ContentionModel", "FailureEvent", "Fleet", "FleetConfig",
    "FleetRebalancer", "FleetRouter", "MigrationRecord", "PlanCache",
    "Placement", "RoutedRequest", "SoCInstance", "balanced_utilization",
    "capacity_ratio", "default_demand", "effective_replicas",
    "place_contention_aware", "place_random", "place_round_robin",
    "replay_open_loop", "soc_utilization", "transplant_solutions",
]
