"""Public compile entry points — thin wrappers over the deployment session.

The full MATCHA pipeline (Fig. 1)

    pre-process -> tile-centric CP pattern matching (stage 1, core.tiling)
                -> IR rewrite (supernodes + helpers, core.rewrite)
                -> scheduling & memory planning (stage 2, core.schedule)
                -> (optionally) code generation (core.codegen)

lives in :mod:`repro.core.deploy`: a :class:`~repro.core.deploy.
DeploymentSession` over a typed :class:`~repro.core.deploy.CompileRequest`
runs one unified candidate search (a registry of named
:class:`~repro.core.deploy.CandidateStrategy` entries: tile-centric at
several granularities, the all-or-nothing corner, HEFT, contention-priced
re-runs, complementary selections, and the joint cross-tenant CP — one
constraint program over every tenant's tile variables), arbitrates every
candidate under the exact stage-2 model with a typed
:class:`~repro.core.deploy.Objective` (makespan-primary, configurable
ordered tie-break chain), iterates the contention-hint loop to a bounded
fixpoint, and caches co-schedules per occupancy in an LRU-bounded
:class:`~repro.core.deploy.PlanStore` — so
``MultiCompiledModel.plan_for(active)`` answers *partial* occupancy with
tilings re-decided for that occupancy.

This module keeps the historical free-function surface:

  * ``compile_model(graph, soc, patterns, mode)`` — one model, returns a
    :class:`CompiledModel` whose ``plan`` carries the executable schedule +
    memory plan and whose ``run`` method executes the plan numerically in
    JAX.  For ``mode="matcha"`` the session evaluates several stage-1
    candidates under the exact stage-2 model and keeps the best,
    reproducing the Table-2 behaviour where depthwise-dominated nets
    reject tiling while ResNet/AutoEncoder embrace it (§3.1).
  * ``compile_multi(graphs, soc, patterns)`` — N models co-scheduled onto
    one SoC, returns a session-backed :class:`MultiCompiledModel`.

Both construct a session internally and return its artifacts unchanged, so
callers that need the richer API (subset pre-compilation, explicit
objectives, strategy selection) can build the session directly instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.deploy import (MODES, CandidateSpec, CandidateStrategy,
                               CompiledModel, CompileRequest,
                               DeploymentSession, MultiCompiledModel,
                               Objective, PlanStore, default_strategy_names,
                               get_strategy, register_strategy)
from repro_torch.core.ir import Graph
from repro_torch.core.patterns import Pattern
from repro_torch.soc.device import SoC

__all__ = [
    "MODES", "CandidateSpec", "CandidateStrategy", "CompileRequest",
    "CompiledModel", "DeploymentSession", "MultiCompiledModel", "Objective",
    "PlanStore", "compile_model", "compile_multi",
    "default_strategy_names", "get_strategy", "register_strategy",
]


def compile_model(g: Graph, soc: SoC, patterns: Sequence[Pattern],
                  mode: str = "matcha", requested_tiles: int = 16,
                  time_budget_s: float = 8.0) -> CompiledModel:
    """Compile ONE model: a single-graph deployment session's
    compile-alone artifact."""
    assert mode in MODES, mode
    request = CompileRequest(graphs=[g], soc=soc, patterns=patterns,
                             mode=mode, requested_tiles=requested_tiles,
                             time_budget_s=time_budget_s)
    return DeploymentSession(request).compile_single(0)


def compile_multi(graphs: Sequence[Graph], soc: SoC,
                  patterns: Sequence[Pattern], mode: str = "matcha",
                  budgets: Optional[Sequence[int]] = None,
                  requested_tiles: int = 16,
                  time_budget_s: float = 8.0,
                  retile_for_contention: bool = True,
                  max_hint_rounds: int = 3,
                  joint_tiling: bool = True,
                  joint_time_budget_s: float = 6.0,
                  lazy_joint_time_budget_s: float = 1.5,
                  incremental: bool = True,
                  incremental_time_budget_s: float = 1.5,
                  l2_split: str = "proportional",
                  analysis: str = "strict",
                  decompose: str = "auto",
                  decompose_min_tenants: int = 6,
                  max_workers: int = 2
                  ) -> MultiCompiledModel:
    """Compile N independent models into one multi-tenant co-schedule.

    Stage 1 runs per model exactly as :func:`compile_model`; stage 2 merges
    the N execution DAGs under shared-resource constraints (per-device
    mutual exclusion, one double-buffered DMA engine, a shared L2 with
    per-tenant ``budgets`` — default an equal split).  With
    ``retile_for_contention`` the session then iterates contention hints ->
    per-tenant re-tiling -> exact re-arbitration until fixpoint (bounded by
    ``max_hint_rounds``), followed by the *joint* cross-tenant stage-1
    solve (one CP over every tenant's tile variables — shared device
    loads, one shared-L2 capacity constraint, coupled DMA; disabled with
    ``joint_tiling=False``, time-bounded by ``joint_time_budget_s`` with a
    best-response fallback).  The sequential concatenation of the
    single-model schedules remains a candidate throughout, so

        joint <= best-response <= re-tiling-free co-schedule <= sequential.

    The returned artifact is session-backed: ``plan_for(active)`` answers
    any occupancy from the session's :class:`PlanStore` (lazily compiling
    subset co-schedules on first miss — tiling re-decided per occupancy,
    with the L2 re-split among the active tenants) and ``tenant_plan`` /
    ``reference_plan`` reuse cached reference schedules.  Serving engines
    that must not stall on a miss probe with the thread-safe
    ``try_plan_for`` and push compiles to a background
    :class:`~repro.serve.compiler_thread.BackgroundCompiler`, whose
    ``submit_compile`` jobs run under the smaller
    ``lazy_joint_time_budget_s`` joint budget.

    ``incremental`` warm-starts each subset miss from the nearest cached
    occupancy's tiling solutions (under ``incremental_time_budget_s``)
    instead of solving from scratch; ``l2_split`` chooses the per-plan
    shared-L2 re-split — "proportional" (working-set-weighted, arbitrated
    against the equal split so it never ships a worse plan) or the legacy
    "equal"; ``analysis`` sets the static plan-analyzer mode the session
    runs over every plan before PlanStore insertion (``"strict"`` raises
    on ERROR diagnostics, ``"warn"`` records them, ``"off"`` skips).

    ``decompose`` controls the decomposed joint solve
    (:func:`repro.core.decompose.solve_decomposed`): ``"auto"`` engages
    it at ``decompose_min_tenants`` or more active tenants, ``"on"``
    always offers it, ``"off"`` never — the decomposed candidate is
    arbitrated against the monolithic joint / best-response candidates,
    so enabling it can only improve the shipped plan.  ``max_workers``
    bounds both the decomposed solve's cluster-solver threads and the
    default :class:`~repro.serve.compiler_thread.BackgroundCompiler`
    pool size."""
    assert len(graphs) >= 1
    request = CompileRequest(graphs=list(graphs), soc=soc, patterns=patterns,
                             mode=mode, requested_tiles=requested_tiles,
                             time_budget_s=time_budget_s, budgets=budgets,
                             retile_for_contention=retile_for_contention,
                             max_hint_rounds=max_hint_rounds,
                             joint_tiling=joint_tiling,
                             joint_time_budget_s=joint_time_budget_s,
                             lazy_joint_time_budget_s=lazy_joint_time_budget_s,
                             incremental=incremental,
                             incremental_time_budget_s=incremental_time_budget_s,
                             l2_split=l2_split, analysis=analysis,
                             decompose=decompose,
                             decompose_min_tenants=decompose_min_tenants,
                             max_workers=max_workers)
    return DeploymentSession(request).compile()
