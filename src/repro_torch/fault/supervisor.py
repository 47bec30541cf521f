"""Fault-tolerant training supervision: checkpoint/restart loop, simulated
failures, straggler mitigation policy.

On a real multi-pod deployment the supervisor is the per-job controller:
it runs the train loop, checkpoints every ``ckpt_every`` steps, and on any
step failure (preemption, ICI link error, host OOM — here injectable via
``failure_schedule``) restarts from the latest finished checkpoint —
possibly with a *different* device count (elastic: restore re-shards via
the checkpoint manifest).

Straggler mitigation: the supervisor tracks a rolling step-time median; a
step slower than ``straggler_factor`` x median is recorded, and after
``straggler_patience`` consecutive slow steps it triggers the mitigation
callback (on real pods: re-shard away from the slow host / re-launch the
replica; here: the policy decision is what is under test)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class SupervisorConfig:
    total_steps: int
    ckpt_every: int = 10
    max_restarts: int = 10
    straggler_factor: float = 3.0
    straggler_patience: int = 3


class StepFailure(Exception):
    """A simulated (or real) step failure."""


@dataclasses.dataclass
class RunReport:
    steps_run: int
    restarts: int
    stragglers: List[int]
    mitigations: int
    final_state: Any
    # wall seconds from each failure to the restored state (checkpoint
    # wait + manifest lookup + restore) — one entry per restart, so
    # recovery cost is a measured quantity, not an assumed one.  The
    # fleet rebalancer reports its SoC drain/migration latencies in the
    # same shape (``FleetRebalancer.stats()["recovery_s"]``).
    recovery_s: List[float] = dataclasses.field(default_factory=list)


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, ckpt: CheckpointManager,
                 failure_schedule: Optional[Dict[int, Exception]] = None,
                 step_time_hook: Optional[Callable[[int], float]] = None,
                 on_straggler: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.ckpt = ckpt
        self.failures = dict(failure_schedule or {})
        self.step_time_hook = step_time_hook
        self.on_straggler = on_straggler
        self.report_stragglers: List[int] = []
        self.mitigations = 0

    def run(self, init_state: Any, step_fn: Callable[[Any, int], Any],
            state_like: Optional[Any] = None) -> RunReport:
        """step_fn(state, step) -> state.  Restarts from the latest
        checkpoint on StepFailure."""
        state = init_state
        restarts = 0
        step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, state_like or init_state)
            step = latest + 1

        durations: List[float] = []
        recovery_s: List[float] = []
        slow_streak = 0
        while step < self.cfg.total_steps:
            try:
                if step in self.failures:
                    exc = self.failures.pop(step)
                    raise exc
                t0 = time.perf_counter()
                state = step_fn(state, step)
                dt = (self.step_time_hook(step)
                      if self.step_time_hook else
                      time.perf_counter() - t0)
                # straggler detection on a rolling median
                durations.append(dt)
                med = sorted(durations[-32:])[len(durations[-32:]) // 2]
                if len(durations) > 4 and dt > self.cfg.straggler_factor * med:
                    self.report_stragglers.append(step)
                    slow_streak += 1
                    if slow_streak >= self.cfg.straggler_patience:
                        self.mitigations += 1
                        slow_streak = 0
                        if self.on_straggler:
                            self.on_straggler(step)
                else:
                    slow_streak = 0
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
                step += 1
            except StepFailure:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                t_fail = time.perf_counter()
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    state, step = init_state, 0
                else:
                    state = self.ckpt.restore(latest,
                                              state_like or init_state)
                    step = latest + 1
                recovery_s.append(time.perf_counter() - t_fail)
        self.ckpt.wait()
        return RunReport(steps_run=step, restarts=restarts,
                         stragglers=self.report_stragglers,
                         mitigations=self.mitigations, final_state=state,
                         recovery_s=recovery_s)
