"""Structured diagnostics for the static plan analyzer.

Every finding the analyzer emits is a :class:`Diagnostic` — a stable
linter-style rule ID (``PA001``..``PA008``), a :class:`Severity`, a
human-readable message, and enough structure (nodes, tensors, resource,
tenant, time window) for tooling to group, count, and gate on findings
without parsing message text.

The shared ``TIME_EPS`` lives here too: historically
``schedule.validate_schedule`` / ``validate_multi_schedule`` used a
``1e-6``-cycle slack while ``memplan.validate_plan`` compared with strict
inequalities — three checkers, two epsilon conventions.  All interval
overlap tests in the analyzer (and, through the wrapper shims, in the
legacy validators) now agree: two half-open intervals ``[a0, a1)`` and
``[b0, b1)`` conflict iff each starts more than ``TIME_EPS`` before the
other ends.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

#: One epsilon for every time/interval comparison in plan validation.
#: Units are cycles (the analytic schedule clock).
TIME_EPS = 1e-6


class Severity(enum.IntEnum):
    """Graded like a compiler: only ERROR findings fail strict mode."""
    INFO = 10
    WARNING = 20
    ERROR = 30


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered analyzer rule: stable ID + default severity."""
    rule_id: str
    title: str
    severity: Severity
    description: str


#: The stable rule registry.  IDs are append-only: a retired check keeps
#: its number (like flake8 codes) so CI gates and suppressions never
#: silently rebind.
RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("PA001", "precedence", Severity.ERROR,
         "A node starts before one of its predecessors ends (or a "
         "tenant's completion time exceeds the plan makespan)."),
    Rule("PA002", "resource-overlap", Severity.ERROR,
         "Two occupants of one exclusive resource (a device, or the "
         "single DMA engine including inline transfers) overlap in "
         "time; sequential-mode plans additionally require global "
         "mutual exclusion."),
    Rule("PA003", "data-hazard", Severity.ERROR,
         "A DMA transfer touches an L2 tensor while a node reading or "
         "writing that tensor is executing (RAW/WAR/WAW between the "
         "DMA engine and compute)."),
    Rule("PA004", "use-after-evict", Severity.ERROR,
         "A node reads a tensor outside any of its L2 residency "
         "windows — the buffer was evicted/swapped out (or never "
         "loaded) while still needed."),
    Rule("PA005", "l2-aliasing", Severity.ERROR,
         "Two concurrently-live L2 allocations overlap in address "
         "space, or an allocation falls outside the L2 capacity."),
    Rule("PA006", "tenant-isolation", Severity.ERROR,
         "An allocation escapes its tenant's SharedL2Allocator slice: "
         "owner tag disagrees with the tensor's namespace, or a "
         "tenant's persistent (static) footprint exceeds its budget. "
         "Transient soft-budget overshoot is reported at WARNING."),
    Rule("PA007", "dag-shape", Severity.ERROR,
         "The plan DAG is malformed: a dependency cycle, a reference "
         "to a missing predecessor, or a node that was never "
         "scheduled."),
    Rule("PA008", "double-buffer", Severity.ERROR,
         "A planned load lands outside the target buffer's residency "
         "window — the transfer would overwrite a buffer before its "
         "allocation opens or after it closes (double-buffer "
         "discipline violation)."),
]}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding.  ``str(d)`` renders the legacy-validator
    style one-liner the wrapper shims return."""
    rule: str                                    # e.g. "PA003"
    severity: Severity
    message: str
    nodes: Tuple[str, ...] = ()
    tensors: Tuple[str, ...] = ()
    resource: Optional[str] = None
    tenant: Optional[int] = None
    window: Optional[Tuple[float, float]] = None

    def __str__(self) -> str:
        return f"{self.rule}[{self.severity.name}] {self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["severity"] = self.severity.name
        return d


def errors_only(diags) -> list:
    """The strict-mode view: ERROR-severity findings only."""
    return [d for d in diags if d.severity >= Severity.ERROR]
