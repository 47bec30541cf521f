"""The arithmetic of the per-layer metrics, which the readers in
``portbench/metrics/<metric>.py`` apply to a run's record: each returns
None where the run gave it nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.work import counts


def _peak(rec) -> float:
    return counts.PEAKS["flops_per_s"][rec.config["torch_dtype"]]


def train_mfu(rec) -> Optional[float]:
    """The model FLOPs of the window's training steps over its seconds
    times the card's peak, in %."""
    if not getattr(rec, "steps", 0):
        return None
    flops = rec.steps * counts.train_step_flops(rec.config, rec.mix["batch"],
                                                rec.mix["seq"])
    return 100.0 * flops / (rec.window_s * _peak(rec))


def prefill_mfu(rec) -> Optional[float]:
    """The model FLOPs of every prompt the window served over its seconds
    times the card's peak, in %."""
    if not getattr(rec, "lengths", None):
        return None
    flops = sum(counts.prefill_flops(rec.config, n) for n in rec.lengths)
    return 100.0 * flops / (rec.window_s * _peak(rec))


def span_ms_per_step(rec, span: str) -> Optional[float]:
    """Device ms of a span's calls (and their backward) per step."""
    s = rec.spans.get(span)
    if not s or not s["calls"]:
        return None
    return (s["fwd_ms"] + s["bwd_ms"]) / rec.steps


def roofline(rec, span: str) -> Optional[float]:
    """The least time of a span's work over its device time, in %."""
    s = rec.spans.get(span)
    if not s or not s["calls"]:
        return None
    return 100.0 * s["bound_s"] / ((s["fwd_ms"] + s["bwd_ms"]) * 1e-3)


def idle_share(rec) -> Optional[float]:
    """1 - busy / window of the traced window, in %."""
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])


def host_ms_median(rec) -> Optional[float]:
    if not getattr(rec, "host_ms", None):
        return None
    return statistics.median(rec.host_ms)
