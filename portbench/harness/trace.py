"""The device trace of a traced window: ``torch.profiler`` over the card's
activity, reduced to the device's busy seconds (the union of the
intervals in which an operation ran on the device, so overlapping work
counts once), the device operations that took the most time, and the
longest idle gaps, each put down to the host call that was running when
the device went idle (the innermost CUDA runtime call, on any thread;
"(no host operation)" where the host ran Python between calls).

After the measured window, the driver starts the profiler, runs one
step or request (the profiler's own start-up), then marks the traced
window's start and, at its end, its end, each mark a one-thread
``torch.cuda._sleep`` kernel launched after a synchronise.  The traced
window is the time between the end of the first mark and the start of
the second, on the device's own clock (where the profiler lost a mark's
record, between the ends of the synchronises before them).  Names are cut to
:data:`NAME` characters (a kernel's name holds its C++ template).
"""

from __future__ import annotations

import heapq
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10
NAME = 160
MARK = "spin_kernel"           # the kernel of torch.cuda._sleep
SYNC = "cudaDeviceSynchronize"

Span = Tuple[Tuple[float, float], str]      # ((start µs, end µs), name)


class Trace:
    """A context that profiles what runs inside it on ``device``; call
    :meth:`begin` where the traced window starts."""

    def __init__(self, device) -> None:
        self.cuda = device.type == "cuda"

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self) -> None:
        self._sync()
        if self.cuda:
            torch.cuda._sleep(1)

    def __enter__(self) -> "Trace":
        from torch.profiler import ProfilerActivity, profile
        self._mark()            # the mark's module loaded before tracing
        # the card's activity alone (kernels, copies and the CUDA runtime
        # calls that launched them): tracing every CPU operator as well
        # doubles a training step's host time and makes the card wait
        acts = [ProfilerActivity.CUDA] if self.cuda else \
            [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def begin(self) -> None:
        self._mark()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        self._mark()
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)

    def reduce(self) -> Dict[str, object]:
        from torch.autograd import DeviceType
        device, host = [], []
        for e in self.prof.events():
            span = ((e.time_range.start, e.time_range.end), e.name)
            (device if e.device_type == DeviceType.CUDA else host).append(
                span)
        return reduce(device, host, self.window_s)


def reduce(device: List[Span], host: List[Span], host_window_s: float
           ) -> Dict[str, object]:
    """``busy_s``, ``window_s`` and ``breakdown`` (``device_ops`` and
    ``idle_gaps``, each up to :data:`TOP` [name, seconds] by seconds) of
    the window between the marks (the host's window where there are
    none)."""
    marks = sorted(s for s, n in device if MARK in n)
    syncs = sorted(s for s, n in host if n == SYNC)
    ops = sorted((s, n) for s, n in device if MARK not in n)
    lo: Optional[float] = None
    hi: Optional[float] = None
    if len(marks) >= 2:
        lo, hi = marks[-2][1], marks[-1][0]
    elif len(syncs) >= 3:       # a mark's record was lost: the syncs before
        lo, hi = syncs[-3][1], syncs[-2][1]
    if lo is not None:
        ops = [((max(a, lo), min(b, hi)), n) for (a, b), n in ops
               if b > lo and a < hi]
    by_name: Dict[str, float] = {}
    for (a, b), name in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    busy, end, gaps = 0.0, lo, []
    for (a, b), _ in ops:
        if end is not None and a > end:
            gaps.append((end, a))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    if hi is not None and end is not None and hi > end:
        gaps.append((end, hi))
    window_s = (hi - lo) * 1e-6 if lo is not None else host_window_s
    blamed = _blame(gaps, sorted(host))
    totals: Dict[str, float] = {}
    for (a, b), name in blamed:
        totals[name] = totals.get(name, 0.0) + (b - a) * 1e-6
    start = lo if lo is not None else (ops[0][0][0] if ops else 0.0)
    longest = sorted(blamed, key=lambda g: g[0][0] - g[0][1])[:5]
    print(f"trace: {len(marks)} marks, {len(syncs)} syncs; "
          f"{len(ops)} device operations in {window_s:.6f} s, busy "
          f"{busy * 1e-6:.6f} s; longest gaps (ms from the start, ms, host):"
          " " + "; ".join(f"{(a - start) * 1e-3:.3f} {(b - a) * 1e-3:.3f} {n}"
                          for (a, b), n in longest), file=sys.stderr)

    def top(d: Dict[str, float]) -> List[list]:
        return [[k[:NAME], v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(totals)}}


def _blame(gaps: List[Tuple[float, float]], host: List[Span]) -> List[Span]:
    """Each gap with the innermost host call running at its start."""
    live: List[Tuple[float, int]] = []              # (end, index)
    out, i = [], 0
    for a, b in gaps:
        while i < len(host) and host[i][0][0] <= a:
            heapq.heappush(live, (host[i][0][1], i))
            i += 1
        while live and live[0][0] < a:
            heapq.heappop(live)
        inner = max(live, key=lambda x: host[x[1]][0][0], default=None)
        out.append(((a, b), host[inner[1]][1] if inner
                    else "(no host operation)"))
    return out
