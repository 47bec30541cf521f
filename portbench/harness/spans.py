"""Spans around the calls into the program's layers, timed on the device.

A span file ``portbench/spans/<name>.json`` names the functions to wrap
(``"module:attribute"``; the wrapper replaces the module's attribute,
so every caller that looks the name up there goes through it) and how:

* ``"kind": "call"`` (the default): each call is an interval between two
  CUDA events on the current stream, around the call.  ``"backward"``
  adds the call's backward: ``"node"`` times the output's autograd node
  (a pre-hook and a hook on it), ``"tensor"`` times from the output's
  gradient to the gradient of argument ``"input"``.  ``"work"`` names
  the count of ``portbench/work/counts.py`` that :func:`_work` reads the
  call's shapes into.
* ``"kind": "recompute"``: the wrapped function is a checkpoint; each
  time it runs its function again (in the backward) that run is an
  interval, which is taken out of the intervals it falls inside.

Intervals carry host-side sequence numbers at their start and stop; the
device stream runs them in that order, so one interval lies inside
another on the device exactly when it does on the host.  A span's time
is the sum of its intervals' device times less the recompute intervals
inside them.  Nothing here runs unless a traced run installs it.
"""

from __future__ import annotations

import bisect
import importlib
import itertools
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench.work import counts

SPANS_DIR = Path(__file__).resolve().parents[1] / "spans"


class _HostEvent:
    """A CPU stand-in for a CUDA event (the CPU tests)."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


class Interval:
    __slots__ = ("span", "kind", "work", "open", "close", "a", "b")

    def __init__(self, span: str, kind: str, work=None) -> None:
        self.span, self.kind, self.work = span, kind, work
        self.open = self.close = None

    def ms(self) -> float:
        return self.a.elapsed_time(self.b)


def _work(name: Optional[str], args, kwargs):
    """((forward flops, bytes), (backward flops, bytes), dtype) of a call,
    from its tensors' shapes."""
    if name == "flash_attention":
        q, k = args[0], args[1]
        causal = kwargs.get("causal", args[3] if len(args) > 3 else True)
        window = kwargs.get("window", args[4] if len(args) > 4 else None)
        B, S, H, Dh = q.shape
        fwd, bwd = counts.flash_attention(B, S, H, k.shape[2], Dh, causal,
                                          window, q.element_size())
    elif name == "grouped_matmul":
        x, w = args[0], args[1]
        E, C, D = x.shape
        fwd, bwd = counts.grouped_matmul(E, C, D, w.shape[2],
                                         x.element_size())
    else:
        return None
    return fwd, bwd, str(args[0].dtype).replace("torch.", "")


class Spans:
    def __init__(self, names: List[str], device: torch.device) -> None:
        self.defs = {n: json.loads((SPANS_DIR / f"{n}.json").read_text())
                     for n in names}
        self.cuda = device.type == "cuda"
        self.seq = itertools.count()
        self.intervals: List[Interval] = []
        self._undo: List[Callable[[], None]] = []

    # -- events -----------------------------------------------------------
    def _event(self):
        e = torch.cuda.Event(enable_timing=True) if self.cuda \
            else _HostEvent()
        e.record()
        return e

    def start(self, iv: Interval) -> None:
        if iv.open is None:
            iv.a, iv.open = self._event(), next(self.seq)

    def stop(self, iv: Interval) -> None:
        if iv.open is not None and iv.close is None:
            iv.b, iv.close = self._event(), next(self.seq)
            self.intervals.append(iv)

    def clear(self) -> None:
        """Drop what was recorded so far (the set-up's calls)."""
        self.intervals = []

    # -- wrappers ---------------------------------------------------------
    def install(self) -> "Spans":
        for name, d in self.defs.items():
            for target in d["targets"]:
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                make = (self._recompute if d.get("kind") == "recompute"
                        else self._call)
                setattr(mod, attr, make(name, d, orig))
                self._undo.append(
                    lambda m=mod, a=attr, o=orig: setattr(m, a, o))
        return self

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _call(self, name: str, d: dict, orig: Callable) -> Callable:
        backward, work = d.get("backward"), d.get("work")

        def wrapper(*args, **kwargs):
            w = _work(work, args, kwargs)
            iv = Interval(name, "fwd", w and (w[0], w[2]))
            self.start(iv)
            try:
                out = orig(*args, **kwargs)
            finally:
                self.stop(iv)
            if backward and isinstance(out, torch.Tensor) \
                    and out.requires_grad and out.grad_fn is not None:
                self._hook_backward(Interval(name, "bwd", w and (w[1], w[2])),
                                    backward, out, args, d)
            return out
        return wrapper

    def _hook_backward(self, iv: Interval, how: str, out: torch.Tensor,
                       args, d: dict) -> None:
        if how == "node":
            out.grad_fn.register_prehook(lambda go: self.start(iv))
            out.grad_fn.register_hook(lambda gi, go: self.stop(iv))
            return
        x = args[d["input"]]
        if isinstance(x, torch.Tensor) and x.requires_grad:
            out.register_hook(lambda g: self.start(iv))
            x.register_hook(lambda g: self.stop(iv))

    def _recompute(self, name: str, d: dict, orig: Callable) -> Callable:
        def wrapper(fn, *args, **kwargs):
            runs = itertools.count()

            def timed(*a, **k):
                if next(runs) == 0:            # the forward itself
                    return fn(*a, **k)
                iv = Interval(name, "recompute")
                self.start(iv)
                try:
                    return fn(*a, **k)
                finally:
                    self.stop(iv)
            return orig(timed, *args, **kwargs)
        return wrapper

    # -- readings ---------------------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """Per span: device ms of its forward and backward intervals (the
        recompute inside them taken out), its calls, and the least
        seconds of their work (``bound_s``, 0 where it has none)."""
        if self.cuda:
            torch.cuda.synchronize()
        rec = sorted((iv.open, iv.close, iv.ms()) for iv in self.intervals
                     if iv.kind == "recompute")
        opens = [r[0] for r in rec]
        out: Dict[str, dict] = {}
        for iv in self.intervals:
            s = out.setdefault(iv.span, {"fwd_ms": 0.0, "bwd_ms": 0.0,
                                         "recompute_ms": 0.0, "calls": 0,
                                         "bound_s": 0.0})
            if iv.kind == "recompute":
                s["recompute_ms"] += iv.ms()
                continue
            lo = bisect.bisect_right(opens, iv.open)
            hi = bisect.bisect_left(opens, iv.close)
            inside = sum(r[2] for r in rec[lo:hi] if r[1] < iv.close)
            s[iv.kind + "_ms"] += iv.ms() - inside
            s["calls"] += iv.kind == "fwd"
            if iv.work:
                (flops, nbytes), dtype = iv.work
                s["bound_s"] += counts.bound_s(flops, nbytes, dtype)
        return out
