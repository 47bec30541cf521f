"""The training driver: the port's train step, donated, on the mix's
batches, for ``--seconds``.

Set-up makes the weights and the optimizer state, builds the step the
launcher builds (``repro_torch.train.step.make_train_step`` with
``donate=True``) and drives it through the mix's ``check_steps`` first
steps on their own rows (the same call and feed as the window's, so the
set-up is also the warm-up and the checks read the timed path).  The
window then runs steps until ``--seconds`` have passed, one step in
flight: each step's batch is made on the host and copied to the card
while the step before it runs.  ``train_tokens_per_s`` is every token
of the steps the window ran over the window's seconds.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import torch

from portbench.harness import cell as C
from portbench.harness import checks, traffic
from portbench.harness.trace import Trace


class Feed:
    """Step ``i``'s batch on the device, through two pairs of pinned
    buffers (the one step in flight reads the other pair)."""

    def __init__(self, mix: dict, vocab: int, seed: int, device) -> None:
        self.mix, self.vocab, self.seed, self.device = mix, vocab, seed, device
        pin = device.type == "cuda"
        shape = (mix["batch"], mix["seq"])
        self.bufs = [(torch.empty(shape, dtype=torch.int32).pin_memory()
                      if pin else torch.empty(shape, dtype=torch.int32))
                     for _ in range(4)]

    def __call__(self, i: int) -> dict:
        x, y = traffic.train_rows(self.mix, self.vocab, self.seed, i)
        bx, by = self.bufs[2 * (i % 2)], self.bufs[2 * (i % 2) + 1]
        bx.numpy()[:] = x
        by.numpy()[:] = y
        return {"x": bx.to(self.device, non_blocking=True),
                "labels": by.to(self.device, non_blocking=True)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device):
    if device.type != "cuda":
        return None
    e = torch.cuda.Event()
    e.record()
    return e


def _log_steps(ends, device) -> None:
    """Step times of the window and the card's state, on stderr."""
    gaps = sorted(b - a for a, b in zip(ends, ends[1:]))
    if gaps:
        q = [gaps[int(f * (len(gaps) - 1))] * 1e3 for f in (0, .5, .9, 1)]
        print("window steps (ms, min/median/p90/max): "
              + " ".join(f"{x:.1f}" for x in q), file=sys.stderr)
    print("card: " + card_state(device), file=sys.stderr)


def card_state(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = []
    for name in ("clock_rate", "temperature", "power_draw"):
        try:
            out.append(f"{name} {getattr(torch.cuda, name)(device)}")
        except Exception as e:          # pynvml absent or unsupported
            out.append(f"{name} unread ({type(e).__name__})")
    return ", ".join(out)


def run(cell, cfg, seed: int, seconds: float, device, t_start: float,
        spans=None, trace: bool = False) -> C.Run:
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    mix, config = cell.mix, cell.config
    parts = {"to_driver_s": time.perf_counter() - t_start}
    params = C.make_params(config, cfg, seed, device)
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(**mix["adamw"])
    step = make_train_step(cfg, opt_cfg, remat=mix["remat"],
                           microbatches=mix["microbatches"], donate=True)
    feed = Feed(mix, cfg.vocab, seed, device)
    _sync(device)
    parts["weights_s"] = time.perf_counter() - t_start - sum(parts.values())

    # set-up: the check steps, read as the window would run them
    prog = {"losses": []}
    for i in range(mix["check_steps"]):
        params, opt, m = step(params, opt, feed(i))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = {}
            for path, t in C.flat_leaves(opt.m).items():
                prog["grad"].update(checks.part_norms(
                    path, t / (1.0 - opt_cfg.beta1)))
        _sync(device)
        parts[f"step{i + 1}_s"] = time.perf_counter() - t_start \
            - sum(parts.values())
    with torch.no_grad():
        prog["change"] = checks.initial_change(config, seed,
                                               C.flat_leaves(params))
    _sync(device)
    parts["change_s"] = time.perf_counter() - t_start - sum(parts.values())
    if spans:
        spans.clear()

    # the window; then, in a traced run, 1 + ``trace_steps`` steps more
    # under the profiler (the first its start-up), after the window's
    # spans and rates are taken
    losses, ends = [], []
    n, first = 0, mix["check_steps"]
    t0 = time.perf_counter()
    prev = None
    setup_s = t0 - t_start
    while True:
        params, opt, m = step(params, opt, feed(first + n))
        losses.append(m["loss"])
        n += 1
        done = _event(device)
        if prev is not None:
            prev.synchronize()
            ends.append(time.perf_counter())
        prev = done
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    _log_steps(ends, device)
    record = SimpleNamespace(
        config=config, mix=mix, window_s=window_s, steps=n,
        spans=spans.summary() if spans else {}, trace=None)
    if trace:
        with Trace(device) as tr:
            for k in range(1 + mix["trace_steps"]):
                if k == 1:
                    tr.begin()
                params, opt, m = step(params, opt, feed(first + n + k))
                losses.append(m["loss"])
                done = _event(device)
                if prev is not None:    # the feed's buffers are reused
                    prev.synchronize()
                prev = done
        record.trace = tr.reduce()
    device_info = C.device_info(device, cell.chips)
    finite = torch.isfinite(torch.stack([l.float() for l in losses]))
    failed = int((~finite).sum())

    tokens = n * mix["batch"] * mix["seq"]
    # the program's state goes before the reference runs
    del params, opt, step, m, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = checks.reference_train(config, mix, seed, device)
    numbers = checks.train_numbers(prog, want)
    ok, table = checks.verdict(numbers, cell.limits)
    return C.Run(correct=ok and failed == 0, attempted=n, failed=failed,
                 end_to_end={"train_tokens_per_s": tokens / window_s,
                             "setup_s": setup_s},
                 record=record, device=device_info, checks=table,
                 trace=record.trace, setup_parts=parts)

