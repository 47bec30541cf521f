"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``cell.execute``, past the look for a
card) at smoke size on the CPU with the program in fp32, under the
cell's own limits: the sound run is correct, and each fault the cell can
have is not.  Training: a step that returns its state unchanged; half of
the batch left out, the mean taken over the rest.  Serving: the served
token altered where it is produced; the cache returned unchanged (as it
was allocated); half of the prompt left out.  (No cell runs on more than
one card, so none can leave out an exchange between cards.)"""

import time

import pytest
import torch

from portbench.harness import cell as C
from portbench.tests.smoke import serving_cell, smoke_cell

TRAIN = ["internlm2-1.8b.train-b4s1024", "granite-moe-3b-a800m.train-b4s1024"]
SEED = 2 ** 31 + 99


def _run(workload=None):
    """A run of ``workload``, or of the serving driver's cell."""
    cell, cfg = (smoke_cell(workload, dtype="float32") if workload
                 else serving_cell(dtype="float32"))
    assert cell.limits, f"{workload} has no limits file"
    return C.execute(cell, SEED, 0.2, False, torch.device("cpu"),
                     time.perf_counter(), cfg=cfg)


def state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update(cfg, state, grads, params, donate=False):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(adamw, "update", update)


def half_batch(monkeypatch):
    from repro_torch.train import step as step_mod
    make = step_mod.make_train_step

    def make_half(*a, **k):
        inner = make(*a, **k)

        def step(params, opt, batch):
            half = {n: t[: t.shape[0] // 2] for n, t in batch.items()}
            return inner(params, opt, half)
        return step
    monkeypatch.setattr(step_mod, "make_train_step", make_half)


@pytest.mark.parametrize("workload", TRAIN)
def test_a_sound_training_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
@pytest.mark.parametrize("workload", TRAIN)
def test_a_training_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["checks"]


def _prefill_fault(monkeypatch, change):
    from repro_torch.models import transformer
    prefill = transformer.prefill

    def broken(cfg, p, x, max_seq):
        return change(prefill, cfg, p, x, max_seq)
    monkeypatch.setattr(transformer, "prefill", broken)


def token_altered(monkeypatch):
    def change(prefill, cfg, p, x, max_seq):
        logits, cache = prefill(cfg, p, x, max_seq)
        top = logits.argmax(-1, keepdim=True)
        return logits.scatter(-1, top, float(logits.min()) - 1.0), cache
    _prefill_fault(monkeypatch, change)


def cache_unchanged(monkeypatch):
    def change(prefill, cfg, p, x, max_seq):
        logits, cache = prefill(cfg, p, x, max_seq)
        for entry in cache["slots"]:
            for t in entry.values():
                t.zero_()
        return logits, cache
    _prefill_fault(monkeypatch, change)


def half_prompt(monkeypatch):
    def change(prefill, cfg, p, x, max_seq):
        S = x.shape[1]
        logits, half = prefill(cfg, p, x[:, S // 2:], max_seq)
        cache = prefill(cfg, p, x, max_seq)[1]
        for entry, h in zip(cache["slots"], half["slots"]):
            for name in entry:
                entry[name][:, :, :S - S // 2] = h[name][:, :, :S - S // 2]
        return logits, cache
    _prefill_fault(monkeypatch, change)


def test_a_sound_serving_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [token_altered, cache_unchanged,
                                   half_prompt])
def test_a_serving_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]
