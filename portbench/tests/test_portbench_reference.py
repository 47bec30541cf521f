"""The benchmark's plain reference against the port's CPU path, at the
port's smoke sizes of both families, in fp32: one train step (loss,
gradients as AdamW receives them, the updated weights; a MoE layer's
capacity drops included) and a prefill (the last position's logits and
every layer's cache)."""

import pytest
import torch

from portbench.harness import cell as C
from portbench.harness import checks, traffic, weights
from portbench.reference import decoder as ref
from portbench.tests.smoke import smoke_cell

CELLS = {"dense": "internlm2-1.8b.train-b4s1024",
         "moe": "granite-moe-3b-a800m.train-b4s1024"}
SEED = 2 ** 33 + 17


def _weights(cell, skew: bool):
    """fp32 weights from the seed; ``skew`` sends every token to expert 0
    (a router column far above the others), so its capacity overflows."""
    w = weights.make(cell.config, SEED, "cpu")
    if skew:
        w["blocks.0.moe.router.w"][..., 0] += 5.0
    return w


def _rel(a, b) -> float:
    return checks.rel_err(a, b)


@pytest.mark.parametrize("family,skew", [("dense", False), ("moe", False),
                                         ("moe", True)])
def test_train_step_matches_the_port(family, skew):
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cell, cfg = smoke_cell(CELLS[family], dtype="float32")
    w = _weights(cell, skew)
    x, y = (torch.from_numpy(a) for a in traffic.train_rows(
        cell.mix, cfg.vocab, SEED, 0))
    if skew:
        # the reference drops assignments past expert 0's capacity
        C_ = ref.capacity(cell.config, x.shape[1])
        assert x.shape[1] * cell.config["num_experts_per_tok"] > C_

    # the port: one donated step on its own copy of the weights
    params = C.port_tree({k: t.clone() for k, t in w.items()}, cfg)
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(**cell.mix["adamw"])
    step = make_train_step(cfg, opt_cfg, remat=True, donate=True)
    params, opt, m = step(params, opt, {"x": x, "labels": y})
    port_g = {k: t / (1 - opt_cfg.beta1)
              for k, t in C.flat_leaves(opt.m).items()}
    port_w = C.flat_leaves(params)

    # the reference
    rw = {k: t.clone().requires_grad_(True) for k, t in w.items()}
    loss = ref.loss(cell.config, rw, x, y, ref.Exact)
    g = dict(zip(rw, torch.autograd.grad(loss, list(rw.values()))))
    ropt = ref.AdamW(cell.mix["adamw"], rw)
    g = ropt.clipped(g)
    want_g = {k: t.clone() for k, t in g.items()}
    with torch.no_grad():
        ropt.step(rw, g)

    loss = float(loss.detach())
    assert abs(float(m["loss"]) - loss) <= 1e-5 * loss
    for k in want_g:
        assert _rel(port_g[k], want_g[k]) < 1e-4, k
        assert _rel(port_w[k], rw[k].detach()) < 1e-5, k


@pytest.mark.parametrize("family,skew", [("dense", False), ("moe", True)])
def test_prefill_matches_the_port(family, skew):
    from repro_torch.models.api import get_model
    cell, cfg = smoke_cell(CELLS[family], dtype="float32")
    w = _weights(cell, skew)
    mix = {"prompts": {"median": 40, "sigma": 0.5, "min": 24, "max": 64,
                       "count": 3}}
    ids = torch.from_numpy(traffic.Prompts(mix, cfg.vocab, SEED).ids(0))
    S = ids.shape[1]
    with torch.no_grad():
        logits, cache = get_model(cfg).prefill(cfg, C.port_tree(w, cfg), ids,
                                               S + 8)
    want, want_kv = ref.prefill(cell.config, w, ids, ref.Exact)
    assert _rel(logits[0], want) < 1e-5
    c = cache["slots"][0]
    for g, (k, v) in enumerate(want_kv):
        assert _rel(c["k"][g, 0, :S], k) < 1e-5
        assert _rel(c["v"][g, 0, :S], v) < 1e-5
        assert not c["k"][g, 0, S:].any()


def test_the_fp8_control_rounds_both_operands():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 32, generator=gen)
    b = torch.randn(32, 16, generator=gen)
    err = _rel(ref.FP8.mm(a, b), ref.Exact.mm(a, b))
    assert 1e-3 < err < 0.1           # e4m3: 3 mantissa bits
