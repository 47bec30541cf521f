"""AdamW on plain pytrees of tensors, with float32 moments over (possibly
bf16) params, cosine schedule with warmup, and the ZeRO-1 moment sharding
helpers (which wait for the mesh planner's port).

The JAX package's ``repro/optim/adamw.py`` with its arithmetic unchanged:
every scalar (the step, the schedule, the bias corrections, the clip
factor) is a float32 tensor on the params' device, so ``update`` is a
function of tensors that never waits for the card.  ``update`` returns
new tensors and leaves its arguments as they are."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.pytree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any


def _device(params) -> torch.device:
    for leaf in leaves(params):
        return leaf.device
    return torch.device("cpu")


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    sq = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        sq = s if sq is None else sq + s
    if sq is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sq)


# elements of a donated leaf updated at once: a larger leaf is walked in
# slices along its first axis, which bounds the update's fp32 temporaries
# (granite-moe-3b-a800m's stacked experts, 32 x 40 x 1536 x 512 = 1.0 B
# elements, would need ~4 GB for each)
DONATE_SLICE = 1 << 26


def _slices(t: torch.Tensor, limit: int):
    """Indices that cut ``t`` along its first axis into pieces of at most
    ``limit`` elements (whole rows; a 0-d tensor, or one that fits, is
    one piece)."""
    if t.dim() == 0 or t.numel() <= limit:
        return [...]
    rows = max(1, limit // max(1, t.numel() // t.shape[0]))
    return [slice(a, a + rows) for a in range(0, t.shape[0], rows)]


def update(cfg: AdamWConfig, state: AdamWState, grads, params,
           donate: bool = False
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``donate``: the new params and moments are written
    into ``params``, ``state.m`` and ``state.v`` leaf by leaf, and those
    trees are returned (what the JAX launcher gets from
    ``jax.jit(..., donate_argnums=(0, 1))``): the step then holds one set
    of params and moments and the temporaries of one leaf, or of one
    slice of at most :data:`DONATE_SLICE` elements of a larger leaf (the
    update is elementwise, so the slices give the whole leaf's bits), not
    two sets."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                      # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = []
    for leaf in zip(leaves(params), leaves(grads), leaves(state.m),
                    leaves(state.v)):
        if not donate:
            out.append(upd(*leaf))
            continue
        p, _, m, v = leaf
        for at in _slices(p, DONATE_SLICE):
            new = upd(*(t[at] for t in leaf))
            for old, value in zip((p[at], m[at], v[at]), new):
                old.copy_(value)
        out.append((p, m, v))
    new_params, new_m, new_v = (
        unflatten(like, [o[i] for o in out])
        for i, like in enumerate((params, state.m, state.v)))
    return new_params, AdamWState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}


def zero_specs(plan, mesh, params):
    """PartitionSpec pytree for ZeRO-sharded per-param fp32 buffers (Adam
    moments, microbatch grad accumulators).  Needs the mesh planner
    (``core/meshplan.py``), which the port does not have yet: the port
    trains on one device."""
    raise NotImplementedError("zero_specs needs core/meshplan.py, not yet "
                              "ported: the port trains on one device")


def zero1_shardings(plan, mesh, params, opt_state: AdamWState):
    """ZeRO-1 moment shardings over the data axis.  Needs the mesh planner
    (``core/meshplan.py``), which the port does not have yet."""
    raise NotImplementedError("zero1_shardings needs core/meshplan.py, not "
                              "yet ported: the port trains on one device")
