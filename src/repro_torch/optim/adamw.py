"""AdamW on plain pytrees of tensors, with float32 moments over (possibly
bf16) params, cosine schedule with warmup, and the ZeRO-1 moment sharding
helpers.

The JAX package's ``repro/optim/adamw.py`` with its arithmetic unchanged:
every scalar (the step, the schedule, the bias corrections, the clip
factor) is a float32 tensor on the params' device, so ``update`` is a
function of tensors that never waits for the card.  ``update`` returns
new tensors and leaves its arguments as they are, unless told to write
into them (``donate``).

On a device mesh the params, gradients and moments are DTensors.  A
gradient arrives Partial over the data axes; ``update`` reduces it to
its moments' placement (an all-reduce to the param's placement, or a
reduce-scatter to a ZeRO-1 moment's), takes the global norm over those
reduced gradients (DTensor sums count a replicated element once and a
sharded one once on its shard: the norm and the clip factor stay on the
device), updates each rank's local shards with the same ops in the same
order as on one device, and gathers each new param back to its own
placement."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.meshplan import (Sharding, Spec, map_with_path,
                                       mesh_axes)
from repro_torch.core.on_mesh import on_mesh
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
    """Zero moments in each param's shape (and, for a DTensor param, its
    placements) and a zero step."""
    def zeros(p):
        if on_mesh(p):
            return torch.zeros_like(p, dtype=torch.float32)
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
    mesh = any(on_mesh(p) for p in leaves(params))
    if mesh:
        # each gradient reduced to its moments' placement first
        grads = unflatten(grads, [
            g.redistribute(g.device_mesh, m.placements)
            for g, m in zip(leaves(grads), leaves(state.m))])
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), stepf)

    # on a mesh each rank updates its local shards with local scalars
    clip_, lr_, bc1, bc2 = (t.to_local() if on_mesh(t) else t
                            for t in (clip, lr, bc1, bc2))

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip_
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                      # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr_ * delta).to(p.dtype), m, v

    if mesh:
        new_params, new_m, new_v = _update_on_mesh(upd, grads, params,
                                                   state, donate)
        return new_params, AdamWState(step, new_m, new_v), \
            {"grad_norm": gnorm, "lr": lr}

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


def _update_on_mesh(upd, grads, params, state: AdamWState, donate: bool):
    """``update``'s leaf loop on DTensors: each leaf's param and (already
    reduced) gradient laid out as its moments, ``upd`` on the local
    shards, the new param gathered back to its placement.  ``donate``
    writes the new local shards into the old DTensors' local tensors.
    Returns the new (params, m, v) trees."""
    from torch.distributed.tensor import DTensor

    def wrap(local, like, at):
        return DTensor.from_local(local, like.device_mesh, at,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    out = []
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        at = m.placements
        new_p, new_m, new_v = upd(
            p.redistribute(m.device_mesh, at).to_local(), g.to_local(),
            m.to_local(), v.to_local())
        new_p = wrap(new_p, p, at).redistribute(p.device_mesh,
                                                p.placements)
        if donate:
            for old, value in zip((p, m, v),
                                  (new_p.to_local(), new_m, new_v)):
                old.to_local().copy_(value)
            out.append((p, m, v))
        else:
            out.append((new_p, wrap(new_m, m, at), wrap(new_v, v, at)))
    return tuple(unflatten(like, [o[i] for o in out])
                 for i, like in enumerate((params, state.m, state.v)))


def _zero_spec(plan, mesh):
    """The ZeRO spec of a leaf at a path: the param's plan spec plus the
    data axis on its largest unsharded dim that the axis divides."""
    axes = mesh_axes(mesh)
    dp_axis = "data" if "data" in axes else None

    def spec(ps, leaf):
        base = plan.spec_for(ps, leaf.dim())
        if dp_axis is None or leaf.dim() == 0:
            return Spec(*base)
        out = list(base) + [None] * (leaf.dim() - len(base))
        for i in sorted(range(leaf.dim()), key=lambda i: -leaf.shape[i]):
            if out[i] is None and leaf.shape[i] % axes[dp_axis] == 0 \
                    and leaf.shape[i] >= axes[dp_axis]:
                out[i] = dp_axis
                break
        return Spec(*out)
    return spec


def zero_specs(plan, mesh, params):
    """Spec tree for ZeRO-sharded per-param fp32 buffers (Adam moments,
    microbatch grad accumulators): the param's plan spec plus the data
    axis on the largest unsharded divisible dim."""
    return map_with_path(_zero_spec(plan, mesh), params)


def zero1_shardings(plan, mesh, params, opt_state: AdamWState):
    """ZeRO-1: Adam moments take the param's spec *plus* the data axis on
    the largest currently-unsharded dimension when divisible (the fp32
    moments are the dominant optimizer memory and need not be replicated
    across data-parallel replicas); the step is replicated."""
    spec = _zero_spec(plan, mesh)

    def moment(tree):
        return map_with_path(lambda ps, leaf: Sharding(mesh, spec(ps, leaf)),
                             tree)
    return AdamWState(step=Sharding(mesh, Spec()), m=moment(opt_state.m),
                      v=moment(opt_state.v))
