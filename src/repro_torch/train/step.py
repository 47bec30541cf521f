"""Training step: next-token CE loss, grads, AdamW, remat + microbatching.

``make_train_step(cfg, opt_cfg, remat, microbatches)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``, the
JAX package's signature: a function of its arguments, which it leaves
as they are unless asked to take them over (``donate``).  Gradients
come from ``torch.autograd.grad`` over the params' leaves (detached
views of their storage that require grad, so the caller's tensors are
never marked), through the hand-written backward
kernels on the card (RMSNorm, flash attention, WKV6, the RG-LRU scan and
the grouped matmul).  Microbatching
accumulates fp32 grads over ``microbatches`` sequential chunks of the
batch in a Python loop (the JAX package's ``lax.scan``).

On a device mesh (params and batch as DTensors laid out by
``core/meshplan.py``) the same step runs op by op on DTensors: the loss
is reduced to a replicated scalar before the backward, gradients reach
the params Partial over the data axes, and ``accum_specs`` (the JAX
package's ZeRO-2 pinning, ``adamw.zero_specs``) lays the fp32
microbatch accumulator out over the data axis, each microbatch's
gradient reduce-scattered into it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.meshplan import placements
from repro_torch.core import on_mesh
from repro_torch.core.pytree import leaves, unflatten
from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

IGNORE = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions, in fp32; returns (loss,
    n_tokens).  The max, the exponentials' sum and the target's logit
    come from ``on_mesh.vocab_stats``: on plain tensors an amax, a sum
    and a gather; on a mesh each rank's vocab shard reduced on its own,
    so vocab-sharded logits are never gathered (the JAX package's
    iota-compare-select form, for the same reason)."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lf = logits.to(torch.float32)
    # the max only shifts the exponentials; its gradient cancels exactly
    m, se, picked = on_mesh.vocab_stats(lf, safe)
    lse = torch.log(se) + m
    ll = picked - lse
    n = torch.clamp(torch.sum(mask), min=1)
    return -torch.sum(torch.where(mask, ll, torch.zeros_like(ll))) / n, n


def make_loss_fn(cfg: ModelConfig, remat: bool = True):
    model = get_model(cfg)

    def loss_fn(params, x, labels):
        logits = model.forward(cfg, params, x, remat=remat)
        loss, n = cross_entropy(logits, labels)
        return loss, {"loss": loss, "tokens": n}
    return loss_fn


def value_and_grad(loss_fn) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for the port:
    (params, x, labels) -> ((loss, aux), grads), grads a tree like params,
    each leaf in its param's dtype.  A leaf the loss does not reach gets
    zeros, as ``jax.grad`` gives it."""
    def fn(params, x, labels):
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            loss, aux = loss_fn(unflatten(params, live), x, labels)
            if on_mesh.on_mesh(loss):
                # one replicated scalar: each rank's backward then starts
                # from the loss itself, not from its partial sum
                loss = loss.redistribute(
                    loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return (loss.detach(), aux), unflatten(params, grads)
    return fn


def _chunks(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``t`` cut into ``n`` microbatches of consecutive batch rows, as the
    JAX package's reshape cuts them.  A DTensor batch is gathered once
    (token ids: small) and each microbatch laid out as the batch was, so
    each is again data-parallel and the microbatches hold the rows they
    hold on one device."""
    if not on_mesh.on_mesh(t):
        return list(t.chunk(n))
    from torch.distributed.tensor import DTensor
    mesh = t.device_mesh
    whole = t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return [DTensor.from_local(c, mesh, [Replicate()] * mesh.ndim,
                               run_check=False).redistribute(mesh,
                                                             t.placements)
            for c in whole.chunk(n)]


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    remat: bool = True,
                    microbatches: int = 1,
                    accum_specs: Optional[Any] = None,
                    donate: bool = False) -> Callable:
    """``accum_specs``: optional Spec tree (``adamw.zero_specs``) laying
    out the fp32 microbatch grad accumulator of DTensor params on their
    mesh (ZeRO-2-style: sharded over data so the accumulator never
    replicates across DP replicas).  ``donate``: the step writes the new
    params and moments into its arguments' tensors and returns them
    (``adamw.update(donate=True)``), as the JAX launcher donates them to
    its jitted step; without it the step leaves its arguments as they
    are."""
    grad_fn = value_and_grad(make_loss_fn(cfg, remat=remat))

    def zeros(p, spec):
        if spec is None:
            if on_mesh.on_mesh(p):
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        if not on_mesh.on_mesh(p):
            raise ValueError("accum_specs lays out DTensor params on their "
                             "mesh; these params are plain tensors")
        return dtensor_zeros(p.shape, dtype=torch.float32,
                             device_mesh=p.device_mesh,
                             placements=placements(spec, p.device_mesh))

    def accumulate(acc, g):
        if on_mesh.on_mesh(g):
            g = g.redistribute(acc.device_mesh, acc.placements)
        acc.add_(g)               # in place: one fp32 set

    def step(params, opt_state, batch):
        if on_mesh.on_mesh(batch["x"]):
            # tensors the model makes itself (positions, masks) are the
            # same on every rank: they join DTensor ops as replicated
            with implicit_replication():
                return _step(params, opt_state, batch)
        return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        x, labels = batch["x"], batch["labels"]
        if microbatches > 1:
            B = x.shape[0]
            if B % microbatches != 0:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{microbatches} microbatches")
            specs = (leaves(accum_specs) if accum_specs is not None
                     else [None] * len(leaves(params)))
            g_acc: List[torch.Tensor] = [
                zeros(p, spec) for p, spec in zip(leaves(params), specs)]
            loss_acc = 0.0
            for xm, lm in zip(_chunks(x, microbatches),
                              _chunks(labels, microbatches)):
                (loss, aux), g = grad_fn(params, xm, lm)
                for a, b in zip(g_acc, leaves(g)):
                    accumulate(a, b)
                loss_acc = loss_acc + loss
            grads = unflatten(params, [g.div_(microbatches)
                                       for g in g_acc])
            loss = loss_acc / microbatches
        else:
            (loss, aux), grads = grad_fn(params, x, labels)
        params, opt_state, om = adamw.update(opt_cfg, opt_state, grads,
                                             params, donate=donate)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics
    return step


def make_eval_step(cfg: ModelConfig):
    loss_fn = make_loss_fn(cfg, remat=False)

    def step(params, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, aux = loss_fn(params, batch["x"], batch["labels"])
        return {"loss": loss}
    return step
