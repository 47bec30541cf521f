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
batch in a Python loop (the JAX package's ``lax.scan``).  One device:
``accum_specs`` (the ZeRO-2 accumulator shardings) waits for the mesh
planner's port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.pytree import leaves, unflatten
from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

IGNORE = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions, in fp32; returns (loss,
    n_tokens).  The target log-prob is a gather (the JAX package's
    iota-compare-select form serves its vocab-sharded logits; one device
    has no such axis)."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lf = logits.to(torch.float32)
    # the max only shifts the exponentials; its gradient cancels exactly
    m = torch.amax(lf, dim=-1).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m[..., None]), dim=-1)) + m
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
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
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return (loss.detach(), aux), unflatten(params, grads)
    return fn


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    remat: bool = True,
                    microbatches: int = 1,
                    accum_specs: Optional[Any] = None,
                    donate: bool = False) -> Callable:
    """``accum_specs`` (the JAX package's ZeRO-2 pinning of the fp32
    microbatch accumulator over the data axis) needs a mesh: the port
    trains on one device and refuses it.  ``donate``: the step writes the
    new params and moments into its arguments' tensors and returns them
    (``adamw.update(donate=True)``), as the JAX launcher donates them to
    its jitted step; without it the step leaves its arguments as they
    are."""
    if accum_specs is not None:
        raise NotImplementedError("accum_specs needs core/meshplan.py, not "
                                  "yet ported: the port trains on one "
                                  "device")
    grad_fn = value_and_grad(make_loss_fn(cfg, remat=remat))

    def step(params, opt_state, batch):
        x, labels = batch["x"], batch["labels"]
        if microbatches > 1:
            B = x.shape[0]
            if B % microbatches != 0:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{microbatches} microbatches")
            g_acc: List[torch.Tensor] = [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves(params)]
            loss_acc = 0.0
            for xm, lm in zip(x.chunk(microbatches), labels.chunk(
                    microbatches)):
                (loss, aux), g = grad_fn(params, xm, lm)
                for a, b in zip(g_acc, leaves(g)):
                    a.add_(b)             # in place: one fp32 set
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
