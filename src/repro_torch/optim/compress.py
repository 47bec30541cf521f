"""Gradient compression for data-parallel all-reduce: int8 quantization
with error feedback (a standard large-scale distributed-optimization trick;
beyond-paper for MATCHA but squarely in its spirit — trading link load
against a little extra elementwise work).

The JAX package's ``repro/optim/compress.py`` over ``torch.distributed``:
``compressed_psum`` takes a process group where the original takes a
mapped axis name.  Each replica quantizes (grad + error_feedback) to int8
with a scale shared through an all-reduce of the maximum, sums the int8
payload as int32 over the group, dequantizes, and keeps the quantization
residual as the next step's error feedback.  Unbiasedness is restored
over time by the feedback loop.  With no process group initialised it is
the one-replica sum.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.pytree import leaves, tree_map, unflatten


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _distributed(group) -> bool:
    import torch.distributed as dist
    if group is not None:
        return True
    return dist.is_available() and dist.is_initialized()


def compressed_psum(grads: Any, error: Any, group: Optional[Any] = None
                    ) -> Tuple[Any, Any]:
    """Per-leaf int8 sum over the replicas of ``group`` (the default group
    when ``torch.distributed`` is initialised, else this process alone)
    with error feedback.  Returns (averaged grads, new error)."""
    import torch.distributed as dist
    many = _distributed(group)
    n = dist.get_world_size(group) if many else 1

    def leaf(g, e):
        gf = g.to(torch.float32) + e
        # shared scale via a max all-reduce, so the int8 payloads are
        # summable exactly
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        if many:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_e = gf - q.to(torch.float32) * scale    # local residual
        summed = q.to(torch.int32)
        if many:
            dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        avg = summed.to(torch.float32) * scale / n
        return avg.to(g.dtype), new_e

    out = [leaf(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(error, [o[1] for o in out]))


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
