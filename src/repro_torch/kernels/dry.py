"""What a kernel's wrapper does with tensors that have no storage.

The dry run (``launch/dryrun.py``) traces a step on fake tensors
(``FakeTensorMode``) or meta tensors: shapes, dtypes and devices, no
data.  A wrapper given such tensors neither launches its kernel nor runs
its plain version (the WKV6 and RG-LRU plain versions loop over time in
Python: 10^5-10^6 fake ops a cell); it returns outputs of the right
shapes and dtypes through :func:`call`, and adds the kernel's own
operations and bytes to this module's tally, counted as ``PERF.md``'s
bounds count them (each input read once, each output written once).
Under grad the outputs come from an autograd node whose backward gives
gradients of the inputs' shapes and adds the backward kernels' counts,
so a traced train step still runs the backward of everything around the
kernel.  This is what ``torch.library.register_fake`` gives a custom op,
without a custom op's host cost on every real call: real CPU and CUDA
tensors never reach this module.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

flops = 0.0                 # the kernels' operations since the last reset
nbytes = 0.0                # the kernels' bytes moved since the last reset
calls: Dict[str, int] = {}  # kernel -> storage-less calls


def reset() -> None:
    global flops, nbytes
    flops, nbytes = 0.0, 0.0
    calls.clear()


def storageless(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake or meta tensor: a shape without data (a
    plain tensor answers at once: every kernel call asks)."""
    if type(t) is torch.Tensor:
        return t.is_meta
    from torch._subclasses.fake_tensor import is_fake
    return t.is_meta or is_fake(t)


def _count(name: str, work: Tuple[float, float]) -> None:
    global flops, nbytes
    flops += work[0]
    nbytes += work[1]
    calls[name] = calls.get(name, 0) + 1


class _Shapes(torch.autograd.Function):
    """Outputs of the given shapes; a backward of the inputs' shapes."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        name, outs, fwd, bwd, like = spec
        ctx.spec = spec
        ctx.shapes = [(t.shape, t.dtype) if isinstance(t, torch.Tensor)
                      else None for t in inputs]
        _count(name, fwd)
        return tuple(torch.empty(s, dtype=d, device=like.device)
                     for s, d in outs)

    @staticmethod
    def backward(ctx, *grads):
        name, _, _, bwd, like = ctx.spec
        _count(name + "_bwd", bwd)
        return (None,) + tuple(
            None if sd is None else torch.empty(sd[0], dtype=sd[1],
                                                device=like.device)
            for sd in ctx.shapes)


def call(name: str, inputs: Sequence[Optional[torch.Tensor]],
         outputs: Sequence[Tuple[Sequence[int], torch.dtype]],
         fwd: Tuple[float, float],
         bwd: Tuple[float, float] = (0.0, 0.0)):
    """A kernel call on storage-less ``inputs``: the tuple of ``outputs``
    (shape, dtype) on the first input's device, with the forward's
    (operations, bytes) ``fwd`` tallied, and ``bwd`` tallied when a
    backward runs through them."""
    like = next(t for t in inputs if t is not None)
    spec = (name, [(tuple(s), d) for s, d in outputs], fwd, bwd, like)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _Shapes.apply(spec, *inputs)
    _count(name, fwd)
    return tuple(torch.empty(tuple(s), dtype=d, device=like.device)
                 for s, d in outputs)


def attention_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs of an S-token self-attention that its masks
    allow (``ref.attention_mask``: causal keys d = q - k >= 0, a window
    keeps d < window, both sides when not causal)."""
    if window is None:
        return S * (S + 1) // 2 if causal else S * S
    w = max(int(window), 0)
    if w == 0:
        return 0
    if w >= S:
        return S * (S + 1) // 2 if causal else S * S
    one_side = w * S - w * (w - 1) // 2          # 0 <= d < w
    return one_side if causal else 2 * one_side - S
