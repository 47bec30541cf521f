"""Fused RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) [* g]``
in fp32 math, output in x's dtype; ``g=None`` means no gain.

CUDA tensors launch the hand-written kernels in ``csrc/rmsnorm.cu`` on the
route :func:`route` picks from the width, the dtype and the alignment
(never the row count): ``"warp"`` (narrow rows, several to a warp),
``"block"`` (wide rows, one to a block) or ``"scalar"`` (what 16-byte
vectors cannot read).  CPU tensors run
:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`, which autograd
differentiates.

Where grad is enabled and x or g requires grad, a CUDA call goes through
a ``torch.autograd.Function``: its forward launches the same kernel on
the same route, and its backward :func:`rmsnorm_bwd`, the kernels of
``csrc/rmsnorm_bwd.cu`` (dx, and dg as per-block partial sums added in
block order by a second launch).  Every other call, serving's included,
launches exactly as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

_ENTRY = {torch.float32: "repro_rmsnorm_f32",
          torch.bfloat16: "repro_rmsnorm_bf16"}
_BWD_ENTRY = {torch.float32: ("repro_rmsnorm_bwd_f32",
                              "repro_rmsnorm_bwd_dg_f32"),
              torch.bfloat16: ("repro_rmsnorm_bwd_bf16",
                               "repro_rmsnorm_bwd_dg_bf16")}
_ROUTE_ID = {"warp": 0, "block": 1, "scalar": 2}
WARP_MAX_VECS = 128        # 16-byte vectors a warp holds (4 a lane)
BLOCK_MAX_VECS = 4096      # 512 threads x 8 vectors
BWD_MAX_WIDTH = 8192       # 256 threads x 32 columns
BWD_BLOCKS_PER_SM = 2      # the backward's row blocks: at most 2 an SM

launches = 0               # kernel launches since the last reset
routes = {"warp": 0, "block": 0, "scalar": 0}      # the same, by route
bwd_launches = 0           # backward kernel launches (dx, then dg's sum)


def _check(x: torch.Tensor, g: Optional[torch.Tensor]) -> None:
    if x.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm takes fp32 or bf16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"rmsnorm needs a non-empty last axis: "
                         f"{tuple(x.shape)}")
    if g is not None:
        if g.dtype != x.dtype or g.device != x.device:
            raise TypeError(f"gain {g.dtype} on {g.device} does not match "
                            f"x {x.dtype} on {x.device}")
        if tuple(g.shape) != (x.shape[-1],):
            raise ValueError(f"gain shape {tuple(g.shape)} is not "
                             f"({x.shape[-1]},)")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as the (rows, d) view the kernel reads: unit column stride."""
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(1) == 1 else x2.contiguous()


def _route2(x2: torch.Tensor, g: Optional[torch.Tensor]) -> str:
    rows, d = x2.shape
    e = 16 // x2.element_size()
    if (d % e or (rows > 1 and x2.stride(0) % e) or x2.data_ptr() % 16
            or (g is not None and g.data_ptr() % 16)):
        return "scalar"
    nvec = d // e
    if nvec <= WARP_MAX_VECS:
        return "warp"
    return "block" if nvec <= BLOCK_MAX_VECS else "scalar"


def route(x: torch.Tensor, g: Optional[torch.Tensor] = None) -> str:
    """The route a CUDA call of :func:`rmsnorm` on these operands launches.
    Pure: reads only dtypes, shapes, strides and data pointers, so it
    answers for CPU and meta tensors too."""
    _check(x, g)
    return _route2(_rows(x), None if g is None else g.contiguous())


def rmsnorm(x: torch.Tensor, g: Optional[torch.Tensor] = None,
            eps: float = 1e-6) -> torch.Tensor:
    _check(x, g)
    dev = x.device
    if dev.type == "cpu":
        return rmsnorm_ref(x, g, eps)
    if dev.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for device {dev}")
    if torch.is_grad_enabled() and (
            x.requires_grad or (g is not None and g.requires_grad)):
        return _RMSNorm.apply(x, g, eps)
    return _forward(x, g, eps)


def _forward(x: torch.Tensor, g: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    dev = x.device
    d = x.shape[-1]
    x2 = _rows(x)
    rows = x2.shape[0]
    # contiguous: the kernel's (rows, d) output in x's shape
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if rows == 0:
        return out
    if g is not None:
        g = g.contiguous()
    r = _route2(x2, g)
    lib = _build.library()
    global launches
    with _build.on_device(dev.index):
        launches += 1
        routes[r] += 1
        rc = getattr(lib, _ENTRY[x.dtype])(
            x2.data_ptr(), None if g is None else g.data_ptr(),
            out.data_ptr(), rows, d, x2.stride(0) if rows > 1 else d, eps,
            _ROUTE_ID[r], _build.sm_count(dev.index),
            _build.current_stream(dev.index))
    _build.check(rc, f"rmsnorm ({r})")
    return out


class _RMSNorm(torch.autograd.Function):
    """The CUDA kernel as an autograd node: forward by the forward kernel,
    backward by :func:`rmsnorm_bwd`."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _forward(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, g, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dg if ctx.needs_input_grad[1] else None, None)


def rmsnorm_bwd(x: torch.Tensor, g: Optional[torch.Tensor],
                dy: torch.Tensor, eps: float = 1e-6
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dg) of :func:`rmsnorm` at x, g for the output gradient dy: dx
    in x's shape and dtype, dg in g's (None without a gain).  CUDA
    tensors launch ``csrc/rmsnorm_bwd.cu``: the row kernel, then (with a
    gain) the ordered sum of its blocks' partial dg, two calls giving the
    same bits; CPU tensors run
    :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_bwd_ref`."""
    _check(x, g)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    dev = x.device
    if dev.type == "cpu":
        return rmsnorm_bwd_ref(x, g, dy, eps)
    if dev.type != "cuda":
        raise ValueError(f"no rmsnorm backward kernel for device {dev}")
    d = x.shape[-1]
    if d > BWD_MAX_WIDTH:
        raise ValueError(f"rmsnorm backward takes widths up to "
                         f"{BWD_MAX_WIDTH}, got {d}")
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.to(x.dtype).reshape(-1, d).contiguous()
    rows = x2.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dg = None if g is None else torch.empty_like(g)
    if rows == 0:
        return dx, None if g is None else dg.zero_()
    if g is not None:
        g = g.contiguous()
    # each block takes a contiguous run of rows and writes one partial dg
    # row: the count fixes the order of dg's sum
    blocks = min(rows, BWD_BLOCKS_PER_SM * _build.sm_count(dev.index))
    ws = (None if g is None else
          torch.empty((blocks, d), dtype=torch.float32, device=dev))
    rows_entry, sum_entry = _BWD_ENTRY[x.dtype]
    lib = _build.library()
    global bwd_launches
    with _build.on_device(dev.index):
        stream = _build.current_stream(dev.index)
        bwd_launches += 1
        rc = getattr(lib, rows_entry)(
            x2.data_ptr(), None if g is None else g.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(),
            None if ws is None else ws.data_ptr(), rows, d, blocks, eps,
            stream)
        _build.check(rc, "rmsnorm backward")
        if g is not None:
            bwd_launches += 1
            rc = getattr(lib, sum_entry)(ws.data_ptr(), dg.data_ptr(),
                                         blocks, d, stream)
            _build.check(rc, "rmsnorm backward (dg sum)")
    return dx, dg
