"""Grouped (per-expert) matmul of the MoE layer: x (E, C, D) @ w (E, D, F)
-> (E, C, F), an fp32 accumulator, the output in x's dtype (fp32 or bf16).

CUDA tensors launch one of the two hand-written kernels in
``csrc/grouped_matmul.cu``, as :func:`route` picks before the launch: the
tensor-core kernel (``"wgmma"``, bf16 operands that TMA can read) or the
SIMT kernel (``"simt"``, everything else: any C, D and F, x and w read
through their strides).  CPU tensors run
:func:`~repro_torch.kernels.grouped_matmul.ref.grouped_matmul_ref`.  Under
grad the CUDA call is an autograd node whose backward,
:func:`grouped_matmul_bwd`, runs the tensor-core kernel on the transposed
products, reading x, w and dy in place, or the SIMT kernel
(:func:`route_bwd`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_bwd_ref,
                                                    grouped_matmul_ref)

_ENTRY = {("simt", torch.float32): "repro_grouped_matmul_f32",
          ("simt", torch.bfloat16): "repro_grouped_matmul_bf16",
          ("wgmma", torch.bfloat16): "repro_grouped_matmul_bf16_wgmma"}
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (F tiles, experts)
_BN = 64                   # SIMT output tile columns, as in the source

launches = 0               # kernel launches since the last reset
routes = {"wgmma": 0, "simt": 0}      # the same launches, by route
bwd_launches = 0           # the backward's launches (two a call)
bwd_routes = {"wgmma": 0, "simt": 0}  # the same, by route


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul takes two fp32 or two bf16 "
                        f"operands, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"need x (E,C,D) and w (E,D,F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that a CUDA call of :func:`grouped_matmul` on these
    operands launches: ``"wgmma"`` for bf16 operands that TMA can read
    (innermost stride 1, other strides and the bases 16-byte aligned) with
    D and F multiples of 8 (and D > 0), ``"simt"`` for everything else.
    Pure: reads only dtypes, shapes, strides and data pointers, so it
    answers for CPU tensors too."""
    D, F = x.shape[2], w.shape[2]
    if (x.dtype == w.dtype == torch.bfloat16 and D > 0 and D % 8 == 0
            and F % 8 == 0 and _build.tma_readable(x)
            and _build.tma_readable(w)):
        return "wgmma"
    return "simt"


def route_bwd(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route of both of the backward's products, dx = dy wᵀ and dw =
    xᵀ dy, for the forward's operands x (E,C,D) and w (E,D,F): ``"wgmma"``
    where x and w are bf16 and D and F positive multiples of 8
    (the tensor-core kernel reads x, w and dy in place, as contiguous
    16-byte aligned tensors: A K-major for dx, B MN-major for dw, no
    transposed copy), ``"simt"`` otherwise (fp32, odd widths),
    on transposed views.  Pure: reads only dtypes and shapes."""
    D, F = x.shape[2], w.shape[2]
    return ("wgmma" if x.dtype == w.dtype == torch.bfloat16 and D > 0
            and F > 0 and D % 8 == 0 and F % 8 == 0 else "simt")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_matmul kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w)
    return _product(x, w, backward=False)


class _GroupedMatmul(torch.autograd.Function):
    """The CUDA kernels as an autograd node: forward by the same launch as
    without grad, backward by :func:`grouped_matmul_bwd`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w, backward=False)

    @staticmethod
    def backward(ctx, dy):
        return grouped_matmul_bwd(*ctx.saved_tensors, dy)


def _product(x: torch.Tensor, w: torch.Tensor, backward: bool
             ) -> torch.Tensor:
    """x (E,C,D) @ w (E,D,F) by one launch on :func:`route`'s kernel,
    counted with the forward's launches or the backward's."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if E > _MAX_GRID or -(-F // _BN) > _MAX_GRID:
        raise ValueError(f"grouped_matmul grid too large: E {E}, F {F}")
    r = route(x, w)
    lib = _build.library()
    global launches, bwd_launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if backward:
            bwd_launches += 1
            bwd_routes[r] += 1
        else:
            launches += 1
            routes[r] += 1
        rc = getattr(lib, _ENTRY[r, x.dtype])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            *x.stride(), *w.stride(), stream)
    _build.check(rc, f"grouped_matmul ({r})")
    return out


def grouped_matmul_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`grouped_matmul` for the output gradient dy
    (E,C,F): dx in x's dtype, dw in w's.  CUDA tensors take
    :func:`route_bwd`'s route: two launches of the tensor-core kernel on
    x, w and dy in place, or of the SIMT kernel on the transposed views;
    each output one accumulation in a fixed order.  CPU tensors run
    :func:`~repro_torch.kernels.grouped_matmul.ref.grouped_matmul_bwd_ref`."""
    _check(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    if tuple(dy.shape) != (E, C, F):
        raise ValueError(f"dy {tuple(dy.shape)} is not ({E}, {C}, {F})")
    if x.device.type == "cpu":
        return grouped_matmul_bwd_ref(x, w, dy)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_matmul backward kernel for device "
                         f"{x.device}")
    dy = dy.to(x.dtype)
    if route_bwd(x, w) == "simt":
        return (_product(dy, w.transpose(1, 2), backward=True),
                _product(x.transpose(1, 2), dy, backward=True))
    x, w, dy = map(_build.dense, (x, w, dy))
    return _product_bwd(0, x, w, dy), _product_bwd(1, x, w, dy)


def _product_bwd(which: int, x: torch.Tensor, w: torch.Tensor,
                 dy: torch.Tensor) -> torch.Tensor:
    """dx (``which`` 0) or dw (1) by one tensor-core launch on dense bf16
    x, w, dy, counted with the backward's launches."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, D) if which == 0 else (E, D, F),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0 or C == 0:        # dw over no rows is zero
        return out.zero_()
    if E > _MAX_GRID:
        raise ValueError(f"grouped_matmul grid too large: E {E}")
    lib = _build.library()
    global bwd_launches
    with _build.on_device(x.device.index):
        bwd_launches += 1
        bwd_routes["wgmma"] += 1
        rc = lib.repro_grouped_matmul_bwd_bf16_wgmma(
            which, x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            out.data_ptr(), E, C, D, F,
            _build.current_stream(x.device.index))
    name = "dx" if which == 0 else "dw"
    _build.check(rc, f"grouped_matmul backward ({name}, wgmma)")
    return out
