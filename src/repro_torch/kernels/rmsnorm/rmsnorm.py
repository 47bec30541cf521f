"""Fused RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) [* g]``
in fp32 math, output in x's dtype; ``g=None`` means no gain.

CUDA tensors launch the hand-written kernels in ``csrc/rmsnorm.cu`` on the
route :func:`route` picks from the width, the dtype and the alignment
(never the row count): ``"warp"`` (narrow rows, several to a warp),
``"block"`` (wide rows, one to a block) or ``"scalar"`` (what 16-byte
vectors cannot read).  CPU tensors run
:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_ENTRY = {torch.float32: "repro_rmsnorm_f32",
          torch.bfloat16: "repro_rmsnorm_bf16"}
_ROUTE_ID = {"warp": 0, "block": 1, "scalar": 2}
WARP_MAX_VECS = 128        # 16-byte vectors a warp holds (4 a lane)
BLOCK_MAX_VECS = 4096      # 512 threads x 8 vectors

launches = 0               # kernel launches since the last reset
routes = {"warp": 0, "block": 0, "scalar": 0}      # the same, by route


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
