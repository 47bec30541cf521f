"""Fused RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) [* g]``
in fp32 math, output in x's dtype; ``g=None`` means no gain.

CUDA tensors launch the hand-written kernel in ``csrc/rmsnorm.cu``; CPU
tensors run :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_ENTRY = {torch.float32: "repro_rmsnorm_f32",
          torch.bfloat16: "repro_rmsnorm_bf16"}

launches = 0               # kernel launches since the last reset


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


def rmsnorm(x: torch.Tensor, g: Optional[torch.Tensor] = None,
            eps: float = 1e-6) -> torch.Tensor:
    _check(x, g)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for device {x.device}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(x.shape)
    if g is not None:
        g = g.contiguous()
    lib = _build.library()
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        rc = getattr(lib, _ENTRY[x.dtype])(
            x2.data_ptr(), None if g is None else g.data_ptr(),
            out.data_ptr(), rows, d, x2.stride(0), eps, stream)
    _build.check(rc, "rmsnorm")
    return out.reshape(x.shape)
