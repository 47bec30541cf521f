"""RG-LRU scan: the diagonal linear recurrence ``h_t = a_t * h_{t-1} +
b_t`` over a, b (B,T,D) from a zero state -> (h (B,T,D) in a's dtype,
h_T (B,D) in fp32), fp32 arithmetic.

CUDA tensors launch the hand-written kernel in ``csrc/rglru_scan.cu``
(any T, any D, a and b read through their strides); CPU tensors run
:func:`~repro_torch.kernels.rglru_scan.ref.rglru_ref`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_ref

_ENTRY = {torch.float32: "repro_rglru_f32",
          torch.bfloat16: "repro_rglru_bf16"}
_MAX_GRID = 65535          # gridDim.y limit (batch)

launches = 0               # kernel launches since the last reset


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"rglru takes fp32 or bf16 a/b of one dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"need a, b of one shape (B,T,D), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def rglru(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(a, b)
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no rglru kernel for device {a.device}")
    B, T, D = a.shape
    if B > _MAX_GRID:
        raise ValueError(f"B={B} exceeds the grid limit {_MAX_GRID}")
    a, b = (t if t.stride(-1) == 1 else t.contiguous() for t in (a, b))
    h = torch.empty((B, T, D), dtype=a.dtype, device=a.device)
    h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
    if B * D == 0:
        return h, h_last
    lib = _build.library()
    global launches
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        launches += 1
        rc = getattr(lib, _ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), h_last.data_ptr(),
            B, T, D, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            stream)
    _build.check(rc, "rglru")
    return h, h_last
