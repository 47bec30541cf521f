"""Grouped (per-expert) matmul of the MoE layer: x (E, C, D) @ w (E, D, F)
-> (E, C, F), an fp32 accumulator, the output in x's dtype (fp32 or bf16).

CUDA tensors launch one of the two hand-written kernels in
``csrc/grouped_matmul.cu``, as :func:`route` picks before the launch: the
tensor-core kernel (``"wgmma"``, bf16 operands that TMA can read) or the
SIMT kernel (``"simt"``, everything else: any C, D and F, x and w read
through their strides).  CPU tensors run
:func:`~repro_torch.kernels.grouped_matmul.ref.grouped_matmul_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

_ENTRY = {("simt", torch.float32): "repro_grouped_matmul_f32",
          ("simt", torch.bfloat16): "repro_grouped_matmul_bf16",
          ("wgmma", torch.bfloat16): "repro_grouped_matmul_bf16_wgmma"}
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (F tiles, experts)
_BN = 64                   # SIMT output tile columns, as in the source

launches = 0               # kernel launches since the last reset
routes = {"wgmma": 0, "simt": 0}      # the same launches, by route


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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_matmul kernel for device {x.device}")
    _build.refuse_grad("grouped_matmul", x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if E > _MAX_GRID or -(-F // _BN) > _MAX_GRID:
        raise ValueError(f"grouped_matmul grid too large: E {E}, F {F}")
    r = route(x, w)
    lib = _build.library()
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        routes[r] += 1
        rc = getattr(lib, _ENTRY[r, x.dtype])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            *x.stride(), *w.stride(), stream)
    _build.check(rc, f"grouped_matmul ({r})")
    return out
