"""Tiled GEMM: ``jnp.matmul`` semantics over fp32 or bf16 operands with an
fp32 accumulator and the output in the operands' dtype.

CUDA tensors launch the hand-written kernel in ``csrc/matmul.cu``; CPU
tensors run :func:`~repro_torch.kernels.matmul.ref.matmul_ref`.  Shapes:
``(..., M, K) @ (K, N)`` (leading dims of ``a`` flattened into M), or
``(..., M, K) @ (..., K, N)`` with broadcast batch dims.  ``b`` is read
through its strides, so a column slice of a weight or a transposed view
goes in without a copy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

_ENTRY = {torch.float32: "repro_matmul_f32",
          torch.bfloat16: "repro_matmul_bf16"}
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (M tiles, batch)
_BM = 64                   # output tile rows, as in csrc/matmul.cu

launches = 0               # kernel launches since the last reset


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"matmul takes two fp32 or two bf16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError(f"matmul needs 2-D or higher operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no matmul kernel for device {a.device}")
    K, N = b.shape[-2], b.shape[-1]
    if b.dim() == 2:
        lead = a.shape[:-1]
        a3 = a.reshape(1, -1, K)
        b3 = b.unsqueeze(0)
    else:
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        M = a.shape[-2]
        lead = (*batch, M)
        a3 = a.expand(*batch, M, K).reshape(-1, M, K)
        b3 = b.expand(*batch, K, N).reshape(-1, K, N)
    nb, M = a3.shape[0], a3.shape[1]
    out = torch.empty((nb, M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out.reshape(*lead, N)
    if nb > _MAX_GRID or -(-M // _BM) > _MAX_GRID:
        raise ValueError(f"matmul grid too large: batch {nb}, M {M}")
    lib = _build.library()
    global launches
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        launches += 1
        rc = getattr(lib, _ENTRY[a.dtype])(
            a3.data_ptr(), b3.data_ptr(), out.data_ptr(), nb, M, N, K,
            *a3.stride(), *b3.stride(), stream)
    _build.check(rc, "matmul")
    return out.reshape(*lead, N)
