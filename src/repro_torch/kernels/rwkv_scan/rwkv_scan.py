"""WKV6 (RWKV6 / Finch) recurrence: r,k,v,w (B,T,H,D), u (H,D) ->
(y (B,T,H,D) in r's dtype, final state S (B,H,D,D) in fp32), from a zero
state, fp32 arithmetic.

CUDA tensors launch the hand-written kernel in ``csrc/wkv6.cu``, which
steps the exact recurrence (no chunked rescaling, so any decay and any T)
and reads r/k/v/w through their strides; CPU tensors run
:func:`~repro_torch.kernels.rwkv_scan.ref.wkv6_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref

_ENTRY = {torch.float32: "repro_wkv6_f32",
          torch.bfloat16: "repro_wkv6_bf16"}
HEAD_DIMS = (16, 32, 64, 128)       # the kernel's head-width instances
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (heads, batch)

launches = 0               # kernel launches since the last reset


def _check(r, k, v, w, u) -> None:
    if r.dtype not in _ENTRY or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6 takes fp32 or bf16 r/k/v/w of one dtype, got "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    if not u.is_floating_point():
        raise TypeError(f"wkv6 takes a floating-point u, got {u.dtype}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError(f"r/k/v/w/u on "
                         f"{[str(t.device) for t in (r, k, v, w, u)]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"need r, k, v, w of one shape (B,T,H,D), got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, D = r.shape
    if tuple(u.shape) != (H, D):
        raise ValueError(f"u {tuple(u.shape)} is not ({H}, {D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} is not one of {HEAD_DIMS}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for device {r.device}")
    B, T, H, D = r.shape
    if H > _MAX_GRID or B > _MAX_GRID:
        raise ValueError(f"B={B}, H={H}: a grid axis exceeds {_MAX_GRID}")
    r, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    u = u.float().contiguous()
    y = torch.empty((B, T, H, D), dtype=r.dtype, device=r.device)
    s = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, s
    strides = (ctypes.c_longlong * 12)(*r.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *w.stride()[:3])
    lib = _build.library()
    global launches
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        launches += 1
        rc = getattr(lib, _ENTRY[r.dtype])(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s.data_ptr(), B, T, H, D, strides,
            stream)
    _build.check(rc, "wkv6")
    return y, s
