"""Flash attention: online-softmax GQA attention with causal and
sliding-window masks, fp32 arithmetic, output in q's dtype.

q is (B,S,H,Dh) and k/v are (B,S,KV,Dh) with H % KV == 0; query head h
reads KV head ``h // (H // KV)``.  CUDA tensors launch one of the two
hand-written kernels in ``csrc/flash_attention.cu``, as :func:`route`
picks before the launch: the tensor-core kernel (``"wgmma"``, bf16 q/k/v
with Dh 64, 128 or 256 that TMA can read) or the SIMT kernel
(``"simt"``, everything else), both reading q/k/v through their strides.
The tensor-core kernel's key tile is compiled per head width
(:data:`WGMMA_BLOCK_K`); ``block_k`` picks one of them, and without it
the call launches :data:`DEFAULT_BLOCK_K`'s.
CPU tensors run the plain versions of
:mod:`~repro_torch.kernels.flash_attention.ref` (the chunked form beyond
1024 positions, the exact one below), which autograd differentiates.

Where grad is enabled and q, k or v requires grad, a CUDA call goes
through a ``torch.autograd.Function``: its forward launches the same
kernel on the same route, and its backward :func:`flash_attention_bwd`,
three launches of ``csrc/flash_attention_bwd.cu`` (row statistics,
dK/dV, dQ) on one of its two routes, as :func:`route_bwd` picks: the
tensor-core kernels (``"wgmma"``, bf16 with Dh 64, 128 or 256) or the
SIMT kernels (``"simt"``, fp32 and the other head widths).  Every other
call, serving's included, launches exactly as before.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_chunked,
                                                     attention_ref)

_ENTRY = {("simt", torch.float32): "repro_flash_attention_f32",
          ("simt", torch.bfloat16): "repro_flash_attention_bf16",
          ("wgmma", torch.bfloat16): "repro_flash_attention_bf16_wgmma"}
HEAD_DIMS = (8, 12, 16, 32, 64, 80, 128, 256)   # the SIMT kernel's Dh
WGMMA_HEAD_DIMS = (64, 128, 256)                # the wgmma kernels' Dh
# the wgmma kernel's compiled key tiles by Dh, and the one a call without
# block_k launches (csrc/flash_attention.cu refuses any other pair)
WGMMA_BLOCK_K = {64: (64, 128), 128: (64, 128), 256: (32,)}
DEFAULT_BLOCK_K = {64: 128, 128: 128, 256: 32}
WGMMA_BLOCK_Q = 128        # the wgmma kernel's query rows a block
BWD_HEAD_DIMS = HEAD_DIMS                       # the backward kernels' Dh
_BWD_ENTRY = {("simt", torch.float32): "repro_flash_attention_bwd_f32",
              ("simt", torch.bfloat16): "repro_flash_attention_bwd_bf16",
              ("wgmma", torch.bfloat16):
                  "repro_flash_attention_bwd_bf16_wgmma"}
_BWD_TILE = 64             # the wgmma route's tile rows: lse/D row padding
BWD_STAGES = ("stats", "dkdv", "dq")            # launched in this order
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit
# beyond which the exact O(S^2) plain version gives way to the chunked one
CHUNKED_THRESHOLD = 1024

launches = 0               # kernel launches since the last reset
routes = {"wgmma": 0, "simt": 0}      # the same launches, by route
bwd_launches = 0           # backward kernel launches (three a call)
bwd_routes = {"wgmma": 0, "simt": 0}  # the same launches, by route


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"flash_attention takes fp32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,S,H,Dh) and k = v (B,S,KV,Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, Dh):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2] != 0:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head width {Dh} is not one of {HEAD_DIMS}")


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that a CUDA call of :func:`flash_attention` on these
    operands launches: ``"wgmma"`` for bf16 q/k/v with Dh 64, 128 or 256
    that TMA can read (innermost stride 1, other strides and the bases
    16-byte aligned), ``"simt"`` for everything else.  Pure: reads only
    dtypes, shapes, strides and data pointers, so it answers for CPU
    tensors too."""
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in WGMMA_HEAD_DIMS
            and all(_build.tma_readable(t) for t in (q, k, v))):
        return "wgmma"
    return "simt"


def route_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernels that a CUDA call of :func:`flash_attention_bwd` on these
    operands launches: ``"wgmma"`` for bf16 q/k/v with Dh 64, 128 or 256,
    ``"simt"`` for everything else (fp32, whose contract allows no TF32,
    and Dh 8, 12, 16, 32 and 80).  The wrapper hands the kernels contiguous,
    16-byte aligned copies, so strides never matter.  Pure: reads only
    dtypes and shapes, so it answers for meta and CPU tensors too."""
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in WGMMA_HEAD_DIMS):
        return "wgmma"
    return "simt"


def _check_block_k(q: torch.Tensor, block_k: Optional[int]) -> None:
    Dh = q.shape[-1]
    if block_k is not None and block_k not in WGMMA_BLOCK_K.get(Dh, ()):
        raise ValueError(f"no wgmma instance with {block_k}-key tiles at "
                         f"head width {Dh}: compiled "
                         f"{WGMMA_BLOCK_K.get(Dh, ())}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """``block_k``: the tensor-core kernel's key tile, one of
    :data:`WGMMA_BLOCK_K` for q's head width (None: the default); a CUDA
    call that it is given must take the wgmma route.  CPU tensors check it
    and run the plain version."""
    _check(q, k, v)
    _check_block_k(q, block_k)
    if window is not None and window < 0:
        raise ValueError(f"window {window} is negative")
    if dry.storageless(q):
        B, S, H, Dh = q.shape
        pairs = dry.attention_pairs(S, causal, window)
        es = q.element_size()
        qkv = 2 * q.numel() + k.numel() + v.numel()
        return dry.call("flash_attention", (q, k, v), [(q.shape, q.dtype)],
                        (4.0 * B * H * Dh * pairs, qkv * es),
                        # q, out, dO read and dq written; k, v read,
                        # dk, dv written
                        (10.0 * B * H * Dh * pairs,
                         (4 * q.numel() + 2 * (k.numel() + v.numel()))
                         * es))[0]
    if q.device.type == "cpu":
        if q.shape[1] > CHUNKED_THRESHOLD:
            return attention_chunked(q, k, v, causal=causal, window=window)
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    _build.refuse_dtensor("flash_attention", q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, block_k)
    return _forward(q, k, v, causal, window, block_k)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int],
             block_k: Optional[int] = None) -> torch.Tensor:
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    r = route(q, k, v)
    if block_k is not None and r != "wgmma":
        raise ValueError(f"block_k {block_k} is the wgmma kernel's key tile, "
                         f"and these operands take the {r} route")
    # grid y: the heads (simt) or the 128-row query tiles (wgmma); z: batch
    if max(H if r == "simt" else -(-S // WGMMA_BLOCK_Q), B) > _MAX_GRID:
        raise ValueError(f"B={B}, S={S}, H={H}: a grid axis exceeds "
                         f"{_MAX_GRID} on the {r} route")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    # the wgmma entry takes the key tile of the instance to launch
    tile = (() if r == "simt"
            else (DEFAULT_BLOCK_K[Dh] if block_k is None else block_k,))
    lib = _build.library()
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launches += 1
        routes[r] += 1
        rc = getattr(lib, _ENTRY[r, q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, Dh, strides, int(causal),
            # a window of S or more masks nothing: clamped, it fits an int
            -1 if window is None else min(int(window), S),
            1.0 / math.sqrt(Dh), *tile, stream)
    _build.check(rc, f"flash_attention ({r})")
    return out


class _FlashAttention(torch.autograd.Function):
    """The CUDA kernels as an autograd node: forward by the forward kernel
    (either route), backward by :func:`flash_attention_bwd` from q, k, v,
    the forward's output and its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_k):
        out = _forward(q, k, v, causal, window, block_k)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``do``, given the forward's output ``out``; each in its input's shape
    and dtype.  CUDA tensors launch ``csrc/flash_attention_bwd.cu``'s three
    kernels (Dh in :data:`BWD_HEAD_DIMS`) on :func:`route_bwd`'s route,
    two calls giving the same bits; CPU tensors run
    :func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`
    (which recomputes the output and so ignores ``out``)."""
    _check(q, k, v)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must be q's shape {tuple(q.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window {window} is negative")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention backward kernel for device "
                         f"{q.device}")
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    if Dh not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward takes head widths {BWD_HEAD_DIMS}, "
                         f"got {Dh}")
    if max(H, B) > _MAX_GRID:
        raise ValueError(f"B={B}, H={H}: a grid axis exceeds {_MAX_GRID}")
    r = route_bwd(q, k, v)
    # contiguous and 16-byte aligned: what the wgmma route's TMA maps read
    q, k, v, out, do = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                        else t.clone(memory_format=torch.contiguous_format)
                        for t in (q, k, v, out, do.to(q.dtype)))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    # the row statistics: (B, H, S), rows padded to whole 64-row tiles on
    # the wgmma route (its kernels copy a tile's 64 values in one piece)
    rows = S if r == "simt" else -(-S // _BWD_TILE) * _BWD_TILE
    lse = torch.empty((B, H, rows), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _build.library()
    entry = getattr(lib, _BWD_ENTRY[r, q.dtype])
    win = -1 if window is None else min(int(window), S)
    global bwd_launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for stage, name in enumerate(BWD_STAGES):
            bwd_launches += 1
            bwd_routes[r] += 1
            rc = entry(stage, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), B, S, H, KV, Dh, int(causal), win,
                       1.0 / math.sqrt(Dh), stream)
            _build.check(rc, f"flash_attention backward ({r}, {name})")
    return dq, dk, dv
