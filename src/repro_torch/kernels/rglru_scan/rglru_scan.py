"""RG-LRU scan: the diagonal linear recurrence ``h_t = a_t * h_{t-1} +
b_t`` over a, b (B,T,D) from a zero state -> (h (B,T,D) in a's dtype,
h_T (B,D) in fp32), fp32 arithmetic.

CUDA tensors launch the hand-written kernel in ``csrc/rglru_scan.cu``
(any T, any D, a and b read through their strides), on the grid
:func:`grid` gives (the C side launches that grid and refuses one its
instance cannot run); CPU tensors run
:func:`~repro_torch.kernels.rglru_scan.ref.rglru_ref`.  Under grad the CUDA
call is an autograd node whose backward is :func:`rglru_bwd`, one launch
of ``csrc/rglru_scan_bwd.cu`` on :func:`grid_bwd`'s grid, its checkpoints
in shared memory or in :func:`bwd_workspace`'s tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref

_ENTRY = {torch.float32: "repro_rglru_f32",
          torch.bfloat16: "repro_rglru_bf16"}
STRIP = 16                 # channels a block walks (csrc/rglru_scan.cu's
#                            one instance): D 2560 makes 160 blocks
THREADS = 128              # a block: one chain warp, three that move data
_MAX_GRID = 65535          # gridDim.y limit (batch)
_BWD_ENTRY = {torch.float32: "repro_rglru_bwd_f32",
              torch.bfloat16: "repro_rglru_bwd_bf16"}
# the backward's instance (csrc/rglru_scan_bwd.cu): strips of 32 channels
# (a chain warp, a lane a channel, three mover warps), chunks of 4 KB of
# one array, h checkpointed at each chunk's start in shared memory up to
# 8 KB of checkpoints, past that in a global tensor
BWD_STRIP = 32
BWD_THREADS = 128
BWD_CHUNK_BYTES = 4096
BWD_CKPT_BYTES = 8192

launches = 0               # kernel launches since the last reset
bwd_launches = 0           # the backward's launches (one a call)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"rglru takes fp32 or bf16 a/b of one dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"need a, b of one shape (B,T,D), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def chunk(dtype: torch.dtype) -> int:
    """Time steps a block stages and scans at once: 8 KB of a and b
    (csrc/rglru_scan.cu's TCH)."""
    return 8192 // (2 * STRIP * torch.finfo(dtype).bits // 8)


def grid(shape, dtype: torch.dtype):
    """((strips of :data:`STRIP` channels, batch), threads a block) of the
    launch for a of ``shape`` (B,T,D) and ``dtype``; raises for what the
    kernel does not take."""
    if dtype not in _ENTRY:
        raise TypeError(f"rglru takes fp32 or bf16, got {dtype}")
    B, _, D = shape
    return (-(-D // STRIP), B), THREADS


def chunk_bwd(dtype: torch.dtype) -> int:
    """Time steps a backward block stages and walks at once: 4 KB of one
    array of its strip (csrc/rglru_scan_bwd.cu's TCH: 64 in bf16, 32 in
    fp32)."""
    if dtype not in _BWD_ENTRY:
        raise TypeError(f"rglru takes fp32 or bf16, got {dtype}")
    return BWD_CHUNK_BYTES // (BWD_STRIP * torch.finfo(dtype).bits // 8)


def grid_bwd(shape, dtype: torch.dtype):
    """((strips of :data:`BWD_STRIP` channels, batch), threads a block) of
    the backward's launch for a of ``shape`` (B,T,D) and ``dtype``;
    raises for what the kernel does not take.  Independent of T."""
    chunk_bwd(dtype)
    B, _, D = shape
    return (-(-D // BWD_STRIP), B), BWD_THREADS


def bwd_workspace(shape, dtype: torch.dtype):
    """The shape (B, chunks, D) of the backward's fp32 checkpoint tensor,
    h at the start of each of :func:`chunk_bwd`'s chunks, for a of
    ``shape`` (B,T,D); None where a block's checkpoints fit in its
    :data:`BWD_CKPT_BYTES` of shared memory.  Pure: shape and dtype."""
    B, T, D = shape
    chunks = -(-T // chunk_bwd(dtype))
    if chunks * BWD_STRIP * 4 <= BWD_CKPT_BYTES:
        return None
    return (B, chunks, D)


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte copies read ``t``: channels contiguous, the (batch, time)
    strides of dims longer than 1 multiples of 16 bytes, the base 16-byte
    aligned."""
    e = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % e == 0 or n == 1
                    for s, n in zip(t.stride()[:2], t.shape[:2])))


def _launch(a: torch.Tensor, b: torch.Tensor):
    """One launch on the grid of :func:`grid`: (h, h_T)."""
    B, T, D = a.shape
    dev = a.device
    h = torch.empty((B, T, D), dtype=a.dtype, device=dev)
    h_last = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B * D == 0:
        return h, h_last
    vec = _vec_ok(a) and _vec_ok(b)
    (strips, _), threads = grid(a.shape, a.dtype)
    lib = _build.library()
    global launches
    with _build.on_device(dev.index):
        launches += 1
        rc = getattr(lib, _ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), h_last.data_ptr(),
            B, T, D, strips, threads, a.stride(0), a.stride(1), b.stride(0),
            b.stride(1), int(vec), _build.current_stream(dev.index))
    _build.check(rc, "rglru")
    return h, h_last


def rglru(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(a, b)
    if dry.storageless(a):
        B, D = a.shape[0], a.shape[2]
        n, es = a.numel(), a.element_size()
        return dry.call("rglru", (a, b),
                        [(a.shape, a.dtype), ((B, D), torch.float32)],
                        (2.0 * n, 3 * n * es + 4 * B * D),
                        (5.0 * n, 5 * n * es + 4 * B * D))
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no rglru kernel for device {a.device}")
    _build.refuse_dtensor("rglru", a)
    B = a.shape[0]
    if B > _MAX_GRID:
        raise ValueError(f"B={B} exceeds the grid limit {_MAX_GRID}")
    a, b = (t if t.stride(-1) == 1 else t.contiguous() for t in (a, b))
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _RGLRU.apply(a, b)
    return _launch(a, b)


class _RGLRU(torch.autograd.Function):
    """The CUDA kernel as an autograd node: forward by the forward kernel
    (the same launch as without grad), backward by :func:`rglru_bwd`; an
    unused output's gradient (often h_T's) comes as None."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, b)
        return _launch(a, b)

    @staticmethod
    def backward(ctx, dh, dh_last):
        return rglru_bwd(*ctx.saved_tensors, dh, dh_last)


def rglru_bwd(a: torch.Tensor, b: torch.Tensor,
              dh: Optional[torch.Tensor] = None,
              dh_last: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of :func:`rglru` for the gradients dh of h and dh_last of
    h_T (None: zeros), in a's dtype.  CUDA tensors launch
    ``csrc/rglru_scan_bwd.cu`` once (h checkpointed a chunk at a time,
    recomputed, then the reverse scan; a, b and dh read through their
    (batch, time) strides), two calls giving the same bits; CPU tensors
    run :func:`~repro_torch.kernels.rglru_scan.ref.rglru_bwd_ref`."""
    _check(a, b)
    if a.device.type == "cpu":
        return rglru_bwd_ref(a, b, dh, dh_last)
    if a.device.type != "cuda":
        raise ValueError(f"no rglru backward kernel for device {a.device}")
    B, T, D = a.shape
    if B > _MAX_GRID:
        raise ValueError(f"B={B} exceeds the grid limit {_MAX_GRID}")
    dev = a.device
    dh = (torch.zeros(a.shape, dtype=a.dtype, device=dev) if dh is None
          else dh.to(a.dtype))
    dh_last = _build.dense(
        torch.zeros((B, D), dtype=torch.float32, device=dev)
        if dh_last is None else dh_last.float())
    a, b, dh = (t if t.stride(-1) == 1 else t.contiguous()
                for t in (a, b, dh))
    da, db = (torch.empty(a.shape, dtype=a.dtype, device=dev)
              for _ in range(2))
    if B * T * D == 0:
        return da, db
    ws = bwd_workspace(a.shape, a.dtype)
    ckpt = (torch.empty(ws, dtype=torch.float32, device=dev)
            if ws is not None else None)
    vec = all(map(_vec_ok, (a, b, dh)))
    (strips, _), threads = grid_bwd(a.shape, a.dtype)
    lib = _build.library()
    global bwd_launches
    with _build.on_device(dev.index):
        bwd_launches += 1
        rc = getattr(lib, _BWD_ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), dh.data_ptr(), dh_last.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), da.data_ptr(),
            db.data_ptr(), B, T, D, strips, threads, a.stride(0),
            a.stride(1), b.stride(0), b.stride(1), dh.stride(0),
            dh.stride(1), int(vec), _build.current_stream(dev.index))
    _build.check(rc, "rglru backward")
    return da, db
