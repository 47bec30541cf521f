"""RG-LRU scan: the diagonal linear recurrence ``h_t = a_t * h_{t-1} +
b_t`` over a, b (B,T,D) from a zero state -> (h (B,T,D) in a's dtype,
h_T (B,D) in fp32), fp32 arithmetic.

CUDA tensors launch the hand-written kernel in ``csrc/rglru_scan.cu``
(any T, any D, a and b read through their strides), on the grid
:func:`grid` gives (the C side launches that grid and refuses one its
instance cannot run); CPU tensors run
:func:`~repro_torch.kernels.rglru_scan.ref.rglru_ref`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_ref

_ENTRY = {torch.float32: "repro_rglru_f32",
          torch.bfloat16: "repro_rglru_bf16"}
STRIP = 16                 # channels a block walks (csrc/rglru_scan.cu's
#                            one instance): D 2560 makes 160 blocks
THREADS = 128              # a block: one chain warp, three that move data
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
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no rglru kernel for device {a.device}")
    _build.refuse_grad("rglru", a, b)
    B = a.shape[0]
    if B > _MAX_GRID:
        raise ValueError(f"B={B} exceeds the grid limit {_MAX_GRID}")
    a, b = (t if t.stride(-1) == 1 else t.contiguous() for t in (a, b))
    return _launch(a, b)
