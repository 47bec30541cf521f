"""WKV6 (RWKV6 / Finch) recurrence: r,k,v,w (B,T,H,D), u (H,D) ->
(y (B,T,H,D) in r's dtype, final state S (B,H,D,D) in fp32), from a zero
state, fp32 arithmetic.

CUDA tensors launch the hand-written kernel in ``csrc/wkv6.cu``, which
steps the exact recurrence (no chunked rescaling, so any decay and any T)
and reads r/k/v/w through their strides, on the grid :func:`grid` gives
(the columns per block from :func:`plan`; the C side launches that grid
and refuses one its instance cannot run); CPU tensors run
:func:`~repro_torch.kernels.rwkv_scan.ref.wkv6_ref`.  Under grad the CUDA
call is an autograd node whose backward is :func:`wkv6_bwd`, the two
launches of ``csrc/wkv6_bwd.cu`` on :func:`grid_bwd`'s grid.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref, wkv6_ref

_ENTRY = {torch.float32: "repro_wkv6_f32",
          torch.bfloat16: "repro_wkv6_bf16"}
PRODUCERS = 128            # threads a block that stage the chunks
TILE = (4, 2)              # state rows x columns a thread keeps
# head width -> columns of the state a block steps (csrc/wkv6.cu's
# REPRO_WKV6_CASE instances, one for each D; the CPU tests hold the two
# lists equal): whole warps (a column pair's D/4 threads share one); at D 64
# a head is three blocks of 24, 24 and 16 columns, 120 blocks at B1 H40,
# so no SM of an H100 holds two (measured faster than 16 or 32, whose
# 160 or 80 blocks leave 8 stepping warps on the busiest SMs, not 6)
COLUMN_BLOCK = {16: 16, 32: 32, 64: 24, 128: 16}
HEAD_DIMS = tuple(COLUMN_BLOCK)     # the kernel's head-width instances
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (heads, batch)
# the backward (csrc/wkv6_bwd.cu): a block holds BWD_ROWS rows of a head's
# state, all D columns (D / BWD_ROWS blocks a head); a thread keeps
# BWD_LINE columns of one row, so a row's D / BWD_LINE lanes share a warp;
# time walks in chunks of BWD_CHUNK steps (staged, and the states
# checkpointed at their starts); two launches: the walk (forward, then
# backward: dr, dk, dw, the blocks' partial dv) and the sums (dv, du)
BWD_LINE = 4
BWD_CHUNK = 8
BWD_ROWS = 16
BWD_STAGES = ("walk", "sums")
_BWD_ENTRY = {torch.float32: "repro_wkv6_bwd_f32",
              torch.bfloat16: "repro_wkv6_bwd_bf16"}

launches = 0               # kernel launches since the last reset
bwd_launches = 0           # the backward's launches (two a call)


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


def chunk(D: int) -> int:
    """Time steps a block stages and steps at once (csrc/wkv6.cu's TC)."""
    return 16 if D == 128 else 32


def plan(shape, dtype: torch.dtype) -> int:
    """Columns of a head's state per block for r of ``shape`` (B,T,H,D)
    and ``dtype``; raises for what the kernel does not take."""
    if dtype not in _ENTRY:
        raise TypeError(f"wkv6 takes fp32 or bf16, got {dtype}")
    D = shape[3]
    if D not in COLUMN_BLOCK:
        raise ValueError(f"head width {D} is not one of {HEAD_DIMS}")
    return COLUMN_BLOCK[D]


def grid(shape, dtype: torch.dtype):
    """((column blocks, heads, batch), threads a block) of the launch: the
    threads that step the state (D/4 for each column pair; the last block
    of a head may use fewer) and the :data:`PRODUCERS` that stage the
    chunks."""
    B, _, H, D = shape
    cb = plan(shape, dtype)
    return (-(-D // cb), H, B), cb // TILE[1] * (D // TILE[0]) + PRODUCERS


def grid_bwd(shape, dtype: torch.dtype):
    """((blocks a head, heads, batch), threads a block) of the backward's
    walk for r of ``shape`` (B,T,H,D): D / :data:`BWD_ROWS` blocks a head,
    each :data:`BWD_ROWS` rows of D / :data:`BWD_LINE` lanes; raises for
    what the kernels do not take."""
    B, _, H, D = shape
    plan(shape, dtype)
    return (D // BWD_ROWS, H, B), BWD_ROWS * (D // BWD_LINE)


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte copies read ``t``: last axis contiguous, the (batch, time,
    head) strides of dims longer than 1 multiples of 16 bytes, the base
    16-byte aligned."""
    e = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % e == 0 or n == 1
                    for s, n in zip(t.stride()[:3], t.shape[:3])))


def _launch(r, k, v, w, u):
    """One launch on the grid of :func:`plan` and :func:`grid`: (y, S)."""
    B, T, H, D = r.shape
    dev = r.device
    y = torch.empty((B, T, H, D), dtype=r.dtype, device=dev)
    s = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, s
    strides = (ctypes.c_longlong * 12)(*r.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *w.stride()[:3])
    vec = all(_vec_ok(t) for t in (r, k, v, w))
    (blocks, _, _), threads = grid(r.shape, r.dtype)
    lib = _build.library()
    global launches
    with _build.on_device(dev.index):
        launches += 1
        rc = getattr(lib, _ENTRY[r.dtype])(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s.data_ptr(), B, T, H, D,
            plan(r.shape, r.dtype), blocks, threads, strides, int(vec),
            _build.current_stream(dev.index))
    _build.check(rc, "wkv6")
    return y, s


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(r, k, v, w, u)
    if dry.storageless(r):
        B, T, H, D = r.shape
        n, es = r.numel(), r.element_size()
        state = 4 * (B * H * D * D + H * D)
        return dry.call("wkv6", (r, k, v, w, u),
                        [(r.shape, r.dtype), ((B, H, D, D), torch.float32)],
                        (5.0 * n * D, 5 * n * es + state),
                        (12.0 * n * D, 9 * n * es + state + 4 * H * D))
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for device {r.device}")
    _build.refuse_dtensor("wkv6", r)
    B, T, H, D = r.shape
    if H > _MAX_GRID or B > _MAX_GRID:
        raise ValueError(f"B={B}, H={H}: a grid axis exceeds {_MAX_GRID}")
    r, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    u = u.float().contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return _WKV6.apply(r, k, v, w, u)
    return _launch(r, k, v, w, u)


class _WKV6(torch.autograd.Function):
    """The CUDA kernel as an autograd node: forward by the forward kernel
    (the same launch as without grad), backward by :func:`wkv6_bwd`; an
    unused output's gradient (often the final state's) comes as None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return _launch(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy, ds):
        return wkv6_bwd(*ctx.saved_tensors, dy, ds)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             dy: Optional[torch.Tensor] = None,
             ds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du) of :func:`wkv6` for the gradients dy of y and
    ds of the final state (None: zeros): dr, dk, dv, dw in r's dtype, du
    in u's.  CUDA tensors launch ``csrc/wkv6_bwd.cu``'s two kernels
    (:data:`BWD_STAGES`: the walk, which checkpoints the states every
    :data:`BWD_CHUNK` steps on its way forward and yields dr, dk, dw and
    each row block's part of dv on its way back; then the sums of dv's
    parts and of du over the batch, in fixed orders), two calls giving the
    same bits; CPU tensors run
    :func:`~repro_torch.kernels.rwkv_scan.ref.wkv6_bwd_ref`."""
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, dy, ds)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 backward kernel for device {r.device}")
    B, T, H, D = r.shape
    if H > _MAX_GRID or B > _MAX_GRID:
        raise ValueError(f"B={B}, H={H}: a grid axis exceeds {_MAX_GRID}")
    dev = r.device
    dy = (torch.zeros(r.shape, dtype=r.dtype, device=dev) if dy is None
          else dy.to(r.dtype))
    ds = (torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
          if ds is None else ds.float())
    r, k, v, w, dy, ds = map(_build.dense, (r, k, v, w, dy, ds))
    uf = _build.dense(u.float())
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=r.dtype, device=dev)
                      for _ in range(4))
    du = torch.empty((H, D), dtype=torch.float32, device=dev)
    if B * T * H == 0:
        for g in (dr, dk, dv, dw, du):
            g.zero_()
        return dr, dk, dv, dw, du.to(u.dtype)
    ck = torch.empty((B, H, -(-T // BWD_CHUNK), D, D), dtype=torch.float32,
                     device=dev)
    (blocks, _, _), threads = grid_bwd(r.shape, r.dtype)
    dv_part = torch.empty((blocks, B, T, H, D), dtype=torch.float32,
                          device=dev)
    bonus_part = torch.empty((blocks, B, T, H), dtype=torch.float32,
                             device=dev)
    du_part = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    entry = getattr(_build.library(), _BWD_ENTRY[r.dtype])
    global bwd_launches
    with _build.on_device(dev.index):
        stream = _build.current_stream(dev.index)
        for st, name in enumerate(BWD_STAGES):
            bwd_launches += 1
            rc = entry(st, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), dy.data_ptr(), uf.data_ptr(),
                       ds.data_ptr(), ck.data_ptr(), dr.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                       dv_part.data_ptr(), bonus_part.data_ptr(),
                       du_part.data_ptr(), du.data_ptr(), B, T, H, D,
                       blocks, threads, stream)
            _build.check(rc, f"wkv6 backward ({name})")
    return dr, dk, dv, dw, du.to(u.dtype)
