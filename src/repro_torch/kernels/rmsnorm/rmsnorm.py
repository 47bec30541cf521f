"""Fused RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) [* g]``
in fp32 math, output in x's dtype; ``g=None`` means no gain.

CUDA tensors launch the hand-written kernels in ``csrc/rmsnorm.cu`` on the
route :func:`route` picks from the width, the dtype and the alignment
(never the row count): ``"warp"`` (narrow rows, several to a warp),
``"block"`` (wide rows, one to a block) or ``"scalar"`` (what 16-byte
vectors cannot read).  CPU tensors run
:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`, which autograd
differentiates.

Where grad is enabled and x or g requires grad, a CUDA call goes through
a ``torch.autograd.Function``: its forward launches the same kernel on
the same route, and its backward :func:`rmsnorm_bwd`, the kernels of
``csrc/rmsnorm_bwd.cu`` (dx, and dg as per-block partial sums added in
block order by a second launch) on the route :func:`route_bwd` picks, as
:func:`route` does, from the width, the dtype, the row strides and the
alignment (never the row count), over the grid :func:`grid_bwd` sizes.
Every other call, serving's included, launches exactly as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

_ENTRY = {torch.float32: "repro_rmsnorm_f32",
          torch.bfloat16: "repro_rmsnorm_bf16"}
_BWD_ENTRY = {torch.float32: ("repro_rmsnorm_bwd_f32",
                              "repro_rmsnorm_bwd_dg_f32"),
              torch.bfloat16: ("repro_rmsnorm_bwd_bf16",
                               "repro_rmsnorm_bwd_dg_bf16")}
_ROUTE_ID = {"warp": 0, "block": 1, "scalar": 2}
WARP_MAX_VECS = 128        # 16-byte vectors a warp holds (4 a lane)
BLOCK_MAX_VECS = 4096      # 512 threads x 8 vectors
BWD_MAX_WIDTH = 8192       # the backward's widest row, on every route
# the backward's launch shapes, as csrc/rmsnorm_bwd.cu compiles them: the
# warp route's warps a block, the block route's bytes of x and dy in
# flight a block (its ring's slots: 1 + that over a row's bytes, 2 to 8),
# an SM's shared memory (228 KB, 1 KB of it reserved a block) and
# registers
BWD_WARPS = 8
BWD_RING_BYTES = 24 * 1024
BWD_MAX_STAGES = 8
SMEM_PER_SM = 228 * 1024
REGS_PER_SM = 65536

launches = 0               # kernel launches since the last reset
routes = {"warp": 0, "block": 0, "scalar": 0}      # the same, by route
bwd_launches = 0           # backward kernel launches (dx, then dg's sum)
bwd_routes = {"warp": 0, "block": 0, "scalar": 0}  # the same, by route


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


def _check_bwd(x: torch.Tensor, g: Optional[torch.Tensor],
               dy: Optional[torch.Tensor]) -> None:
    _check(x, g)
    if dy is not None and (dy.shape != x.shape or dy.device != x.device):
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")


def _check_width(d: int) -> None:
    if d > BWD_MAX_WIDTH:
        raise ValueError(f"rmsnorm backward takes widths up to "
                         f"{BWD_MAX_WIDTH}, got {d}")


def _route_bwd2(x2: torch.Tensor, g: Optional[torch.Tensor],
                dy2: Optional[torch.Tensor]) -> str:
    d = x2.shape[1]
    e = 16 // x2.element_size()
    # every row stride counts, the row count never does (a lone row's
    # stride is read as any other)
    if (d % e or any(t.stride(0) % e or t.data_ptr() % 16
                     for t in (x2, dy2) if t is not None)
            or (g is not None and g.data_ptr() % 16)):
        return "scalar"
    return "warp" if d // e <= WARP_MAX_VECS else "block"


def route_bwd(x: torch.Tensor, g: Optional[torch.Tensor] = None,
              dy: Optional[torch.Tensor] = None) -> str:
    """The route a CUDA call of :func:`rmsnorm_bwd` on these operands
    launches (dy, where given, must be readable by it too): ``"warp"``
    (rows of at most ``WARP_MAX_VECS`` 16-byte vectors, several a warp),
    ``"block"`` (wider rows, a ring of rows a block) or ``"scalar"``
    (what 16-byte vectors cannot read).  Pure: reads only dtypes, widths,
    row strides and data pointers, never the row count, so it answers for
    CPU and meta tensors too; raises on what no route takes."""
    _check_bwd(x, g, dy)
    _check_width(x.shape[-1])
    return _route_bwd2(_rows(x), None if g is None else g.contiguous(),
                       None if dy is None else _rows(dy.to(x.dtype)))


def grid_bwd(route: str, rows: int, d: int, element_size: int,
             sms: int) -> int:
    """Blocks of the backward's row kernel: a function of the route, the
    rows, the width and the SM count alone (with the dtype's size), so the
    order of dg's sum, one partial row a block, is fixed.  As many blocks
    as fill the card once (all resident together) or as the rows need.
    The warp route's warps walk row groups (32 / G rows of G lanes, twice
    where a lane holds one vector) grid-stride; the block and scalar
    routes' blocks take balanced runs of rows: no two warps or blocks
    differ by more than one group or row."""
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    if route == "warp":
        nvec = d // (16 // element_size)
        lanes = min(32, 1 << max(0, nvec - 1).bit_length())
        vecs = cdiv(nvec, 32)             # a lane's vectors: 1, 2 or 4
        vecs = 4 if vecs == 3 else vecs
        group = 32 // lanes * (2 if vecs == 1 else 1)
        need = cdiv(cdiv(rows, group), BWD_WARPS)
        per_sm = 4 // vecs
    elif route == "block":
        nvec = d // (16 // element_size)
        vecs = 2 if nvec <= 256 else 4 if nvec <= 512 else 8
        threads = cdiv(cdiv(nvec, vecs), 32) * 32
        row_bytes = 2 * d * element_size
        stages = min(BWD_MAX_STAGES,
                     max(2, 1 + cdiv(BWD_RING_BYTES, row_bytes)))
        # what fits an SM 4 times at most: the ring, and the registers at
        # the kernel's cap (128 a thread, 255 at 8 vectors)
        per_sm = min(4, SMEM_PER_SM // (stages * row_bytes + 1024),
                     REGS_PER_SM // (threads * (256 if vecs == 8 else 128)))
        need = rows
    elif route == "scalar":
        per_sm, need = 2, rows
    else:
        raise ValueError(f"no rmsnorm backward route {route!r}")
    return max(1, min(need, per_sm * sms))


def rmsnorm(x: torch.Tensor, g: Optional[torch.Tensor] = None,
            eps: float = 1e-6) -> torch.Tensor:
    _check(x, g)
    dev = x.device
    if dry.storageless(x):
        d, es = x.shape[-1], x.element_size()
        rows = x.numel() // max(d, 1)
        return dry.call("rmsnorm", (x, g), [(x.shape, x.dtype)],
                        ((3.0 if g is None else 4.0) * rows * d,
                         (2 * rows * d + (0 if g is None else d)) * es),
                        (10.0 * rows * d, (3 * rows * d + 2 * d) * es))[0]
    if dev.type == "cpu":
        return rmsnorm_ref(x, g, eps)
    if dev.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for device {dev}")
    _build.refuse_dtensor("rmsnorm", x)
    if torch.is_grad_enabled() and (
            x.requires_grad or (g is not None and g.requires_grad)):
        return _RMSNorm.apply(x, g, eps)
    return _forward(x, g, eps)


def _forward(x: torch.Tensor, g: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    dev = x.device
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


class _RMSNorm(torch.autograd.Function):
    """The CUDA kernel as an autograd node: forward by the forward kernel,
    backward by :func:`rmsnorm_bwd`."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _forward(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, g, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dg if ctx.needs_input_grad[1] else None, None)


def rmsnorm_bwd(x: torch.Tensor, g: Optional[torch.Tensor],
                dy: torch.Tensor, eps: float = 1e-6
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dg) of :func:`rmsnorm` at x, g for the output gradient dy: dx
    in x's shape and dtype, dg in g's (None without a gain).  CUDA
    tensors launch ``csrc/rmsnorm_bwd.cu`` on :func:`route_bwd`'s route:
    the row kernel, then (with a gain) the ordered sum of its blocks'
    partial dg, two calls giving the same bits; CPU tensors run
    :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_bwd_ref`."""
    _check_bwd(x, g, dy)
    dev = x.device
    if dev.type == "cpu":
        return rmsnorm_bwd_ref(x, g, dy, eps)
    if dev.type != "cuda":
        raise ValueError(f"no rmsnorm backward kernel for device {dev}")
    d = x.shape[-1]
    _check_width(d)
    # (rows, d) views with unit column stride: no copy where there is one
    x2 = _rows(x)
    dy2 = _rows(dy.to(x.dtype))
    rows = x2.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dg = None if g is None else torch.empty_like(g)
    if rows == 0:
        return dx, None if g is None else dg.zero_()
    if g is not None:
        g = g.contiguous()
    r = _route_bwd2(x2, g, dy2)
    blocks = grid_bwd(r, rows, d, x.element_size(),
                      _build.sm_count(dev.index))
    ws = (None if g is None else
          torch.empty((blocks, d), dtype=torch.float32, device=dev))
    rows_entry, sum_entry = _BWD_ENTRY[x.dtype]
    lib = _build.library()
    global bwd_launches
    with _build.on_device(dev.index):
        stream = _build.current_stream(dev.index)
        bwd_launches += 1
        bwd_routes[r] += 1
        rc = getattr(lib, rows_entry)(
            x2.data_ptr(), None if g is None else g.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(),
            None if ws is None else ws.data_ptr(), rows, d, x2.stride(0),
            dy2.stride(0), blocks, eps, _ROUTE_ID[r], stream)
        _build.check(rc, f"rmsnorm backward ({r})")
        if g is not None:
            bwd_launches += 1
            bwd_routes[r] += 1
            rc = getattr(lib, sum_entry)(ws.data_ptr(), dg.data_ptr(),
                                         blocks, d, stream)
            _build.check(rc, f"rmsnorm backward ({r}, dg sum)")
    return dx, dg
