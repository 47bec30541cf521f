"""Grouped (per-expert) matmul of the MoE layer: x (E, C, D) @ w (E, D, F)
-> (E, C, F), an fp32 accumulator, the output in x's dtype (fp32 or bf16).

CUDA tensors launch one of the two hand-written kernels in
``csrc/grouped_matmul.cu``, as :func:`route` picks before the launch: the
tensor-core kernel (``"wgmma"``, bf16 operands that TMA can read) or the
SIMT kernel (``"simt"``, everything else: any C, D and F, x and w read
through their strides in either orientation, on :func:`plan_simt`'s
tiles).  CPU tensors run
:func:`~repro_torch.kernels.grouped_matmul.ref.grouped_matmul_ref`.  Under
grad the CUDA call is an autograd node whose backward,
:func:`grouped_matmul_bwd`, runs the tensor-core kernel on the transposed
products, reading x, w and dy in place on :func:`plan_bwd`'s tiles, or
the SIMT kernel (:func:`route_bwd`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_bwd_ref,
                                                    grouped_matmul_ref)

_ENTRY = {("simt", torch.float32): "repro_grouped_matmul_f32",
          ("simt", torch.bfloat16): "repro_grouped_matmul_bf16",
          ("wgmma", torch.bfloat16): "repro_grouped_matmul_bf16_wgmma"}
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (F tiles, experts)
TILE_M = 128               # the tensor-core kernel's output columns a tile
# the SIMT kernel's instances (csrc/grouped_matmul_simt.cu): output tiles
# of SIMT_BN F columns by SIMT_ROWS C rows, on rows / 8 x 16 threads of
# an 8 x 8 register tile each (16 rows: 128 threads of 2 x 8).  80 rows
# cover olmoe-1b-7b's C 160 in two tiles with no padding; 128 the rest of
# a large C (granite-moe-3b-a800m's 1056 in nine tiles measured faster than
# 120-row tiles with 2% padding); 16 a C of at most 16 and small grids.
SIMT_BN = 128
SIMT_ROWS = (16, 80, 128)

launches = 0               # kernel launches since the last reset
routes = {"wgmma": 0, "simt": 0}      # the same launches, by route
bwd_launches = 0           # the backward's launches (two a call)
bwd_routes = {"wgmma": 0, "simt": 0}  # the same, by route


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


def route_bwd(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route of both of the backward's products, dx = dy wᵀ and dw =
    xᵀ dy, for the forward's operands x (E,C,D) and w (E,D,F): ``"wgmma"``
    where x and w are bf16 and D and F positive multiples of 8
    (the tensor-core kernel reads x, w and dy in place, as contiguous
    16-byte aligned tensors: A K-major for dx, B MN-major for dw, no
    transposed copy), ``"simt"`` otherwise (fp32, odd widths),
    on transposed views.  Pure: reads only dtypes and shapes."""
    D, F = x.shape[2], w.shape[2]
    return ("wgmma" if x.dtype == w.dtype == torch.bfloat16 and D > 0
            and F > 0 and D % 8 == 0 and F % 8 == 0 else "simt")


class SimtPlan(NamedTuple):
    """One SIMT launch: ``rows`` C rows a block (by :data:`SIMT_BN` F
    columns) on ``threads`` threads; for x and for w the contiguous axis
    (``"k"``: D, the contraction; ``"mn"``: C for x, F for w) and the
    bytes a copy moves along it (16, or the element size where 16-byte
    copies cannot read it)."""
    rows: int
    threads: int
    x_axis: str
    w_axis: str
    x_copy: int
    w_copy: int


def _operand(t: torch.Tensor, mn: int, k: int):
    """(contiguous axis, copy bytes) of an operand whose M (or N) axis is
    dim ``mn`` and whose K axis is dim ``k``: K where its stride is 1, or
    where it is the smaller and the other is not 1; 16-byte copies where
    that axis has unit stride, the other strides (of extents past 1) are
    multiples of 16 bytes and the base is 16-byte aligned."""
    s, n = t.stride(), t.shape
    axis = "k" if s[k] == 1 or (s[mn] != 1 and s[k] <= s[mn]) else "mn"
    c, o = (k, mn) if axis == "k" else (mn, k)
    e = 16 // t.element_size()
    vec = (s[c] == 1 and t.data_ptr() % 16 == 0
           and all(n[d] <= 1 or s[d] % e == 0 for d in (o, 0)))
    return axis, 16 if vec else t.element_size()


def simt_rows(E: int, C: int, F: int, sms: int) -> int:
    """C rows a SIMT block: the smallest of :data:`SIMT_ROWS` that holds
    C's equal split into tiles of at most the largest; a smaller one while
    the grid of E x row tiles x F tiles would leave some of the ``sms`` SMs
    without a block, down to the smallest."""
    q = -(-C // -(-C // SIMT_ROWS[-1])) if C > 0 else 1
    i = next(i for i, r in enumerate(SIMT_ROWS) if r >= q)
    while i > 0 and E * -(-C // SIMT_ROWS[i]) * -(-F // SIMT_BN) < sms:
        i -= 1
    return SIMT_ROWS[i]


def plan_simt(x: torch.Tensor, w: torch.Tensor, sms: int) -> SimtPlan:
    """The SIMT launch for x (E,C,D) @ w (E,D,F): :func:`simt_rows`'s
    tile, and each operand's orientation and copy width, read in place
    (the backward's dy wᵀ and xᵀ dy views too).  Pure: reads only shapes,
    strides, dtypes and data pointers, so it answers for CPU and meta
    tensors; the C side launches that instance and refuses one it does not
    have."""
    rows = simt_rows(x.shape[0], x.shape[1], w.shape[2], sms)
    x_axis, x_copy = _operand(x, 1, 2)
    w_axis, w_copy = _operand(w, 2, 1)
    return SimtPlan(rows, simt_threads(rows), x_axis, w_axis, x_copy,
                    w_copy)


def simt_threads(rows: int) -> int:
    """Threads of the SIMT instance of ``rows`` C rows: rows / 8 x 16, an
    8 x 8 register tile each; 128 of 2 x 8 at 16 rows."""
    return rows // (2 if rows == 16 else 8) * (SIMT_BN // 8)


def tile_rows(rows: int) -> int:
    """C rows a tile of the tensor-core kernel where its B operand is
    K-major (the forward's x, dx's dy): ``rows`` split into equal tiles of
    at most 256, rounded up to a multiple of 8 (the instruction's N step),
    as ``csrc/grouped_matmul.cu``'s ``tile_rows``."""
    per = -(-rows // -(-rows // 256))
    return -(-per // 8) * 8


def tile_rows64(rows: int) -> int:
    """The same for an MN-major B (dw's x), whose tiles are whole 64-column
    swizzle atoms: rounded up to a multiple of 64 (``tile_rows64``)."""
    per = -(-rows // -(-rows // 256))
    return -(-per // 64) * 64


def plan(E: int, rows: int, cols: int, sms: int, pick=tile_rows):
    """(rows a tile, tiles, persistent blocks) of a tensor-core launch
    writing (E, rows, cols): tiles of :data:`TILE_M` of ``cols`` by
    ``pick(rows)`` rows, walked by one block an SM (``sms``), or one a
    tile where there are fewer.  The forward's (E,C,F) is ``plan(E, C, F,
    sms)``.  Pure: shapes and the SM count only; the C side launches the
    instance of that many rows on that many blocks."""
    n = pick(rows)
    tiles = E * -(-cols // TILE_M) * -(-rows // n)
    return n, tiles, min(tiles, sms)


def plan_bwd(which: int, E: int, C: int, D: int, F: int, sms: int):
    """:func:`plan` of the backward's tensor-core launch: ``which`` 0 is
    dx (E,C,D) = dy wᵀ, tiles of :data:`TILE_M` of D by :func:`tile_rows`
    (C) rows; 1 is dw (E,D,F) = xᵀ dy, tiles of :data:`TILE_M` of F by
    :func:`tile_rows64` (D) rows."""
    if which == 0:
        return plan(E, C, D, sms)
    if which == 1:
        return plan(E, D, F, sms, tile_rows64)
    raise ValueError(f"which is 0 (dx) or 1 (dw), got {which}")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    if dry.storageless(x):
        E, C, D = x.shape
        Fw, es = w.shape[-1], x.element_size()
        io = E * C * D + E * D * Fw
        return dry.call("grouped_matmul", (x, w),
                        [((E, C, Fw), x.dtype)],
                        (2.0 * E * C * D * Fw, (io + E * C * Fw) * es),
                        (4.0 * E * C * D * Fw,
                         (2 * io + E * C * Fw) * es))[0]
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_matmul kernel for device {x.device}")
    _build.refuse_dtensor("grouped_matmul", x)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w)
    return _product(x, w, backward=False)


class _GroupedMatmul(torch.autograd.Function):
    """The CUDA kernels as an autograd node: forward by the same launch as
    without grad, backward by :func:`grouped_matmul_bwd`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w, backward=False)

    @staticmethod
    def backward(ctx, dy):
        return grouped_matmul_bwd(*ctx.saved_tensors, dy)


def _product(x: torch.Tensor, w: torch.Tensor, backward: bool
             ) -> torch.Tensor:
    """x (E,C,D) @ w (E,D,F) by one launch on :func:`route`'s kernel (the
    tensor cores' on :func:`plan`'s tiles and persistent blocks, the SIMT
    kernel on :func:`plan_simt`'s), counted with the forward's launches or
    the backward's."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if E > _MAX_GRID or -(-F // SIMT_BN) > _MAX_GRID:
        raise ValueError(f"grouped_matmul grid too large: E {E}, F {F}")
    r = route(x, w)
    sms = _build.sm_count(x.device.index)
    if r == "wgmma":
        n, _, blocks = plan(E, C, F, sms)
        tiles = (n, blocks)
    else:
        p = plan_simt(x, w, sms)
        tiles = (p.rows, p.threads, int(p.x_axis == "k"), int(p.x_copy == 16),
                 int(p.w_axis == "k"), int(p.w_copy == 16))
    lib = _build.library()
    global launches, bwd_launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if backward:
            bwd_launches += 1
            bwd_routes[r] += 1
        else:
            launches += 1
            routes[r] += 1
        rc = getattr(lib, _ENTRY[r, x.dtype])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            *x.stride(), *w.stride(), *tiles, stream)
    _build.check(rc, f"grouped_matmul ({r})")
    return out


def grouped_matmul_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`grouped_matmul` for the output gradient dy
    (E,C,F): dx in x's dtype, dw in w's.  CUDA tensors take
    :func:`route_bwd`'s route: two launches of the tensor-core kernel on
    x, w and dy in place (persistent blocks on :func:`plan_bwd`'s tiles;
    dw on a second stream, so that it fills the SMs dx's last tiles
    leave), or of the SIMT kernel on the transposed views, read in place
    (no transposed copy); each output one accumulation in a fixed order.
    CPU tensors run
    :func:`~repro_torch.kernels.grouped_matmul.ref.grouped_matmul_bwd_ref`."""
    _check(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    if tuple(dy.shape) != (E, C, F):
        raise ValueError(f"dy {tuple(dy.shape)} is not ({E}, {C}, {F})")
    if x.device.type == "cpu":
        return grouped_matmul_bwd_ref(x, w, dy)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped_matmul backward kernel for device "
                         f"{x.device}")
    dy = dy.to(x.dtype)
    if route_bwd(x, w) == "simt":
        return (_product(dy, w.transpose(1, 2), backward=True),
                _product(x.transpose(1, 2), dy, backward=True))
    x, w, dy = map(_build.dense, (x, w, dy))
    E, C, D = x.shape
    F = w.shape[2]
    dx = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    dw = torch.empty((E, D, F), dtype=x.dtype, device=x.device)
    # dw on a second stream, so that its blocks take the SMs that dx's
    # last tiles leave idle (the outputs are independent).  Every tensor
    # it touches was allocated on the caller's stream, which waits for it
    # before going on, so none is freed or reused before it is done.
    main = torch.cuda.current_stream(x.device)
    side = _side_stream(x.device)
    side.wait_stream(main)
    _product_bwd(0, x, w, dy, dx)
    with torch.cuda.stream(side):
        _product_bwd(1, x, w, dy, dw)
    main.wait_stream(side)
    return dx, dw


_SIDE = {}                 # device index -> the backward's second stream


def _side_stream(device: torch.device):
    if device.index not in _SIDE:
        _SIDE[device.index] = torch.cuda.Stream(device)
    return _SIDE[device.index]


def _product_bwd(which: int, x: torch.Tensor, w: torch.Tensor,
                 dy: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """dx (``which`` 0) or dw (1) into ``out`` by one tensor-core launch
    on dense bf16 x, w, dy on :func:`plan_bwd`'s tiles and persistent
    blocks, on the current stream, counted with the backward's
    launches."""
    E, C, D = x.shape
    F = w.shape[2]
    if out.numel() == 0 or C == 0:        # dw over no rows is zero
        return out.zero_()
    n, _, blocks = plan_bwd(which, E, C, D, F,
                            _build.sm_count(x.device.index))
    lib = _build.library()
    global bwd_launches
    with _build.on_device(x.device.index):
        bwd_launches += 1
        bwd_routes["wgmma"] += 1
        rc = lib.repro_grouped_matmul_bwd_bf16_wgmma(
            which, x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            out.data_ptr(), E, C, D, F, n, blocks,
            _build.current_stream(x.device.index))
    name = "dx" if which == 0 else "dw"
    _build.check(rc, f"grouped_matmul backward ({name}, wgmma)")
    return out
