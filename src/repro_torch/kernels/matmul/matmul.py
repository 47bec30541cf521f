"""Tiled GEMM: ``jnp.matmul`` semantics over fp32 or bf16 operands with an
fp32 accumulator and the output in the operands' dtype.

CUDA tensors launch the hand-written kernels in ``csrc/matmul.cu`` on the
route :func:`route` picks before the launch: ``"gemv"`` (M <= 8, B
16-byte readable), ``"tile"`` (A and B 16-byte readable) or ``"scalar"``
(the tile kernel with element copies: any strides), with the block tile
:func:`tile` gives.  K is split into the chunks :func:`plan` gives, summed
in chunk order by a second kernel (counted in ``sum_launches``); a call
may name one of :func:`splits` instead (``split``).  CPU
tensors run :func:`~repro_torch.kernels.matmul.ref.matmul_ref`.  Shapes:
``(..., M, K) @ (K, N)`` (leading dims of ``a`` flattened into M), or
``(..., M, K) @ (..., K, N)`` with broadcast batch dims.  ``b`` is read
through its strides, so a column slice of a weight or a transposed view
goes in without a copy.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.matmul.ref import matmul_ref

_ENTRY = {torch.float32: "repro_matmul_f32",
          torch.bfloat16: "repro_matmul_bf16"}
_ROUTE_ID = {"gemv": 0, "tile": 1, "scalar": 2}
_MAX_GRID = 65535          # gridDim.y / gridDim.z limit (M tiles, batch)
GEMV_MAX_M = 8             # rows the gemv kernel holds (MR <= 8)
# the kernels' fixed sizes, which csrc/matmul.cu checks its arguments by:
_BK = 16                   # the tile kernel's K step
_GEMV_COLS = 128           # columns of a gemv block
_GEMV_A_FLOATS = 8192      # gemv's chunk of A in shared memory (32 KB)
# plan()'s model of a block's time, checked on an H100 SXM by
# ``launch/time_k1k2.py --splits`` (every split of K on phase a's fp32
# rows against plan()'s pick): the gemv route streams B at 2.5 TB/s over
# the card, the tile route runs FMAs at the 67 TFLOP/s fp32 peak, a block
# costs 32 k rows more than its chunk, one or two waves of blocks hide
# latency at 0.7 or 0.9 of a full card, and the partial sums' round trip
# moves 8 bytes an output a chunk at 3 TB/s after a 2 us launch
_GEMV_BYTES_PER_S = 2.5e12
_FP32_FLOPS = 67e12
_BLOCK_ROWS = 32
_OCCUPANCY = {1: 0.7, 2: 0.9}
_SUM_BYTES_PER_S, _SUM_LAUNCH_S = 3e12, 2e-6

launches = 0               # GEMM kernel launches since the last reset
routes = {"gemv": 0, "tile": 0, "scalar": 0}      # the same, by route
sum_launches = 0           # chunk-sum kernel launches (calls that split K)


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


def _operands(a: torch.Tensor, b: torch.Tensor):
    """(a3 (batch, M, K), b3 (batch or 1, K, N), the output's leading
    shape): the views the kernel reads."""
    K = b.shape[-2]
    if b.dim() == 2:
        return a.reshape(1, -1, K), b.unsqueeze(0), a.shape[:-1]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    M, N = a.shape[-2], b.shape[-1]
    return (a.expand(*batch, M, K).reshape(-1, M, K),
            b.expand(*batch, K, N).reshape(-1, K, N), (*batch, M))


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte readable rows: innermost stride 1, the other strides (of
    dims longer than 1) multiples of 16 bytes, the base 16-byte aligned."""
    e = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % e == 0 or n == 1
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def _route3(a3: torch.Tensor, b3: torch.Tensor) -> str:
    if a3.shape[1] <= GEMV_MAX_M and _vec_ok(b3):
        return "gemv"
    if _vec_ok(a3) and _vec_ok(b3):
        return "tile"
    return "scalar"


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route a CUDA call of :func:`matmul` on these operands launches.
    Pure: reads only dtypes, shapes, strides and data pointers, so it
    answers for CPU and meta tensors too."""
    _check(a, b)
    return _route3(*_operands(a, b)[:2])


def tile(route: str, M: int, N: int) -> Tuple[int, int]:
    """The thread's register tile (TM, TN) of the tile and scalar routes'
    8TM x 16TN block tile: 16, 32 or 64 rows by M; 64 columns, 128 at 64
    rows where N > 64.  On gemv, (MR, 0): M rounded up to the 1, 2, 4 or 8
    rows a gemv block holds."""
    if route == "gemv":
        return 1 << max(0, M - 1).bit_length(), 0
    tm = 2 if M <= 16 else 4 if M <= 32 else 8
    return tm, 8 if tm == 8 and N > 64 else 4


def splits(route: str, M: int, N: int, K: int) -> List[Tuple[int, int]]:
    """The splits of K that :func:`plan` weighs, (chunks, chunk length),
    for 1 to 64 chunks wanted: whole chunks of the kernel's step (16 k rows,
    128 on gemv) of at least 128 rows, and on gemv at most what its shared
    memory holds of A (chunk x MR floats)."""
    tm, _ = tile(route, M, N)
    if route == "gemv":
        unit, lo, hi = 128, 128, _GEMV_A_FLOATS // tm
    else:
        unit, lo, hi = _BK, 128, 1 << 30
    out = []
    for want in range(1, 65):
        chunk = min(hi, max(lo, -(-(-(-K // want)) // unit) * unit))
        s = (max(1, -(-K // chunk)), chunk)
        if s not in out:
            out.append(s)
    return out


def cost(route: str, M: int, N: int, sms: int, dtype: torch.dtype,
         split: Tuple[int, int]) -> float:
    """Seconds of the busiest SM that :func:`plan`'s model gives ``split``
    (chunks, chunk length) at (M, N) on a card of ``sms`` SMs: blocks
    spread over the SMs, each costing its chunk of FMAs (tile) or of weight
    bytes (gemv) plus a fixed overhead, fewer than three waves of blocks
    hiding latency worse, plus the partial sums' round trip."""
    tm, tn = tile(route, M, N)
    if route == "gemv":
        tiles = -(-N // _GEMV_COLS)
        per_row = (_GEMV_COLS * torch.finfo(dtype).bits // 8
                   / (_GEMV_BYTES_PER_S / sms))
    else:
        bm, bn = 8 * tm, 16 * tn
        tiles = -(-M // bm) * -(-N // bn)
        per_row = 2 * bm * bn / (_FP32_FLOPS / sms)
    s, chunk = split
    waves = -(-tiles * s // sms)
    t = waves * (chunk + _BLOCK_ROWS) * per_row / _OCCUPANCY.get(waves, 1.0)
    if s > 1:
        t += s * M * N * 8 / _SUM_BYTES_PER_S + _SUM_LAUNCH_S
    return t


@functools.lru_cache(maxsize=4096)
def plan(route: str, M: int, N: int, K: int, sms: int,
         dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(chunks, chunk length) of the split of K for ``route`` at (M, N,
    K) on a card of ``sms`` SMs: a function of these alone, so equal shapes
    sum in equal order.  Picks of :func:`splits` the first that minimises
    :func:`cost`."""
    return min(splits(route, M, N, K),
               key=lambda split: cost(route, M, N, sms, dtype, split))


def _launch(a3: torch.Tensor, b3: torch.Tensor, out: torch.Tensor, r: str,
            splits: int, chunk: int) -> None:
    """One call of the C entry into ``out`` (contiguous, batch x M x N
    elements): the kernel of route ``r`` over K in ``splits`` chunks of
    ``chunk``, then (splits > 1) the chunk sum."""
    global launches, sum_launches
    nb, M, K = a3.shape
    N = b3.shape[-1]
    tm, tn = tile(r, M, N)
    if nb > _MAX_GRID or -(-M // 16) > _MAX_GRID or splits > _MAX_GRID:
        raise ValueError(f"matmul grid too large: batch {nb}, M {M}")
    index = a3.device.index
    ws = (torch.empty((splits, nb, M, N), dtype=torch.float32,
                      device=a3.device) if splits > 1 else None)
    lib = _build.library()
    with _build.on_device(index):
        launches += 1
        routes[r] += 1
        sum_launches += splits > 1
        rc = getattr(lib, _ENTRY[a3.dtype])(
            a3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), nb, M, N, K,
            *a3.stride(), *b3.stride(), _ROUTE_ID[r], tm, tn, splits, chunk,
            _build.sm_count(index), _build.current_stream(index))
    _build.check(rc, f"matmul ({r})")


@functools.lru_cache(maxsize=4096)
def _listed(route: str, M: int, N: int, K: int) -> frozenset:
    return frozenset(splits(route, M, N, K))


def _check_split(a: torch.Tensor, b: torch.Tensor,
                 split: Tuple[int, int]) -> None:
    a3, b3, _ = _operands(a, b)
    r, (M, K), N = _route3(a3, b3), a3.shape[1:], b3.shape[-1]
    if tuple(split) not in _listed(r, M, N, K):
        raise ValueError(f"split {tuple(split)} of K {K} is not one that the "
                         f"{r} route launches at M {M}, N {N}: "
                         f"{splits(r, M, N, K)}")


def matmul(a: torch.Tensor, b: torch.Tensor,
           split: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``split``: (chunks, chunk length), one of :func:`splits` for the
    route these operands take, in place of :func:`plan`'s; CPU tensors
    check it and run the plain version."""
    _check(a, b)
    if split is not None:
        _check_split(a, b, split)
    dev = a.device
    if dry.storageless(a):
        a3, b3, lead = _operands(a, b)
        (M, K), N = a3.shape[1:], b3.shape[-1]
        return dry.call("matmul", (a, b), [((*lead, N), a.dtype)],
                        (2.0 * a3.shape[0] * M * N * K,
                         (a3.numel() + b3.numel() + a3.shape[0] * M * N)
                         * a.element_size()))[0]
    if dev.type == "cpu":
        return matmul_ref(a, b)
    if dev.type != "cuda":
        raise ValueError(f"no matmul kernel for device {dev}")
    _build.refuse_dtensor("matmul", a)
    _build.refuse_grad("matmul", a, b)
    a3, b3, lead = _operands(a, b)
    M, K = a3.shape[1:]
    N = b3.shape[-1]
    # contiguous: the kernel's (batch, M, N) output in the result's shape
    out = torch.empty((*lead, N), dtype=a.dtype, device=dev)
    if out.numel() == 0:
        return out
    r = _route3(a3, b3)
    _launch(a3, b3, out, r,
            *(split or plan(r, M, N, K, _build.sm_count(dev.index), a.dtype)))
    return out
