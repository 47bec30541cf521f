"""Tile tuner for the port's hand-written kernels on an NVIDIA H100.

The JAX package's tuner picks the Pallas BlockSpec shapes of its TPU
kernels with MATCHA's ZigZag-LOMA idea one level down: enumerate the
tiles, keep those whose working set fits the fast memory, and rank them
by a two-term model,

    seconds = max(compute, memory)        (an overlapped pipeline)

Here the candidates are the launches that the port's wrappers can make on
the card, and the model's constants are the card's:

* K1, the GEMM (``kernels/matmul``): the splits of K that
  :func:`~repro_torch.kernels.matmul.matmul.splits` lists for the route a
  pair of contiguous operands takes, each on
  :func:`~repro_torch.kernels.matmul.matmul.tile`'s register tile.  They
  are ranked by :func:`~repro_torch.kernels.matmul.matmul.cost`, the one
  model of K1's time (the one that ``matmul.plan`` minimises): fp32 FMAs
  at :data:`FP32_FLOPS` (K1 multiplies in plain FMAs, in both dtypes) or
  gemv's weight stream, per block, in waves over the SMs, plus the partial
  sums' round trip.  So :func:`tune_matmul`'s pick is ``plan``'s.
* K3, flash attention (``kernels/flash_attention``): the key tiles that
  ``csrc/flash_attention.cu`` compiles for the head width
  (``WGMMA_BLOCK_K``), on the tensor-core kernel's 128 query rows a block.
  The blocks (128 query rows of a head, one an SM) go in launch order to
  the SM that frees first; the SM that finishes last gives the compute
  term, its (64-row warpgroup, key tile) products at its share of
  :data:`PEAK_FLOPS`, padding and masked keys included.  Memory is q read
  and o written once and K/V read once per head where the K/V of every
  head fits the L2 (the blocks resident at once share it), or once per
  query tile (the JAX model) where it does not, at :data:`HBM_BW`.  Beside
  the two overlapped terms, each key tile that the last SM's blocks step
  through costs :data:`TILE_SECONDS` (the ring's barriers, the waits on
  both products and the softmax's shuffles).  A tile is feasible if its
  shared memory fits :data:`SMEM_LIMIT`.

Neither tuner changes what a call launches by itself: the wrappers' own
defaults (``matmul.plan``, ``flash_attention.DEFAULT_BLOCK_K``) stand, and
a caller passes a pick as ``matmul(..., split=...)`` or
``flash_attention(..., block_k=...)``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.matmul import matmul as mm

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (K3)
FP32_FLOPS = mm._FP32_FLOPS  # H100 SXM fp32 FMAs, no tensor cores (K1)
HBM_BW = 3.35e12           # H100 SXM device memory, bytes/s
SMEM_LIMIT = 232448        # shared memory a block can opt into
L2_BYTES = 50e6            # H100 SXM L2
SMS = 132                  # H100 SXM streaming multiprocessors
# K3's cost of one key tile a block steps through, beside its products:
# the least-squares fit (0.726 us) of ``launch/time_tiles.py``'s rows on an
# H100 SXM (every compiled key tile at its six attention rows against this
# model's two terms)
TILE_SECONDS = 0.73e-6

_DTYPE = {2: torch.bfloat16, 4: torch.float32}
_ROW = 128                 # bytes of one swizzled row: 64 bf16
_WARPGROUP_ROWS = 64


@dataclasses.dataclass(frozen=True)
class MatmulTiling:
    block_m: int                 # rows of a block tile (gemv: rows held)
    block_n: int                 # columns of a block tile
    block_k: int                 # k rows of a block: the chunk of K
    order: str                   # "k_inner": each block sums its chunk
    smem_bytes: int
    est_seconds: float
    route: str                   # "gemv" or "tile"
    splits: int                  # chunks of K, summed in order


@dataclasses.dataclass(frozen=True)
class AttentionTiling:
    block_q: int
    block_k: int
    smem_bytes: int
    est_seconds: float
    stages: int                  # the K/V ring's depth
    compute_seconds: float
    memory_seconds: float
    tile_seconds: float          # the key tiles' fixed cost


def _matmul_smem(route: str, tm: int, tn: int, chunk: int,
                 itemsize: int) -> int:
    """Shared memory of a K1 block (``csrc/matmul.cu``): gemv's chunk of A
    (or its 8 warps' partial rows); the tile kernel's ring of 16-deep K
    steps, 4 stages at 64 columns and 3 at 128, A at a pitch of 16 + one
    16-byte copy."""
    if route == "gemv":
        return 4 * max(chunk * tm, 8 * tm * mm._GEMV_COLS)
    bm, bn = 8 * tm, 16 * tn
    stages = 4 if tn == 4 else 3
    pitch = mm._BK + 16 // itemsize
    return stages * (bm * pitch + mm._BK * bn) * itemsize


def rank_matmul(M: int, N: int, K: int, itemsize: int = 2,
                sms: int = SMS) -> List[MatmulTiling]:
    """Every split of K that K1 launches for contiguous (M, K) and (K, N)
    operands of ``itemsize`` bytes, fastest first by ``matmul.cost`` on a
    card of ``sms`` SMs (ties in ``splits``' order)."""
    route = "gemv" if M <= mm.GEMV_MAX_M else "tile"
    tm, tn = mm.tile(route, M, N)
    dtype = _DTYPE[itemsize]
    cands = [MatmulTiling(
        tm if route == "gemv" else 8 * tm,
        mm._GEMV_COLS if route == "gemv" else 16 * tn, chunk, "k_inner",
        _matmul_smem(route, tm, tn, chunk, itemsize),
        mm.cost(route, M, N, sms, dtype, (s, chunk)), route, s)
        for s, chunk in mm.splits(route, M, N, K)]
    return sorted((c for c in cands if c.smem_bytes <= SMEM_LIMIT),
                  key=lambda c: c.est_seconds)


def tune_matmul(M: int, N: int, K: int, itemsize: int = 2,
                sms: int = SMS) -> MatmulTiling:
    """K1's split of K for (M, N, K): ``matmul.plan``'s pick, with its
    block tile, shared memory and modelled time."""
    return rank_matmul(M, N, K, itemsize, sms)[0]


def _key_range(q_first: int, q_last: int, S: int, causal: bool,
               window: Optional[int]) -> Tuple[int, int]:
    """The keys [lo, hi) that some query row in [q_first, q_last] attends
    (``csrc/flash_attention.cu``: key_range)."""
    lo, hi = 0, S
    if causal:
        hi = min(hi, q_last + 1)
    if window is not None:
        lo = max(lo, q_first - window + 1)
        if not causal:
            hi = min(hi, q_last + window)
    return lo, hi


def _attention_blocks(S: int, bk: int, causal: bool,
                      window: Optional[int]) -> List[Tuple[int, int]]:
    """(key tiles the block steps through, (warpgroup, key tile) products
    it computes) of each query tile of one head, in the order the wgmma
    kernel launches them (the last query tile first): a block streams the
    key tiles of its 128 rows' range, a warpgroup skips a tile none of its
    64 rows attends."""
    bq = fa.WGMMA_BLOCK_Q
    out = []
    for q0 in reversed(range(0, S, bq)):
        lo, hi = _key_range(q0, min(q0 + bq, S) - 1, S, causal, window)
        t_lo, t_hi = lo // bk, -(-hi // bk)
        products = 0
        for wq0 in range(q0, min(q0 + bq, S), _WARPGROUP_ROWS):
            wlo, whi = _key_range(wq0, min(wq0 + _WARPGROUP_ROWS, S) - 1, S,
                                  causal, window)
            products += sum(1 for t in range(t_lo, t_hi)
                            if t * bk < whi and t * bk + bk > wlo)
        out.append((max(0, t_hi - t_lo), products))
    return out


def _busiest_sm(blocks: List[Tuple[int, int]], heads: int, product_s: float,
                sms: int) -> Tuple[float, float]:
    """(product seconds, key-tile seconds) of the SM that finishes last
    when the blocks, every head of one query tile after another, each go to
    the SM that frees first (one block an SM)."""
    free = [(0.0, 0.0, 0.0)] * min(sms, heads * len(blocks))
    for steps, products in blocks:
        for _ in range(heads):
            t, c, k = heapq.heappop(free)
            dc, dk = products * product_s, steps * TILE_SECONDS
            heapq.heappush(free, (t + dc + dk, c + dc, k + dk))
    _, c, k = max(free)
    return c, k


def attention_smem(Dh: int, bk: int) -> Tuple[int, int]:
    """(shared memory bytes, ring stages) of the wgmma kernel's (Dh, bk)
    instance (``csrc/flash_attention.cu``, Cfg): Q, a ring of K/V tiles
    holding 256 keys at Dh <= 128 (3 stages at Dh 256), 1024 bytes of
    alignment slack and the ring's mbarriers."""
    atoms = Dh // 64
    stages = 256 // bk if Dh <= 128 else 3
    q_bytes = atoms * fa.WGMMA_BLOCK_Q * _ROW
    stage = 2 * atoms * bk * _ROW
    return 1024 + q_bytes + stages * stage + 8 * (2 * stages + 1), stages


def rank_flash_attention(S: int, Dh: int, heads_per_core: int = 1,
                         itemsize: int = 2, causal: bool = False,
                         window: Optional[int] = None, batch: int = 1,
                         kv_heads: Optional[int] = None,
                         sms: int = SMS) -> List[AttentionTiling]:
    """Every compiled key tile of the wgmma kernel at head width ``Dh``
    for ``batch`` x ``heads_per_core`` query heads of S positions over
    ``kv_heads`` K/V heads a batch row (None: as many as query heads),
    fastest first by the model in this module's docstring (ties: less
    shared memory)."""
    if Dh not in fa.WGMMA_BLOCK_K:
        raise ValueError(f"no wgmma instance at head width {Dh}: "
                         f"{sorted(fa.WGMMA_BLOCK_K)}")
    heads = heads_per_core * batch
    bq = fa.WGMMA_BLOCK_Q
    nq = -(-S // bq)
    io_bytes = 2 * heads * S * Dh * itemsize             # q read, o written
    kv = 2 * S * Dh * itemsize * batch * (kv_heads or heads_per_core)
    kv_reads = 1 if kv <= L2_BYTES else nq
    memory = (io_bytes + kv * kv_reads) / HBM_BW
    out = []
    for bk in fa.WGMMA_BLOCK_K[Dh]:
        smem, stages = attention_smem(Dh, bk)
        if smem > SMEM_LIMIT:
            continue
        # QK^T and PV of a warpgroup's 64 rows by bk keys, at one SM's
        # share of the peak
        product_s = 4.0 * _WARPGROUP_ROWS * bk * Dh / (PEAK_FLOPS / sms)
        compute, tiles = _busiest_sm(_attention_blocks(S, bk, causal, window),
                                     heads, product_s, sms)
        out.append(AttentionTiling(bq, bk, smem,
                                   max(compute, memory) + tiles, stages,
                                   compute, memory, tiles))
    return sorted(out, key=lambda t: (t.est_seconds, t.smem_bytes))


def tune_flash_attention(S: int, Dh: int, heads_per_core: int = 1,
                         itemsize: int = 2, causal: bool = False,
                         window: Optional[int] = None, batch: int = 1,
                         kv_heads: Optional[int] = None,
                         sms: int = SMS) -> AttentionTiling:
    """The key tile :func:`rank_flash_attention` puts first."""
    return rank_flash_attention(S, Dh, heads_per_core, itemsize, causal,
                                window, batch, kv_heads, sms)[0]
