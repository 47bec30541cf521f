"""The tile tuner's candidates on the card: every split of K of the GEMM
(K1) and every compiled key tile of flash attention's tensor-core kernel
(K3), each held to its plain version and timed beside the tuner's rank.

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/time_tiles.py

K1's rows are the fp32 GEMMs of ``chip_smoke.py`` phase c's tiled
runtime at its shape buckets (M 1, 32 and 64; K 2560 and 8960, N 48, 1280
and 4480, B a column slice of a wider weight), the wide decode gemv (1 x
8960 x 4480) among them.  Each split that ``matmul.splits`` lists is
launched through ``matmul(a, b, split=...)``, held to the plain version
at K1's tolerance (1e-4 sqrt(K) + 1e-4 |y|) and timed with a cold L2
(:func:`median_ms`: ``time_k1k2.time_ms``'s method with a spin four times
as long, since a call that names its split checks it on the host first,
and the median of the calls; with the shorter spin these 0.01-0.15 ms
kernels' times moved by up to 6x between two runs); the row prints
``autotune.rank_matmul``'s order beside the measured one.  K3's rows are qwen3-8b's B1 S77 and S1000 (H32/8
Dh128 causal), olmoe-1b-7b's B1 S4096 (H16/16 Dh128 causal),
recurrentgemma-2b's Dh 256 window 2048 (B1 S4096 H10/1), granite-moe-3b-
a800m's training shape (B4 S1024 H24/8 Dh64 causal) and the tuner's long
sequence (B1 S32768 H1 Dh128, no mask).  Each compiled key tile is
launched through ``flash_attention(..., block_k=...)``, held to the plain
version at 2e-2 and timed the same way, beside SDPA's time (the library
yardstick) and the bound; the row prints ``autotune.rank_flash_attention``'s model of
each tile beside the measured times, and the file fits the model's fixed
cost a key tile (``autotune.TILE_SECONDS``) to all of them.

Prints the card's name and power limit, then one ``{"tiles": ...}`` JSON
line.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory

# K1: phase c's fp32 buckets; (M, K, N)
K1_ROWS = [(M, K, N) for M in (1, 32, 64) for K in (2560, 8960)
           for N in (48, 1280, 4480)]
# K3: B, S, H, KV, Dh, causal, window, what
K3_ROWS = [
    (1, 77, 32, 8, 128, True, None, "qwen3-8b"),
    (1, 1000, 32, 8, 128, True, None, "qwen3-8b"),
    (1, 4096, 16, 16, 128, True, None, "olmoe-1b-7b"),
    (1, 4096, 10, 1, 256, True, 2048, "recurrentgemma-2b local"),
    (4, 1024, 24, 8, 64, True, None, "granite-moe-3b-a800m training"),
    (1, 32768, 1, 1, 128, False, None, "long sequence"),
]
# rows at or past this many positions hold the kernel to the plain version
# once and leave the plain version untimed
PLAIN_UNTIMED_S = 32768


def median_ms(torch, fn, flush) -> float:
    """The median device time of ``fn`` over ``time_k1k2.ITERS`` calls,
    each after a zeroing of ``flush`` (larger than L2) and a ~0.4 ms spin
    (the host enqueues ``fn`` meanwhile), between its own pair of events,
    after 3 warm calls."""
    from repro_torch.launch.time_k1k2 import ITERS, SPIN_CYCLES
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(4 * SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return 0.5 * (times[(ITERS - 1) // 2] + times[ITERS // 2])


def _bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _ranks(values):
    """Each entry's place (0 the least) in ``values``."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    rank = [0] * len(values)
    for place, i in enumerate(order):
        rank[i] = place
    return rank


def k1_rows(torch, dev, gen, flush):
    """Every split of K at each K1 row: a dict a row with the splits in
    ``matmul.splits``' order, each with its time, the tuner's modelled
    seconds and both ranks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import autotune
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matmul.ref import matmul_ref
    sms = _build.sm_count(dev.index)
    rows = []
    for M, K, N in K1_ROWS:
        a = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N + 64, generator=gen, device=dev)
        b = w[:, 32:32 + N]
        route = mm.route(a, b)
        want = matmul_ref(a, b)
        tuned = {(t.splits, t.block_k): t
                 for t in autotune.rank_matmul(M, N, K, 4, sms)}
        cands, err = [], 0.0
        for split in mm.splits(route, M, N, K):
            before = mm.routes[route]
            got = mm.matmul(a, b, split=split)
            if mm.routes[route] != before + 1:
                raise AssertionError(f"matmul {M}x{K}x{N} split {split}: "
                                     f"not one launch on the {route} route")
            diff = (got - want).abs()
            err = max(err, diff.max().item())
            if not bool((diff <= 1e-4 * math.sqrt(K)
                         + 1e-4 * want.abs()).all()):
                raise AssertionError(f"matmul {M}x{K}x{N} split {split}: "
                                     f"max abs err {diff.max().item()}")
            cands.append({"splits": split[0], "chunk": split[1],
                          "est_ms": tuned[split].est_seconds * 1e3,
                          "ms": median_ms(torch, lambda: mm.matmul(
                              a, b, split=split), flush)})
        for key, rank in (("est_ms", "tuner_rank"), ("ms", "measured_rank")):
            for c, r in zip(cands, _ranks([c[key] for c in cands])):
                c[rank] = r
        pick = autotune.tune_matmul(M, N, K, 4, sms)
        plan = mm.plan(route, M, N, K, sms, torch.float32)
        if (pick.splits, pick.block_k) != plan:
            raise AssertionError(f"tuner {pick} is not plan's {plan}")
        best = min(cands, key=lambda c: c["ms"])
        at_pick = next(c for c in cands
                       if (c["splits"], c["chunk"]) == plan)
        rows.append({
            "case": f"{M}x{K}x{N} strided B fp32", "route": route,
            "max_abs_err": err, "pick": [pick.splits, pick.block_k],
            "pick_ms": at_pick["ms"], "pick_measured_rank":
                at_pick["measured_rank"],
            "best": [best["splits"], best["chunk"]], "best_ms": best["ms"],
            "pick_over_best": at_pick["ms"] / best["ms"],
            "bound_ms": _bound_ms(2.0 * M * N * K,
                                  4.0 * (M * K + K * N + M * N),
                                  FP32_FLOPS)[0],
            "library_ms": median_ms(torch, lambda: torch.matmul(a, b), flush),
            "splits": cands})
        print(f"tiles: K1 {rows[-1]['case']} {route}: tuner's pick "
              f"{rows[-1]['pick']} {at_pick['ms']:.5f} ms (measured rank "
              f"{at_pick['measured_rank']} of {len(cands)}), fastest "
              f"{rows[-1]['best']} {best['ms']:.5f} ms; tuner ranks "
              f"{[c['tuner_rank'] for c in cands]}, measured "
              f"{[c['measured_rank'] for c in cands]}", flush=True)
    return rows


def k3_rows(torch, dev, gen, flush):
    """Every compiled key tile at each K3 row: a dict a row with the
    tiles' times, the tuner's model of each, SDPA's time and the bound."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                       attention_mask,
                                                       attention_ref)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for B, S, H, KV, Dh, causal, win, what in K3_ROWS:
        q = torch.randn(B, S, H, Dh, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).bfloat16()
        plain = attention_ref if S <= fa.CHUNKED_THRESHOLD \
            else attention_chunked
        want = plain(q, k, v, causal=causal, window=win).float()
        pos = torch.arange(S, device=dev)
        if S < PLAIN_UNTIMED_S:
            allowed = attention_mask(pos, pos, causal, win)
            pairs = int(allowed.sum().item())
        else:
            allowed, pairs = None, S * S
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if win is None:
            def lib():
                return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            def lib():
                return sdpa(qt, kt, vt, attn_mask=allowed, enable_gqa=True)
        model = {t.block_k: t for t in autotune.rank_flash_attention(
            S, Dh, H, 2, causal, win, B, KV)}
        tiles, err = [], 0.0
        for bk in fa.WGMMA_BLOCK_K[Dh]:
            before = fa.routes["wgmma"]
            got = fa.flash_attention(q, k, v, causal=causal, window=win,
                                     block_k=bk)
            if fa.routes["wgmma"] != before + 1:
                raise AssertionError(f"flash_attention {what} S{S} block_k "
                                     f"{bk}: no launch on the wgmma route")
            diff = (got.float() - want).abs()
            err = max(err, diff.max().item())
            if not bool((diff <= 2e-2 + 2e-2 * want.abs()).all()):
                raise AssertionError(f"flash_attention {what} S{S} block_k "
                                     f"{bk}: max abs err "
                                     f"{diff.max().item()}")
            m = model[bk]
            tiles.append({
                "block_k": bk, "stages": m.stages, "smem_bytes": m.smem_bytes,
                "ms": median_ms(torch, lambda: fa.flash_attention(
                    q, k, v, causal=causal, window=win, block_k=bk), flush),
                "est_ms": m.est_seconds * 1e3,
                "compute_ms": m.compute_seconds * 1e3,
                "memory_ms": m.memory_seconds * 1e3,
                "tile_ms": m.tile_seconds * 1e3,
                "default": bk == fa.DEFAULT_BLOCK_K[Dh]})
        pick = autotune.tune_flash_attention(S, Dh, H, 2, causal, win, B, KV)
        best = min(tiles, key=lambda t: t["ms"])
        b_ms, b_by = _bound_ms(4.0 * B * H * Dh * pairs,
                               (2 * q.numel() + k.numel() + v.numel()) * 2,
                               BF16_FLOPS)
        rows.append({
            "case": (f"{what} B{B} S{S} H{H}/{KV} Dh{Dh} "
                     f"{'causal' if causal else 'bidirectional'}"
                     f"{'' if win is None else f' window {win}'} bf16"),
            "max_abs_err": err, "pick": pick.block_k,
            "fastest": best["block_k"], "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": (median_ms(torch, lambda: plain(
                q, k, v, causal=causal, window=win), flush)
                if S < PLAIN_UNTIMED_S else None),
            "library_ms": median_ms(torch, lib, flush), "tiles": tiles})
        print(f"tiles: K3 {rows[-1]['case']}: tuner's pick {pick.block_k}, "
              f"fastest {best['block_k']}; "
              + ", ".join(f"BK {t['block_k']} {t['ms']:.5f} ms (model "
                          f"{t['est_ms']:.5f})" for t in tiles)
              + f"; SDPA {rows[-1]['library_ms']:.5f} ms", flush=True)
        del q, k, v, want, allowed
        torch.cuda.empty_cache()
    return rows


def fit_tile_seconds(rows) -> float:
    """The fixed cost a key tile that makes the model's time closest (least
    squares) to every measured K3 time: time = max(compute, memory) + n x
    cost, n the key tiles of the SM that finishes last."""
    from repro_torch.kernels import autotune
    num = den = 0.0
    for row in rows:
        for t in row["tiles"]:
            n = t["tile_ms"] / (autotune.TILE_SECONDS * 1e3)
            rest = t["ms"] - max(t["compute_ms"], t["memory_ms"])
            num += n * rest
            den += n * n
    return num / den * 1e-3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_tiles: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.launch.time_k1k2 import FLUSH_BYTES, warm_up
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    warm_up(torch, dev)
    k1 = k1_rows(torch, dev, gen, flush)
    k3 = k3_rows(torch, dev, gen, flush)
    print(smi[0])
    print(json.dumps({"tiles": {"k1": k1, "k3": k3,
                                "tile_seconds_fit": fit_tile_seconds(k3)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
