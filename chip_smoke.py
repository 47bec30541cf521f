#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs
ten phases; any mismatch raises, so the script exits non-zero:

(a) kernels: the GEMM, RMSNorm, flash-attention, WKV6, RG-LRU scan and
    grouped-matmul kernels against their plain torch versions on the
    card, at the serving paths' shapes, and their times (cold L2) beside
    the plain version, the library call (none for the two scans) and the
    bound; each row names the route its call took (the GEMM's gemv, tile
    or scalar, at M 1, 8, 16, 32 and 64 and at a misaligned column slice;
    RMSNorm's warp, block or scalar, at the rows of every served family);
    flash attention and the grouped matmul on both of their routes
    (the tensor-core kernel, and the SIMT kernel that fp32 and the shapes
    and strides TMA cannot read take), each row naming its route, the
    bf16 flash-attention rows also timed on the SIMT kernel (the design
    before the tensor-core one), each of the tensor-core flash-attention
    instances (Dh 64, 128, 256) held once, the grouped matmul's
    wrapper's host time per call on each route; WKV6 and the RG-LRU scan
    also at rwkv6-3b's and recurrentgemma-2b's 4096-token prefill shapes
    (held to the plain version once, the plain version untimed), and
    every compiled instance of both held once (WKV6's four head widths,
    each with its columns per block, and the scan's strip, in fp32 and
    bf16);
(b) plans: MLPerf-Tiny autoencoder, resnet and transformer_block compiled
    by the port's compiler (carfield SoC, mode "matcha"); ``execute_plan``
    on the card against ``execute_graph`` on CPU tensors at 1e-4, and a
    two-tenant ``execute_multi_plan`` bitwise against ``execute_plan``;
(c) serving, the main path: ``build_engine("rwkv6", max_seq=64, d=2560,
    ffn=8960)`` on the card drains launch/serve.py's trace (2 prompts, 4
    decode steps each); every served output is held to ``execute_graph``
    of its bucket graph on CPU tensors at 1e-4, and both kernels must have
    launched during this phase; it prints both kernels' launches by route
    and requires that a GEMM took the scalar route only where no vector
    route could read its operands;
(d) LM serving: qwen3-8b at full width and depth (configs/qwen3_8b.py,
    bf16, random weights from a seeded generator) prefills prompts of 77,
    256, 511 and 1000 tokens and a batch of 2 x 128, and greedily decodes
    8 tokens after each; the logits must be finite, flash attention must
    launch once per layer per prefill, on the tensor-core route, and
    RMSNorm once per norm of each forward pass (prefill or decode step),
    the q/k-norm on its warp route and the rest on its block route.
    Then ``decode_step`` fed token S after ``prefill`` of S tokens is held to
    ``prefill`` of S + 1 tokens (the flash-attention path against the
    plain decode attention): in bf16 at full depth, and in fp32 on the
    first 4 layers at full width.
(e) recurrent LM serving: rwkv6-3b at full width and depth
    (configs/rwkv6_3b.py, bf16) serves prompts of 77, 256, 1000 and 4096
    tokens and 2 x 128 as phase d does; WKV6 must launch once per layer
    per prefill and RMSNorm once per norm of each forward pass (the
    per-head ln_x on the warp route).  Decode is
    held to prefill at S = 77 and 1000 (the WKV6 kernel against the plain
    single-token step), in bf16 at full depth and fp32 on 4 layers.
(f) hybrid LM serving: recurrentgemma-2b at full width and depth
    (configs/recurrentgemma_2b.py, bf16), the same prompts (4096 crosses
    the 2048-token window); the RG-LRU scan must launch once per recurrent
    layer (18) and flash attention once per attention layer (8) per
    prefill, on the tensor-core route.  Decode is held to prefill at S =
    77 and 2100 (a rolled ring cache), in bf16 at full depth and fp32 on 6
    layers.
(g) MoE LM serving: olmoe-1b-7b at full width and depth
    (configs/olmoe_1b_7b.py, bf16: 64 experts, top-8), phase e's prompts
    (4096 tokens dispatch 648 rows per expert, which the TPU kernel's
    128-row block cannot take); the grouped matmul must launch three times
    per layer (48) in every forward pass, prefill or decode step, and
    flash attention once per layer per prefill.  Decode is held to
    prefill at S = 77 and 1000 with the capacity factor raised to
    n_experts / top_k (so that no assignment drops in either), in bf16 at
    full depth and fp32 on 4 layers.  Every grouped matmul and flash
    attention of the bf16 serving runs (d, f, g) takes the tensor-core
    route, every one of their fp32 checks the SIMT route.

(h) the fleet layer: examples/fleet.py's rack (four carfield SoCs of two
    tenant slots, the four MLPerf Tiny classes at their published widths)
    with numeric execution on the card: contention-aware placement, the
    router with the placement's demand split, and the rebalancer; an
    open-loop trace of 40 arrivals of each class at about 1/3 of its alone
    rate, mobilenet HIGH with a deadline of 2.5 x its alone time, and the
    SoC hosting mobilenet failing halfway through mobilenet's arrivals.
    No request may drop; every result, and a probe request, is held to
    ``execute_graph`` on CPU tensors at 1e-4; the probe's inputs served on
    the failing SoC before the failure, on mobilenet's destination after
    it, and by the reference plan of the destination's tiling give the
    same bits; the GEMM must launch.  It prints the compile time, the
    placement, each migration's recovery_s, the trace's wall time and
    requests/s, each class's device busy time by its reference plan and
    the phase's peak memory.

(i) training: internlm2-1.8b (configs/internlm2_1_8b.py), the only dense
    model that trains on one card with its AdamW state.  First the backward
    kernels of RMSNorm and flash attention against their plain versions at
    every instance the path launches (4096 x 2048 bf16 and 256 x 2048 fp32,
    RMSNorm's block route; B4 S1024 H16/8 Dh128 bf16 causal on the
    tensor-core route and B1 S256 fp32 on the SIMT route), RMSNorm's at the
    norms of the families still to train on the card (rwkv6-3b's ln_x 163840
    x 64 and qwen3's q-norm width 131072 x 128 on its warp route,
    recurrentgemma-2b's 4096 x 2560), flash attention's at a windowed row,
    Dh 64 and 256, a ragged S and window 0 (every gradient exactly 0), each
    naming its route, timed beside the plain version, the backward of
    ``F.rms_norm`` and of ``F.scaled_dot_product_attention`` (yardsticks,
    never on the path; SDPA's backend pinned, flash for causal rows,
    efficient for masked ones, and timed in turns with the kernel) and the
    bound.  Then 2 layers at full width in fp32, one remat step's loss and
    every gradient on the card against the CPU plain path (relative L2 1e-3;
    the attention backward all on the SIMT route, RMSNorm's on its block
    route).  Then the model at full width and depth in bf16, 5 remat steps of
    ``launch/train.py``'s step (AdamW, warmup 1) on one fixed 4 x 1024
    batch: every gradient leaf finite and non-zero, the loss falling, the
    exact forward (remat runs each layer's twice) and backward launches, the
    attention backward's all on the tensor-core route and RMSNorm's on its
    block route; a checkpoint after step 2 restored bitwise and step 3 taken
    again from it (loss within 1e-3); tokens/s, device busy and idle share
    of a profiled step, the top kernels, one AdamW update's time alone, and
    peak memory.

(j) training the other families: rwkv6-3b, recurrentgemma-2b and
    granite-moe-3b-a800m (olmoe-1b-7b's AdamW state does not fit one
    card).  First the backward kernels of WKV6, the RG-LRU scan and the
    grouped matmul against their plain versions, in bf16 and fp32, two
    calls bitwise equal: WKV6 at rwkv6-3b's B4 T1024 and B1 T1000 H40 D64
    and at every other compiled head width (16, 32, 128), decays down to
    0.01; the scan at B4 T1024 D2560 and a ragged strip; the grouped
    matmul at granite's gate/up and down products and at each of its
    backward's tensor-core instances, on the tensor cores in bf16; timed beside the plain version, the bound and, for the
    grouped matmul, ``torch.bmm`` on the same two products.  Then each
    family at full width and 2 layers (recurrentgemma-2b: its whole rec,
    rec, attn unit) in fp32, one remat step on the card against the CPU
    plain path (relative L2 1e-3 a gradient leaf) and twice on the card
    bitwise; and in bf16, one step twice bitwise.  Then each family at
    full width and depth in bf16, 4 remat steps of the launcher's donated
    step (AdamW at the launcher's schedule for 4 steps) on one fixed 4 x
    1024 batch (a smaller batch only if 4 does not
    fit): the loss finite and falling, every gradient leaf finite and
    non-zero, the exact forward and backward launches per kernel and
    route (K2's backward at the families' widths, K3's at
    recurrentgemma-2b's H10/KV1 Dh256 window 2048 and granite's H24/KV8
    Dh64, all on the tensor cores), step ms, tokens/s, peak memory and a
    profiled step's busy time, idle share and top kernels.

Every LM phase also runs its longest prompt's prefill twice and requires
the same bits from both.

Standard output: per-phase wall times, the card's name and power limit
(the line of ``nvidia-smi --query-gpu=name,power.limit``), a
``kernel_sweep`` JSON line (every shape of phase a), a
``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.  With
no CUDA card, or without the port's sources beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
HBM_BYTES = 3.35e12        # H100 SXM device memory, bytes/s


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is visible")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)

    from repro_torch.core import runtime  # noqa: F401  (fp32 backend flags)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.rglru_scan import rglru_scan as scan
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    for line in ptxas_lines(_build.build_log):
        print(f"ptxas: {line}")
    print(f"phase build: {build_s:.2f} s")

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    sweep, kernels = phase_kernels(torch, dev, mm, rms, fa, wkv, scan, gm)
    print(f"phase a kernels: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_plans(torch, dev)
    print(f"phase b plans: {time.perf_counter() - t0:.2f} s")

    counted = {"matmul": mm, "rmsnorm": rms, "flash_attention": fa,
               "wkv6": wkv, "rglru": scan, "grouped_matmul": gm}
    reset_launches(counted)
    t0 = time.perf_counter()
    served, gemms = phase_serve(torch, dev)
    c_launches = read_launches(counted)
    per_request = {k: v / served for k, v in c_launches.items()}
    print(f"phase c serve: {time.perf_counter() - t0:.2f} s, {served} "
          f"requests served, launches {c_launches}, per request "
          f"{per_request}")
    # K1's and K2's launches by route; a GEMM takes the scalar route only
    # where no vector route can read its operands (B 16-byte readable, and
    # A too unless M <= 8 puts it on gemv), counted here from the served
    # operands' strides and data pointers
    c_routes = {"matmul": dict(mm.routes), "rmsnorm": dict(rms.routes)}
    c_sums = mm.sum_launches
    print(f"phase c launches by route: {c_routes}; the GEMM's chunk-sum "
          f"kernel (calls that split K): {c_sums}")
    unreadable = check_scalar_route(mm, gemms, "phase c")
    print(f"phase c: {unreadable} GEMMs on the scalar route, none that a "
          f"vector route could read")

    by_path = {"c": c_launches}
    for phase, spec in LM_PHASES.items():
        t0 = time.perf_counter()
        by_path[phase] = phase_lm(torch, dev, smi[0], counted, spec)
        print(f"phase {phase} LM serving ({spec['arch']}): "
              f"{time.perf_counter() - t0:.2f} s, launches "
              f"{by_path[phase]}")
    t0 = time.perf_counter()
    by_path["h"] = phase_fleet(torch, dev, smi[0], counted)
    print(f"phase h fleet: {time.perf_counter() - t0:.2f} s, launches "
          f"{by_path['h']}")
    t0 = time.perf_counter()
    by_path["i"], bwd, bwd_rows = phase_train(torch, dev, smi[0], counted,
                                              sweep)
    print(f"phase i training ({TRAIN_ARCH}): {time.perf_counter() - t0:.2f}"
          f" s, forward launches {by_path['i']}, backward launches {bwd}")
    t0 = time.perf_counter()
    fam_runs, fam_rows = phase_families(torch, dev, smi[0], counted, sweep)
    for arch, run in fam_runs.items():
        by_path[f"j {arch}"] = run[1]
    print(f"phase j training the other families: "
          f"{time.perf_counter() - t0:.2f} s, batches "
          f"{ {a: r[0] for a, r in fam_runs.items()} }, forward launches "
          f"{ {a: r[1] for a, r in fam_runs.items()} }, backward launches "
          f"{ {a: r[2] for a, r in fam_runs.items()} }")
    # each kernel's launches come from the serving path it lies on: K1 and
    # K2 from phase c (the tiled runtime), K3 from phase d (qwen3-8b), K4
    # from phase e (rwkv6-3b), K5 from phase f (recurrentgemma-2b), K6
    # from phase g (olmoe-1b-7b)
    home = {"flash_attention": "d", "wkv6": "e", "rglru": "f",
            "grouped_matmul": "g"}
    for k in kernels:
        k["launches"] = by_path[home.get(k["name"], "c")][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
        if k["launches"] == 0:
            raise RuntimeError(f"{k['name']} never launched on its path")
        if k["name"] == "matmul":
            k["sum_launches"] = c_sums
    # the backward kernels, launched by phase i's training steps
    for name, fwd_name in (("rmsnorm_bwd", "rmsnorm"),
                           ("flash_attention_bwd", "flash_attention")):
        r = bwd_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": next(k["replaces"] for k in kernels
                             if k["name"] == fwd_name),
            "launches": bwd[fwd_name],
            "launches_by_path": {"i": bwd[fwd_name], **{
                f"j {a}": r[2][fwd_name] for a, r in fam_runs.items()}},
            "shape": f"{r['case']} {r['dtype']}",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"kernel_route": r["route"], "library": r["library"],
                "launches_by_route": bwd[f"{fwd_name}_routes"]}
               if f"{fwd_name}_routes" in bwd else {})})
        if bwd[fwd_name] == 0:
            raise RuntimeError(f"{name} never launched on its path")

    # the backward kernels of K4, K5 and K6, launched by phase j's training
    # steps of the family each serves
    for name, fwd_name, arch, source in (
            ("wkv6_bwd", "wkv6", "rwkv6-3b", "wkv6_bwd.cu"),
            ("rglru_bwd", "rglru", "recurrentgemma-2b", "rglru_scan_bwd.cu"),
            ("grouped_matmul_bwd", "grouped_matmul", "granite-moe-3b-a800m",
             "grouped_matmul.cu")):
        r = fam_rows[name]
        launches = fam_runs[arch][2][fwd_name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": next(k["replaces"] for k in kernels
                             if k["name"] == fwd_name),
            "launches": launches,
            "launches_by_path": {f"j {arch}": launches},
            "shape": f"{r['case']} {r['dtype']}",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "design": BWD_DESIGN[name],
            **({"kernel_route": r["route"], "library": "torch.bmm",
                "launches_by_route": fam_runs[arch][3][fwd_name]}
               if "route" in r else {})})
        if launches == 0:
            raise RuntimeError(f"{name} never launched on its path")

    print(smi[0])
    print(json.dumps({"kernel_sweep": sweep}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def ptxas_lines(log: str):
    """``nvcc -Xptxas -v``'s registers, shared memory and spills, one line
    per kernel instance, and any warning."""
    kernel, spills = "?", ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        elif "spill" in line:
            spills = line
        elif "registers" in line:
            yield f"{kernel}: {line.split(': ', 1)[-1]}; {spills}"
        elif "warning" in line.lower():
            yield line


def _kernel_name(line: str) -> str:
    """``name<template arguments>`` of the mangled kernel in a ptxas line:
    the length-prefixed name that ends in ``_kernel`` (a digit run may
    hold a namespace's last digit before the name's length)."""
    import re
    for run in re.finditer(r"\d+", line):
        for at in range(run.start(), run.end()):
            n = int(line[at:run.end()])
            name = line[run.end():run.end() + n]
            rest = re.match(r"I(\w*?)EEv", line[run.end() + n:])
            if name.endswith("_kernel") and name.isidentifier() and rest:
                return f"{name}<{rest.group(1)}>"
    return line


# ---------------------------------------------------------------- timing


def reset_launches(counted) -> None:
    """Set every kernel wrapper's launch count (and route counts, the
    backward kernels' counts by route and the GEMM's chunk-sum count) to
    0."""
    for mod in counted.values():
        mod.launches = 0
        if hasattr(mod, "bwd_launches"):
            mod.bwd_launches = 0
        for route in getattr(mod, "routes", {}):
            mod.routes[route] = 0
        for route in getattr(mod, "bwd_routes", {}):
            mod.bwd_routes[route] = 0
    counted["matmul"].sum_launches = 0


def read_launches(counted) -> dict:
    return {name: mod.launches for name, mod in counted.items()}


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- phase a


# B, S, H, KV, Dh, causal, window, dtype, what: tests/test_kernels.py's
# sweep, then the LM serving shapes
ATTN_ROWS = [
    (2, 256, 4, 2, 64, True, None, "float32", "sweep"),
    (1, 128, 8, 8, 32, True, 64, "float32", "sweep"),
    (2, 128, 4, 1, 64, False, None, "float32", "sweep"),
    (1, 256, 6, 2, 128, True, 96, "float32", "sweep"),
    (1, 128, 4, 2, 64, True, None, "bfloat16", "sweep"),
    (1, 512, 2, 2, 64, True, 128, "float32", "sweep"),
    (1, 77, 32, 8, 128, True, None, "bfloat16", "qwen3-8b"),
    (1, 1000, 32, 8, 128, True, None, "bfloat16", "qwen3-8b"),
    (1, 1000, 32, 8, 128, True, None, "float32", "qwen3-8b"),
    (2, 128, 32, 8, 128, True, None, "bfloat16", "qwen3-8b"),
    (1, 2048, 16, 8, 256, True, 1024, "bfloat16", "gemma3-12b local"),
    (1, 500, 16, 16, 80, False, None, "bfloat16", "hubert-xlarge"),
    (1, 4096, 10, 1, 256, True, 2048, "bfloat16", "recurrentgemma-2b local"),
    (1, 4096, 16, 16, 128, True, None, "bfloat16", "olmoe-1b-7b"),
]
# the wgmma route's kernel instances (Dh 64, 128, 256), each held once:
# two ragged sequences (333 = 2 query tiles + 77 rows, 5 keys past the
# last 64- and 128-key tile), GQA 10, a causal window of 100
FA_INSTANCES = [(2, 333, 20, 2, dh, True, 100) for dh in (64, 128, 256)]
# the row whose numbers stand for K3 in the kernels line
ATTN_MAIN = (1, 1000, 32, 8, 128, True, None, "bfloat16", "qwen3-8b")
# B, T, H, D, dtype, what: rwkv6-3b's serving shapes, then
# tests/test_kernels.py's sweep
WKV_ROWS = [
    (1, 1000, 40, 64, "bfloat16", "rwkv6-3b"),
    (1, 4096, 40, 64, "bfloat16", "rwkv6-3b"),
    (1, 1000, 40, 64, "float32", "rwkv6-3b"),
    (1, 77, 40, 64, "bfloat16", "rwkv6-3b"),
    (2, 128, 40, 64, "bfloat16", "rwkv6-3b"),
    (2, 128, 2, 32, "float32", "sweep"),
    (1, 64, 4, 16, "float32", "sweep"),
    (1, 96, 1, 64, "float32", "sweep"),
]
WKV_MAIN = WKV_ROWS[0]
# B, T, D, dtype, what: recurrentgemma-2b's serving shapes, then the sweep
RGLRU_ROWS = [
    (1, 1000, 2560, "bfloat16", "recurrentgemma-2b"),
    (1, 4096, 2560, "bfloat16", "recurrentgemma-2b"),
    (1, 1000, 2560, "float32", "recurrentgemma-2b"),
    (1, 77, 2560, "bfloat16", "recurrentgemma-2b"),
    (2, 256, 384, "float32", "sweep"),
    (1, 128, 64, "float32", "sweep"),
    (3, 64, 96, "float32", "sweep"),
]
RGLRU_MAIN = RGLRU_ROWS[0]
# rows at or past this many steps hold the kernel to the plain version
# once but leave the plain version untimed (wkv6_ref takes ~1 s there)
PLAIN_UNTIMED_T = 4096
# E, C, D, F, dtype, what, x's layout: olmoe-1b-7b's gate/up and down
# GEMMs at every row count its bf16 serving run gives them (phase g
# checks that it gives no other): a 1000-token prefill (C = 160), decode
# (C = 8), 77 tokens or two decoding sequences (C = 16), 256 tokens or
# two 128-token prompts (48 rows) and a 4096-token prefill (C = 648,
# three 216-row tiles on the wgmma route); C = 17, granite-moe-3b-a800m
# at 1000 tokens, then ragged C, D, F; last, bf16 rows that take the
# SIMT route: x a transposed view, and widths that are no multiple of 8
GMM_ROWS = [
    (64, 160, 2048, 1024, "bfloat16", "olmoe-1b-7b S1000 gate", "contiguous"),
    (64, 160, 1024, 2048, "bfloat16", "olmoe-1b-7b S1000 down", "contiguous"),
    (64, 160, 2048, 1024, "float32", "olmoe-1b-7b S1000 gate", "contiguous"),
    (64, 8, 2048, 1024, "bfloat16", "olmoe-1b-7b decode gate", "contiguous"),
    (64, 8, 1024, 2048, "bfloat16", "olmoe-1b-7b decode down", "contiguous"),
    # C = 16 (S 77) and C = 17: on the wgmma route N = 16 and N = 24 rows;
    # on the SIMT route the 16-row and the 64-row tile
    (64, 16, 2048, 1024, "bfloat16", "olmoe-1b-7b S77 gate", "contiguous"),
    (64, 16, 1024, 2048, "bfloat16", "olmoe-1b-7b S77 down", "contiguous"),
    (64, 17, 2048, 1024, "bfloat16", "C 17", "contiguous"),
    (64, 48, 2048, 1024, "bfloat16", "olmoe-1b-7b S256 gate", "contiguous"),
    (64, 48, 1024, 2048, "bfloat16", "olmoe-1b-7b S256 down", "contiguous"),
    (64, 648, 2048, 1024, "bfloat16", "olmoe-1b-7b S4096 gate", "contiguous"),
    (64, 648, 1024, 2048, "bfloat16", "olmoe-1b-7b S4096 down", "contiguous"),
    (40, 256, 1536, 512, "bfloat16", "granite-moe-3b-a800m S1000 gate",
     "contiguous"),
    (40, 104, 1000, 200, "bfloat16", "ragged", "contiguous"),
    (64, 160, 2048, 1024, "bfloat16", "olmoe-1b-7b S1000 gate", "transposed"),
    (40, 17, 100, 7, "bfloat16", "odd widths", "contiguous"),
]
# the wgmma route's kernel instances, one per tile height N = 8, 16, ...,
# 256, each held once against the plain version at C = N: D 1088 is 17
# stages, more than twice round the deepest ring (8), and F 192 gives one
# full 128-column block and one whose second warpgroup lies past F
GMM_INSTANCES = [(2, n, 1088, 192) for n in range(8, 257, 8)]
GMM_MAIN = GMM_ROWS[0]


def simt_attention(torch, q, k, v, causal, win):
    """The SIMT flash-attention kernel on bf16 operands that route() sends
    to the wgmma kernel: the design before the tensor-core one, for a time
    beside it.  Its C entry is called as the wrapper calls it, with no
    launch counted."""
    import ctypes
    from repro_torch.kernels import _build
    B, S, H, Dh = q.shape
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    rc = _build.library().repro_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], Dh, strides, int(causal),
        -1 if win is None else min(win, S),
        1.0 / math.sqrt(Dh), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention (simt, timed beside wgmma)")
    return out


def k1k2_rows(torch, dev, gen, mm, rms, record, entries, flush):
    """Phase a's GEMM (K1) and RMSNorm (K2) rows (launch/time_k1k2.py's),
    each on the route its wrapper names, held to its plain version and
    timed beside the library call, by the spin method and without it, and
    with the wrapper's host time per call."""
    from repro_torch.launch.time_k1k2 import (cases, functions, time_ms,
                                              host_us_per_call, warm_up)
    warm_up(torch, dev)
    mods = {"matmul": mm, "rmsnorm": rms}
    for kernel, case, args, tol, flops, nbytes in cases(torch, dev, gen):
        mod = mods[kernel]
        fn, plain, library = functions(torch, kernel)
        route = mod.route(*args)
        before = dict(mod.routes)
        got = fn(*args)
        if mod.routes != {**before, route: before[route] + 1}:
            raise AssertionError(f"{kernel} {case}: not one launch on the "
                                 f"{route} route")
        row = record(kernel, case, args[0].dtype, got, plain(*args), tol,
                     {"ms": lambda: fn(*args),
                      "plain_ms": lambda: plain(*args),
                      "library_ms": lambda: library(*args)},
                     flops, nbytes)
        row["route"] = route
        row["cold_ms"] = time_ms(torch, lambda: fn(*args), flush, spin=False)
        row["host_us"] = host_us_per_call(torch, lambda: fn(*args))
        if (row["dtype"], case) in (("fp32", "64x2560x1280 strided B"),
                                    ("fp32", "phase c 64x2560")):
            entries[kernel] = row


def phase_kernels(torch, dev, mm, rms, fa, wkv, scan, gm):
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                       attention_ref)
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    from repro_torch.kernels.rwkv_scan.ref import wkv6_ref
    from repro_torch.launch.time_k1k2 import (FLUSH_BYTES, host_us_per_call,
                                              time_ms)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    peaks = {torch.float32: FP32_FLOPS, torch.bfloat16: BF16_FLOPS}
    names = {torch.float32: "fp32", torch.bfloat16: "bf16"}
    sweep, entries = [], {}

    def record(kernel, case, dtype, got, want, tol, fns, flops, nbytes):
        """``got``/``want`` are a tensor each, or tuples of tensors with
        a tolerance each in ``tol``."""
        if isinstance(got, torch.Tensor):
            got, want, tol = (got,), (want,), (tol,)
        err = 0.0
        for g, w, (atol, rtol) in zip(got, want, tol):
            diff = (g.float() - w.float()).abs()
            e = diff.max().item() if diff.numel() else 0.0
            err = max(err, e)
            if not bool((diff <= atol + rtol * w.float().abs()).all()):
                raise AssertionError(f"{kernel} {case} {names[dtype]}: max "
                                     f"abs err {e} beyond atol {atol} "
                                     f"rtol {rtol}")
        ms = {k: (time_ms(torch, f, flush) if f is not None else None)
              for k, f in fns.items()}
        b_ms, b_by = bound(flops, nbytes, peaks[dtype])
        row = {"kernel": kernel, "case": case, "dtype": names[dtype],
               "max_abs_err": err, **ms, "bound_ms": b_ms, "bound_by": b_by}
        sweep.append(row)
        return row

    k1k2_rows(torch, dev, gen, mm, rms, record, entries, flush)

    # K3: each row's bound counts the (query, key) pairs its masks allow
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for case in ATTN_ROWS:
        B, S, H, KV, Dh, causal, win, dt, what = case
        dtype = dtypes[dt]
        q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(dtype)
        pos = torch.arange(S, device=dev)
        allowed = attention_mask(pos, pos, causal, win)
        pairs = int(allowed.sum().item())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if win is None:
            def lib():
                return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            def lib():
                return sdpa(qt, kt, vt, attn_mask=allowed, enable_gqa=True)
        tol = 5e-5 if dtype == torch.float32 else 2e-2
        label = (f"{what} B{B} S{S} H{H}/{KV} Dh{Dh} "
                 f"{'causal' if causal else 'bidirectional'}"
                 f"{'' if win is None else f' window {win}'}")
        route = fa.route(q, k, v)
        before = fa.routes[route]
        row = record(
            "flash_attention", label, dtype,
            fa.flash_attention(q, k, v, causal=causal, window=win),
            attention_ref(q, k, v, causal=causal, window=win), (tol, tol),
            {"ms": lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=win),
             "plain_ms": lambda: attention_ref(q, k, v, causal=causal,
                                               window=win),
             "library_ms": lib},
            4.0 * B * H * Dh * pairs,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size())
        if fa.routes[route] == before:
            raise AssertionError(f"flash_attention {label}: no launch on "
                                 f"the {route} route")
        row["route"] = route
        if route == "wgmma":
            row["simt_ms"] = time_ms(torch, lambda: simt_attention(
                torch, q, k, v, causal, win), flush)
        if case == ATTN_MAIN:
            entries["flash_attention"] = row
    err = 0.0
    for B, S, H, KV, Dh, causal, win in FA_INSTANCES:
        q = torch.randn(B, S, H, Dh, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).bfloat16()
        before = fa.routes["wgmma"]
        got = fa.flash_attention(q, k, v, causal=causal, window=win)
        want = attention_ref(q, k, v, causal=causal, window=win)
        diff = (got.float() - want.float()).abs()
        err = max(err, diff.max().item())
        if fa.routes["wgmma"] != before + 1 or not bool(
                (diff <= 2e-2 + 2e-2 * want.float().abs()).all()):
            raise AssertionError(f"flash_attention wgmma instance Dh {Dh} "
                                 f"B{B} S{S} H{H}/{KV} window {win}: route "
                                 f"{fa.route(q, k, v)}, max abs err "
                                 f"{diff.max().item()}")
    print(f"flash_attention wgmma instances: Dh 64, 128, 256 at B2 S333 "
          f"H20/2 causal window 100 bf16 held to the plain version, max abs "
          f"err {err}")

    # K4: y and S against the plain recurrence.  No single PyTorch call
    # computes WKV6, so there is no library time.  The least work is
    # 5 D^2 operations per (b, t, h): r.S (2 D^2) and S <- w S + k v
    # (3 D^2); the bytes are r/k/v/w and u read, y and S written once.
    # Beside the bound, the fp32 pipe's floor: the kernel computes in fp32
    # whatever the inputs' type, three instructions per state element a
    # step (acc += r S, k v, S <- w S + k v) at one per lane a cycle.

    def wkv_inputs(B, T, H, D, dtype):
        r, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(B, T, H, D, generator=gen,
                                             device=dev) * 0.5)).to(dtype)
        u = (torch.randn(H, D, generator=gen, device=dev) * 0.5).to(dtype)
        return r, k, v, w, u

    def wkv_tol(dtype):
        y_tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
        return y_tol, (1e-3, 1e-3)

    for case in WKV_ROWS:
        B, T, H, D, dt, what = case
        dtype = dtypes[dt]
        r, k, v, w, u = wkv_inputs(B, T, H, D, dtype)
        row = record(
            "wkv6", f"{what} B{B} T{T} H{H} D{D}", dtype,
            wkv.wkv6(r, k, v, w, u), wkv6_ref(r, k, v, w, u), wkv_tol(dtype),
            {"ms": lambda: wkv.wkv6(r, k, v, w, u),
             "plain_ms": (lambda: wkv6_ref(r, k, v, w, u))
             if T < PLAIN_UNTIMED_T else None,
             "library_ms": None},
            5.0 * B * T * H * D * D,
            5 * r.numel() * r.element_size() + 4 * H * D + 4 * B * H * D * D)
        row["library"] = "none: no PyTorch call computes WKV6"
        row["fp32_floor_ms"] = 3.0 * B * T * H * D * D * 2 / FP32_FLOPS * 1e3
        # the grid the wrapper gave the C side, which launches it as given
        (gx, gy, gz), threads = wkv.grid(r.shape, dtype)
        row["grid"] = {"columns_per_block": wkv.plan(r.shape, dtype),
                       "blocks": gx * gy * gz, "threads": threads}
        if case == WKV_MAIN:
            entries["wkv6"] = row
    # every compiled instance (head width, its columns per block) in both
    # dtypes, held once over two chunks and a ragged tail
    err = 0.0
    for (D, cb), dtype in itertools.product(wkv.COLUMN_BLOCK.items(),
                                            (torch.float32, torch.bfloat16)):
        args = wkv_inputs(2, 2 * wkv.chunk(D) + 5, 3, D, dtype)
        got = wkv._launch(*args[:4], args[4].float().contiguous())
        for g, w_, (atol, rtol) in zip(got, wkv6_ref(*args), wkv_tol(dtype)):
            diff = (g.float() - w_.float()).abs()
            err = max(err, diff.max().item())
            if not bool((diff <= atol + rtol * w_.float().abs()).all()):
                raise AssertionError(f"wkv6 instance D {D} columns {cb} "
                                     f"{names[dtype]}: max abs err "
                                     f"{diff.max().item()}")
    print(f"wkv6 instances: every (D: columns per block) of "
          f"{wkv.COLUMN_BLOCK} in fp32 and bf16 held to the plain version, "
          f"max abs err {err}")

    # K5: h and h_T against the plain scan (the kernel rounds as the plain
    # version does: fp32 agrees to rounding, bf16 h to one bf16 rounding)
    def rglru_inputs(B, T, D, dtype):
        a = (torch.sigmoid(torch.randn(B, T, D, generator=gen, device=dev))
             * 0.98).to(dtype)
        b = (torch.randn(B, T, D, generator=gen, device=dev) * 0.3).to(dtype)
        return a, b

    def rglru_tol(dtype):
        h_tol = (1e-6, 1e-6) if dtype == torch.float32 else (1e-2, 1e-2)
        return h_tol, (1e-6, 1e-6)

    for case in RGLRU_ROWS:
        B, T, D, dt, what = case
        dtype = dtypes[dt]
        a, b = rglru_inputs(B, T, D, dtype)
        row = record(
            "rglru", f"{what} B{B} T{T} D{D}", dtype, scan.rglru(a, b),
            rglru_ref(a, b), rglru_tol(dtype),
            {"ms": lambda: scan.rglru(a, b),
             "plain_ms": (lambda: rglru_ref(a, b))
             if T < PLAIN_UNTIMED_T else None,
             "library_ms": None},
            2.0 * B * T * D,
            3 * a.numel() * a.element_size() + 4 * B * D)
        row["library"] = "none: no PyTorch call computes the linear scan"
        # a multiply and an add a step, rounded apart (no fused FMA)
        row["fp32_floor_ms"] = 2.0 * B * T * D * 2 / FP32_FLOPS * 1e3
        (gx, gy), threads = scan.grid(a.shape, dtype)
        row["grid"] = {"channels_per_block": scan.STRIP,
                       "blocks": gx * gy, "threads": threads}
        if case == RGLRU_MAIN:
            entries["rglru"] = row
    # the compiled instance in both dtypes, held once over two chunks and
    # a ragged tail, at a D whose last strip is part-filled
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        a, b = rglru_inputs(2, 2 * scan.chunk(dtype) + 5, 2568, dtype)
        got, want = scan._launch(a, b), rglru_ref(a, b)
        for g, w_, (atol, rtol) in zip(got, want, rglru_tol(dtype)):
            diff = (g.float() - w_.float()).abs()
            err = max(err, diff.max().item())
            if not bool((diff <= atol + rtol * w_.float().abs()).all()):
                raise AssertionError(
                    f"rglru strip {scan.STRIP} {names[dtype]}: max abs "
                    f"err {diff.max().item()}")
    print(f"rglru instance: strips of {scan.STRIP} channels in fp32 and "
          f"bf16 held to the plain version, max abs err {err}")

    # K6: the MoE layer's per-expert GEMMs; the library call is torch.bmm
    # on the same operands (cuBLAS, tensor cores in bf16).  Each row names
    # the route its call took.
    for case in GMM_ROWS:
        E, C, D, F, dt, what, layout = case
        dtype = dtypes[dt]
        if layout == "transposed":
            x = torch.randn(E, D, C, generator=gen, device=dev).to(dtype)
            x = x.transpose(1, 2)
        else:
            x = torch.randn(E, C, D, generator=gen, device=dev).to(dtype)
        w = torch.randn(E, D, F, generator=gen, device=dev).to(dtype)
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        route = gm.route(x, w)
        before = gm.routes[route]
        row = record(
            "grouped_matmul", f"{what} ({E},{C},{D})x({E},{D},{F})"
            f"{'' if layout == 'contiguous' else ', x ' + layout}", dtype,
            gm.grouped_matmul(x, w), grouped_matmul_ref(x, w),
            (tol * math.sqrt(D), tol),
            {"ms": lambda: gm.grouped_matmul(x, w),
             "plain_ms": lambda: grouped_matmul_ref(x, w),
             "library_ms": lambda: torch.bmm(x, w)},
            2.0 * E * C * D * F,
            (E * C * D + E * D * F + E * C * F) * x.element_size())
        if gm.routes[route] == before:
            raise AssertionError(f"grouped_matmul {row['case']}: no launch "
                                 f"on the {route} route")
        row["route"] = route
        if case == GMM_MAIN:
            entries["grouped_matmul"] = row
    err = 0.0
    for E, C, D, F in GMM_INSTANCES:
        x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
        w = torch.randn(E, D, F, generator=gen, device=dev).bfloat16()
        before = gm.routes["wgmma"]
        got, want = gm.grouped_matmul(x, w), grouped_matmul_ref(x, w)
        diff = (got.float() - want.float()).abs()
        err = max(err, diff.max().item())
        if gm.routes["wgmma"] != before + 1 or not bool(
                (diff <= 5e-2 * math.sqrt(D)
                 + 5e-2 * want.float().abs()).all()):
            raise AssertionError(f"grouped_matmul wgmma instance N {C} "
                                 f"({E},{C},{D})x({E},{D},{F}): route "
                                 f"{gm.route(x, w)}, max abs err "
                                 f"{diff.max().item()}")
    print(f"grouped_matmul wgmma instances: {len(GMM_INSTANCES)} tile "
          f"heights N 8..256 at (2,N,1088)x(2,1088,192) bf16 held to the "
          f"plain version, max abs err {err}")
    # the wrapper's host time per call (enqueue only, no synchronise) at
    # the decode shape, on each route: a decode step makes 48 such calls
    E, C, D, F = 64, 8, 2048, 1024
    w = torch.randn(E, D, F, generator=gen, device=dev).bfloat16()
    host_us = {}
    for route, x in (
            ("wgmma", torch.randn(E, C, D, generator=gen,
                                  device=dev).bfloat16()),
            ("simt", torch.randn(E, D, C, generator=gen,
                                 device=dev).bfloat16().transpose(1, 2))):
        if gm.route(x, w) != route:
            raise AssertionError(f"host-time operands take {gm.route(x, w)}"
                                 f", not {route}")
        host_us[route] = host_us_per_call(torch,
                                          lambda: gm.grouped_matmul(x, w))
    print(f"grouped_matmul host time per call, decode ({E},{C},{D})x({E},"
          f"{D},{F}) bf16, no synchronise: wgmma {host_us['wgmma']:.2f} us, "
          f"simt {host_us['simt']:.2f} us")
    entries["grouped_matmul"]["host_us_per_call"] = host_us
    del flush
    torch.cuda.empty_cache()

    meta = {
        "matmul": ("src/repro_torch/csrc/matmul.cu",
                   "src/repro/kernels/matmul/matmul.py:38"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:20"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:78"),
        "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv_scan/rwkv_scan.py:77"),
        "rglru": ("src/repro_torch/csrc/rglru_scan.cu",
                  "src/repro/kernels/rglru_scan/rglru_scan.py:50"),
        "grouped_matmul": (
            "src/repro_torch/csrc/grouped_matmul.cu",
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:36"),
    }
    # "ms" and "kernel_ms" are the same measurement under the two names
    # that readers of this line look for
    kernels = []
    for name, (source, replaces) in meta.items():
        r = entries[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "shape": f"{r['case']} {r['dtype']}",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"library": r["library"]} if "library" in r else {}),
            **({"dispatch": r["route"]} if "route" in r else {}),
            **({"simt_ms": r["simt_ms"]} if "simt_ms" in r else {}),
            **({"host_us_per_call": r["host_us_per_call"]}
               if "host_us_per_call" in r else {}),
            **({"cold_ms": r["cold_ms"], "host_us_per_call": r["host_us"]}
               if "cold_ms" in r else {})})
    return sweep, kernels


# ---------------------------------------------------------------- phase b


def _to(arrays, device):
    return {k: v.to(device) for k, v in arrays.items()}


def _assert_close(torch, got, want, what):
    for t, w in want.items():
        g = got[t].detach().cpu()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {t}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)} or non-finite values")
        if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
            err = (g - w).abs().max().item()
            raise AssertionError(f"{what} {t}: max abs err {err} beyond "
                                 f"1e-4")


def phase_plans(torch, dev):
    from repro_torch.core import runtime as rt
    from repro_torch.core.api import compile_model, compile_multi
    from repro_torch.models import edge
    from repro_torch.soc.carfield import carfield_patterns, carfield_soc
    soc, pats = carfield_soc(), carfield_patterns()
    for name in ("autoencoder", "resnet", "transformer_block"):
        g = edge.ALL_MODELS[name]()
        cm = compile_model(g, soc, pats, mode="matcha", time_budget_s=1.0)
        params = rt.init_params(g, 0, "cpu")
        inputs = rt.init_inputs(g, 1, "cpu")
        got = rt.execute_plan(cm.plan, _to(inputs, dev), _to(params, dev))
        torch.cuda.synchronize()
        _assert_close(torch, got, rt.execute_graph(g, inputs, params),
                      f"plan {name}")
        print(f"plan {name}: {len(cm.plan.order)} nodes, matches the CPU "
              f"oracle at 1e-4")
    graphs = [edge.autoencoder(), edge.transformer_block()]
    mc = compile_multi(graphs, soc, pats, time_budget_s=0.5,
                       joint_time_budget_s=1.0, lazy_joint_time_budget_s=0.5,
                       incremental_time_budget_s=0.5, max_hint_rounds=1)
    params = [rt.init_params(g, 2 * i, dev) for i, g in enumerate(graphs)]
    inputs = [rt.init_inputs(g, 2 * i + 1, dev) for i, g in enumerate(graphs)]
    multi = rt.execute_multi_plan(mc.plan, inputs, params)
    for i, g in enumerate(graphs):
        single = rt.execute_plan(mc.tenant_plan(i), inputs[i], params[i])
        want = rt.execute_graph(g, _to(inputs[i], "cpu"),
                                _to(params[i], "cpu"))
        for t in g.outputs:
            if not torch.equal(single[t], multi[i][t]):
                raise AssertionError(f"multi-tenant {g.name} {t} is not "
                                     f"bitwise equal to the single plan")
        _assert_close(torch, multi[i], want, f"multi-tenant {g.name}")
    torch.cuda.synchronize()
    print("multi-tenant autoencoder+transformer_block: bitwise equal to "
          "per-tenant plans")


# ---------------------------------------------------------------- phase c


def vector_readable(t) -> bool:
    """Rows that 16-byte loads can read: unit innermost stride, the other
    strides (of dims longer than 1) and the base in 16-byte units."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0
        for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


@contextlib.contextmanager
def gemm_operands():
    """Count the runtime's GEMM calls on the card, by (M, A vector
    readable, B vector readable), while the block runs."""
    from repro_torch.core import runtime as rt
    gemms = {}
    gemm = rt._matmul

    def recorded(a, b):
        if a.is_cuda:                   # not the CPU oracle's GEMMs
            key = (a.numel() // a.shape[-1] if b.dim() == 2 else a.shape[-2],
                   vector_readable(a), vector_readable(b))
            gemms[key] = gemms.get(key, 0) + 1
        return gemm(a, b)
    rt._matmul = recorded
    try:
        yield gemms
    finally:
        rt._matmul = gemm


def check_scalar_route(mm, gemms, what) -> int:
    """A GEMM takes the scalar route only where no vector route can read
    its operands (B 16-byte readable, and A too unless M <= 8 puts it on
    gemv); ``gemms`` are the calls counted by :func:`gemm_operands` since
    the launch counts were reset.  Returns the GEMMs that need it."""
    unreadable = sum(n for (m, a_ok, b_ok), n in gemms.items()
                     if not (b_ok and (a_ok or m <= mm.GEMV_MAX_M)))
    if sum(gemms.values()) != mm.launches \
            or mm.routes["scalar"] != unreadable:
        raise AssertionError(f"{what}: {mm.routes['scalar']} GEMMs on the "
                             f"scalar route, {unreadable} of "
                             f"{sum(gemms.values())} need it")
    return unreadable


def phase_serve(torch, dev, d: int = 2560, ffn: int = 8960):
    """The rwkv6 tenant at the widths of configs/rwkv6_3b.py beside the
    vision tenant, one layer deep, random weights from seeds.  Returns the
    requests served and the runtime's GEMM calls counted by (M, A vector
    readable, B vector readable)."""
    with gemm_operands() as gemms:
        served = _serve(torch, dev, d, ffn)
    return served, gemms


def _serve(torch, dev, d, ffn) -> int:
    from repro_torch.core import runtime as rt
    from repro_torch.launch.serve import build_engine
    t0 = time.perf_counter()
    eng, compiler = build_engine("rwkv6", max_seq=64, d=d, ffn=ffn,
                                 execute=True, device=str(dev))
    print(f"serve: engine compiled in {time.perf_counter() - t0:.2f} s")
    rng = random.Random(0)
    t0 = time.perf_counter()
    for _ in range(2):
        for seq_len in [rng.randint(2, 64)] + [1] * 4:
            eng.submit(1, seq_len=seq_len)      # prefill, then decodes
            eng.submit(0)                       # the vision tenant rides
            compiler.run_pending()
            eng.step()
    eng.run()
    torch.cuda.synchronize()
    compiler.stop()
    print(f"serve: trace drained in {time.perf_counter() - t0:.2f} s")
    rep = eng.report()
    if rep["served"] != len(eng.results) or rep["served"] != 20:
        raise AssertionError(f"served {rep['served']} of 20 requests")
    cpu_params = [_to(p, "cpu") for p in eng.params]
    buckets = set()
    for rid, out in eng.results.items():
        req = eng.done[rid]
        g = (eng.session.bucket_graph(req.tenant, req.bucket)
             if req.bucket is not None else eng.compiled.graphs[req.tenant])
        buckets.add((g.name, req.bucket))
        want = rt.execute_graph(g, _to(req.inputs, "cpu"),
                                cpu_params[req.tenant])
        _assert_close(torch, out, want, f"served rid {rid} ({g.name})")
    print(f"serve: {rep['served']} results match the CPU oracle at 1e-4 "
          f"over {sorted(buckets, key=str)}; rounds {rep['rounds']} "
          f"(co {rep['co_rounds']}, floor {rep['floor_rounds']})")
    return rep["served"]


# ---------------------------------------------------- phases d, e, f, g

LM_DECODE = 8            # greedy tokens decoded after each prefill
# one LM serving phase per family: the config, the prompts (B, S), the
# prompt lengths of the decode-vs-prefill checks, the depth of their
# float32 copy (whole repeating units), RMSNorm launches per forward pass,
# the launches per prefill of the phase's scan/attention kernels and the
# launches per forward pass (prefill or decode step) of the others
LM_PHASES = {
    "d": {"arch": "qwen3-8b",
          "prompts": [(1, 77), (1, 256), (1, 511), (1, 1000), (2, 128)],
          "check_s": (77, 1000), "fp32_layers": 4,
          "norms_per_pass": 36 * 4 + 1,        # ln1, ln2, q/k-norm; ln_f
          "per_prefill": {"flash_attention": 36},
          # launches by route: bf16 serving runs only the tensor-core
          # kernels; q/k-norm (width 128) on K2's warp route
          "routes_per_prefill": {"flash_attention": {"wgmma": 36,
                                                     "simt": 0}},
          "routes_per_pass": {"rmsnorm": {"warp": 36 * 2, "block": 36 * 2 + 1,
                                          "scalar": 0}}},
    "e": {"arch": "rwkv6-3b",
          "prompts": [(1, 77), (1, 256), (1, 1000), (1, 4096), (2, 128)],
          "check_s": (77, 1000), "fp32_layers": 4,
          "norms_per_pass": 32 * 3 + 1,        # ln1, ln_x, ln2; ln_f
          "per_prefill": {"wkv6": 32},
          # the per-head ln_x (width 64) on K2's warp route
          "routes_per_pass": {"rmsnorm": {"warp": 32, "block": 32 * 2 + 1,
                                          "scalar": 0}}},
    "f": {"arch": "recurrentgemma-2b",
          "prompts": [(1, 77), (1, 256), (1, 1000), (1, 4096), (2, 128)],
          "check_s": (77, 2100), "fp32_layers": 6,
          "norms_per_pass": 26 * 2 + 1,        # ln/ln1, ln2; ln_f
          "per_prefill": {"rglru": 18, "flash_attention": 8},
          "routes_per_prefill": {"flash_attention": {"wgmma": 8,
                                                     "simt": 0}},
          "routes_per_pass": {"rmsnorm": {"warp": 0, "block": 26 * 2 + 1,
                                          "scalar": 0}}},
    "g": {"arch": "olmoe-1b-7b",
          "prompts": [(1, 77), (1, 256), (1, 1000), (1, 4096), (2, 128)],
          "check_s": (77, 1000), "fp32_layers": 4,
          "norms_per_pass": 16 * 2 + 1,        # ln1, ln2; ln_f
          "per_prefill": {"flash_attention": 16},
          "per_pass": {"grouped_matmul": 16 * 3},    # gate, up, down
          "routes_per_prefill": {"flash_attention": {"wgmma": 16,
                                                     "simt": 0}},
          "routes_per_pass": {"grouped_matmul": {"wgmma": 16 * 3,
                                                 "simt": 0},
                              "rmsnorm": {"warp": 0, "block": 16 * 2 + 1,
                                          "scalar": 0}}},
}
# decode-vs-prefill tolerance, as the relative L2 error of the logits.
# bf16, full depth: the two paths round activations to bf16 at different
# places (prefill's GEMMs over S + 1 rows, flash attention and the scans'
# inputs cast to bf16 -- the decay w of rwkv6, a and b of the RG-LRU --
# against decode's single-row GEMMs, plain attention and fp32 scan
# inputs), each rounding worth 2^-9 of a value; over 26-36 layers with
# random weights these add to a few 1e-2 at most.  fp32, 4-6 layers, TF32
# off: fp32 rounding (6e-8) over a few thousand-term sums leaves ~1e-6,
# so 1e-3 is loose by design.
LM_TOL = {"bfloat16": 5e-2, "float32": 1e-3}


class _Routing:
    """Within ``with``: records, per MoE layer, the experts that
    ``model._top_k`` picks for the last position; with ``pinned`` (such a
    record) layer n takes ``pinned[n]``'s experts instead, each weighted
    by the probability this run gives it."""

    def __init__(self, model, pinned=None):
        self.model, self.pinned, self.picked = model, pinned, []

    def __enter__(self):
        self.orig = top_k = self.model._top_k

        def wrapped(probs, K):
            vals, idx = top_k(probs, K)
            if self.pinned is not None:
                idx = idx.clone()
                idx[:, -1] = self.pinned[len(self.picked)]
                vals = probs.gather(-1, idx)
            self.picked.append(idx[:, -1].clone())
            return vals, idx
        self.model._top_k = wrapped
        return self

    def __exit__(self, *exc):
        self.model._top_k = self.orig


def _teacher_forced(torch, model, cfg, params, x):
    """``decode_step`` fed x[:, S] after ``prefill(x[:, :S])`` against the
    last logits of ``prefill(x[:, :S + 1])``: relative L2 error, max abs
    error, max |logit|, whether the greedy tokens agree.

    MoE: routing is a discrete choice, so rounding noise between the two
    paths can swap an expert where two router probabilities are (near)
    equal, as bf16 router logits often make them.  The layers where the
    token's experts differ are counted (``flips``); where there are any,
    decode runs again with prefill's experts pinned, and the check holds
    that run (``pinned_rel``): the same arithmetic, without the swap."""
    import contextlib
    S = x.shape[1] - 1
    moe = hasattr(model, "_top_k")

    def routing(pinned=None):
        return (_Routing(model, pinned) if moe else
                contextlib.nullcontext())

    def decode(pinned=None):
        _, cache = model.prefill(cfg, params, x[:, :S], max_seq=S + 1)
        with routing(pinned) as r:
            got, _ = model.decode_step(cfg, params, cache, x[:, S])
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("non-finite logits in the decode check")
        return got, r

    with routing() as want_r:
        want, _ = model.prefill(cfg, params, x, max_seq=S + 1)
    if not bool(torch.isfinite(want).all()):
        raise AssertionError("non-finite logits in the decode check")
    got, got_r = decode()

    def rel(got):
        return ((got - want).float().norm() / want.float().norm()).item()

    d = (got - want).float()
    out = {"rel": rel(got), "err": d.abs().max().item(),
           "scale": want.abs().max().item(),
           "same": bool((got.argmax(-1) == want.argmax(-1)).all())}
    if moe:
        out["flips"] = sum(
            not torch.equal(a.sort(-1).values, b.sort(-1).values)
            for a, b in zip(want_r.picked, got_r.picked))
        if out["flips"]:
            out["pinned_rel"] = rel(decode(want_r.picked)[0])
    return out


def phase_lm(torch, dev, card, counted, spec):
    """Serve ``spec["arch"]`` at full width and depth, then the
    decode-vs-prefill checks; returns each kernel's launches in the
    serving run (``counted``: name -> kernel wrapper module)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.models import stacking
    from repro_torch.models.api import get_model

    cfg = registry.get_config(spec["arch"])
    prompts = spec["prompts"]
    model = get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"lm: {cfg.name} ({cfg.family}, d {cfg.d_model}, {cfg.n_layers} "
          f"layers, {cfg.n_heads}/{cfg.n_kv} heads, Dh {cfg.head_dim_}, "
          f"vocab {cfg.vocab}, {cfg.dtype}): {n_params / 1e9:.3f} B params "
          f"({n_params * 2 / 1e9:.2f} GB) made in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, bs)).to(dev)
               for bs in prompts]

    def serve(x):
        """prefill, then LM_DECODE greedy decode steps: (prefill s,
        decode s per token, tokens)"""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(cfg, params, x,
                                      max_seq=x.shape[1] + LM_DECODE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = []
        for _ in range(LM_DECODE):
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits at {len(toks)}")
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, cache = model.decode_step(cfg, params, cache, tok)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits after decoding")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if cache["pos"].tolist() != [x.shape[1] + LM_DECODE] * x.shape[0]:
            raise AssertionError(f"cache pos {cache['pos'].tolist()}")
        return t1 - t0, (t2 - t1) / LM_DECODE, torch.stack(toks, 1)

    serve(batches[0][:, :16])            # warm-up: cuBLAS and allocator
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counted)
    times = [serve(x) for x in batches]
    launches = read_launches(counted)
    peak = torch.cuda.max_memory_allocated() / 1e9
    passes = len(batches) * (1 + LM_DECODE)
    want = {name: n * len(batches) for name, n in spec["per_prefill"].items()}
    want.update({name: n * passes
                 for name, n in spec.get("per_pass", {}).items()})
    want["rmsnorm"] = spec["norms_per_pass"] * passes
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(
                f"{cfg.name}: {name} launched {launches[name]} times, not "
                f"{n} ({len(batches)} prefills, {LM_DECODE} decode steps "
                f"each)")
    # launches by route, per prefill or per pass
    routed = {name: {r: n * len(batches) for r, n in per.items()}
              for name, per in spec.get("routes_per_prefill", {}).items()}
    routed.update({name: {r: n * passes for r, n in per.items()}
                   for name, per in spec.get("routes_per_pass", {}).items()})
    for name, n_by_route in routed.items():
        got = dict(counted[name].routes)
        if got != n_by_route:
            raise AssertionError(f"{cfg.name}: {name} launches by route "
                                 f"{got}, not {n_by_route}")
        print(f"lm serve {cfg.name}: {name} launches by route {got}")
    if "grouped_matmul" in routed:
        # every grouped-matmul shape this run served is a bf16 row of
        # phase a, held there against the plain version: B sequences of
        # capacity(S) rows each at prefill, of capacity(1) at decode
        held = {(E, C, D, F) for E, C, D, F, dt, _, layout in GMM_ROWS
                if dt == "bfloat16" and layout == "contiguous"}
        served = {(cfg.n_experts, B * model.capacity(cfg, s), d, f)
                  for B, S in prompts for s in (S, 1)
                  for d, f in ((cfg.d_model, cfg.d_ff),
                               (cfg.d_ff, cfg.d_model))}
        if served - held:
            raise AssertionError(f"{cfg.name}: grouped matmul shapes "
                                 f"{sorted(served - held)} served but not "
                                 f"held to the plain version in phase a")
    for (B, S), (pre_s, dec_s, toks) in zip(prompts, times):
        print(f"lm serve {cfg.name} B{B} S{S}: prefill {pre_s * 1e3:.3f} "
              f"ms, decode {dec_s * 1e3:.3f} ms/token ({B * LM_DECODE} "
              f"tokens: {toks[0].tolist()}) [{card}]")
    print(f"lm serve {cfg.name}: peak memory {peak:.3f} GB [{card}]")
    print(json.dumps({"lm_serve": {
        "arch": cfg.name, "card": card, "peak_gb": peak,
        "prefill_ms": {f"B{B} S{S}": t[0] * 1e3
                       for (B, S), t in zip(prompts, times)},
        "decode_ms_per_step": {f"B{B} S{S}": t[1] * 1e3
                               for (B, S), t in zip(prompts, times)},
        "launches": launches}}))

    i = max(range(len(prompts)), key=lambda j: prompts[j][1])
    x = batches[i]
    first, second = (model.prefill(cfg, params, x, max_seq=x.shape[1] + 1)
                     for _ in range(2))
    same = [bool(torch.equal(a, b))
            for a, b in zip(_leaves(first), _leaves(second))]
    if not all(same):
        raise AssertionError(f"{cfg.name}: two prefills of S{x.shape[1]} "
                             f"differ in {same.count(False)} of {len(same)} "
                             f"tensors")
    print(f"lm prefill {cfg.name} B{x.shape[0]} S{x.shape[1]}: two runs "
          f"bitwise equal ({len(same)} tensors: logits and cache)")
    cache = second[1]
    del first, second
    tok = x[:, -1]
    for what, fn, wall in (
            ("prefill", lambda: model.prefill(
                cfg, params, x, max_seq=x.shape[1] + 1), times[i][0]),
            ("decode step", lambda: model.decode_step(
                cfg, params, cache, tok), times[i][1])):
        busy, kernels, top = _device_busy_s(torch, fn)
        share = ("not measured" if kernels == 0 else
                 f"{1 - busy / wall:.3f} (of the unprofiled "
                 f"{wall * 1e3:.3f} ms)")
        print(f"lm profile {cfg.name} {what} B{x.shape[0]} S{x.shape[1]}: "
              f"{kernels} kernels, device busy {busy * 1e3:.3f} ms, "
              f"idle share {share} [{card}]; top kernels (ms) {top}")
    del cache

    # MoE: capacity for every token in both paths, so that prefill of
    # S + 1 tokens drops no assignment that decode keeps (at the default
    # factor the last token is the first to drop); restored below
    factor = getattr(model, "CAPACITY_FACTOR", None)
    if factor is not None:
        model.CAPACITY_FACTOR = cfg.n_experts / cfg.top_k
        print(f"lm decode-vs-prefill {cfg.name}: capacity factor "
              f"{model.CAPACITY_FACTOR} (serving used {factor})")
    results = []
    for S in spec["check_s"]:
        x = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1))).to(dev)
        results.append((cfg.dtype, cfg.n_layers, S,
                        _teacher_forced(torch, model, cfg, params, x)))

    # a float32 copy of the first layers, TF32 off; the bf16 model freed
    torch.backends.cuda.matmul.allow_tf32 = False
    n32 = spec["fp32_layers"]
    cfg32 = dataclasses.replace(cfg, n_layers=n32, dtype="float32")
    p32 = {**{k: v for k, v in params.items() if k not in ("blocks",
                                                          "tail")},
           "tail": [],
           "blocks": [stacking.tree_map(lambda t: t[:n32 // cfg.unit], s)
                      for s in params["blocks"]]}
    p32 = stacking.tree_map(lambda t: t.float(), p32)
    del params
    torch.cuda.empty_cache()
    routes_before = {name: dict(counted[name].routes) for name in routed
                     if "wgmma" in counted[name].routes}
    for S in spec["check_s"]:
        x = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1))).to(dev)
        results.append((cfg32.dtype, cfg32.n_layers, S,
                        _teacher_forced(torch, model, cfg32, p32, x)))
    # the fp32 copy runs every grouped matmul and flash attention on the
    # SIMT route
    for name, before in routes_before.items():
        got = {r: n - before[r] for r, n in counted[name].routes.items()}
        if got["wgmma"] != 0 or got["simt"] == 0:
            raise AssertionError(f"{cfg.name} fp32 check: {name} launches "
                                 f"by route {got}")
        print(f"lm decode-vs-prefill {cfg.name} fp32: {name} launches by "
              f"route {got}")
    if factor is not None:
        model.CAPACITY_FACTOR = factor
    del p32
    torch.cuda.empty_cache()
    failed = []
    for dtype, n_layers, S, r in results:
        held = r.get("pinned_rel", r["rel"])
        ok = held <= LM_TOL[dtype]
        routed = ("" if "flips" not in r else
                  f", the token's experts differ from prefill's in "
                  f"{r['flips']} of {n_layers} layers" + (
                      f" (with prefill's pinned: relative L2 error "
                      f"{r['pinned_rel']:.3e})" if r["flips"] else ""))
        print(f"lm decode-vs-prefill {cfg.name} {dtype} {n_layers} layers "
              f"S{S}: relative L2 error {r['rel']:.3e} (limit "
              f"{LM_TOL[dtype]:.0e}), max abs error {r['err']:.3e} of max "
              f"|logit| {r['scale']:.3f}, greedy token "
              f"{'agrees' if r['same'] else 'differs'}{routed}"
              f"{'' if ok else '  FAILED'}")
        if not ok:
            failed.append((dtype, n_layers, S))
    if failed:
        raise AssertionError(f"{cfg.name} decode-vs-prefill beyond "
                             f"tolerance: {failed}")
    return launches


# ---------------------------------------------------------------- phase h

# examples/fleet.py's fleet: the four MLPerf Tiny classes on four carfield
# SoCs of two tenant slots each, at that script's compile budgets
FLEET_CLASSES = ("autoencoder", "ds_cnn", "mobilenet", "resnet")
FLEET_HIGH = "mobilenet"        # the deadline-carrying class; its SoC fails
FLEET_PER_CLASS = 40            # arrivals of each class (the example: 8 s)


def fleet_trace(contention, Priority):
    """examples/fleet.py's open-loop trace, cut short: each class arrives
    every 3 x its alone time (about 1/3 utilization), from 0.4 of that
    period, FLEET_PER_CLASS times; FLEET_HIGH is HIGH with a deadline of
    2.5 x its alone time.  Returns the rows and the failure instant:
    halfway through FLEET_HIGH's arrivals."""
    deadline_s = 2.5 * contention.alone_s(FLEET_HIGH)
    trace = []
    for c in FLEET_CLASSES:
        period = 3.0 * contention.alone_s(c)
        high = c == FLEET_HIGH
        for k in range(FLEET_PER_CLASS):
            trace.append(((0.4 + k) * period, c,
                          Priority.HIGH if high else Priority.NORMAL,
                          deadline_s if high else None))
    trace.sort(key=lambda row: row[0])
    period = 3.0 * contention.alone_s(FLEET_HIGH)
    return trace, (0.4 + FLEET_PER_CLASS / 2) * period


def phase_fleet(torch, dev, card, counted):
    """(h) The fleet layer on the card: place, route, fail a SoC, migrate.
    Returns each kernel's launches over the trace."""
    from repro_torch.core import runtime as rt
    from repro_torch.fleet import (ContentionModel, FailureEvent, Fleet,
                                   FleetConfig, FleetRebalancer,
                                   FleetRouter, PlanCache,
                                   place_contention_aware,
                                   replay_open_loop)
    from repro_torch.models import edge
    from repro_torch.serve.admission import Priority
    from repro_torch.soc.carfield import carfield_patterns, carfield_soc

    torch.cuda.reset_peak_memory_stats(dev)
    config = FleetConfig(
        soc_factory=lambda: (carfield_soc(), carfield_patterns()),
        n_socs=4, capacity=2, requested_tiles=8,
        time_budget_s=0.5, joint_time_budget_s=1.0,
        lazy_joint_time_budget_s=0.5, incremental_time_budget_s=0.5,
        execute=True, device=str(dev))
    graphs = [edge.ALL_MODELS[m]() for m in FLEET_CLASSES]
    t0 = time.perf_counter()
    cache = PlanCache(config, graphs)
    contention = ContentionModel(cache)
    placement = place_contention_aware(list(FLEET_CLASSES), config.n_socs,
                                       config.capacity, contention)
    compile_s = time.perf_counter() - t0
    print(f"fleet: compile and placement {compile_s:.2f} s "
          f"({cache.stats()['builds']} mixes compiled); alone ms "
          f"{ {c: contention.alone_s(c) * 1e3 for c in FLEET_CLASSES} }")
    print(f"fleet: placement {placement.assignment} (max rho "
          f"{placement.max_rho:.3f})")
    fleet = Fleet(config, graphs, cache=cache, contention=contention)
    fleet.apply_placement(placement)
    router = FleetRouter(fleet, split=placement.demand_split)
    rebalancer = FleetRebalancer(fleet, router)
    trace, t_fail = fleet_trace(contention, Priority)
    victim = fleet.hosts_of(FLEET_HIGH)[0]

    # the migration probe, before the failure: one request's inputs served
    # on the SoC that will fail
    g_high = cache.classes[FLEET_HIGH]
    probe = rt.init_inputs(g_high, 123, dev)
    rid = victim.engine.submit(FLEET_HIGH, inputs=dict(probe))
    victim.engine.run()
    before = victim.engine.results[rid]

    reset_launches(counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with gemm_operands() as gemms:
        summary = replay_open_loop(
            fleet, router, trace, rebalancer=rebalancer,
            failures=[FailureEvent(at_s=t_fail, soc_id=victim.soc_id,
                                   kind="fail")])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counted)
    routes = dict(counted["matmul"].routes)
    unreadable = check_scalar_route(counted["matmul"], gemms, "phase h")
    audit = summary["router"]
    print(f"fleet: {len(trace)} requests ({FLEET_PER_CLASS} of each "
          f"class), SoC {victim.soc_id} (hosting {victim.classes}) failed at "
          f"{t_fail * 1e3:.3f} ms of the analytic clock; served "
          f"{audit['served']} of {audit['submitted']}, dropped "
          f"{audit['dropped']}, requeued {audit['requeued']}; HIGH deadline "
          f"attainment {summary['per_class']['HIGH']['slo_attainment']}")
    print(f"fleet: trace wall {wall:.3f} s, {len(trace) / wall:.1f} "
          f"requests/s [{card}]")
    print(f"fleet: launches {launches}; K1 by route {routes} ({unreadable} "
          f"GEMMs need the scalar route: operands no vector route can "
          f"read), chunk sums {counted['matmul'].sum_launches}")
    records = rebalancer.stats()["records"]
    for m in records:
        print(f"fleet: migration {m['class_name']} soc{m['src_soc']} -> "
              f"soc{m['dst_soc']} (cache hit {m['cache_hit']}, seeded "
              f"{m['seeded_occupancies']}, analyzer errors "
              f"{m['analyzer_errors']}): recovery_s {m['recovery_s']}")
    if (audit["dropped"] or audit["queued"] or audit["rejected"]
            or audit["served"] != audit["submitted"]
            or audit["submitted"] != len(trace)
            or summary["served"] != len(trace) + 1):
        raise AssertionError(f"fleet: served {summary['served']} (with the "
                             f"probe) of {len(trace)} + 1; audit {audit}")
    if launches["matmul"] == 0:
        raise AssertionError("fleet: the GEMM kernel never launched")
    moved = [m for m in records if m["class_name"] == FLEET_HIGH]
    if len(moved) != 1 or any(m["analyzer_errors"] for m in records):
        raise AssertionError(f"fleet: migrations {records}")

    # every served result, the probe's too, against the CPU oracle
    cpu_params = {c: _to(cache.params_for(c), "cpu") for c in FLEET_CLASSES}
    n = 0
    for eng in fleet.engines():
        for rid, out in eng.results.items():
            req = eng.done[rid]
            g = eng.compiled.graphs[req.tenant]
            want = rt.execute_graph(g, _to(req.inputs, "cpu"),
                                    cpu_params[g.name])
            _assert_close(torch, out, want, f"fleet {g.name} rid {rid}")
            n += 1
    print(f"fleet: {n} results match the CPU oracle at 1e-4")

    # the probe again, on the destination after the failure: the same bits,
    # and those of the reference plan of the tiling the destination serves
    dst = fleet.instances[moved[0]["dst_soc"]]
    rid = dst.engine.submit(FLEET_HIGH, inputs=dict(probe))
    dst.engine.run()
    after = dst.engine.results[rid]
    idx = dst.engine.resolve(FLEET_HIGH)
    plan = dst.mc.plan_for([idx])
    ref = dst.mc.session.reference_plan(idx, plan.tenants[0])
    want = rt.execute_plan(ref, probe, cache.params_for(FLEET_HIGH))
    torch.cuda.synchronize()
    for t in g_high.outputs:
        if not (torch.equal(before[t], after[t])
                and torch.equal(after[t], want[t])):
            raise AssertionError(
                f"fleet: {FLEET_HIGH} {t} on soc{victim.soc_id} before the "
                f"failure, on soc{dst.soc_id} after it and by the reference "
                f"plan are not bitwise equal (max abs differences "
                f"{(before[t] - after[t]).abs().max().item()}, "
                f"{(after[t] - want[t]).abs().max().item()})")
    print(f"fleet: {FLEET_HIGH} probe bitwise equal on soc{victim.soc_id} "
          f"before the failure, on soc{dst.soc_id} after it and by the "
          f"reference plan")

    # one request of each class by its compile-alone reference plan: the
    # kernels it runs and the card's busy time
    for c in FLEET_CLASSES:
        plan = cache.mc_for((c,)).tenant_plan(0)
        inputs = rt.init_inputs(cache.classes[c], 7, dev)
        params = cache.params_for(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.execute_plan(plan, inputs, params)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        busy, kernels, top = _device_busy_s(
            torch, lambda: rt.execute_plan(plan, inputs, params))
        share = ("not measured" if kernels == 0 else
                 f"{1 - busy / wall1:.3f}")
        print(f"fleet profile {c}: {len(plan.order)} plan nodes, "
              f"{kernels} kernels, device busy {busy * 1e3:.3f} ms of "
              f"{wall1 * 1e3:.3f} ms, idle share {share} [{card}]; top "
              f"kernels (ms) {top[:6]}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"fleet: peak memory {peak:.3f} GB over {len(fleet.engines())} "
          f"engines, {sum(len(i.retired) for i in fleet.instances)} "
          f"retired [{card}]")
    print(json.dumps({"fleet": {
        "card": card, "compile_s": compile_s,
        "placement": placement.assignment, "requests": len(trace),
        "trace_s": wall, "requests_per_s": len(trace) / wall,
        "recovery_s": [m["recovery_s"] for m in records],
        "requeued": audit["requeued"], "peak_gb": peak,
        "launches": launches, "matmul_routes": routes}}))
    return launches


def _device_busy_s(torch, fn):
    """(seconds the card spent in kernels during one call of ``fn``, the
    number of kernels, the six costliest kernel names with their ms and
    last the ms of RMSNorm's, WKV6's and the RG-LRU scan's kernels), from
    a ``torch.profiler`` trace; busy time is the union of the kernels'
    intervals, so overlapping kernels count once.  The last entries also
    give the backward kernels of K3, K2 (in K2's sum too), K4 and K5, and
    K6's tensor-core kernel, whose forward and backward launches share a
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # RMSNorm's (K2's), WKV6's (K4's) and the RG-LRU scan's (K5's)
    # kernels, whatever their rank
    top += [(label, sum(t for n, t in by_name.items() if key in n))
            for label, key in (("K2 rms_*_kernel", "rms_"),
                               ("K4 wkv6_kernel", "wkv6_kernel"),
                               ("K5 rglru_kernel", "rglru_kernel"),
                               ("K3 backward fa_bwd_*", "fa_bwd_"),
                               ("K2 backward rms_bwd_*", "rms_bwd_"),
                               ("K4 backward wkv6_bwd_*", "wkv6_bwd_"),
                               ("K5 backward rglru_bwd_kernel", "rglru_bwd_"),
                               ("K6 gmm_wgmma_kernel (forward and backward)",
                                "gmm_wgmma_kernel"))]
    return busy * 1e-6, len(events), [(n[:60], t * 1e-3) for n, t in top]


# ---------------------------------------------------------------- phase i

TRAIN_ARCH = "internlm2-1.8b"
TRAIN_B, TRAIN_S = 4, 1024      # one fixed batch of 4 x 1024 tokens
TRAIN_STEPS = 5
TRAIN_SAVE_AFTER = 2            # steps; restored and continued once
CHECK_LAYERS, CHECK_B, CHECK_S = 2, 1, 256   # the fp32 card-vs-CPU step
CHECK_TOL = 1e-3                # relative L2 a gradient leaf, relative loss
# backward rows: (B, S, H, KV, Dh, causal, window, dtype, what): the
# training path's instance first, then the fp32 check's (SIMT route), a
# windowed one, the other tensor-core head widths, a ragged S (no
# multiple of the 64-row tile) and window 0 (every gradient exactly 0);
# each row names the route it took
FA_BWD_ROWS = [
    (4, 1024, 16, 8, 128, True, None, "bfloat16", "internlm2-1.8b"),
    (1, 256, 16, 8, 128, True, None, "float32", "internlm2-1.8b fp32 check"),
    (2, 1024, 16, 8, 128, True, 256, "bfloat16", "window 256"),
    (2, 1024, 16, 8, 64, True, None, "bfloat16", "Dh 64"),
    (1, 1024, 8, 4, 256, True, None, "bfloat16", "Dh 256"),
    (2, 1000, 16, 8, 128, True, None, "bfloat16", "ragged S"),
    (1, 1024, 16, 8, 128, True, 0, "bfloat16", "window 0"),
]
# a backward row's tolerance, relative to the largest |gradient| of each
# output: bf16 rounds each output once (2^-9) and reads the forward's bf16
# output in D = rowsum(dO * O); fp32 sums in other orders
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def backward_rows(torch, dev, rms, fa, sweep):
    """Each backward kernel at every instance the training path launches,
    held to its plain version and timed by phase a's method beside the
    plain version, the library call's backward (never on the path) and
    the bound.  Returns the rows that stand for each in the kernels
    line."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                       attention_mask)
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    from repro_torch.launch.time_k1k2 import FLUSH_BYTES, time_ms
    # the RMSNorm backward's rows (rows, width, dtype, what): ln1, ln2 and
    # ln_f of the training path and of the fp32 check, then the norms of
    # the families still to train on the card (rwkv6-3b's per-head ln_x,
    # qwen3's q-norm width, recurrentgemma-2b), each at 4096 tokens;
    # launch/time_rms_bwd.py times the same rows of any tree
    from repro_torch.launch.time_rms_bwd import ROWS as RMS_BWD_ROWS
    from repro_torch.launch.time_rms_bwd import inputs as rms_bwd_inputs
    from repro_torch.launch.time_rms_bwd import settle
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    peaks = {"float32": FP32_FLOPS, "bfloat16": BF16_FLOPS}
    names = {"float32": "fp32", "bfloat16": "bf16"}
    entries = {}

    def held(kernel, case, dt, got, want):
        err = 0.0
        for g, w in zip(got, want):
            diff = (g.float() - w.float()).abs().max().item()
            err = max(err, diff)
            scale = w.float().abs().max().item()
            if not diff <= BWD_TOL[dt] * scale:
                raise AssertionError(f"{kernel} {case} {names[dt]}: max abs "
                                     f"err {diff} beyond {BWD_TOL[dt]} x "
                                     f"max |want| {scale}")
        return err

    def row(kernel, case, dt, err, fns, flops, nbytes, extra=None):
        # the kernel and the library call in turns (kernel, library,
        # library, kernel), each by time_ms; then the plain version
        runs = {"ms": [], "library_ms": []}
        for key in ("ms", "library_ms", "library_ms", "ms"):
            if fns[key] is not None:
                runs[key].append(time_ms(torch, fns[key], flush))
        ms = {k: sum(v) / len(v) if v else None for k, v in runs.items()}
        ms["plain_ms"] = time_ms(torch, fns["plain_ms"], flush)
        b_ms, b_by = bound(flops, nbytes, peaks[dt])
        r = {"kernel": kernel, "case": case, "dtype": names[dt],
             "max_abs_err": err, **ms, "ms_runs": runs["ms"],
             "library_ms_runs": runs["library_ms"], "bound_ms": b_ms,
             "bound_by": b_by, **(extra or {})}
        sweep.append(r)
        lib = ("none" if ms["library_ms"] is None else
               " then ".join(f"{t:.4f}" for t in runs["library_ms"]))
        print(f"backward {kernel} {case} {names[dt]}"
              f"{' route ' + r['route'] if 'route' in r else ''}: "
              f"{' then '.join(f'{t:.4f}' for t in runs['ms'])} ms "
              f"(plain {ms['plain_ms']:.4f}, library {lib}"
              f"{' ' + r['library'] if 'library' in r else ''}, bound "
              f"{b_ms:.5f} by {b_by}), max abs err {err:.3e}")
        return r

    for rows, d, dt, what in RMS_BWD_ROWS:
        x, g, dy = rms_bwd_inputs(torch, dev, gen, rows, d, dt)
        route = rms.route_bwd(x, g, dy)
        before, by_route = rms.bwd_launches, dict(rms.bwd_routes)
        got = rms.rmsnorm_bwd(x, g, dy)
        launched = {r: rms.bwd_routes[r] - n for r, n in by_route.items()}
        if rms.bwd_launches != before + 2 or launched[route] != 2:
            raise AssertionError(f"rmsnorm backward: launches by route "
                                 f"{launched}, want 2 on {route}")
        err = held("rmsnorm_bwd", what, dt, got, rmsnorm_bwd_ref(x, g, dy))
        settle(torch, lambda: rms.rmsnorm_bwd(x, g, dy))
        xl, gl = (t.clone().requires_grad_(True) for t in (x, g))
        y_lib = F.rms_norm(xl, (d,), gl, 1e-6)
        case = f"{what} {rows}x{d} with g"
        r = row("rmsnorm_bwd", case, dt, err,
                {"ms": lambda: rms.rmsnorm_bwd(x, g, dy),
                 "plain_ms": lambda: rmsnorm_bwd_ref(x, g, dy),
                 "library_ms": lambda: torch.autograd.grad(
                     y_lib, (xl, gl), dy, retain_graph=True)},
                10.0 * rows * d,
                (3 * rows * d + 2 * d) * x.element_size(),
                {"route": route, "library": "F.rms_norm backward"})
        entries.setdefault("rmsnorm_bwd", r)
        del x, g, dy, xl, gl, y_lib, got

    for B, S, H, KV, Dh, causal, win, dt, what in FA_BWD_ROWS:
        dtype = dtypes[dt]
        q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(dtype)
        do = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
        out = fa.flash_attention(q, k, v, causal=causal, window=win)
        route = fa.route_bwd(q, k, v)
        before, by_route = fa.bwd_launches, dict(fa.bwd_routes)
        got = fa.flash_attention_bwd(q, k, v, out, do, causal, win)
        launched = {r: fa.bwd_routes[r] - n for r, n in by_route.items()}
        if fa.bwd_launches != before + 3 or launched[route] != 3:
            raise AssertionError(f"flash_attention backward: launches by "
                                 f"route {launched}, want 3 on {route}")
        err = held("flash_attention_bwd", what, dt, got,
                   attention_bwd_ref(q, k, v, do, causal, win))
        if win == 0 and any(bool(g.any()) for g in got):
            raise AssertionError("flash_attention backward, window 0: a "
                                 "gradient is not exactly 0")
        pos = torch.arange(S, device=dev)
        allowed = attention_mask(pos, pos, causal, win)
        pairs = int(allowed.sum().item())
        library, lib_name = sdpa_backward(torch, q, k, v, do, win, allowed)
        case = (f"{what} B{B} S{S} H{H}/{KV} Dh{Dh} causal"
                f"{'' if win is None else f' window {win}'}")
        r = row("flash_attention_bwd", case, dt, err,
                {"ms": lambda: fa.flash_attention_bwd(q, k, v, out, do,
                                                      causal, win),
                 "plain_ms": lambda: attention_bwd_ref(q, k, v, do, causal,
                                                       win),
                 "library_ms": library},
                # five products of 2 pairs Dh: S, dP, dV, dK, dQ
                5 * 2.0 * B * H * pairs * Dh,
                # q, out, dO read and dq written; k, v read, dk, dv written
                (2 * q.numel() + 2 * out.numel() + 2 * k.numel()
                 + 2 * v.numel()) * q.element_size(),
                {"route": route, "library": lib_name})
        if "flash_attention_bwd" not in entries:
            # the training row: SDPA's backward on each backend, and
            # unpinned, in turns (yardsticks only)
            from torch.nn.attention import SDPBackend
            fns = {}
            for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION, None):
                fn, name = sdpa_backward(torch, q, k, v, do, win, allowed,
                                         [b])
                if fn is not None:
                    fns[name] = fn
            times = {n: [] for n in fns}
            for n in [*fns, *reversed(fns)]:
                times[n].append(time_ms(torch, fns[n], flush))
            print(f"backward SDPA by backend, {case} {names[dt]}: "
                  + "; ".join(f"{n} {' then '.join(f'{t:.4f}' for t in ts)}"
                              f" ms" for n, ts in times.items()))
            r["sdpa_by_backend_ms"] = times
        entries.setdefault("flash_attention_bwd", r)
    del flush
    torch.cuda.empty_cache()
    return entries


def sdpa_backward(torch, q, k, v, do, win, allowed, backends=None):
    """(a call of SDPA's backward on these operands, the backend's name):
    the yardstick, never on the path.  The backend is pinned with
    ``sdpa_kernel``: flash attention for the causal rows (efficient
    attention where flash takes no such operands, fp32), efficient
    attention for the masked ones, or the first of ``backends`` that runs
    (None: unpinned, PyTorch's own choice); GQA by ``enable_gqa``, else k
    and v repeated to H heads.  (None, "none") where none runs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if backends is None:
        backends = ([SDPBackend.FLASH_ATTENTION,
                     SDPBackend.EFFICIENT_ATTENTION] if win is None
                    else [SDPBackend.EFFICIENT_ATTENTION])
    groups = q.shape[2] // k.shape[2]
    do_t = do.transpose(1, 2)
    for backend, gqa in itertools.product(backends, (True, False)):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not gqa:
            kt, vt = (t.repeat_interleave(groups, 1) for t in (kt, vt))
        qt, kt, vt = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        try:
            with (contextlib.nullcontext() if backend is None
                  else sdpa_kernel([backend])):
                o = (F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True, enable_gqa=gqa)
                     if win is None else F.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=allowed, enable_gqa=gqa))
            torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True)
        except RuntimeError:
            continue
        return ((lambda: torch.autograd.grad(o, (qt, kt, vt), do_t,
                                             retain_graph=True)),
                f"SDPA {'unpinned' if backend is None else backend.name}"
                f"{'' if gqa else ' (k, v repeated to H heads)'}")
    return None, "none"


def _relative_l2(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp(min=1e-30)).item()


def train_check(torch, dev, card):
    """internlm2-1.8b at full width (d 2048, vocab 92544), CHECK_LAYERS
    layers, fp32, one batch of CHECK_B x CHECK_S: the loss and every
    gradient of the remat train step's loss through the forward and
    backward kernels on the card, against the same on CPU tensors (the
    plain versions)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.models import stacking, transformer
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_config(TRAIN_ARCH),
                              n_layers=CHECK_LAYERS, dtype="float32")
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    card_p = stacking.tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (CHECK_B, CHECK_S)))
    y = torch.from_numpy(rng.integers(0, cfg.vocab, (CHECK_B, CHECK_S)))
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(cfg, remat=True))
    routes, rms_routes = dict(fa.bwd_routes), dict(rms.bwd_routes)
    (loss_d, _), g_d = grad_fn(card_p, x.to(dev), y.to(dev))
    routes = {r: fa.bwd_routes[r] - n for r, n in routes.items()}
    rms_routes = {r: rms.bwd_routes[r] - n for r, n in rms_routes.items()}
    # ln1, ln2 a layer and ln_f, two launches each, 2048 fp32 wide
    want_rms = 2 * (2 * CHECK_LAYERS + 1)
    if routes != {"wgmma": 0, "simt": 3 * CHECK_LAYERS} or rms_routes != {
            "warp": 0, "block": want_rms, "scalar": 0}:
        raise AssertionError(f"train check: backward launches by route: "
                             f"flash attention {routes}, want all "
                             f"{3 * CHECK_LAYERS} on simt (fp32); RMSNorm "
                             f"{rms_routes}, want all {want_rms} on block")
    t0 = time.perf_counter()
    (loss_c, _), g_c = grad_fn(cpu, x, y)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss_d.item() - loss_c.item()) / abs(loss_c.item())
    rels = [_relative_l2(a.cpu(), b)
            for a, b in zip(leaves(g_d), leaves(g_c))]
    worst = max(range(len(rels)), key=lambda i: rels[i])
    print(f"train check {cfg.name} {CHECK_LAYERS} layers fp32 B{CHECK_B} "
          f"S{CHECK_S}: loss card {loss_d.item():.6f}, CPU "
          f"{loss_c.item():.6f} (relative {loss_rel:.2e}); gradients: "
          f"{len(rels)} leaves, worst relative L2 {rels[worst]:.2e} (leaf "
          f"{worst}), limit {CHECK_TOL:.0e}; backward launches by route: "
          f"flash attention {routes}, RMSNorm {rms_routes}; CPU step "
          f"{cpu_s:.1f} s [{card}]")
    if loss_rel > CHECK_TOL or rels[worst] > CHECK_TOL:
        raise AssertionError(f"train check beyond {CHECK_TOL}: loss "
                             f"{loss_rel}, gradient leaf {worst} "
                             f"{rels[worst]}")
    del card_p, g_d
    torch.cuda.empty_cache()


def phase_train(torch, dev, card, counted, sweep):
    """(i) Training internlm2-1.8b on the card: the backward kernels held
    and timed, the fp32 reduced-depth check, then TRAIN_STEPS remat steps
    at full width and depth, a checkpoint round trip and a profiled step.
    Returns (forward launches of the counted steps, backward launches,
    the backward kernels' rows)."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.core.pytree import leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    rms, fa = counted["rmsnorm"], counted["flash_attention"]
    t0 = time.perf_counter()
    entries = backward_rows(torch, dev, rms, fa, sweep)
    print(f"phase i backward kernels: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_check(torch, dev, card)
    print(f"phase i fp32 check: {time.perf_counter() - t0:.2f} s")

    cfg = registry.get_config(TRAIN_ARCH)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    n_params = sum(t.numel() for t in leaves(params))
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=100)
    # the launcher's step: the new params and moments written into the
    # state it is given
    step = make_train_step(cfg, opt_cfg, remat=True, donate=True)
    batch = next(Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                     global_batch=TRAIN_B, seed=0)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    state = (params, adamw.init(params))
    del params
    L = cfg.n_layers
    norms = 2 * L + 1                       # ln1, ln2 a layer; ln_f
    want_fwd = {"rmsnorm": (norms + 2 * L) * TRAIN_STEPS,   # + remat's
                "flash_attention": 2 * L * TRAIN_STEPS,
                "matmul": 0, "wkv6": 0, "rglru": 0, "grouped_matmul": 0}
    want_bwd = {"rmsnorm": 2 * norms * TRAIN_STEPS,        # rows, dg sum
                "flash_attention": 3 * L * TRAIN_STEPS}     # a, b, c
    want_bwd_routes = {"wgmma": want_bwd["flash_attention"], "simt": 0}
    want_rms_bwd_routes = {"warp": 0, "block": want_bwd["rmsnorm"],
                           "scalar": 0}
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    print(f"train {cfg.name}: {n_params / 1e9:.3f} B params ({cfg.dtype}), "
          f"AdamW fp32 moments, remat, B{TRAIN_B} S{TRAIN_S}, one fixed "
          f"batch, {TRAIN_STEPS} steps [{card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(counted)
    losses, times = [], []
    for i in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = step(state[0], state[1], batch)
        loss = new[2]["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorm = new[2]["grad_norm"].item()
        state = new[:2]
        if i == 1:
            # the first moment is 0.1 x clip x grad: finite and non-zero
            # exactly where the gradient is
            bad = [n for n, m in enumerate(leaves(state[1].m))
                   if not bool(torch.isfinite(m).all()) or not bool(
                       (m != 0).any())]
            if bad or not math.isfinite(gnorm) or gnorm == 0:
                raise AssertionError(f"step 1: gradient leaves {bad} of "
                                     f"{len(leaves(state[1].m))} not finite "
                                     f"or all zero (norm {gnorm})")
        if i == TRAIN_SAVE_AFTER:
            t1 = time.perf_counter()
            mgr.save(i, {"params": state[0], "opt": state[1]})
            saved_host = tree_map(lambda t: t.cpu(), {"params": state[0],
                                                      "opt": state[1]})
            print(f"train: checkpoint of step {i} snapshot to host "
                  f"{time.perf_counter() - t1:.2f} s, written in the "
                  f"background")
        if i == TRAIN_SAVE_AFTER + 1:
            after_save = (loss, gnorm, tree_map(torch.clone, state[0]))
        print(f"train step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
              f"{times[-1] * 1e3:.1f} ms, "
              f"{TRAIN_B * TRAIN_S / times[-1]:.0f} tokens/s [{card}]")
    fwd = read_launches(counted)
    bwd = {"rmsnorm": rms.bwd_launches, "flash_attention": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    routes, bwd_routes = dict(fa.routes), dict(fa.bwd_routes)
    rms_bwd_routes = dict(rms.bwd_routes)
    if fwd != want_fwd or bwd != want_bwd or routes != {
            "wgmma": want_fwd["flash_attention"], "simt": 0} or \
            bwd_routes != want_bwd_routes or \
            rms_bwd_routes != want_rms_bwd_routes:
        raise AssertionError(f"train launches forward {fwd} (flash "
                             f"attention by route {routes}), backward "
                             f"{bwd} (flash attention by route "
                             f"{bwd_routes}, RMSNorm {rms_bwd_routes}); "
                             f"want {want_fwd}, {want_bwd}, all flash "
                             f"attention on wgmma, all RMSNorm backward on "
                             f"block")
    print(f"train launches over {TRAIN_STEPS} steps: forward {fwd} "
          f"(flash attention by route {routes}; RMSNorm by route "
          f"{dict(rms.routes)}), backward {bwd} (flash attention by route "
          f"{bwd_routes}; RMSNorm by route {rms_bwd_routes}): per step "
          f"RMSNorm {norms} + {2 * L} (remat) "
          f"forward, {2 * norms} backward; flash attention {L} + {L} "
          f"forward, {3 * L} backward")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    print(f"train: loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak memory "
          f"{peak:.2f} GB [{card}]")

    busy, kernels, top = _device_busy_s(torch, lambda: step(
        state[0], state[1], batch))
    wall = min(times[1:])
    print(f"train profile {cfg.name} one step B{TRAIN_B} S{TRAIN_S}: "
          f"{kernels} kernels, device busy {busy * 1e3:.3f} ms, idle share "
          f"{1 - busy / wall:.3f} (of the fastest unprofiled step "
          f"{wall * 1e3:.3f} ms) [{card}]; top kernels (ms) {top}")
    # the optimizer's share of a step: one AdamW update of the whole
    # state alone, after a warm one (the params stand in for the grads:
    # the same shapes and dtypes)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    adamw.update(opt_cfg, state[1], state[0], state[0])
    torch.cuda.synchronize()
    ev[0].record()
    adamw.update(opt_cfg, state[1], state[0], state[0])
    ev[1].record()
    torch.cuda.synchronize()
    adamw_ms = ev[0].elapsed_time(ev[1])
    print(f"train: one AdamW update of the {n_params / 1e9:.3f} B params "
          f"(fp32 moments) alone {adamw_ms:.3f} ms [{card}]")
    print(json.dumps({"train": {
        "arch": cfg.name, "card": card, "batch": TRAIN_B, "seq": TRAIN_S,
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "tokens_per_s": [TRAIN_B * TRAIN_S / t for t in times],
        "busy_ms": busy * 1e3, "adamw_ms": adamw_ms, "peak_gb": peak}}))

    # the checkpoint: restored into fresh tensors, bitwise; one step on
    state = None
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    mgr.wait()
    write_s = time.perf_counter() - t1
    like = tree_map(lambda t: torch.empty(0, dtype=t.dtype, device=dev),
                    saved_host)
    t1 = time.perf_counter()
    restored = mgr.restore(TRAIN_SAVE_AFTER, like)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t1
    nbytes = sum(t.numel() * t.element_size() for t in leaves(saved_host))
    same = [torch.equal(a, b.to(dev)) for a, b in
            zip(leaves(restored), leaves(saved_host))]
    if not all(same):
        raise AssertionError(f"restore: {same.count(False)} of {len(same)} "
                             f"leaves differ from the saved ones")
    del saved_host
    new = step(restored["params"], restored["opt"], batch)
    loss, gnorm = new[2]["loss"].item(), new[2]["grad_norm"].item()
    loss_rel = abs(loss - after_save[0]) / abs(after_save[0])
    p_rel = max(_relative_l2(a, b) for a, b in
                zip(leaves(new[0]), leaves(after_save[2])))
    print(f"train checkpoint: {len(same)} leaves, {nbytes / 1e9:.2f} GB, "
          f"the rest of the write {write_s:.2f} s after step "
          f"{TRAIN_STEPS}, restore {read_s:.2f} s, restored leaves bitwise "
          f"equal to the saved ones; step {TRAIN_SAVE_AFTER + 1} again from "
          f"the restore: loss {loss:.6f} against {after_save[0]:.6f} "
          f"(relative {loss_rel:.2e}, limit {CHECK_TOL:.0e}), grad norm "
          f"{gnorm:.6f} against {after_save[1]:.6f}, params' worst "
          f"relative L2 {p_rel:.2e} (torch's deterministic mode not set: "
          f"held at {CHECK_TOL:.0e}, not bitwise) [{card}]")
    if loss_rel > CHECK_TOL or p_rel > CHECK_TOL:
        raise AssertionError(f"step from the restore: loss {loss_rel}, "
                             f"params {p_rel}")
    del restored, new, after_save
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    bwd["flash_attention_routes"] = bwd_routes
    bwd["rmsnorm_routes"] = rms_bwd_routes
    return fwd, bwd, entries


# ---------------------------------------------------------------- phase j

FAMILY_ARCHS = ("rwkv6-3b", "recurrentgemma-2b", "granite-moe-3b-a800m")
FAMILY_B, FAMILY_S, FAMILY_STEPS = 4, 1024, 4
# layers of the fp32 card-vs-CPU check and of the repeated bf16 step: 2,
# and recurrentgemma-2b's whole (rec, rec, attn) unit, so that its
# attention layer and remat run there too
FAMILY_CHECK_LAYERS = {"rwkv6-3b": 2, "recurrentgemma-2b": 3,
                       "granite-moe-3b-a800m": 2}
# the backward kernels' rows beside the training shapes that
# launch/time_train_bwd.py times (its ROWS, which stand for each kernel in
# the kernels line): every other WKV6 head width, a ragged K5 strip and
# K6's other tensor-core instances (dx's C tiles in 8-row steps, dw's D
# tiles in 64-row steps); each row in bf16 and fp32, decays down to 0.01
FAMILY_BWD_INSTANCES = [
    ("wkv6_bwd", (2, 77, 4, 16), "instance D16"),
    ("wkv6_bwd", (2, 77, 4, 32), "instance D32"),
    ("wkv6_bwd", (2, 77, 4, 128), "instance D128"),
    ("rglru_bwd", (2, 77, 2568), "ragged strip"),
    ("grouped_matmul_bwd", (3, 40, 48, 32), "instances dx N40 dw N64"),
    ("grouped_matmul_bwd", (3, 100, 96, 40), "instances dx N104 dw N128"),
    ("grouped_matmul_bwd", (2, 150, 160, 72), "instances dx N152 dw N192")]
# the floors of the backward kernels' redesign at the training shapes, bf16
# (ms, NVIDIA H100 at 700 W): a row slower than its floor fails the phase
BWD_FLOOR_MS = {("wkv6_bwd", "rwkv6-3b training"): 2.0,
                ("wkv6_bwd", "rwkv6-3b"): 1.0,
                ("grouped_matmul_bwd", "granite-moe-3b-a800m gate/up"): 0.26,
                ("grouped_matmul_bwd", "granite-moe-3b-a800m down"): 0.24}
# what each backward kernel of phase j is, for the kernels line
BWD_DESIGN = {
    "wkv6_bwd": "walk (forward: a cp.async ring a warp, fp32 checkpoints "
                "every 8 steps; backward: staged chunks, 3 L partial row "
                "sums deferred and halved together, one walk for dr, dk, "
                "dw and the blocks' dv parts) + sums (dv, du in fixed "
                "order)",
    "rglru_bwd": "one launch on the forward's strips, h recomputed in fp32",
    "grouped_matmul_bwd": "wgmma, persistent (one block an SM), one group "
                          "in flight, dx tiles in 8-row steps, dw on a "
                          "second stream; epilogue by stmatrix and TMA "
                          "stores"}


def _time_plain(torch, fn, flush) -> float:
    """The plain version's device ms: the mean of 2 calls after 1 warm one,
    each after a zeroing of ``flush`` (it is slow: phase a's 20 would take
    minutes at the training shapes)."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for n in range(2):
        flush.zero_()
        ev[2 * n].record()
        fn()
        ev[2 * n + 1].record()
    torch.cuda.synchronize()
    return sum(ev[2 * n].elapsed_time(ev[2 * n + 1]) for n in range(2)) / 2


def family_backward_rows(torch, dev, wkv, scan, gm, sweep):
    """The backward kernels of K4, K5 and K6 against their plain versions
    at the training shapes and at every compiled instance, in bf16 and
    fp32: two calls bitwise equal, the largest error within BWD_TOL of the
    largest |gradient|, the launches and routes; timed by phase a's method
    (cold L2, spin) beside the plain version, the bound and, for K6,
    ``torch.bmm`` on the same two products.  The training rows, inputs,
    tolerance, bounds and yardstick are ``launch/time_train_bwd.py``'s.
    Returns the rows that stand for each kernel in the kernels line (the
    training shape, bf16)."""
    from repro_torch.launch import time_train_bwd as ttb
    from repro_torch.launch.time_k1k2 import FLUSH_BYTES, time_ms
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    names = {"float32": "fp32", "bfloat16": "bf16"}
    fns = ttb.wrappers()
    # each wrapper's launch counter and its launches a call
    counters = {"wkv6_bwd": (lambda: wkv.bwd_launches, len(wkv.BWD_STAGES)),
                "rglru_bwd": (lambda: scan.bwd_launches, 1),
                "grouped_matmul_bwd": (lambda: gm.bwd_launches, 2)}
    entries = {}

    def check(kernel, case, dt, fn, plain):
        counter, per_call = counters[kernel]
        before = counter()
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        if counter() - before != 2 * per_call:
            raise AssertionError(f"{kernel} {case}: {counter() - before} "
                                 f"launches for two calls, want "
                                 f"{2 * per_call}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kernel} {case} {names[dt]}: two calls "
                                 f"differ")
        return ttb.held(torch, got, plain(), dt, f"{kernel} {case}")

    def row(kernel, shape, case, dt, err, fn, plain, element_size,
            library=None, extra=None):
        # the kernel and the library call in turns (kernel, library,
        # library, kernel); then the plain version
        runs, lib_runs = [], []
        for turn in ("kernel", "library", "library", "kernel"):
            if turn == "kernel":
                runs.append(time_ms(torch, fn, flush))
            elif library is not None:
                lib_runs.append(time_ms(torch, library, flush))
        ms = sum(runs) / len(runs)
        lib_ms = sum(lib_runs) / len(lib_runs) if lib_runs else None
        plain_ms = _time_plain(torch, plain, flush)
        b_ms, b_by = ttb.bound_ms(kernel, shape, dt, element_size)
        ops = ttb.work(kernel, shape, element_size)[0]
        r = {"kernel": kernel, "case": case, "dtype": names[dt],
             "max_abs_err": err, "ms": ms, "ms_runs": runs,
             "plain_ms": plain_ms, "library_ms": lib_ms,
             "library_ms_runs": lib_runs, "bound_ms": b_ms,
             "bound_by": b_by,
             "fp32_floor_ms": ops / ttb.PEAK_FLOPS["float32"] * 1e3,
             **(extra or {})}
        sweep.append(r)
        lib = ("none" if lib_ms is None else
               " then ".join(f"{t:.4f}" for t in lib_runs) + " torch.bmm")
        print(f"backward {kernel} {case} {names[dt]}"
              f"{' route ' + r['route'] if 'route' in r else ''}: "
              f"{' then '.join(f'{t:.4f}' for t in runs)} ms (plain "
              f"{plain_ms:.3f}, library {lib}, bound {b_ms:.5f} by {b_by}, "
              f"fp32 floor {r['fp32_floor_ms']:.5f}), max abs err "
              f"{err:.3e}, two calls bitwise equal")
        return r

    # the training rows first, one a (kernel, shape), then the instances
    train = list(dict.fromkeys((k, shape, what)
                               for k, shape, _, what in ttb.ROWS))
    for dt in ("bfloat16", "float32"):
        for kernel, shape, what in train + FAMILY_BWD_INSTANCES:
            args = ttb.inputs(torch, dev, gen, kernel, shape, dt)
            fn, plain = fns[kernel]
            case = ttb.case(kernel, shape, what)
            extra = None
            if kernel == "grouped_matmul_bwd":
                route = gm.route_bwd(args[0], args[1])
                extra = {"route": route}
                before = dict(gm.bwd_routes)
            err = check(kernel, case, dt, lambda: fn(*args),
                        lambda: plain(*args))
            if kernel == "grouped_matmul_bwd":
                took = {k: gm.bwd_routes[k] - n for k, n in before.items()}
                want = {r: 4 * (r == route) for r in ("wgmma", "simt")}
                if took != want or (dt == "bfloat16" and route != "wgmma"):
                    raise AssertionError(f"grouped_matmul_bwd {case} "
                                         f"{names[dt]}: routes {took}, want "
                                         f"{want} ({route}); bf16 must take "
                                         f"the tensor cores")
            res = row(kernel, shape, case, dt, err, lambda: fn(*args),
                      lambda: plain(*args), args[0].element_size(),
                      library=ttb.library(torch, kernel, args), extra=extra)
            floor = BWD_FLOOR_MS.get((kernel, what))
            if floor is not None and dt == "bfloat16" and \
                    not res["ms"] <= floor:
                raise AssertionError(f"{kernel} {case} bf16: "
                                     f"{res['ms']:.4f} ms, floor {floor}")
            entries.setdefault(kernel, res)
            del args
    del flush
    torch.cuda.empty_cache()
    return entries


def family_expect(torch, cfg, rms, fa, steps: int):
    """The exact launches of ``steps`` remat train steps of ``cfg``
    (stacked layers' forward kernels twice a step, tail layers' and ln_f's
    once; the backward once a layer): ({kernel: forward launches},
    {kernel: backward launches}, {kernel: {route: launches}} forward and
    backward), from the model's layer kinds and K2's and K3's pure
    routes."""
    G = cfg.n_layers // cfg.unit
    dt = cfg.param_dtype
    cpu = torch.device("cpu")   # small operands, for the routes' purity
    kernels = ("matmul", "rmsnorm", "flash_attention", "wkv6", "rglru",
               "grouped_matmul")
    from repro_torch.kernels.rwkv_scan.rwkv_scan import BWD_STAGES
    per_call = {"rmsnorm": 2, "flash_attention": 3,
                "wkv6": len(BWD_STAGES), "rglru": 1, "grouped_matmul": 2}
    fwd, bwd = dict.fromkeys(kernels, 0), dict.fromkeys(kernels, 0)
    fr = {k: {} for k in ("rmsnorm", "flash_attention", "grouped_matmul")}
    br = {k: {} for k in fr}

    def add(kernel, n, times, routes=None):
        fwd[kernel] += n * times
        bwd[kernel] += n * per_call[kernel]
        if routes:
            f, b = routes
            fr[kernel][f] = fr[kernel].get(f, 0) + n * times
            br[kernel][b] = br[kernel].get(b, 0) + n * per_call[kernel]

    def norm(width, times):
        x = torch.empty((8, width), dtype=dt, device=cpu)
        g = torch.empty((width,), dtype=dt, device=cpu)
        add("rmsnorm", 1, times,
            (rms.route(x, g), rms.route_bwd(x, g, x)))

    def attention(times):
        q = torch.empty((1, 8, cfg.n_heads, cfg.head_dim), dtype=dt,
                        device=cpu)
        k = torch.empty((1, 8, cfg.n_kv, cfg.head_dim), dtype=dt,
                        device=cpu)
        add("flash_attention", 1, times,
            (fa.route(q, k, k), fa.route_bwd(q, k, k)))
        if cfg.qk_norm:
            norm(cfg.head_dim, times)
            norm(cfg.head_dim, times)

    for layer in range(cfg.n_layers):
        times = 2 if layer < G * cfg.unit else 1
        kind = cfg.layer_kind(layer % cfg.unit)
        if cfg.family == "ssm":
            add("wkv6", 1, times)
            for width in (cfg.d_model, cfg.d_model, cfg.rwkv_head_dim):
                norm(width, times)
        elif cfg.family == "hybrid" and kind == "rec":
            add("rglru", 1, times)
            norm(cfg.d_model, times)
            norm(cfg.d_model, times)
        elif cfg.family in ("hybrid", "moe"):
            attention(times)
            norm(cfg.d_model, times)
            norm(cfg.d_model, times)
            if cfg.family == "moe":
                # bf16 operands TMA reads, widths multiples of 8: wgmma
                add("grouped_matmul", 3, times, ("wgmma", "wgmma"))
        else:
            raise ValueError(f"no launch model for {cfg.name}")
    norm(cfg.d_model, 1)                      # ln_f
    scale = lambda d: {k: v * steps for k, v in d.items()}  # noqa: E731
    return (scale(fwd), scale(bwd),
            {k: scale(v) for k, v in fr.items()},
            {k: scale(v) for k, v in br.items()})


def _routes_now(counted):
    return {name: (dict(mod.routes) if hasattr(mod, "routes") else {},
                   dict(getattr(mod, "bwd_routes", {})))
            for name, mod in counted.items()}


def family_check(torch, dev, card, arch, counted):
    """``arch`` at full width, FAMILY_CHECK_LAYERS layers: one fp32 remat
    step's loss and every gradient on the card against the same on CPU
    tensors (the plain versions) at CHECK_TOL, twice on the card bitwise;
    then the same depth in bf16 (the training path's routes), one step
    twice on the card, bitwise."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.pytree import leaves
    from repro_torch.models import stacking
    from repro_torch.models.api import get_model
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = FAMILY_CHECK_LAYERS[arch]
    base = dataclasses.replace(registry.get_config(arch), n_layers=layers)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, base.vocab, (CHECK_B, CHECK_S)))
    y = torch.from_numpy(rng.integers(0, base.vocab, (CHECK_B, CHECK_S)))
    cfg = dataclasses.replace(base, dtype="float32")
    model = get_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    card_p = stacking.tree_map(lambda t: t.to(dev), cpu)
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(cfg, remat=True))
    before = _routes_now(counted)
    bwd0 = {n: getattr(m, "bwd_launches", 0) for n, m in counted.items()}
    (loss_d, _), g_d = grad_fn(card_p, x.to(dev), y.to(dev))
    bwd = {n: getattr(m, "bwd_launches", 0) - bwd0[n]
           for n, m in counted.items()}
    after = _routes_now(counted)
    routes = {n: {r: after[n][1][r] - c for r, c in before[n][1].items()}
              for n in after}
    (loss_d2, _), g_d2 = grad_fn(card_p, x.to(dev), y.to(dev))
    same = torch.equal(loss_d, loss_d2) and all(
        torch.equal(a, b) for a, b in zip(leaves(g_d), leaves(g_d2)))
    t0 = time.perf_counter()
    (loss_c, _), g_c = grad_fn(cpu, x, y)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss_d.item() - loss_c.item()) / abs(loss_c.item())
    rels = [_relative_l2(a.cpu(), b)
            for a, b in zip(leaves(g_d), leaves(g_c))]
    worst = max(range(len(rels)), key=lambda i: rels[i])
    # fp32: flash attention's and the grouped matmul's backward on SIMT
    simt_only = all(routes[n].get("wgmma", 0) == 0
                    for n in ("flash_attention", "grouped_matmul"))
    new = {"ssm": "wkv6", "hybrid": "rglru", "moe": "grouped_matmul"}[
        cfg.family]
    print(f"family check {arch} {layers} layers fp32 B{CHECK_B} S{CHECK_S}:"
          f" loss card {loss_d.item():.6f}, CPU {loss_c.item():.6f} "
          f"(relative {loss_rel:.2e}); gradients: {len(rels)} leaves, worst "
          f"relative L2 {rels[worst]:.2e} (leaf {worst}), limit "
          f"{CHECK_TOL:.0e}; backward launches {bwd}, by route {routes}; "
          f"the card's step twice bitwise equal: {same}; CPU step "
          f"{cpu_s:.1f} s [{card}]")
    if loss_rel > CHECK_TOL or rels[worst] > CHECK_TOL:
        raise AssertionError(f"{arch} check beyond {CHECK_TOL}: loss "
                             f"{loss_rel}, gradient leaf {worst} "
                             f"{rels[worst]}")
    if not same or not simt_only or bwd[new] == 0:
        raise AssertionError(f"{arch} fp32 check: bitwise repeat {same}, "
                             f"routes {routes}, {new} backward launches "
                             f"{bwd[new]}")
    del card_p, g_d, g_d2, cpu, g_c
    # bf16 at the same depth: the training path's kernels and routes, one
    # step twice, every output bitwise
    cfg = dataclasses.replace(base, dtype="bfloat16")
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(cfg, remat=True))
    xd, yd = x.to(dev), y.to(dev)
    (l1, _), g1 = grad_fn(params, xd, yd)
    (l2, _), g2 = grad_fn(params, xd, yd)
    diff = [n for n, (a, b) in enumerate(zip(leaves(g1), leaves(g2)))
            if not torch.equal(a, b)]
    print(f"family check {arch} {layers} layers bf16: one step twice, loss "
          f"{l1.item():.6f} and {l2.item():.6f}, {len(diff)} of "
          f"{len(leaves(g1))} gradient leaves differ {diff[:8]} [{card}]")
    if diff or not torch.equal(l1, l2):
        raise AssertionError(f"{arch} bf16 step not bitwise repeatable: "
                             f"leaves {diff}")
    del params, g1, g2
    torch.cuda.empty_cache()


def family_train(torch, dev, card, arch, counted):
    """``arch`` at full width and depth in bf16: FAMILY_STEPS remat steps of
    the launcher's donated step (AdamW at the launcher's schedule for that
    many steps) on one fixed batch of
    FAMILY_B rows of FAMILY_S tokens (out of memory fails the phase); the
    loss finite and falling, every gradient leaf finite and non-zero
    after step 1, the exact launches per kernel and route, step ms,
    tokens/s, peak memory and a profiled step.  Returns (batch, forward
    launches, backward launches, backward launches by route, the
    summary), the launches those of the FAMILY_STEPS counted steps."""
    from repro_torch.configs import registry
    from repro_torch.core.pytree import leaves
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = registry.get_config(arch)
    model = get_model(cfg)
    # launch/train.py's schedule for a run of FAMILY_STEPS steps (phase i's
    # warmup 1 of 100 left recurrentgemma-2b's loss at 12.99, 11.69, 9.05,
    # 13.55 on this batch: its fourth step overshoots)
    opt_cfg = adamw.AdamWConfig(total_steps=FAMILY_STEPS,
                                warmup_steps=FAMILY_STEPS // 10)
    rms, fa = counted["rmsnorm"], counted["flash_attention"]
    B = FAMILY_B
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    n_params = sum(t.numel() for t in leaves(params))
    state = (params, adamw.init(params))
    del params
    step = make_train_step(cfg, opt_cfg, remat=True, donate=True)
    batch = next(Pipeline(DataConfig(vocab=cfg.vocab, seq_len=FAMILY_S,
                                     global_batch=B, seed=0)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    print(f"train {arch}: {n_params / 1e9:.3f} B params ({cfg.dtype}), "
          f"AdamW fp32 moments, remat, B{B} S{FAMILY_S}, one fixed batch,"
          f" {FAMILY_STEPS} steps [{card}]")
    reset_launches(counted)
    losses, times = [], []
    for i in range(1, FAMILY_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = step(state[0], state[1], batch)
        loss = new[2]["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorm = new[2]["grad_norm"].item()
        state = new[:2]
        del new
        if i == 1:
            bad = [n for n, m in enumerate(leaves(state[1].m))
                   if not bool(torch.isfinite(m).all())
                   or not bool((m != 0).any())]
            if bad or not math.isfinite(gnorm) or gnorm == 0:
                raise AssertionError(
                    f"{arch} step 1: gradient leaves {bad} of "
                    f"{len(leaves(state[1].m))} not finite or all "
                    f"zero (norm {gnorm})")
        print(f"train {arch} step {i}: loss {loss:.4f}, grad norm "
              f"{gnorm:.4f}, {times[-1] * 1e3:.1f} ms, "
              f"{B * FAMILY_S / times[-1]:.0f} tokens/s [{card}]")
    fwd = read_launches(counted)
    bwd = {n: getattr(m, "bwd_launches", 0) for n, m in counted.items()}
    got_routes = _routes_now(counted)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want_fwd, want_bwd, want_fr, want_br = family_expect(
        torch, cfg, rms, fa, FAMILY_STEPS)
    want_bwd = {k: v for k, v in want_bwd.items() if k != "matmul"}
    bwd = {k: bwd[k] for k in want_bwd}
    wrong = []
    if fwd != want_fwd:
        wrong.append(f"forward {fwd}, want {want_fwd}")
    if bwd != want_bwd:
        wrong.append(f"backward {bwd}, want {want_bwd}")
    for name in want_fr:
        got_f = {r: n for r, n in got_routes[name][0].items() if n}
        got_b = {r: n for r, n in got_routes[name][1].items() if n}
        if got_f != want_fr[name] or got_b != want_br[name]:
            wrong.append(f"{name} routes forward {got_f} backward {got_b}, "
                         f"want {want_fr[name]} and {want_br[name]}")
    print(f"train {arch} launches over {FAMILY_STEPS} steps: forward {fwd}, "
          f"backward {bwd}; by route "
          f"{ {n: got_routes[n] for n in want_fr} }")
    if wrong:
        raise AssertionError(f"train {arch} launches: " + "; ".join(wrong))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch} loss not finite or not falling:"
                             f" {losses}")
    busy, kernels, top = _device_busy_s(torch, lambda: step(
        state[0], state[1], batch))
    wall = min(times[1:])
    tokens = B * FAMILY_S
    summary = {"arch": arch, "card": card, "batch": B, "seq": FAMILY_S,
               "params": n_params, "losses": losses,
               "step_ms": [t * 1e3 for t in times],
               "tokens_per_s": [tokens / t for t in times],
               "busy_ms": busy * 1e3, "idle_share": 1 - busy / wall,
               "peak_gb": peak, "kernels": kernels, "top_ms": top}
    print(f"train {arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
          f"memory {peak:.2f} GB; profiled step: {kernels} kernels, device "
          f"busy {busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f} (of "
          f"the fastest unprofiled step {wall * 1e3:.3f} ms, "
          f"{tokens / wall:.0f} tokens/s) [{card}]; top kernels (ms) {top}")
    print(json.dumps({"train_family": summary}))
    state = batch = step = None
    torch.cuda.empty_cache()
    return B, fwd, bwd, {n: got_routes[n][1] for n in want_fr}, summary


def phase_families(torch, dev, card, counted, sweep):
    """(j) Training the recurrent, hybrid and MoE families on the card:
    K4's, K5's and K6's backward kernels held and timed, a full-width check
    of each family against the CPU plain path (and bitwise repeats), then
    each family trained at full width and depth.  Returns ({arch:
    (batch, forward launches, backward launches, backward launches by
    route)}, the backward kernels' rows)."""
    t0 = time.perf_counter()
    entries = family_backward_rows(torch, dev, counted["wkv6"],
                                   counted["rglru"],
                                   counted["grouped_matmul"], sweep)
    print(f"phase j backward kernels: {time.perf_counter() - t0:.2f} s")
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        family_check(torch, dev, card, arch, counted)
        print(f"phase j check {arch}: {time.perf_counter() - t0:.2f} s")
    runs = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        runs[arch] = family_train(torch, dev, card, arch, counted)[:4]
        print(f"phase j train {arch}: {time.perf_counter() - t0:.2f} s")
    return runs, entries


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
