#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs
three phases; any mismatch raises, so the script exits non-zero:

(a) kernels: the GEMM and RMSNorm kernels against their plain torch
    versions on the card, at the serving path's shapes, and their times
    (cold L2) beside the plain version, the library call and the bound;
(b) plans: MLPerf-Tiny autoencoder, resnet and transformer_block compiled
    by the port's compiler (carfield SoC, mode "matcha"); ``execute_plan``
    on the card against ``execute_graph`` on CPU tensors at 1e-4, and a
    two-tenant ``execute_multi_plan`` bitwise against ``execute_plan``;
(c) serving, the main path: ``build_engine("rwkv6", max_seq=64, d=2560,
    ffn=8960)`` on the card drains launch/serve.py's trace (2 prompts, 4
    decode steps each); every served output is held to ``execute_graph``
    of its bucket graph on CPU tensors at 1e-4, and both kernels must have
    launched during this phase.

Standard output: per-phase wall times, the card's name and power limit
(the line of ``nvidia-smi --query-gpu=name,power.limit``), a
``kernel_sweep`` JSON line (every shape of phase a), a
``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.  With
no CUDA card, or without the port's sources beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

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
FLUSH_BYTES = 256 << 20    # > the 50 MB L2; zeroed before each timed call
ITERS = 20


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
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    print(f"phase build: {build_s:.2f} s")

    t0 = time.perf_counter()
    sweep, kernels = phase_kernels(torch, dev, mm, rms)
    print(f"phase a kernels: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_plans(torch, dev)
    print(f"phase b plans: {time.perf_counter() - t0:.2f} s")

    mm.launches = 0
    rms.launches = 0
    t0 = time.perf_counter()
    served = phase_serve(torch, dev)
    launches = {"matmul": mm.launches, "rmsnorm": rms.launches}
    per_request = {k: v / served for k, v in launches.items()}
    print(f"phase c serve: {time.perf_counter() - t0:.2f} s, {served} "
          f"requests served, launches {launches}, per request {per_request}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise RuntimeError(f"{k['name']} never launched on the main path")

    print(smi[0])
    print(json.dumps({"kernel_sweep": sweep}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------- timing


def time_ms(torch, fn, flush) -> float:
    """Mean device time of ``fn`` with a cold L2: each call runs after a
    zeroing of a buffer larger than L2, between its own pair of events."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / ITERS


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- phase a


def phase_kernels(torch, dev, mm, rms):
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    peaks = {torch.float32: FP32_FLOPS, torch.bfloat16: BF16_FLOPS}
    names = {torch.float32: "fp32", torch.bfloat16: "bf16"}
    sweep, entries = [], {}

    def record(kernel, case, dtype, got, want, tol, fns, flops, nbytes):
        err = (got.float() - want.float()).abs().max().item()
        lim = tol[0] + tol[1] * want.float().abs()
        if not bool(((got.float() - want.float()).abs() <= lim).all()):
            raise AssertionError(f"{kernel} {case} {names[dtype]}: max abs "
                                 f"err {err} beyond atol {tol[0]} rtol "
                                 f"{tol[1]}")
        ms = {k: (time_ms(torch, f, flush) if f is not None else None)
              for k, f in fns.items()}
        b_ms, b_by = bound(flops, nbytes, peaks[dtype])
        row = {"kernel": kernel, "case": case, "dtype": names[dtype],
               "max_abs_err": err, **ms, "bound_ms": b_ms, "bound_by": b_by}
        sweep.append(row)
        return row

    # K1: the runtime slices a weight's columns (strided B, row stride
    # wider than N) and runs prefill (M = 64) and decode (M = 1) rows
    for dtype in (torch.float32, torch.bfloat16):
        for M in (1, 64):
            for K in (2560, 8960):
                for N in (48, 1280, 4480):
                    a = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                    w = torch.randn(K, N + 64, generator=gen,
                                    device=dev).to(dtype)
                    b = w[:, 32:32 + N]
                    got = mm.matmul(a, b)
                    want = matmul_ref(a, b)
                    tol = 1e-4 if dtype == torch.float32 else 5e-2
                    row = record(
                        "matmul", f"{M}x{K}x{N} strided B", dtype, got, want,
                        (tol * math.sqrt(K), tol),
                        {"ms": lambda: mm.matmul(a, b),
                         "plain_ms": lambda: matmul_ref(a, b),
                         "library_ms": lambda: torch.matmul(a, b)},
                        2.0 * M * N * K,
                        (M * K + K * N + M * N) * a.element_size())
                    if (dtype, M, K, N) == (torch.float32, 64, 2560, 1280):
                        entries["matmul"] = row
    # batch_matmul against a transposed kT view (transformer_block shape)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(4, 64, 32, generator=gen, device=dev).to(dtype)
        k = torch.randn(4, 64, 32, generator=gen, device=dev).to(dtype)
        kt = k.transpose(1, 2)
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        record("matmul", "batched 4x(64x32x64) kT view", dtype,
               mm.matmul(q, kt), matmul_ref(q, kt),
               (tol * math.sqrt(32), tol),
               {"ms": lambda: mm.matmul(q, kt),
                "plain_ms": lambda: matmul_ref(q, kt),
                "library_ms": lambda: torch.matmul(q, kt)},
               2.0 * 4 * 64 * 64 * 32,
               (q.numel() + kt.numel() + 4 * 64 * 64) * q.element_size())

    # K2: the rwkv6 tenant's ln at prefill and decode rows
    lib_rms = getattr(torch.nn.functional, "rms_norm", None)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (64, 1):
            d = 2560
            x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            g = torch.randn(d, generator=gen, device=dev).to(dtype)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            row = record(
                "rmsnorm", f"{rows}x{d}", dtype, rms.rmsnorm(x, g),
                rmsnorm_ref(x, g), (tol, tol),
                {"ms": lambda: rms.rmsnorm(x, g),
                 "plain_ms": lambda: rmsnorm_ref(x, g),
                 "library_ms": (None if lib_rms is None else
                                lambda: lib_rms(x, (d,), g, 1e-6))},
                4.0 * rows * d, (2 * rows * d + d) * x.element_size())
            if (dtype, rows) == (torch.float32, 64):
                entries["rmsnorm"] = row
            # the runtime's rmsnorm without a gain input passes no g
            record("rmsnorm", f"{rows}x{d} no gain", dtype, rms.rmsnorm(x),
                   rmsnorm_ref(x), (tol, tol),
                   {"ms": lambda: rms.rmsnorm(x),
                    "plain_ms": lambda: rmsnorm_ref(x),
                    "library_ms": (None if lib_rms is None else
                                   lambda: lib_rms(x, (d,), None, 1e-6))},
                   3.0 * rows * d, 2 * rows * d * x.element_size())
    del flush
    torch.cuda.empty_cache()

    meta = {
        "matmul": ("src/repro_torch/csrc/matmul.cu",
                   "src/repro/kernels/matmul/matmul.py:38"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:20"),
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
            "library_ms": r["library_ms"]})
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


def phase_serve(torch, dev, d: int = 2560, ffn: int = 8960) -> int:
    """The rwkv6 tenant at the widths of configs/rwkv6_3b.py beside the
    vision tenant, one layer deep, random weights from seeds."""
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


if __name__ == "__main__":
    sys.exit(main())
