"""The GEMM (K1) and RMSNorm (K2) rows of ``chip_smoke.py``'s phase a, and
the card-side timing that the smoke test shares with them.

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/time_k1k2.py [--splits]

times the K1 and K2 kernels of the tree on ``PYTHONPATH`` on this file's
rows, so that one file times two trees (this one and a ``git archive`` of
an earlier commit) by one method.  It calls only the wrappers
``matmul.matmul`` and ``rmsnorm.rmsnorm`` and their plain versions, whose
signatures have stood since the port began.  Each row is held to its plain
version and reports

- ``ms``: device time with a cold L2 (a 256 MB zeroing before each call)
  and a ~0.1 ms spin on the card after the zeroing, so that the host has
  enqueued the call before the card reaches it: the kernels alone;
- ``cold_ms``: the same without the spin (phase a's method before the
  spin): where the host takes longer to enqueue the zeroing and the call
  than the card takes to run them, part of the wrapper's host time shows;
- ``host_us``: the wrapper's host time per call, enqueue only;
- ``plain_ms`` and ``library_ms`` (``torch.matmul``, ``F.rms_norm``).

It prints the card's name and power limit, then one ``{"k1k2": [...]}``
JSON line.  With ``--splits`` it then times, on this tree only, every fp32
K1 row at each split of K that ``matmul.plan`` weighs, and prints one
``{"splits": [...]}`` line: per row the plan's pick and the fastest split
with their times, and every split's.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

FLUSH_BYTES = 256 << 20    # > the 50 MB L2; zeroed before each timed call
ITERS = 20
SPIN_CYCLES = 200_000      # ~0.1 ms at the H100's clock, before a timed call

# K1's fp32 rows: decode (1) and the shape buckets of chip_smoke.py phase
# c's prompts; bf16 at decode and prefill
MM_M = {"float32": (1, 8, 16, 32, 64), "bfloat16": (1, 64)}
# K2's rows: (rows, width, dtypes, what): phase c's rwkv6 tenant (d 2560)
# at prefill and decode; qwen3-8b's ln1/ln2/ln_f at S 1000 and decode, its
# q-norm (32 heads x 1000 tokens) and k-norm (8 heads x 1000); rwkv6-3b's
# per-head ln_x at T 4096 (40 heads of 64); recurrentgemma-2b's norms at
# T 4096
RMS_ROWS = [
    (64, 2560, ("float32", "bfloat16"), "phase c"),
    (1, 2560, ("float32", "bfloat16"), "phase c"),
    (1000, 4096, ("bfloat16",), "qwen3-8b"),
    (1, 4096, ("bfloat16",), "qwen3-8b"),
    (32000, 128, ("bfloat16",), "qwen3-8b q-norm"),
    (8000, 128, ("bfloat16",), "qwen3-8b k-norm"),
    (163840, 64, ("bfloat16",), "rwkv6-3b ln_x"),
    (4096, 2560, ("bfloat16",), "recurrentgemma-2b"),
]


def time_ms(torch, fn, flush, spin: bool = True) -> float:
    """Mean device time of ``fn`` with a cold L2: each call runs after a
    zeroing of ``flush`` (larger than L2), between its own pair of events,
    after 3 warm calls.  With ``spin``, ~0.1 ms of spinning on the card
    (``torch.cuda._sleep``) follows the zeroing, so that the host has
    enqueued ``fn`` before the card reaches the first event: a wrapper's
    host time would otherwise count as device time wherever it outlasts
    the zeroing."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
    for start, end in ev:
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / ITERS


def host_us_per_call(torch, fn, n: int = 100) -> float:
    """Host microseconds per call of ``fn``, which only enqueues work: the
    mean over ``n`` calls, timed without a synchronise, after 3 warm ones."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def warm_up(torch, dev) -> None:
    """~0.4 s of zeroing, so that the first timed rows do not meet the
    card's clocks still rising from idle."""
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for _ in range(5000):
        buf.zero_()
    torch.cuda.synchronize()


def cases(torch, dev, gen):
    """The rows: (kernel, case, args, (atol, rtol), flops, bytes moved),
    the tensors made on ``dev`` from ``gen`` in a fixed order."""
    # K1: the runtime slices a weight's columns (strided B, row stride
    # wider than N) and runs decode (M = 1) and bucket rows (M = 8 ... 64)
    for dt, Ms in MM_M.items():
        dtype = getattr(torch, dt)
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        for M in Ms:
            for K in (2560, 8960):
                for N in (48, 1280, 4480):
                    a = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                    w = torch.randn(K, N + 64, generator=gen,
                                    device=dev).to(dtype)
                    yield _mm_case(f"{M}x{K}x{N} strided B", a,
                                   w[:, 32:32 + N], tol)
    # a column slice 3 elements (12 bytes) past a 16-byte boundary: no
    # vector route reads it
    for M in (1, 64):
        a = torch.randn(M, 2560, generator=gen, device=dev)
        w = torch.randn(2560, 1280 + 64, generator=gen, device=dev)
        yield _mm_case(f"{M}x2560x1280 B at column offset 3", a,
                       w[:, 3:3 + 1280], 1e-4)
    # batch_matmul against a transposed kT view (transformer_block shape)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(4, 64, 32, generator=gen, device=dev).to(dtype)
        k = torch.randn(4, 64, 32, generator=gen, device=dev).to(dtype)
        yield _mm_case("batched 4x(64x32x64) kT view", q, k.transpose(1, 2),
                       1e-4 if dtype == torch.float32 else 5e-2)

    # K2: each row with its gain and, for phase c's rows, without (the
    # runtime's rmsnorm without a gain input passes no g)
    for rows, d, dtypes, what in RMS_ROWS:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            g = torch.randn(d, generator=gen, device=dev).to(dtype)
            for gain in ((g, None) if what == "phase c" else (g,)):
                case = f"{what} {rows}x{d}" + (" no gain" if gain is None
                                                else "")
                yield ("rmsnorm", case, (x, gain), (tol, tol),
                       (3.0 if gain is None else 4.0) * rows * d,
                       (2 * rows * d + (0 if gain is None else d))
                       * x.element_size())


def _mm_case(case, a, b, tol):
    K, N = b.shape[-2], b.shape[-1]
    M = a.numel() // K
    return ("matmul", case, (a, b), (tol * math.sqrt(K), tol),
            2.0 * M * N * K, (a.numel() + b.numel() + M * N)
            * a.element_size())


def functions(torch, kernel):
    """(the wrapper, its plain version, the library call) of ``kernel``,
    each taking a case's args."""
    if kernel == "matmul":
        from repro_torch.kernels.matmul.matmul import matmul
        from repro_torch.kernels.matmul.ref import matmul_ref
        return matmul, matmul_ref, torch.matmul
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm

    def library(x, g):
        return torch.nn.functional.rms_norm(x, x.shape[-1:], g, 1e-6)
    return rmsnorm, rmsnorm_ref, library


def max_abs_err(got, want, tol, what: str) -> float:
    """The largest |got - want|; raises where one is beyond atol + rtol *
    |want|."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{what}: max abs err {err} beyond atol {atol} "
                             f"rtol {rtol}")
    return err


def _split_probe(torch, dev, gen, flush):
    """Every fp32 K1 row at each split of K ``plan`` weighs, beside the
    plan's pick."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import matmul as mm
    sms = _build.sm_count(dev.index)
    out = []
    for kernel, case, (a, b), _, _, _ in cases(torch, dev, gen):
        if kernel != "matmul" or a.dtype != torch.float32 \
                or "strided" not in case:
            continue
        a3, b3, _ = mm._operands(a, b)
        nb, M, K = a3.shape
        N = b3.shape[-1]
        r = mm.route(a, b)
        c = torch.empty(nb, M, N, dtype=a.dtype, device=dev)
        timed = [(s, chunk, time_ms(torch, lambda: mm._launch(
            a3, b3, c, r, s, chunk), flush))
            for s, chunk in mm.splits(r, M, N, K)]
        pick = mm.plan(r, M, N, K, sms, a.dtype)
        best = min(timed, key=lambda t: t[2])
        at_pick = next(t for t in timed if t[:2] == pick)
        out.append({"case": case, "route": r, "plan": at_pick,
                    "best": best, "plan_over_best": at_pick[2] / best[2],
                    "all": timed})
        print(f"splits {case} {r}: plan {at_pick}, best {best}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_k1k2: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.matmul import matmul as mm
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    warm_up(torch, dev)
    rows = []
    for kernel, case, args, tol, _, _ in cases(torch, dev, gen):
        fn, plain, library = functions(torch, kernel)
        err = max_abs_err(fn(*args), plain(*args), tol,
                          f"{kernel} {case} {args[0].dtype}")
        rows.append({
            "kernel": kernel, "case": case, "dtype": str(args[0].dtype),
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: fn(*args), flush),
            "cold_ms": time_ms(torch, lambda: fn(*args), flush, spin=False),
            "host_us": host_us_per_call(torch, lambda: fn(*args)),
            "plain_ms": time_ms(torch, lambda: plain(*args), flush),
            "library_ms": time_ms(torch, lambda: library(*args), flush)})
    print(smi[0])
    print(json.dumps({"k1k2": rows, "tree": mm.__file__}))
    if "--splits" in sys.argv[1:]:
        print(json.dumps({"splits": _split_probe(torch, dev, gen, flush)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
