"""The backward kernels of K4 (WKV6), K5 (RG-LRU scan) and K6 (grouped
matmul) at the training shapes of ``chip_smoke.py``'s phase j, timed alone:

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/time_train_bwd.py

times ``rwkv_scan.wkv6_bwd``, ``rglru_scan.rglru_bwd`` and
``grouped_matmul.grouped_matmul_bwd`` of the tree on ``PYTHONPATH`` on this
file's rows, so that one file times two trees (this one and a ``git
archive`` of an earlier commit) by one method; run it for each tree in
turns (parent, change, change, parent) within one call to compare them on
one card.  It calls only those three wrappers and their plain versions,
whose signatures have stood since the backward kernels were added.  Each
row is held to the plain version at ``BWD_TOL`` of the largest |gradient|,
two calls bitwise equal, and reports

- ``ms``: device time with a cold L2, by ``time_k1k2.time_ms`` (a 256 MB
  zeroing and a ~0.1 ms spin on the card before each call, the mean of
  20), the mean of two turns taken in the order kernel, library, library,
  kernel, after ``SETTLE`` untimed calls;
- ``library_ms``: the same for ``torch.bmm`` on K6's two products (dy wᵀ
  and xᵀ dy on transposed views), a yardstick that the port never calls;
  none for K4 and K5, which no PyTorch call computes;
- ``bound_ms``: the larger of the bytes (inputs read once, outputs written
  once, at 3.35 TB/s) and the operations (K4 12 D² a (b, t, h), K5 5 an
  element, K6 4 E C D F) at the dtype's peak; and the route where the
  tree's module names one.

It prints the card's name and power limit, then one ``{"train_bwd":
[...]}`` JSON line.  Needs a CUDA card.  ``chip_smoke.py``'s phase j
takes its training rows, inputs, tolerance, bounds and yardstick from
here, so both read the same rows by the same measure.
"""

from __future__ import annotations

import json
import subprocess
import sys

# (kernel, shape, dtype, what): rwkv6-3b at B4 T1024 (training) and B1
# T1000; recurrentgemma-2b at B4 T1024; granite-moe-3b-a800m's expert
# products at B4 S1024 (1056 rows an expert); each in bf16 and fp32 (K6's
# fp32 products on the SIMT route)
ROWS = [("wkv6_bwd", (4, 1024, 40, 64), "bfloat16", "rwkv6-3b training"),
        ("wkv6_bwd", (1, 1000, 40, 64), "bfloat16", "rwkv6-3b"),
        ("wkv6_bwd", (4, 1024, 40, 64), "float32", "rwkv6-3b training"),
        ("wkv6_bwd", (1, 1000, 40, 64), "float32", "rwkv6-3b"),
        ("rglru_bwd", (4, 1024, 2560), "bfloat16",
         "recurrentgemma-2b training"),
        ("rglru_bwd", (4, 1024, 2560), "float32",
         "recurrentgemma-2b training"),
        ("grouped_matmul_bwd", (40, 1056, 1536, 512), "bfloat16",
         "granite-moe-3b-a800m gate/up"),
        ("grouped_matmul_bwd", (40, 1056, 512, 1536), "bfloat16",
         "granite-moe-3b-a800m down"),
        ("grouped_matmul_bwd", (40, 1056, 1536, 512), "float32",
         "granite-moe-3b-a800m gate/up"),
        ("grouped_matmul_bwd", (40, 1056, 512, 1536), "float32",
         "granite-moe-3b-a800m down")]
# relative to the largest |gradient| of each output: bf16 rounds each
# output once (2^-9); fp32 sums in other orders
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
HBM_BYTES = 3.35e12        # H100 SXM device memory, bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
WKV_BWD_OPS = 12           # K4's backward a state element and (b, t, h)
SETTLE = 5


def inputs(torch, dev, gen, kernel: str, shape, dt: str):
    """The wrapper's arguments for a row, made on ``dev`` from ``gen``:
    decays in [0.01, 1] (K4), gates in (0, 1) (K5), x at scale 0.5 and w
    at D^-0.5 (K6)."""
    dtype = getattr(torch, dt)

    def randn(*s, scale=1.0, to=dtype):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(to)

    if kernel == "wkv6_bwd":
        B, T, H, D = shape
        r, k, v, dy = (randn(B, T, H, D) for _ in range(4))
        w = (0.01 + 0.99 * torch.rand(B, T, H, D, generator=gen,
                                      device=dev)).to(dtype)
        return (r, k, v, w, randn(H, D, scale=0.3, to=torch.float32), dy,
                randn(B, H, D, D, to=torch.float32))
    if kernel == "rglru_bwd":
        B, T, D = shape
        a = torch.rand(B, T, D, generator=gen, device=dev).to(dtype)
        return a, randn(B, T, D), randn(B, T, D), randn(B, D,
                                                        to=torch.float32)
    E, C, D, F = shape
    return (randn(E, C, D, scale=0.5), randn(E, D, F, scale=D ** -0.5),
            randn(E, C, F))


def case(kernel: str, shape, what: str) -> str:
    """A row's name: what it stands for, then its shape."""
    if kernel == "wkv6_bwd":
        return f"{what} B{shape[0]} T{shape[1]} H{shape[2]} D{shape[3]}"
    if kernel == "rglru_bwd":
        return f"{what} B{shape[0]} T{shape[1]} D{shape[2]}"
    E, C, D, F = shape
    return f"{what} ({E},{C},{D})x({E},{D},{F})"


def work(kernel: str, shape, element_size: int):
    """(operations, bytes) of one call: the bytes of the inputs read once
    and the outputs written once."""
    if kernel == "wkv6_bwd":
        B, T, H, D = shape
        n = B * T * H * D
        return (WKV_BWD_OPS * n * D,
                9 * n * element_size + 4 * (B * H * D * D + 2 * H * D))
    if kernel == "rglru_bwd":
        B, T, D = shape
        return 5 * B * T * D, 5 * B * T * D * element_size + 4 * B * D
    E, C, D, F = shape
    return (4.0 * E * C * D * F,
            (2 * (E * C * D + E * D * F) + E * C * F) * element_size)


def bound_ms(kernel: str, shape, dt: str, element_size: int):
    """(the least time the card could take, what bounds it)."""
    ops, nbytes = work(kernel, shape, element_size)
    t_bytes, t_ops = nbytes / HBM_BYTES, ops / PEAK_FLOPS[dt]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def wrappers():
    """{kernel: (the port's wrapper, its plain version)}."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_bwd_ref
    from repro_torch.kernels.rglru_scan import rglru_scan as scan
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref
    return {"wkv6_bwd": (wkv.wkv6_bwd, wkv6_bwd_ref),
            "rglru_bwd": (scan.rglru_bwd, rglru_bwd_ref),
            "grouped_matmul_bwd": (gm.grouped_matmul_bwd,
                                   grouped_matmul_bwd_ref)}


def library(torch, kernel: str, args):
    """The PyTorch call that computes the same function on ``args``, a
    yardstick the port never calls: ``torch.bmm`` on K6's two products
    (dy wᵀ, xᵀ dy on transposed views); None for K4 and K5."""
    if kernel != "grouped_matmul_bwd":
        return None
    x, w, dy = args
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    return lambda: (torch.bmm(dy, wt), torch.bmm(xt, dy))


def held(torch, got, want, dt: str, what: str) -> float:
    """The largest |got - want| over the gradients; raises past
    ``BWD_TOL`` of the largest |want| of each."""
    err = 0.0
    for n, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: output {n} {a.dtype} "
                                 f"{tuple(a.shape)}, want {b.dtype} "
                                 f"{tuple(b.shape)}")
        diff = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if not diff <= BWD_TOL[dt] * scale:
            raise AssertionError(f"{what} {dt}: output {n} max abs err "
                                 f"{diff} beyond {BWD_TOL[dt]} x max |want| "
                                 f"{scale}")
        err = max(err, diff)
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_train_bwd: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.launch.time_k1k2 import FLUSH_BYTES, time_ms, warm_up
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    fns = wrappers()
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    warm_up(torch, dev)
    out = []
    for kernel, shape, dt, what in ROWS:
        args = inputs(torch, dev, gen, kernel, shape, dt)
        fn, plain = fns[kernel]
        got, again = fn(*args), fn(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kernel} {what} {dt}: two calls differ")
        err = held(torch, got, plain(*args), dt, f"{kernel} {what}")
        del got, again
        call = (lambda: fn(*args))
        lib_call = library(torch, kernel, args)
        for _ in range(SETTLE):
            call()
        torch.cuda.synchronize()
        runs, lib_runs = [], []
        for turn in ("kernel", "library", "library", "kernel"):
            if turn == "kernel":
                runs.append(time_ms(torch, call, flush))
            elif lib_call is not None:
                lib_runs.append(time_ms(torch, lib_call, flush))
        b_ms, b_by = bound_ms(kernel, shape, dt, args[0].element_size())
        route = None
        if kernel == "grouped_matmul_bwd" and hasattr(gm, "route_bwd"):
            route = gm.route_bwd(args[0], args[1])
        row = {"kernel": kernel, "case": case(kernel, shape, what),
               "dtype": dt,
               "route": route, "max_abs_err": err,
               "ms": sum(runs) / len(runs), "ms_runs": runs,
               "library_ms": (sum(lib_runs) / len(lib_runs)
                              if lib_runs else None),
               "library_ms_runs": lib_runs,
               "bound_ms": b_ms, "bound_by": b_by}
        out.append(row)
        lib = (" then ".join(f"{t:.5f}" for t in lib_runs) + " torch.bmm"
               if lib_runs else "none")
        print(f"{kernel} {row['case']} {dt}"
              f"{' route ' + route if route else ''}: "
              f"{' then '.join(f'{t:.5f}' for t in runs)} ms (library "
              f"{lib}, bound {b_ms:.5f} by {b_by}), max abs err "
              f"{err:.3e}, two calls bitwise equal", flush=True)
        del args, call, lib_call
        torch.cuda.empty_cache()
    print(smi[0])
    print(json.dumps({"train_bwd": out, "tree": wkv.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
