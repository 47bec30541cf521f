"""The RMSNorm backward (K2's backward) rows of ``chip_smoke.py``'s phase
i, timed alone:

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/time_rms_bwd.py

times ``rmsnorm.rmsnorm_bwd`` of the tree on ``PYTHONPATH`` (dx, then dg's
ordered sum) on this file's rows, so that one file times two trees (this
one and a ``git archive`` of an earlier commit) by one method.  It calls
only ``rmsnorm.rmsnorm_bwd`` and ``ref.rmsnorm_bwd_ref``, whose signatures
have stood since the backward kernel was added.  Each row is held to the
plain version at ``BWD_TOL`` of the largest |gradient| and reports

- ``ms``: device time with a cold L2, by ``time_k1k2.time_ms`` (a 256 MB
  zeroing and a ~0.1 ms spin on the card before each call), the mean of
  two turns taken in the order kernel, library, library, kernel, after
  ``settle``'s untimed calls;
- ``library_ms``: the same for the backward of ``F.rms_norm`` (autograd
  over one retained graph), a yardstick that the port never calls;
- ``plain_ms``, ``bound_ms`` (bytes: x and dy read, dx written, g read and
  dg written once, at 3.35 TB/s; operations: 10 an element at the
  dtype's peak) and the route where the tree's module has ``route_bwd``;
- ``add_ms``: ``torch.add(x, dy, out=dx)`` by the same method, an
  elementwise pass over the same bytes (two reads, one write): what the
  cold-L2 method lets such a pass reach on this card, beside the bound.

It prints the card's name and power limit, then one ``{"rms_bwd": [...]}``
JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys

# (rows, width, dtype, what): internlm2-1.8b's ln1/ln2/ln_f at B4 S1024
# and at the fp32 check's B1 S256; rwkv6-3b's per-head ln_x at 4096
# tokens x 40 heads of 64; qwen3's q-norm width (4096 tokens x 32 heads
# of 128); recurrentgemma-2b's norms at 4096 tokens
ROWS = [(4096, 2048, "bfloat16", "internlm2-1.8b"),
        (256, 2048, "float32", "internlm2-1.8b fp32 check"),
        (163840, 64, "bfloat16", "rwkv6-3b ln_x"),
        (131072, 128, "bfloat16", "qwen3 q-norm width"),
        (4096, 2560, "bfloat16", "recurrentgemma-2b")]
# relative to the largest |gradient| of each output: bf16 rounds dx once
# (2^-9); fp32 sums in other orders
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
HBM_BYTES = 3.35e12        # H100 SXM device memory, bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def inputs(torch, dev, gen, rows: int, d: int, dt: str):
    """x, g (1 + 0.1 N(0, 1)) and dy of a row, made on ``dev`` from
    ``gen``."""
    dtype = getattr(torch, dt)
    x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
    g = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
    return x, g, dy


def bound_ms(rows: int, d: int, dt: str, element_size: int):
    """(the least time the card could take, what bounds it)."""
    t_bytes = (3 * rows * d + 2 * d) * element_size / HBM_BYTES
    t_ops = 10.0 * rows * d / PEAK_FLOPS[dt]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def held(torch, got, want, dt: str, what: str) -> float:
    """The largest |got - want| over dx and dg; raises past ``BWD_TOL``."""
    err = 0.0
    for a, b in zip(got, want):
        diff = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if not diff <= BWD_TOL[dt] * scale:
            raise AssertionError(f"rmsnorm_bwd {what} {dt}: max abs err "
                                 f"{diff} beyond {BWD_TOL[dt]} x max |want| "
                                 f"{scale}")
        err = max(err, diff)
    return err


def settle(torch, fn, calls: int = 50) -> None:
    """``calls`` untimed calls of ``fn``: through the first rows timed
    after the card idles (a phase of host work before), its clocks still
    rise, and a row's first turn came out up to 1.5x its second."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()


def time_in_turns(torch, fns, flush):
    """{key: [ms, ms]} of each of the two calls in ``fns`` ("ms",
    "library_ms"), timed in the order first, second, second, first."""
    from repro_torch.launch.time_k1k2 import time_ms
    runs = {k: [] for k in fns}
    a, b = fns
    for k in (a, b, b, a):
        runs[k].append(time_ms(torch, fns[k], flush))
    return runs


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("time_rms_bwd: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    from repro_torch.launch.time_k1k2 import (FLUSH_BYTES, time_ms,
                                              warm_up)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    warm_up(torch, dev)
    out = []
    for rows, d, dt, what in ROWS:
        x, g, dy = inputs(torch, dev, gen, rows, d, dt)
        err = held(torch, rms.rmsnorm_bwd(x, g, dy),
                   rmsnorm_bwd_ref(x, g, dy), dt, what)
        settle(torch, lambda: rms.rmsnorm_bwd(x, g, dy))
        dx = torch.empty_like(x)
        xl, gl = (t.clone().requires_grad_(True) for t in (x, g))
        y_lib = F.rms_norm(xl, (d,), gl, 1e-6)
        runs = time_in_turns(torch, {
            "ms": lambda: rms.rmsnorm_bwd(x, g, dy),
            "library_ms": lambda: torch.autograd.grad(
                y_lib, (xl, gl), dy, retain_graph=True)}, flush)
        b_ms, b_by = bound_ms(rows, d, dt, x.element_size())
        row = {"case": f"{what} {rows}x{d} with g", "dtype": dt,
               "route": (rms.route_bwd(x, g, dy)
                         if hasattr(rms, "route_bwd") else "n/a"),
               "max_abs_err": err,
               **{k: sum(v) / len(v) for k, v in runs.items()},
               "ms_runs": runs["ms"], "library_ms_runs": runs["library_ms"],
               "plain_ms": time_ms(torch, lambda: rmsnorm_bwd_ref(x, g, dy),
                                   flush),
               "add_ms": time_ms(torch, lambda: torch.add(x, dy, out=dx),
                                 flush),
               "bound_ms": b_ms, "bound_by": b_by}
        out.append(row)
        print(f"rmsnorm_bwd {row['case']} {dt} route {row['route']}: "
              f"{' then '.join(f'{t:.5f}' for t in runs['ms'])} ms "
              f"(F.rms_norm backward "
              f"{' then '.join(f'{t:.5f}' for t in runs['library_ms'])}, "
              f"plain {row['plain_ms']:.5f}, add {row['add_ms']:.5f}, bound "
              f"{b_ms:.5f} by {b_by}), "
              f"max abs err {err:.3e}", flush=True)
        del x, g, dy, dx, xl, gl, y_lib
        torch.cuda.empty_cache()
    print(smi[0])
    print(json.dumps({"rms_bwd": out, "tree": rms.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
