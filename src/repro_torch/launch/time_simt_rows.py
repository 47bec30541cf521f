"""K6's SIMT route (``csrc/grouped_matmul_simt.cu``) on its measured
products, at the tile height ``grouped_matmul.plan_simt()`` picks and, with
``--every-height``, at each height the source compiles:

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/time_simt_rows.py

The products: olmoe-1b-7b's S1000 gate in fp32 and in bf16 with x a
transposed view (``chip_smoke.py``'s phase a), granite-moe-3b-a800m's fp32
backward products at B4 S1024 (dx = dy wᵀ and dw = xᵀ dy of gate/up and
of down, on the views ``grouped_matmul_bwd`` passes) and the odd widths
(40,17,100)×(40,100,7) in bf16 (element copies of both operands).  Each is
timed by ``time_k1k2.time_ms`` (cold L2, a spin before each call, the mean
of 20) in the order kernel, ``torch.bmm``, ``torch.bmm``, kernel, and held
to ``torch.bmm`` on the first call.  A forced height replaces
``simt_rows`` for that product only; the C side launches what it is told.
Runs on any tree whose ``grouped_matmul`` module has ``plan_simt``, so that
two trees (this one and a ``git archive`` of an earlier commit) are timed
by one method in one call.  Prints the card's name and power limit, then
one ``{"simt_rows": [...]}`` JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys

# (what, E, C, D, F, dtype, layout): x @ w with x (E,C,D), w (E,D,F);
# layout "x^T": x a transposed view of (E,D,C); "dx": dy (E,C,D) @ w^T
# (w stored (E,F,D)); "dw": x^T (x stored (E,D,C)) @ dy (E,D,F)
PRODUCTS = [
    ("olmoe-1b-7b S1000 gate", 64, 160, 2048, 1024, "float32", "plain"),
    ("olmoe-1b-7b S1000 gate, x transposed", 64, 160, 2048, 1024,
     "bfloat16", "x^T"),
    ("granite-moe-3b-a800m gate/up dx", 40, 1056, 512, 1536, "float32",
     "dx"),
    ("granite-moe-3b-a800m gate/up dw", 40, 1536, 1056, 512, "float32",
     "dw"),
    ("granite-moe-3b-a800m down dx", 40, 1056, 1536, 512, "float32", "dx"),
    ("granite-moe-3b-a800m down dw", 40, 512, 1056, 1536, "float32", "dw"),
    ("odd widths", 40, 17, 100, 7, "bfloat16", "plain"),
]


def operands(torch, dev, gen, E, C, D, F, dtype, layout):
    """x (E,C,D) and w (E,D,F) as the layout's views."""
    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)
    x = (randn(E, D, C).transpose(1, 2) if layout in ("x^T", "dw")
         else randn(E, C, D))
    w = randn(E, F, D).transpose(1, 2) if layout == "dx" else randn(E, D, F)
    return x, w


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_simt_rows: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.launch.time_k1k2 import FLUSH_BYTES, time_ms, warm_up
    every = "--every-height" in sys.argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    warm_up(torch, dev)
    heights = getattr(gm, "SIMT_ROWS", tuple(range(16, 129, 8)))
    pick = gm.simt_rows
    out = []
    for what, E, C, D, F, dt, layout in PRODUCTS:
        dtype = getattr(torch, dt)
        x, w = operands(torch, dev, gen, E, C, D, F, dtype, layout)
        assert gm.route(x, w) == "simt"
        chosen = pick(E, C, F, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        want = torch.bmm(x, w).float()
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        for rows in (heights if every else (chosen,)):
            gm.simt_rows = lambda *a, r=rows: r
            try:
                got = gm.grouped_matmul(x, w).float()
                err = (got - want).abs().max().item()
                if not bool(((got - want).abs() <= tol * D ** 0.5
                             + tol * want.abs()).all()):
                    raise AssertionError(f"{what} rows {rows}: max abs "
                                         f"err {err}")
                k = lambda: gm.grouped_matmul(x, w)
                lib = lambda: torch.bmm(x, w)
                ts = [time_ms(torch, f, flush) for f in (k, lib, lib, k)]
            finally:
                gm.simt_rows = pick
            row = {"case": f"{what} ({E},{C},{D})x({E},{D},{F})",
                   "dtype": dt, "rows": rows, "picked": rows == chosen,
                   "ms": (ts[0] + ts[3]) / 2, "ms_turns": [ts[0], ts[3]],
                   "library_ms": (ts[1] + ts[2]) / 2,
                   "ratio": (ts[0] + ts[3]) / (ts[1] + ts[2]),
                   "max_abs_err": err}
            out.append(row)
            print(f"{row['case']} {dt} rows {rows}"
                  f"{' (plan)' if row['picked'] else ''}: "
                  f"{ts[0]:.5f} then {ts[3]:.5f} ms, torch.bmm "
                  f"{ts[1]:.5f} then {ts[2]:.5f}, ratio {row['ratio']:.3f}",
                  flush=True)
        del x, w, want
    print(json.dumps({"card": smi, "simt_rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
