"""The wall and host time of one eager decode step (``chip_smoke.py``'s
phase d), on the tree on ``PYTHONPATH``.

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/time_decode.py \
        [--arch qwen3-8b] [--batch 1] [--prompt 77] [--steps 32] \
        [--repeats 5]

builds ARCH at full width and depth (random weights from seed 0, its
config's dtype) on the card, prefills a prompt of BATCH x PROMPT random
tokens and decodes STEPS greedy tokens, REPEATS times after one warm-up
run.  It calls only ``registry.get_config``, ``get_model`` and the
model's ``init``, ``prefill`` and ``decode_step``, whose signatures have
stood since the port began, so that one file times two trees (this one
and a ``git archive`` of an earlier commit) by one method.  Per decode
step, the median over the repeats of

- ``wall_ms``: a synchronise, STEPS steps, a synchronise;
- ``host_ms``: the same STEPS steps up to the last step's return, before
  the synchronise: the time the host takes to enqueue a step (equal to
  ``wall_ms`` where the step is host-bound);
- ``cpu_ms``: the calling thread's CPU time over those steps;

and the launches of each kernel wrapper per step.  It prints the card's
name and power limit, then one ``{"decode": {...}}`` JSON line.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=77)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.grouped_matmul import grouped_matmul as gm
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.rglru_scan import rglru_scan as scan
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.models.api import get_model

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wrappers = {"matmul": mm, "rmsnorm": rms, "flash_attention": fa,
                "wkv6": wkv, "rglru": scan, "grouped_matmul": gm}

    cfg = registry.get_config(args.arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab,
                                      (args.batch, args.prompt))).to(dev)

    def run():
        logits, cache = model.prefill(cfg, params, x,
                                      max_seq=args.prompt + args.steps)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(args.steps):
            logits, cache = model.decode_step(cfg, params, cache, tok)
            tok = logits.argmax(-1)
        t1, c1 = time.perf_counter(), time.thread_time()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: (w.launches - before[k]) / args.steps
                    for k, w in wrappers.items()}
        return ((t2 - t0) / args.steps * 1e3, (t1 - t0) / args.steps * 1e3,
                (c1 - c0) / args.steps * 1e3, launches)

    run()                                   # warm-up: cuBLAS, allocator
    runs = [run() for _ in range(args.repeats)]
    out = {"arch": cfg.name, "batch": args.batch, "prompt": args.prompt,
           "steps": args.steps, "repeats": args.repeats, "card": card,
           "wall_ms": statistics.median(r[0] for r in runs),
           "host_ms": statistics.median(r[1] for r in runs),
           "cpu_ms": statistics.median(r[2] for r in runs),
           "wall_ms_each": [r[0] for r in runs],
           "launches_per_step": {k: n for k, n in runs[-1][3].items() if n}}
    print(json.dumps({"decode": out}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
