"""The readings that the limits of ``correct`` are set from, for one cell
at its own size, without the program: the control (the reference in
fp8, put in the program's place) and the faults planted in the fp32
reference put in the program's place, each compared with the fp32
reference as a run compares the program.

    python3 portbench/harness/control.py --workload <name> --seeds 1 2 3

Training: ``fp8`` (every product's operands rounded to e4m3 with a
per-tensor scale) and ``half_batch`` (each step's loss the mean over the
first half of its rows).  Serving: ``fp8`` over the requests a run
checks, with ``served`` requests in its window.  ``--program`` adds the
program's own readings: a whole run of the cell (its set-up, a window of
``--seconds`` and the reference), seed after seed in this one process.
One JSON line a seed and reading.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def train_readings(cell, seed: int, device) -> dict:
    from portbench.harness import checks
    from portbench.reference import decoder as ref
    exact = checks.reference_train(cell.config, cell.mix, seed, device)
    out = {"fp8": checks.train_numbers(
        checks.reference_train(cell.config, cell.mix, seed, device,
                               ref.FP8), exact)}
    half = dict(cell.mix, batch=cell.mix["batch"] // 2,
                microbatches=max(1, cell.mix["microbatches"] // 2))
    # the first half of each step's rows: train_rows makes row r from
    # (seed, step, r) alone, so the half batch is the full one's first rows
    out["half_batch"] = checks.train_numbers(
        checks.reference_train(cell.config, half, seed, device), exact)
    return out


def serve_readings(cell, seed: int, device, served: int) -> dict:
    from portbench.harness import checks, traffic
    prompts = traffic.Prompts(cell.mix, cell.config["vocab_size"], seed)
    cached = checks.cache_sample(cell.mix, seed, prompts)
    requests = checks.logits_sample(cell.mix, seed, served, cached)
    control = checks.control_serve_tokens(cell.config, cell.mix, seed, device,
                                          requests, cached)
    return {"fp8": checks.reference_serve(cell.config, cell.mix, seed,
                                          device, control)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--served", type=int, default=400,
                    help="requests a serving window serves")
    ap.add_argument("--program", action="store_true",
                    help="also the program's readings, from short runs")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the window of a --program run")
    ap.add_argument("--no-control", action="store_true",
                    help="the program's readings alone")
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import cell as C
    cell = C.load(args.workload)
    device = torch.device("cuda", 0)
    cfg = C.port_config(cell.config) if args.program else None
    for seed in args.seeds:
        t = time.perf_counter()
        got = {}
        if args.program:
            run = C.execute(cell, seed, args.seconds, False, device,
                            time.perf_counter(), cfg=cfg)
            got["program"] = {k: (v, at) for k, (v, _, at)
                              in run["checks"].items()}
            got["program_correct"] = run["correct"]
        if args.no_control:
            pass
        elif cell.mix["kind"] == "train":
            got.update(train_readings(cell, seed, device))
        else:
            got.update(serve_readings(cell, seed, device, args.served))
        for what, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": what, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
