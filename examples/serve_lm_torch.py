"""The PyTorch port's twin of ``examples/serve_lm.py``: co-scheduled LM +
vision serving through ``repro_torch.launch.serve``.  Like the original
it runs the analytic timing model by default; ``--execute`` also runs
each served round numerically, on the CUDA card (the hand-written GEMM and
RMSNorm kernels) unless ``--device cpu`` puts it on the CPU (their plain
versions).

    python examples/serve_lm_torch.py [--lm rwkv6] [--execute] [--device cpu]

What this demonstrates, step by step:

1.  **One engine, two kinds of tenant.**  A fixed-shape vision-style
    graph and a shape-bucketed LM tenant (``lm_tenant`` pairs the LM's
    default prefill graph with a ``ShapeBucketSpec`` — power-of-two
    sequence buckets from 1, the decode shape, up to ``max_seq``) are
    compiled into one ``DeploymentSession``.  There is no separate
    token-loop engine for the LM: prefill and decode are ordinary
    bucketed requests to the same ``MultiModelEngine``.

2.  **Prefill, then decode, through the same queue.**  A prompt of
    length L submits as ``submit(lm, seq_len=L)`` — the spec rounds L up
    to its bucket — and each generated token submits as
    ``submit(lm, seq_len=1)``.  The engine resolves every round's plan
    at the ``(occupancy, bucket-vector)`` lattice point of the queued
    heads, so a decode round co-schedules with the vision tenant under a
    plan priced for seq=1, not for the prefill shape.

3.  **The bucket-transition prefetch.**  The attached
    ``BackgroundCompiler`` (deterministic no-thread mode here) watches
    dispatched lattice points and walks one Hamming step along the
    lattice — occupancy joins/leaves and one-rung bucket ladder moves,
    with the step toward seq=1 weighted double.  After the first prefill
    round it is already compiling the decode-bucket plan, so the
    prefill->decode transition lands on a warm plan instead of a floor
    round.

Run with ``--no-prefetch`` to watch the same trace pay floor rounds at
every bucket transition instead.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.launch.serve import serve  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lm", default="rwkv6",
                    choices=["rwkv6", "rglru", "transformer"])
    ap.add_argument("--prompts", type=int, default=3)
    ap.add_argument("--decode-steps", type=int, default=6)
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--execute", action="store_true",
                    help="run the numeric execution, not just the "
                         "analytic timing model")
    ap.add_argument("--device", default="cuda",
                    help="where the parameters live and --execute runs: "
                         "cuda, or cpu")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    rep = serve(args.lm, n_prompts=args.prompts,
                decode_steps=args.decode_steps,
                prefetch=not args.no_prefetch, execute=args.execute,
                device=args.device)
    print(f"  starvation events: {rep['starvation_events']}, "
          f"slo attainment: {rep['slo_attainment']}")
    return rep


if __name__ == "__main__":
    main()
