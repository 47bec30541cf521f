"""The PyTorch port's twin of ``examples/quickstart.py``: compile a DNN for
the Carfield heterogeneous SoC with the four toolchains of the paper,
validate the tiled plan numerically, inspect the schedule, and emit the
multi-ISA deployment artifact -- through ``repro_torch``, with the tiled
plan executed on the CUDA card by default (the hand-written GEMM and
RMSNorm kernels), or on the CPU with ``--device cpu`` (their plain
versions).

    python examples/quickstart_torch.py [--device cpu] [--out DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.api import compile_model  # noqa: E402
from repro_torch.core.runtime import plan_matches_oracle  # noqa: E402
from repro_torch.models import edge  # noqa: E402
from repro_torch.soc.carfield import (carfield_patterns,  # noqa: E402
                                      carfield_soc)

OUT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "quickstart_deploy")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the plans execute: cuda, or cpu")
    ap.add_argument("--out", default=OUT,
                    help="directory for the deployment artifact")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")

    soc = carfield_soc()
    patterns = carfield_patterns()
    graph = edge.autoencoder()          # MLPerf-Tiny anomaly detection

    print(f"model: {graph.name}  "
          f"({graph.total_macs() / 1e6:.2f} M MACs, "
          f"{graph.total_params() / 1e3:.0f} k params)\n")

    results = {}
    for mode in ("tvm", "match", "matcha_nt", "matcha"):
        cm = compile_model(graph, soc, patterns, mode=mode,
                           time_budget_s=3.0)
        # tiled exec == direct exec
        assert plan_matches_oracle(cm.plan, device=args.device)
        results[mode] = cm
        util = cm.plan.utilization()
        print(f"{mode:10s} {cm.runtime_ms:8.2f} ms   "
              f"util: " + "  ".join(f"{d}={u:.0%}"
                                    for d, u in util.items()
                                    if d != "dma"))

    m, a = results["match"], results["matcha"]
    print(f"\nMATCHA vs MATCH: "
          f"{100 * (1 - a.makespan_cycles / m.makespan_cycles):.1f}% "
          f"latency reduction (paper: 33.3%)")

    files = a.emit(args.out)
    print(f"\nemitted {len(files)} deployment files to {args.out}/:")
    for f in sorted(files):
        print(f"  {f}")
    return {"compiled": results, "files": files}


if __name__ == "__main__":
    main()
