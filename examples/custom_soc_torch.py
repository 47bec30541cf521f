"""The PyTorch port's twin of ``examples/custom_soc.py`` (Table 1 "Device
Extension"): define a custom heterogeneous SoC -- host + a systolic GEMM
NPU + a SIMD DSP -- with its own kernel pattern catalogue, compile a
transformer block for it through ``repro_torch``, and check each plan
numerically on the CUDA card by default, or on the CPU with
``--device cpu``.

    python examples/custom_soc_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.api import compile_model  # noqa: E402
from repro_torch.core.patterns import chain, wildcard  # noqa: E402
from repro_torch.core.runtime import plan_matches_oracle  # noqa: E402
from repro_torch.models import edge  # noqa: E402
from repro_torch.soc.device import Device, MemoryLevel, SoC  # noqa: E402

KiB = 1024
MiB = 1024 * KiB


def my_soc() -> SoC:
    host = Device("cpu", alpha=1.5,
                  l1=MemoryLevel("cpu_l1", 64 * KiB, 8.0),
                  dma_bandwidth=8.0, is_host=True, copy_bandwidth=0.5)
    npu = Device("npu", alpha=0.1,           # systolic GEMM engine
                 l1=MemoryLevel("npu_l1", 512 * KiB, 32.0),
                 dma_bandwidth=16.0)
    dsp = Device("dsp", alpha=0.8,           # SIMD vector DSP
                 l1=MemoryLevel("dsp_l1", 128 * KiB, 16.0),
                 dma_bandwidth=8.0)
    return SoC(name="my_soc", devices={"cpu": host, "npu": npu,
                                       "dsp": dsp},
               l2=MemoryLevel("l2", 2 * MiB, 32.0),
               l3=MemoryLevel("l3", 256 * MiB, 8.0),
               dma_l3_bandwidth=8.0, mailbox_latency=150.0, freq_mhz=200.0)


def my_patterns():
    ps = []
    # NPU: GEMM-class ops only, very efficient, high invocation cost
    for ops_, eta in [(["dense"], 0.85), (["dense", "bias_add"], 0.85),
                      (["matmul"], 0.85), (["batch_matmul"], 0.80),
                      (["conv2d"], 0.75),
                      (["conv2d", "bias_add", "relu"], 0.75)]:
        ps.append(chain("npu", "npu_" + "_".join(ops_), ops_, eta, 4000.0))
    # DSP: elementwise/activations + small convs
    for ops_, eta in [(["add"], 0.7), (["add", "relu"], 0.7),
                      (["dwconv2d"], 0.6),
                      (["dense"], 0.35), (["softmax"], 0.5)]:
        ps.append(chain("dsp", "dsp_" + "_".join(ops_), ops_, eta, 800.0))
    ps.append(wildcard("cpu", eta=0.3, delta=200.0))
    return ps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the plans execute: cuda, or cpu")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")

    soc, pats = my_soc(), my_patterns()
    g = edge.transformer_block()
    results = {}
    for mode in ("match", "matcha"):
        cm = compile_model(g, soc, pats, mode=mode, time_budget_s=3.0)
        assert plan_matches_oracle(cm.plan, device=args.device)
        results[mode] = cm
        print(f"{mode:8s} {cm.makespan_cycles / 1e3:9.1f}k cycles  "
              f"util={ {d: f'{u:.0%}' for d, u in cm.plan.utilization().items()} }")
    return results


if __name__ == "__main__":
    main()
