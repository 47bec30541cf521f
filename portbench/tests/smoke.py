"""Cells cut to the port's smoke sizes, for the CPU tests: the
configuration's widths from ``registry.get_smoke_config`` and the mix's
batch, lengths and samples made small."""

from __future__ import annotations

import dataclasses
import json

from portbench.harness import cell as C

# The serving driver's cell.  BENCHMARK.json holds no serving cell until a
# mix of prompt lengths taken from a published trace or benchmark is
# added; these tests keep the driver, its check and its faults working.
# The limits are those read on the card for internlm2-1.8b's prefill of
# 1k-8k-token prompts (PERF.md).
SERVING_LIMITS = {"token_gap": 0.2, "logits": 0.07, "kv": 0.065}
SERVING_E2E = (("prefill_tokens_per_s", "tokens/s"), ("ttft_p95_ms", "ms"),
               ("setup_s", "s"))
SERVING_LAYERS = (("mfu.prefill", "%"), ("flash_attention_roofline.prefill",
                                         "%"),
                  ("idle_share.prefill", "%"), ("prefill_host_ms", "ms"))


def _at_smoke_size(cell: C.Cell, dtype: str):
    from repro_torch.configs import registry
    s = dataclasses.replace(registry.get_smoke_config(cell.config["arch"]),
                            dtype=dtype)
    s = C.with_options(s, cell.config)
    sizes = dict(num_hidden_layers=s.n_layers, hidden_size=s.d_model,
                 num_attention_heads=s.n_heads,
                 num_key_value_heads=s.n_kv, head_dim=s.head_dim_,
                 intermediate_size=s.d_ff, vocab_size=s.vocab,
                 torch_dtype=dtype)
    if s.n_experts:
        sizes.update(num_local_experts=s.n_experts,
                     num_experts_per_tok=s.top_k)
    cell.config = dict(cell.config, **sizes)
    if cell.mix["kind"] == "train":
        small = {"batch": 2 * cell.mix["microbatches"], "seq": 48,
                 "documents": {"median": 20, "sigma": 0.9, "min": 4,
                               "max": 200}}
    else:
        small = {"prompts": {"median": 64, "sigma": 0.6, "min": 24,
                             "max": 160, "count": 6},
                 "cache_extra": 8, "check_requests": 3, "check_caches": 2,
                 "trace_requests": 2}
    cell.mix = dict(cell.mix, **small)
    return cell, s


def smoke_cell(workload: str, dtype: str = "bfloat16"):
    """(cell, the port's configuration) at smoke size, in ``dtype``."""
    return _at_smoke_size(C.load(workload), dtype)


def serving_cell(dtype: str = "bfloat16"):
    """(the serving driver's internlm2-1.8b cell, the port's configuration)
    at smoke size, in ``dtype``."""
    config = json.loads((C.BENCH / "configs" / "internlm2-1.8b.json")
                        .read_text())
    cell = C.Cell("internlm2-1.8b.prefill", 1, config,
                  {"kind": "prefill", "clients": 1}, dict(SERVING_LIMITS),
                  [{"name": n, "unit": u} for n, u in SERVING_E2E],
                  [{"name": n, "unit": u} for n, u in SERVING_LAYERS])
    return _at_smoke_size(cell, dtype)
