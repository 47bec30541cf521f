"""Device-memory planner: MATCHA's §3.2 memory planning one level up, on
the card's device memory.

The paper packs tensor lifetimes into the L2 scratchpad, choosing per
tensor between (i) static residence, (ii) swap to L3, (iii) planned
loading.  For training the same three policies appear in device memory:

  (i)   keep activations resident (no remat),
  (ii)  rematerialize (recompute instead of keeping: trades the "swap DMA"
        for the products' cycles),
  (iii) ZeRO-1 shard the fp32 optimizer moments across data-parallel
        replicas (planned gather at update time).

``plan_memory`` estimates the bytes a device holds for each policy
combination and picks the cheapest *feasible* one: the total under 0.9 of
the capacity, which is the current CUDA card's
(``torch.cuda.get_device_properties(...).total_memory``) unless the
caller names one.  This module is the JAX package's planner with only that
seam changed: the JAX package judges feasibility by a fixed per-chip
constant, the port by the card it runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

GiB = 1024.0 ** 3


@dataclasses.dataclass
class MemoryPlan:
    arch: str
    remat: bool
    zero1: bool
    microbatches: int
    est_bytes: Dict[str, float]    # component -> bytes/chip
    total: float
    feasible: bool
    notes: List[str]


def param_count(cfg: ModelConfig) -> float:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, dh = max(cfg.n_heads, 1), max(cfg.n_kv, 1), cfg.head_dim_
    per_layer = 0.0
    if cfg.family in ("dense", "vlm", "audio"):
        per_layer = D * (H + 2 * KV) * dh + H * dh * D + 3 * D * F
    elif cfg.family == "moe":
        per_layer = D * (H + 2 * KV) * dh + H * dh * D \
            + cfg.n_experts * 3 * D * F + D * cfg.n_experts
    elif cfg.family == "ssm":
        per_layer = 5 * D * D + D * F + F * D + D * D
    elif cfg.family == "hybrid":
        W = cfg.rnn_width or D
        n = len(cfg.block_pattern) or 1
        rec = 2 * D * W + 2 * W * W + W * D
        att = D * (H + 2 * KV) * dh + H * dh * D
        frac_rec = cfg.block_pattern.count("rec") / n if n else 0
        per_layer = frac_rec * rec + (1 - frac_rec) * att + 2 * D * F
    emb = V * D * (1 if cfg.input_kind != "tokens" else 2)
    return cfg.n_layers * per_layer + emb


def activation_bytes(cfg: ModelConfig, batch_per_replica: int,
                     seq: int, remat: bool, model_par: int) -> float:
    """Stored activation bytes per chip for backward.  Block inputs are
    batch-sharded only (no sequence parallelism yet), so model_par does
    NOT divide them; the CE head tensors are vocab-sharded."""
    D = cfg.d_model
    tokens = batch_per_replica * seq
    per_layer_resident = tokens * D * 2
    # fp32 logits + log-softmax for the CE head (vocab model-sharded)
    head = 3 * tokens * cfg.vocab * 4 / model_par
    if remat:
        # only the block inputs are saved
        return cfg.n_layers * per_layer_resident + head
    # ~8 tensors of (B,S,D)-class per block without remat
    return cfg.n_layers * 8 * per_layer_resident + head


def plan_memory(cfg: ModelConfig, global_batch: int, seq: int,
                dp: int, model_par: int,
                capacity_bytes: float | None = None) -> MemoryPlan:
    """The cheapest feasible policy for ``global_batch`` sequences of
    ``seq`` tokens over ``dp`` data-parallel replicas and ``model_par``
    model shards, on a device of ``capacity_bytes`` (None: the current CUDA
    card's memory; with no card, name it)."""
    if capacity_bytes is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to plan for: pass "
                               "capacity_bytes")
        capacity_bytes = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    n_params = param_count(cfg)
    bpr = max(global_batch // max(dp, 1), 1)
    notes: List[str] = []

    best = None
    # at production sequence lengths remat is strictly necessary once the
    # 8x resident-activation multiplier meets a device's memory; don't even
    # offer the no-remat point beyond 2k tokens
    remat_opts = (True,) if seq >= 2048 else (False, True)
    for remat in remat_opts:
        for zero1 in (False, True):
            for micro in (1, 2, 4, 8, 16):
                if bpr % micro != 0:
                    continue
                # grads: bf16 transients at micro=1; an fp32 accumulator
                # when accumulating, ZeRO-2-sharded over data when zero1
                # (train/step pins it via adamw.zero_specs)
                gbytes = 2 if micro == 1 else 4
                comp = {
                    "params(bf16)": 2 * n_params / model_par,
                    "grads": gbytes * n_params / model_par
                    / (dp if (zero1 and micro > 1) else 1),
                    "adam_m+v(f32)": 8 * n_params / model_par
                    / (dp if zero1 else 1),
                    "activations": activation_bytes(
                        cfg, bpr // micro, seq, remat, model_par),
                }
                total = sum(comp.values())
                feasible = total < capacity_bytes * 0.9
                cand = MemoryPlan(cfg.name, remat, zero1, micro, comp,
                                  total, feasible, notes)
                # prefer: feasible, then least remat/zero1/micro complexity,
                # then lowest total
                key = (not feasible, remat + zero1 + (micro > 1), total)
                if best is None or key < best[0]:
                    best = (key, cand)
    plan = best[1]
    if not plan.feasible:
        plan.notes.append(
            f"infeasible even with remat+zero1+micro8: "
            f"{plan.total / GiB:.1f} GiB > {capacity_bytes * 0.9 / GiB:.1f}")
    plan.notes.append(
        f"chosen remat={plan.remat} zero1={plan.zero1} "
        f"micro={plan.microbatches}: "
        + ", ".join(f"{k}={v / GiB:.2f}GiB" for k, v in
                    plan.est_bytes.items()))
    return plan
