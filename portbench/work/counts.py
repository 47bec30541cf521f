"""Operations and bytes: of a model step (for the ``mfu`` metrics) and of
one kernel call (for the ``*_roofline`` metrics), from shapes alone.

The kernels' counts are the definitions of the port's kernel table
(``PERF.md``): a call's least time is the larger of its operations over
the peak of its inputs' type and its bytes over the memory's rate, each
input read once and each output written once.  Flash attention counts
the (query, key) pairs its mask allows: forward two products of
2 * pairs * Dh, backward five (the scores recomputed, dP, dV, dQ, dK).
The grouped matmul counts every row it is handed, capacity padding
included.

A model step's operations are the model's and not the program's: 2 a
multiply-add of every weight a token takes part in (the router and its
top-k experts, the output head; not the embedding lookup), plus causal
attention's two products, forward only for a prefill and three times
that for a training step; recomputation is not counted.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds the card takes for the work."""
    return max(flops / PEAKS["flops_per_s"][dtype],
               nbytes / PEAKS["bytes_per_s"])


def attention_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs an S-token self-attention's mask allows: causal
    keys d = q - k >= 0, a window keeps d < window."""
    if window is None or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    w = max(int(window), 0)
    if w == 0:
        return 0
    one_side = w * S - w * (w - 1) // 2
    return one_side if causal else 2 * one_side - S


def flash_attention(B: int, S: int, H: int, KV: int, Dh: int, causal: bool,
                    window: Optional[int], itemsize: int
                    ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """((forward flops, bytes), (backward flops, bytes)) of one call."""
    pairs = attention_pairs(S, causal, window)
    q, kv = B * S * H * Dh, B * S * KV * Dh
    fwd = (4.0 * B * H * Dh * pairs, (2 * q + 2 * kv) * itemsize)
    # q, out, dO read and dq written; k, v read and dk, dv written
    bwd = (10.0 * B * H * Dh * pairs, (4 * q + 4 * kv) * itemsize)
    return fwd, bwd


def grouped_matmul(E: int, C: int, D: int, F: int, itemsize: int
                   ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """((forward flops, bytes), (backward flops, bytes)) of x (E,C,D) @
    w (E,D,F): the backward's dx and dw read x, w and dy and write dx, dw."""
    x, w, y = E * C * D, E * D * F, E * C * F
    return ((2.0 * E * C * D * F, (x + w + y) * itemsize),
            (4.0 * E * C * D * F, (2 * x + 2 * w + y) * itemsize))


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by in one forward pass, the output head
    included (a training position and a served last position)."""
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    attn = D * H * Dh * 2 + D * KV * Dh * 2
    F = cfg["intermediate_size"]
    E = cfg.get("num_local_experts", 0)
    mlp = (D * E + cfg["num_experts_per_tok"] * 3 * D * F) if E \
        else 3 * D * F
    return L * (attn + mlp) + D * cfg["vocab_size"]


def attention_flops(cfg: dict, S: int, rows: int) -> float:
    """Forward flops of causal attention over ``rows`` sequences of S."""
    return (4.0 * rows * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * attention_pairs(S, True, None))


def train_step_flops(cfg: dict, rows: int, seq: int) -> float:
    """A training step over ``rows`` sequences of ``seq`` tokens:
    forward and backward (3 times the forward)."""
    return 3.0 * (2.0 * matmul_params_per_token(cfg) * rows * seq
                  + attention_flops(cfg, seq, rows))


def prefill_flops(cfg: dict, S: int) -> float:
    """One prompt's prefill: every position through the layers, the head
    at the last position only."""
    head = cfg["hidden_size"] * cfg["vocab_size"]
    body = matmul_params_per_token(cfg) - head
    return 2.0 * body * S + 2.0 * head + attention_flops(cfg, S, 1)
