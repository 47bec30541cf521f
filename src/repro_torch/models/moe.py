"""Mixture-of-Experts transformer family (olmoe-1b-7b, granite-moe-3b).

Token-choice top-k routing with capacity-bucketed, sort-based dispatch
(O(S*K) bookkeeping, no (N,E,C) one-hot tensors), the per-expert FFN
matmuls through the grouped-matmul kernel, and residual fall-through for
assignments past an expert's capacity.  Attention is the transformer
family's (flash attention in ``forward`` and ``prefill``, the plain
decode attention writing its KV cache in place).  Layers keep the JAX
package's slot-stacked layout (:mod:`repro_torch.models.stacking`).

The routing stays on the device: no host sync, no output whose size
depends on the data.  Ties between equal router probabilities (common,
since the router's logits are bf16) go to the lower expert index, as
``jax.lax.top_k`` orders them, and the combine adds each token's
contributions in slot order, as the JAX package's scatter-add does, in a
fixed order, so one prefill gives the same bits twice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import hints, on_mesh
from repro_torch.core.on_mesh import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import stacking as ST
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

CAPACITY_FACTOR = 1.25


def init_moe_mlp(gen, cfg: ModelConfig, device="cuda") -> Params:
    dt = cfg.param_dtype
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff

    def expert_stack(d_in, d_out):
        return torch.stack([L._dense_init(gen, (d_in, d_out), dt, device)
                            for _ in range(E)])

    return {
        "router": L.init_linear(gen, D, E, dt, device),
        "w_gate": expert_stack(D, Fd),
        "w_up": expert_stack(D, Fd),
        "w_down": expert_stack(Fd, D),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * CAPACITY_FACTOR / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)     # round up to 8


def _route_group(top_e: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """top_e: (..., S, K) chosen experts of each token group.  Returns the
    gather index (..., E*C) mapping each expert-capacity slot to a flat
    (s*K+k) assignment, with S*K as the padding sentinel for unfilled
    slots.  Sort-based dispatch: an assignment's slot is its expert's
    base plus its rank among the expert's assignments in token order;
    ranks past C go to the sentinel slot E*C, which is cut off."""
    S, K = top_e.shape[-2:]
    lead = top_e.shape[:-2]
    flat = top_e.reshape(*lead, S * K).long()                # (..., S*K)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, -1, order)
    counts = F.one_hot(flat, E).sum(-2)                      # (..., E)
    offsets = torch.cumsum(counts, -1) - counts
    rank = torch.arange(S * K, device=flat.device) \
        - torch.gather(offsets, -1, sorted_e)                # pos in expert
    slot = torch.where(rank < C, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    gather = torch.full((*lead, E * C + 1), S * K, dtype=torch.long,
                        device=flat.device)
    gather.scatter_(-1, slot, order)
    return gather[..., :E * C]


def _top_k(probs: torch.Tensor, K: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K largest of the last axis, ties to the lower index first (the
    order of ``jax.lax.top_k``; ``torch.topk`` gives none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _dispatch(top_e: torch.Tensor, x: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather (B,E*C), x's rows in expert-capacity slots (B,E*C,D)): each
    batch row's own bookkeeping, padding slots reading a zero row."""
    B, S, D = x.shape
    K = top_e.shape[-1]
    gather = _route_group(top_e, E, C)                       # (B,E*C)
    token_idx = torch.clamp(gather // K, max=S)              # pad -> row S
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    b_idx = torch.arange(B, device=x.device)[:, None]
    return gather, xpad[b_idx, token_idx]                    # (B,E*C,D)


def _combine(y: torch.Tensor, top_p: torch.Tensor, gather: torch.Tensor
             ) -> torch.Tensor:
    """Each token's output (B,S,D) from the experts' slots y (B,E*C,D):
    each slot weighted by its router prob, then each token's slots added
    in ascending slot order (the JAX package's scatter-add order)."""
    B, EC, D = y.shape
    S, K = top_p.shape[1:]
    ppad = torch.cat([top_p.reshape(B, S * K), top_p.new_zeros((B, 1))], 1)
    w_slot = torch.gather(ppad, 1, torch.clamp(gather, max=S * K))
    contrib = y * w_slot[..., None].to(y.dtype)              # (B,E*C,D)
    contrib = torch.cat([contrib, contrib.new_zeros((B, 1, D))], dim=1)
    # each assignment's slot (E*C when it was dropped: the zero row)
    assign_slot = torch.full((B, S * K + 1), EC, dtype=torch.long,
                             device=y.device)
    assign_slot.scatter_(1, gather, torch.arange(EC, device=y.device)
                         .expand(B, EC))
    slots = torch.sort(assign_slot[:, :S * K].reshape(B, S, K), -1).values
    b_idx = torch.arange(B, device=y.device)[:, None]
    out = torch.zeros((B, S, D), dtype=y.dtype, device=y.device)
    for k in range(K):
        out = out + contrib[b_idx, slots[..., k]]
    return out


def moe_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D).  Top-k routing; capacity C per (batch-row)
    group; assignments past capacity fall back to the residual path.  The
    routing, dispatch and combine are each batch row's own, and on a mesh
    run on each rank's rows (``on_mesh.rowwise``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)

    logits = L.linear(p["router"], x).float()                # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)                          # (B,S,K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    gather, xdisp = on_mesh.rowwise(
        lambda te, xl: _dispatch(te, xl, E, C), top_e, x, outputs=2)
    xdisp = xdisp.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    xdisp = hints.constraint(xdisp, "moe_dispatch")

    g = on_mesh.grouped_matmul(xdisp, p["w_gate"])           # (E,BC,F)
    u = on_mesh.grouped_matmul(xdisp, p["w_up"])
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    h = hints.constraint(h, "moe_hidden")
    y = on_mesh.grouped_matmul(h, p["w_down"])               # (E,BC,D)
    y = hints.constraint(y, "moe_out")
    y = y.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    return on_mesh.rowwise(_combine, y, top_p, gather)


def _init_block(gen, cfg: ModelConfig, i: int, device) -> Params:
    dt = cfg.param_dtype
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(gen, T._attn_cfg(cfg, i), dt, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "moe": init_moe_mlp(gen, cfg, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random params drawn from ``gen`` (a generator on ``device``)."""
    dt = cfg.param_dtype
    p: Params = {"embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                           device)}
    slots, tail = ST.init_stacked(
        lambda i: _init_block(gen, cfg, i, device), cfg.n_layers, cfg.unit)
    p["blocks"] = slots
    p["tail"] = tail
    p["ln_f"] = L.init_rmsnorm(cfg.d_model, dt, device)
    p["head"] = L.init_linear(gen, cfg.d_model, cfg.vocab, dt, device)
    return p


def forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """x: (B,S) int tokens -> logits (B,S,V); ``remat``
    recomputes each repeating unit in backward
    (:func:`~repro_torch.models.stacking.scan_blocks`)."""
    h = L.embed(p["embed"], x)
    B, S = h.shape[:2]
    positions = T._positions(B, S, h.device)

    def body(h, blk, u, g):
        a = L.attention(blk["attn"], T._attn_cfg(cfg, u),
                        L.rmsnorm(blk["ln1"], h), positions)
        h = h + a
        return h + moe_mlp(blk["moe"], cfg, L.rmsnorm(blk["ln2"], h))

    h = ST.scan_blocks(h, p["blocks"], p["tail"], body, cfg.unit,
                       cfg.n_layers, remat)
    h = L.rmsnorm(p["ln_f"], h)
    return L.linear(p["head"], h).float()


init_cache = T.init_cache


def decode_step(cfg: ModelConfig, p: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token: (B,) int -> (logits (B,V), cache).  The cache's k/v tensors
    are updated in place; the returned cache holds them and the advanced
    ``pos``."""
    pos = cache["pos"]
    h = L.embed(p["embed"], token[:, None])

    def body(h, blk, lc, u):
        acfg = T._attn_cfg(cfg, u)
        a, _, _ = L.attention_decode(
            blk["attn"], acfg, L.rmsnorm(blk["ln1"], h),
            lc["k"], lc["v"], pos)
        h = h + a
        return h + moe_mlp(blk["moe"], cfg, L.rmsnorm(blk["ln2"], h))

    h, slots, tail = ST.scan_blocks_cached(
        h, p["blocks"], p["tail"], cache["slots"], cache["tail"],
        body, cfg.unit, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h)[:, 0].float()
    return logits, {"slots": slots, "tail": tail, "pos": pos + 1}


def prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, max_seq: int
            ) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt, materializing the KV cache: returns (logits of
    the last position (B,V), cache ready for decode)."""
    B, S = x.shape[:2]
    h = L.embed(p["embed"], x)
    positions = T._positions(B, S, h.device)

    def body(h, blk, u):
        acfg = T._attn_cfg(cfg, u)
        xn = L.rmsnorm(blk["ln1"], h)
        q, k, v = L.attention_qkv(blk["attn"], acfg, xn, positions)
        ctx = flash_attention(q, k, v, causal=True, window=acfg.window)
        h = h + L.linear(blk["attn"]["wo"], ctx.reshape(B, S, -1))
        h = h + moe_mlp(blk["moe"], cfg, L.rmsnorm(blk["ln2"], h))
        return h, T.ring_cache(k, v, T.cache_len(cfg, u, max_seq))

    h, slots, tail = ST.scan_blocks_collect(
        h, p["blocks"], p["tail"], body, cfg.unit, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h[:, -1]).float()
    return logits, {"slots": slots, "tail": tail,
                    "pos": torch.full((B,), S, dtype=torch.int32,
                                      device=h.device)}
