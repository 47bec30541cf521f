"""Decoder / encoder transformer family.

Covers the dense architectures (internlm2, qwen3-8b/32b with qk-norm,
gemma3 with 5:1 local:global interleaving), the VLM backbone
(llava-next-mistral-7b — the anyres frontend is a stub that feeds
precomputed patch embeddings), and the audio encoder (hubert-xlarge,
bidirectional, no decode path).

All weights are plain trees of tensors in the JAX package's layout:
layers stacked per repeating slot (:mod:`repro_torch.models.stacking`).
``forward`` is the full-sequence path, ``prefill``/``decode_step`` the
serving paths over a stacked KV cache (ring buffers of size ``window`` on
local layers).  Prefill attention runs through the flash-attention kernel;
``decode_step`` updates the cache tensors in place and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.on_mesh import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import stacking as ST
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _attn_cfg(cfg: ModelConfig, u: int) -> L.AttnConfig:
    kind = cfg.layer_kind(u)
    window = cfg.window if kind == "local" else None
    return L.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv, head_dim=cfg.head_dim_,
                        qk_norm=cfg.qk_norm, window=window,
                        rope_theta=cfg.rope_theta, causal=cfg.causal)


def _init_block(gen, cfg: ModelConfig, i: int, device) -> Params:
    dt = cfg.param_dtype
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(gen, _attn_cfg(cfg, i), dt, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random params drawn from ``gen`` (a generator on ``device``)."""
    dt = cfg.param_dtype
    p: Params = {}
    if cfg.input_kind == "tokens":
        p["embed"] = L.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device)
    slots, tail = ST.init_stacked(
        lambda i: _init_block(gen, cfg, i, device), cfg.n_layers, cfg.unit)
    p["blocks"] = slots
    p["tail"] = tail
    p["ln_f"] = L.init_rmsnorm(cfg.d_model, dt, device)
    p["head"] = L.init_linear(gen, cfg.d_model, cfg.vocab, dt, device)
    return p


def _embed_in(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.input_kind == "tokens":
        return L.embed(p["embed"], x)
    return x.to(cfg.param_dtype)          # precomputed frame/patch embeds


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """x: (B,S) int tokens or (B,S,D) embeds -> logits (B,S,V); ``remat``
    recomputes each repeating unit in backward
    (:func:`~repro_torch.models.stacking.scan_blocks`)."""
    h = _embed_in(cfg, p, x)
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)

    def body(h, blk, u, g):
        a = L.attention(blk["attn"], _attn_cfg(cfg, u),
                        L.rmsnorm(blk["ln1"], h), positions)
        h = h + a
        return h + L.swiglu(blk["mlp"], L.rmsnorm(blk["ln2"], h))

    h = ST.scan_blocks(h, p["blocks"], p["tail"], body, cfg.unit,
                       cfg.n_layers, remat)
    h = L.rmsnorm(p["ln_f"], h)
    return L.linear(p["head"], h).float()


# ---------------------------------------------------------------------------
# Serving: KV-cache prefill / decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, u: int, max_seq: int) -> int:
    """Local layers only ever need a window-sized cache."""
    if cfg.layer_kind(u) == "local" and cfg.window:
        return min(cfg.window, max_seq)
    return max_seq


def _empty_cache_entry(cfg: ModelConfig, u: int, batch: int, max_seq: int,
                       device, G: Tuple[int, ...] = ()):
    Sl = cache_len(cfg, u, max_seq)
    shape = G + (batch, Sl, cfg.n_kv, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Params:
    unit = cfg.unit
    G = cfg.n_layers // unit
    slots = [_empty_cache_entry(cfg, u, batch, max_seq, device, (G,))
             for u in range(unit)]
    tail = [_empty_cache_entry(cfg, (G * unit + j) % unit, batch, max_seq,
                               device)
            for j in range(cfg.n_layers - G * unit)]
    return {"slots": slots, "tail": tail,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def ring_cache(k: torch.Tensor, v: torch.Tensor, Sl: int) -> Params:
    """A prompt's k/v (B,S,KV,Dh) as a cache of Sl slots: the last
    min(S, Sl) positions, each at slot ``position % Sl``."""
    B, S = k.shape[:2]
    take = min(S, Sl)
    shift = (S - take) % Sl
    ck = k.new_zeros((B, Sl) + tuple(k.shape[2:]))
    cv = torch.zeros_like(ck)
    ck[:, :take] = k[:, S - take:]
    cv[:, :take] = v[:, S - take:]
    if shift:
        ck = torch.roll(ck, shift, dims=1)
        cv = torch.roll(cv, shift, dims=1)
    return {"k": ck, "v": cv}


def _ring(cfg: ModelConfig, u: int, Sl: int) -> bool:
    return cfg.layer_kind(u) == "local" and bool(cfg.window) \
        and Sl <= (cfg.window or 0)


def decode_step(cfg: ModelConfig, p: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token: (B,) int — or (B, D) embeds for embeds-input backbones —
    -> (logits (B,V), cache).  The cache's k/v tensors are updated in
    place; the returned cache holds them and the advanced ``pos``."""
    pos = cache["pos"]                                   # (B,)
    if cfg.input_kind == "tokens":
        h = _embed_in(cfg, p, token[:, None])
    else:
        h = token[:, None, :].to(cfg.param_dtype)        # (B,1,D)

    def body(h, blk, lc, u):
        acfg = _attn_cfg(cfg, u)
        Sl = lc["k"].shape[1]
        if _ring(cfg, u, Sl):
            write_idx = pos % Sl
            slots = torch.arange(Sl, device=pos.device)
            valid = (slots[None, :] <= pos[:, None]) | (pos[:, None] >= Sl)
            acfg = dataclasses.replace(acfg, window=None)
        else:
            write_idx, valid = pos, None
        a, _, _ = L.attention_decode(
            blk["attn"], acfg, L.rmsnorm(blk["ln1"], h),
            lc["k"], lc["v"], pos, write_idx=write_idx, valid=valid)
        h = h + a
        return h + L.swiglu(blk["mlp"], L.rmsnorm(blk["ln2"], h))

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
    h = _embed_in(cfg, p, x)
    positions = _positions(B, S, h.device)

    def body(h, blk, u):
        acfg = _attn_cfg(cfg, u)
        xn = L.rmsnorm(blk["ln1"], h)
        q, k, v = L.attention_qkv(blk["attn"], acfg, xn, positions)
        ctx = flash_attention(q, k, v, causal=acfg.causal,
                              window=acfg.window)
        h = h + L.linear(blk["attn"]["wo"], ctx.reshape(B, S, -1))
        h = h + L.swiglu(blk["mlp"], L.rmsnorm(blk["ln2"], h))
        return h, ring_cache(k, v, cache_len(cfg, u, max_seq))

    h, slots, tail = ST.scan_blocks_collect(
        h, p["blocks"], p["tail"], body, cfg.unit, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h[:, -1]).float()
    return logits, {"slots": slots, "tail": tail,
                    "pos": torch.full((B,), S, dtype=torch.int32,
                                      device=h.device)}
