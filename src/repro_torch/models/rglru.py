"""RecurrentGemma (Griffin) — hybrid RG-LRU + local-attention LM.

Block pattern (rec, rec, attn): two recurrent blocks per local-attention
block.  The recurrent block is Griffin's:

    x -> RMSNorm -> [branch a: Linear -> GeLU]                 (gate)
                    [branch b: Linear -> Conv1D(4) -> RG-LRU]
    y = gate * rglru_out -> Linear -> residual

RG-LRU:  r_t = sigmoid(W_a x_t); i_t = sigmoid(W_x x_t)
         log a_t = -c * softplus(L) * r_t          (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The diagonal recurrence runs in the RG-LRU scan kernel (prefill /
forward; a and b cast to the model dtype first) and in plain fp32 torch
in ``decode_step``, both as in the JAX package.  Local attention runs
through the flash-attention kernel in prefill and the plain decode
attention against a window-sized ring cache in decode.  Decode state per
recurrent block: h (B, W) fp32 + the conv history (B, K-1, W); the cache
tensors are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.on_mesh import flash_attention, rglru
from repro_torch.models import layers as L
from repro_torch.models import stacking as ST
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ring_cache

Params = Dict[str, Any]

LRU_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rnn_width or cfg.d_model


def init_rec_block(gen, cfg: ModelConfig, device="cuda") -> Params:
    dt = cfg.param_dtype
    D, W = cfg.d_model, _width(cfg)
    return {
        "ln": L.init_rmsnorm(D, dt, device),
        "w_gate": L.init_linear(gen, D, W, dt, device),
        "w_x": L.init_linear(gen, D, W, dt, device),
        "conv": (torch.randn((cfg.conv_width, W), generator=gen,
                             device=device, dtype=torch.float32)
                 * 0.1).to(dt),
        "wa": L.init_linear(gen, W, W, dt, device),
        "wi": L.init_linear(gen, W, W, dt, device),
        "lam": torch.full((W,), 0.7, dtype=dt, device=device),
        "w_out": L.init_linear(gen, W, D, dt, device),
    }


def _attn_cfg(cfg: ModelConfig) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv, head_dim=cfg.head_dim_,
                        window=cfg.window, rope_theta=cfg.rope_theta,
                        causal=True)


def _init_block(gen, cfg: ModelConfig, i: int, device) -> Params:
    dt = cfg.param_dtype
    if cfg.layer_kind(i) == "rec":
        blk = {"rec": init_rec_block(gen, cfg, device)}
    else:
        blk = {"ln1": L.init_rmsnorm(cfg.d_model, dt, device),
               "attn": L.init_attention(gen, _attn_cfg(cfg), dt, device)}
    blk["ln2"] = L.init_rmsnorm(cfg.d_model, dt, device)
    blk["mlp"] = L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return blk


def init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random params drawn from ``gen`` (a generator on ``device``)."""
    dt = cfg.param_dtype
    embed = L.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device)
    slots, tail = ST.init_stacked(lambda i: _init_block(gen, cfg, i, device),
                                  cfg.n_layers, cfg.unit)
    return {"embed": embed, "blocks": slots, "tail": tail,
            "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
            "head": L.init_linear(gen, cfg.d_model, cfg.vocab, dt, device)}


def _conv1d(conv: torch.Tensor, x: torch.Tensor,
            x_hist: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, width K: x (B,T,W), x_hist (B,K-1,W); the
    taps apply reversed (``conv[K-1-j]`` to the j-th oldest input)."""
    K = conv.shape[0]
    T = x.shape[1]
    xc = torch.cat([x_hist, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(K):
        out = out + xc[:, j:j + T].float() * conv[K - 1 - j].float()
    return out.to(x.dtype)


def _lru_gates(rec: Params, xb: torch.Tensor):
    """The recurrence's a and b (fp32) from the conv output xb."""
    r = torch.sigmoid(L.linear(rec["wa"], xb).float())
    i = torch.sigmoid(L.linear(rec["wi"], xb).float())
    log_a = -LRU_C * F.softplus(rec["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.float())
    return a, b


def _new_hist(cfg: ModelConfig, hist: torch.Tensor,
              xb_raw: torch.Tensor) -> torch.Tensor:
    K = cfg.conv_width
    return torch.cat([hist, xb_raw], dim=1)[:, -(K - 1):] if K > 1 else hist


def rec_block(rec: Params, cfg: ModelConfig, h: torch.Tensor,
              conv_hist: torch.Tensor):
    """Full-sequence recurrent mixer.  Returns (out, new conv hist, h_T)."""
    xn = L.rmsnorm(rec["ln"], h)
    gate = F.gelu(L.linear(rec["w_gate"], xn).float(), approximate="tanh")
    xb_raw = L.linear(rec["w_x"], xn)
    xb = _conv1d(rec["conv"], xb_raw, conv_hist)
    a, b = _lru_gates(rec, xb)
    hs, hT = rglru(a.to(xn.dtype), b.to(xn.dtype))
    y = (gate * hs.float()).to(h.dtype)
    return (L.linear(rec["w_out"], y), _new_hist(cfg, conv_hist, xb_raw),
            hT)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _zero_hist(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((h.shape[0], cfg.conv_width - 1, _width(cfg)),
                       dtype=h.dtype, device=h.device)


def forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """x: (B,S) int tokens -> logits (B,S,V); ``remat``
    recomputes each repeating unit in backward
    (:func:`~repro_torch.models.stacking.scan_blocks`)."""
    h = L.embed(p["embed"], x)
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)
    zero_hist = _zero_hist(cfg, h)

    def body(h, blk, u, g):
        if cfg.layer_kind(u) == "rec":
            a, _, _ = rec_block(blk["rec"], cfg, h, zero_hist)
            h = h + a
        else:
            h = h + L.attention(blk["attn"], _attn_cfg(cfg),
                                L.rmsnorm(blk["ln1"], h), positions)
        return h + L.gelu_mlp(blk["mlp"], L.rmsnorm(blk["ln2"], h))

    h = ST.scan_blocks(h, p["blocks"], p["tail"], body, cfg.unit,
                       cfg.n_layers, remat)
    h = L.rmsnorm(p["ln_f"], h)
    return L.linear(p["head"], h).float()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _cache_entry(cfg: ModelConfig, u: int, batch: int, max_seq: int,
                 device, G: Tuple[int, ...] = ()):
    dt = cfg.param_dtype
    W = _width(cfg)
    if cfg.layer_kind(u) == "rec":
        return {"h": torch.zeros(G + (batch, W), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros(G + (batch, cfg.conv_width - 1, W),
                                    dtype=dt, device=device)}
    Sl = min(cfg.window or max_seq, max_seq)
    shape = G + (batch, Sl, cfg.n_kv, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Params:
    unit = cfg.unit
    G = cfg.n_layers // unit
    slots = [_cache_entry(cfg, u, batch, max_seq, device, (G,))
             for u in range(unit)]
    tail = [_cache_entry(cfg, (G * unit + j) % unit, batch, max_seq, device)
            for j in range(cfg.n_layers - G * unit)]
    return {"slots": slots, "tail": tail,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(cfg: ModelConfig, p: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token: (B,) int -> (logits (B,V), cache).  The cache's tensors are
    updated in place; the returned cache holds them and the advanced
    ``pos``."""
    pos = cache["pos"]
    h = L.embed(p["embed"], token[:, None])

    def body(h, blk, lc, u):
        if cfg.layer_kind(u) == "rec":
            rec = blk["rec"]
            xn = L.rmsnorm(rec["ln"], h)
            gate = F.gelu(L.linear(rec["w_gate"], xn).float(),
                          approximate="tanh")
            xb_raw = L.linear(rec["w_x"], xn)
            xb = _conv1d(rec["conv"], xb_raw, lc["conv"])
            a, b = _lru_gates(rec, xb)
            h_new = a[:, 0] * lc["h"] + b[:, 0]                # (B,W)
            y = (gate[:, 0] * h_new).to(h.dtype)
            h = h + L.linear(rec["w_out"], y)[:, None]
            # the new history reads the slots it replaces: built first
            hist = _new_hist(cfg, lc["conv"], xb_raw)
            lc["h"].copy_(h_new)
            lc["conv"].copy_(hist)
        else:
            Sl = lc["k"].shape[1]
            slots = torch.arange(Sl, device=pos.device)
            valid = (slots[None, :] <= pos[:, None]) | (pos[:, None] >= Sl)
            a2cfg = dataclasses.replace(_attn_cfg(cfg), window=None)
            att, _, _ = L.attention_decode(
                blk["attn"], a2cfg, L.rmsnorm(blk["ln1"], h), lc["k"],
                lc["v"], pos, write_idx=pos % Sl, valid=valid)
            h = h + att
        return h + L.gelu_mlp(blk["mlp"], L.rmsnorm(blk["ln2"], h))

    h, slots, tail = ST.scan_blocks_cached(
        h, p["blocks"], p["tail"], cache["slots"], cache["tail"], body,
        cfg.unit, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h)[:, 0].float()
    return logits, {"slots": slots, "tail": tail, "pos": pos + 1}


def prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, max_seq: int
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, building the recurrent states and the window-sized
    ring KV caches: returns (logits of the last position (B,V), cache
    ready for decode)."""
    B, S = x.shape[:2]
    h = L.embed(p["embed"], x)
    positions = _positions(B, S, h.device)
    zero_hist = _zero_hist(cfg, h)

    def body(h, blk, u):
        if cfg.layer_kind(u) == "rec":
            a, hist, hT = rec_block(blk["rec"], cfg, h, zero_hist)
            h = h + a
            out = {"h": hT, "conv": hist}
        else:
            acfg = _attn_cfg(cfg)
            xn = L.rmsnorm(blk["ln1"], h)
            q, k, v = L.attention_qkv(blk["attn"], acfg, xn, positions)
            ctx = flash_attention(q, k, v, causal=True, window=acfg.window)
            h = h + L.linear(blk["attn"]["wo"], ctx.reshape(B, S, -1))
            out = ring_cache(k, v, min(cfg.window or max_seq, max_seq))
        h = h + L.gelu_mlp(blk["mlp"], L.rmsnorm(blk["ln2"], h))
        return h, out

    h, slots, tail = ST.scan_blocks_collect(
        h, p["blocks"], p["tail"], body, cfg.unit, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h[:, -1]).float()
    return logits, {"slots": slots, "tail": tail,
                    "pos": torch.full((B,), S, dtype=torch.int32,
                                      device=h.device)}
