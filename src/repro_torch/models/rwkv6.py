"""RWKV6 "Finch" — attention-free RNN LM with data-dependent decay.

Structure per block, as in the JAX package:
  * time-mix: token-shift lerp produces r/k/v/gate/decay projections; the
    per-channel decay w_t = exp(-exp(wx_t)) is data-dependent via a LoRA on
    the shifted input; the WKV6 recurrence runs in the WKV6 kernel
    (prefill / forward); per-head RMS normalization and a silu gate close
    the mixer.
  * channel-mix: token-shift lerp, squared-ReLU FFN with sigmoid receptance.

State for decode: per layer (WKV state S (B,H,D,D) fp32, time-mix shift
x_tm (B,D), channel-mix shift x_cm (B,D)), O(1) in sequence length.  The
single-token step is plain torch, as the JAX package leaves it, and
``decode_step`` writes the new state into the cache tensors in place.
Prefill casts the decay to the model dtype before the kernel; decode
keeps it in fp32 (both as in the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import on_mesh
from repro_torch.core.on_mesh import wkv6
from repro_torch.models import layers as L
from repro_torch.models import stacking as ST
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

LORA_R = 64


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init_block(gen, cfg: ModelConfig, device="cuda") -> Params:
    dt = cfg.param_dtype
    D = cfg.d_model
    H, hd = _heads(cfg), cfg.rwkv_head_dim

    def full(value):
        return torch.full((D,), value, dtype=dt, device=device)

    def lin(d_in, d_out):
        return L.init_linear(gen, d_in, d_out, dt, device)

    return {
        "ln1": L.init_rmsnorm(D, dt, device),
        "ln2": L.init_rmsnorm(D, dt, device),
        "tm": {
            # token-shift mixing coefficients per projection
            "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
            "mu_w": full(0.5), "mu_g": full(0.5),
            "wr": lin(D, D), "wk": lin(D, D), "wv": lin(D, D),
            "wg": lin(D, D),
            # data-dependent decay: w0 + LoRA(x_shifted)
            "w0": full(-0.6),
            "w_lora_a": lin(D, LORA_R),
            "w_lora_b": lin(LORA_R, D),
            "u": (torch.randn((H, hd), generator=gen, device=device,
                              dtype=torch.float32) * 0.3).to(dt),
            "ln_x": L.init_rmsnorm(hd, dt, device),   # per-head group norm
            "wo": lin(D, D),
        },
        "cm": {
            "mu_k": full(0.5), "mu_r": full(0.5),
            "wk": lin(D, cfg.d_ff), "wr": lin(D, D), "wv": lin(cfg.d_ff, D),
        },
    }


def init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random params drawn from ``gen`` (a generator on ``device``)."""
    dt = cfg.param_dtype
    embed = L.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device)
    slots, tail = ST.init_stacked(lambda i: init_block(gen, cfg, device),
                                  cfg.n_layers, 1)
    return {"embed": embed, "blocks": slots, "tail": tail,
            "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
            "head": L.init_linear(gen, cfg.d_model, cfg.vocab, dt, device)}


def _lerp(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor):
    return x + (x_prev - x) * mu.to(x.dtype)


def _shifted(x: torch.Tensor, x_prev_last: torch.Tensor) -> torch.Tensor:
    return torch.cat([x_prev_last[:, None], x[:, :-1]], dim=1)


def _decay(tm: Params, xw: torch.Tensor) -> torch.Tensor:
    lora = L.linear(tm["w_lora_b"], torch.tanh(L.linear(tm["w_lora_a"], xw)))
    wx = tm["w0"].float() + lora.float()
    return torch.exp(-torch.exp(wx))        # in (0,1), data-dependent


def _mix_projections(tm: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """r, k, v, g in x's dtype and the fp32 decay w, each (B,T,D)."""
    r = L.linear(tm["wr"], _lerp(x, x_prev, tm["mu_r"]))
    k = L.linear(tm["wk"], _lerp(x, x_prev, tm["mu_k"]))
    v = L.linear(tm["wv"], _lerp(x, x_prev, tm["mu_v"]))
    g = L.linear(tm["wg"], _lerp(x, x_prev, tm["mu_g"]))
    w = _decay(tm, _lerp(x, x_prev, tm["mu_w"]))
    return r, k, v, g, w


def _gate_out(tm: Params, y: torch.Tensor, g: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Per-head ``ln_x`` over (..., H, hd), the silu gate, ``wo``."""
    y = L.rmsnorm(tm["ln_x"], y)
    # the heads merged back: on a mesh their gradient keeps the merged
    # layout, which splits back into heads however the width is sharded
    y = on_mesh.grad_as_forward(y.reshape(g.shape)) \
        * F.silu(g.float()).to(dtype)
    return L.linear(tm["wo"], y)


def time_mix(tm: Params, cfg: ModelConfig, x: torch.Tensor,
             x_prev_last: torch.Tensor):
    """x: (B,T,D); x_prev_last: (B,D) last token of the previous segment.
    Returns (out (B,T,D), new shift (B,D), new WKV state)."""
    H, hd = _heads(cfg), cfg.rwkv_head_dim
    r, k, v, g, w = _mix_projections(tm, x, _shifted(x, x_prev_last))

    def hsplit(t):
        return on_mesh.split_dim(t, -1, (H, hd))

    y, s_new = wkv6(hsplit(r), hsplit(k), hsplit(v), hsplit(w.to(x.dtype)),
                    tm["u"])
    return _gate_out(tm, y, g, x.dtype), x[:, -1], s_new


def channel_mix(cm: Params, x: torch.Tensor, x_prev_last: torch.Tensor):
    x_prev = _shifted(x, x_prev_last)
    k = L.linear(cm["wk"], _lerp(x, x_prev, cm["mu_k"]))
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    r = torch.sigmoid(
        L.linear(cm["wr"], _lerp(x, x_prev, cm["mu_r"])).float())
    return r.to(x.dtype) * L.linear(cm["wv"], k), x[:, -1]


def _block(blk: Params, cfg: ModelConfig, h: torch.Tensor,
           zero: torch.Tensor):
    """One full-sequence block from zero shifts: (h, its state entry)."""
    a, tm_x, s = time_mix(blk["tm"], cfg, L.rmsnorm(blk["ln1"], h), zero)
    h = h + a
    m, cm_x = channel_mix(blk["cm"], L.rmsnorm(blk["ln2"], h), zero)
    return h + m, {"wkv": s, "tm_x": tm_x, "cm_x": cm_x}


def forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """x: (B,S) int tokens -> logits (B,S,V); ``remat``
    recomputes each repeating unit in backward
    (:func:`~repro_torch.models.stacking.scan_blocks`)."""
    h = L.embed(p["embed"], x)
    zero = torch.zeros((h.shape[0], cfg.d_model), dtype=h.dtype,
                       device=h.device)
    h = ST.scan_blocks(h, p["blocks"], p["tail"],
                       lambda h, blk, u, g: _block(blk, cfg, h, zero)[0],
                       1, cfg.n_layers, remat)
    h = L.rmsnorm(p["ln_f"], h)
    return L.linear(p["head"], h).float()


# ---------------------------------------------------------------------------
# Serving: recurrent state instead of a KV cache (O(1) in sequence length)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Params:
    H, hd = _heads(cfg), cfg.rwkv_head_dim
    dt = cfg.param_dtype
    G = cfg.n_layers
    entry = {
        "wkv": torch.zeros((G, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((G, batch, cfg.d_model), dtype=dt, device=device),
        "cm_x": torch.zeros((G, batch, cfg.d_model), dtype=dt, device=device),
    }
    return {"slots": [entry], "tail": [],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _step_block(blk: Params, cfg: ModelConfig, h: torch.Tensor,
                lc: Params) -> torch.Tensor:
    """Single-token block step, h: (B,1,D); the layer's state entry ``lc``
    (views into the stacked cache) is updated in place."""
    H, hd = _heads(cfg), cfg.rwkv_head_dim
    xn = L.rmsnorm(blk["ln1"], h)
    tm = blk["tm"]
    r, k, v, g, w = _mix_projections(tm, xn, lc["tm_x"][:, None])
    # the einsums flatten (b, h): keep h whole
    rt, kt, vt = (on_mesh.replicate_dims(
        on_mesh.split_dim(t, -1, (H, hd))[:, 0], (1,)).float()
        for t in (r, k, v))
    wt = on_mesh.replicate_dims(on_mesh.split_dim(w, -1, (H, hd))[:, 0],
                                (1,))
    u = tm["u"].float()
    S = lc["wkv"]
    y = torch.einsum("bhi,bhij->bhj", rt, S) \
        + torch.einsum("bhi,bhi,bhj->bhj", rt, u[None] * kt, vt)
    S_new = wt[..., None] * S + kt[..., :, None] * vt[..., None, :]
    h = h + _gate_out(tm, y.to(h.dtype), g, h.dtype)
    m, cm_x = channel_mix(blk["cm"], L.rmsnorm(blk["ln2"], h), lc["cm_x"])
    S.copy_(S_new)
    lc["tm_x"].copy_(xn[:, -1])
    lc["cm_x"].copy_(cm_x)
    return h + m


def decode_step(cfg: ModelConfig, p: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token: (B,) int -> (logits (B,V), cache).  The cache's state
    tensors are updated in place; the returned cache holds them and the
    advanced ``pos``."""
    h = L.embed(p["embed"], token[:, None])
    h, slots, tail = ST.scan_blocks_cached(
        h, p["blocks"], p["tail"], cache["slots"], cache["tail"],
        lambda h, blk, lc, u: _step_block(blk, cfg, h, lc), 1, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h)[:, 0].float()
    return logits, {"slots": slots, "tail": tail, "pos": cache["pos"] + 1}


def prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, max_seq: int
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, building the recurrent state: returns (logits of
    the last position (B,V), state ready for decode)."""
    h = L.embed(p["embed"], x)
    B = h.shape[0]
    zero = torch.zeros((B, cfg.d_model), dtype=h.dtype, device=h.device)
    h, slots, tail = ST.scan_blocks_collect(
        h, p["blocks"], p["tail"],
        lambda h, blk, u: _block(blk, cfg, h, zero), 1, cfg.n_layers)
    h = L.rmsnorm(p["ln_f"], h)
    logits = L.linear(p["head"], h[:, -1]).float()
    return logits, {"slots": slots, "tail": tail,
                    "pos": torch.full((B,), x.shape[1], dtype=torch.int32,
                                      device=h.device)}
