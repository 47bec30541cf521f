"""Functional torch building blocks of the transformer family.

Each layer is an ``init_*`` returning a params tree (nested dicts of
tensors) and an apply function, with the JAX package's signatures and
param layout, so a JAX params tree carries over leaf by leaf
(:func:`repro_torch.core.weights.tree_from_jax`).  Initialisers take an
explicit ``torch.Generator`` and a device; the param dtype is theirs.

Numerics follow the JAX package: RMSNorm (pre-norm) through the RMSNorm
kernel, rotary position embeddings in fp32 (non-interleaved halves), GQA
attention with optional per-head qk-norm and optional sliding window
through the flash-attention kernel, decode attention in plain torch, and
SwiGLU / GeGLU MLPs.  ``linear`` is ``torch.matmul``: a plain large
product, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import hints, on_mesh
from repro_torch.core.on_mesh import flash_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (all take an explicit generator; dtype is the *param* dtype)
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * s).to(dtype)


def init_linear(gen, d_in: int, d_out: int, dtype=torch.bfloat16,
                device="cuda") -> Params:
    return {"w": _dense_init(gen, (d_in, d_out), dtype, device)}


def init_rmsnorm(d: int, dtype=torch.bfloat16, device="cuda") -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def init_embedding(gen, vocab: int, d: int, dtype=torch.bfloat16,
                   device="cuda") -> Params:
    return {"table": _dense_init(gen, (vocab, d), dtype, device, scale=1.0)}


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return on_mesh.rmsnorm(x, p["g"], eps)


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """The embedding table's rows at integer ``ids``."""
    return on_mesh.embed(p["table"], ids)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return on_mesh.grad_as_forward(torch.matmul(x, p["w"]))


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                       # (Dh/2,)
    ang = positions[..., :, None].float() * freqs                 # (..., S, Dh/2)
    cos = torch.cos(ang)[..., :, None, :]                         # (.., S, 1, Dh/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + optional qk-norm + optional sliding window)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window size (local attn)
    rope_theta: float = 10000.0
    causal: bool = True                   # False for encoder-only (HuBERT)


def init_attention(gen, cfg: AttnConfig, dtype=torch.bfloat16,
                   device="cuda") -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p: Params = {
        "wq": init_linear(gen, d, h * dh, dtype, device),
        "wk": init_linear(gen, d, kv * dh, dtype, device),
        "wv": init_linear(gen, d, kv * dh, dtype, device),
        "wo": init_linear(gen, h * dh, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, device)
        p["k_norm"] = init_rmsnorm(dh, dtype, device)
    return p


def attention_qkv(p: Params, cfg: AttnConfig, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B,S,D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), rope + qk-norm applied."""
    q = on_mesh.split_dim(linear(p["wq"], x), -1,
                          (cfg.n_heads, cfg.head_dim))
    k = on_mesh.split_dim(linear(p["wk"], x), -1,
                          (cfg.n_kv, cfg.head_dim))
    v = on_mesh.split_dim(linear(p["wv"], x), -1,
                          (cfg.n_kv, cfg.head_dim))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p: Params, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (training / prefill)."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(p, cfg, x, positions)
    ctx = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    return linear(p["wo"], ctx.reshape(B, S, -1))


def attention_decode(p: Params, cfg: AttnConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     position: torch.Tensor,
                     write_idx: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step against a (B, S_cache, KV, Dh) cache.

    ``position`` (B,) — absolute position of the new token (drives RoPE).
    ``write_idx`` (B,) — cache slot to write (``position`` by default;
    ``position % window`` for ring-buffer local-layer caches).
    ``valid`` (B, S_cache) — which cache slots may be attended; defaults to
    ``slot <= position``.  Ring buffers pass their own mask.

    The new k/v are written into ``cache_k``/``cache_v`` IN PLACE (the JAX
    package returns updated copies; the values are the same), and the two
    caches are returned."""
    B, one, _ = x.shape
    assert one == 1
    q = on_mesh.split_dim(linear(p["wq"], x), -1,
                          (cfg.n_heads, cfg.head_dim))
    # keep the q projection head-sharded: with a 1-token batch a mesh
    # otherwise gathers the TP weight shards instead of running the
    # projection tensor-parallel
    q = hints.constraint(q, "decode_heads")
    k = on_mesh.split_dim(linear(p["wk"], x), -1,
                          (cfg.n_kv, cfg.head_dim))
    v = on_mesh.split_dim(linear(p["wv"], x), -1,
                          (cfg.n_kv, cfg.head_dim))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    pos = position[:, None]                                   # (B,1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    S = cache_k.shape[1]
    slots = torch.arange(S, device=x.device)
    if write_idx is None:
        write_idx = position
    if valid is None:
        valid = slots[None, :] <= position[:, None]

    # the new k/v into their slots, in place; on a mesh by a scatter of
    # the written slot where the "decode_scatter_update" hint says so,
    # else by a select over each rank's shard of the cache
    on_mesh.cache_write((cache_k, cache_v), write_idx, (k[:, 0], v[:, 0]),
                        hints.get("decode_scatter_update") is not None)
    cache_k = hints.constraint(cache_k, "decode_cache")
    cache_v = hints.constraint(cache_v, "decode_cache")

    groups = cfg.n_heads // cfg.n_kv
    # the einsums flatten (b, k): keep k whole
    qh = on_mesh.replicate_dims(
        on_mesh.split_dim(q[:, 0], 1, (cfg.n_kv, groups)), (1, 2))
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                          cache_k.float()) * scale
    # sequence-sharded ring-decode: keep the (B,KV,G,S) logits sharded on
    # S, so the softmax and the value contraction run as partial
    # statistics and a reduce instead of gathering the cache
    logits = hints.constraint(logits, "decode_logits")
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bkgs,bskd->bkgd", w, cache_v.float()).to(x.dtype)
    ctx = ctx.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return linear(p["wo"], ctx), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                device="cuda") -> Params:
    return {"w_gate": init_linear(gen, d, d_ff, dtype, device),
            "w_up": init_linear(gen, d, d_ff, dtype, device),
            "w_down": init_linear(gen, d_ff, d, dtype, device)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(linear(p["w_gate"], x).float())
    u = linear(p["w_up"], x).float()
    h = hints.constraint((g * u).to(x.dtype), "ffn_hidden")
    return linear(p["w_down"], h)


def init_gelu_mlp(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                  device="cuda") -> Params:
    return {"w_up": init_linear(gen, d, d_ff, dtype, device),
            "w_down": init_linear(gen, d_ff, d, dtype, device)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(linear(p["w_up"], x).float(), approximate="tanh")
    h = hints.constraint(h.to(x.dtype), "ffn_hidden")
    return linear(p["w_down"], h)
