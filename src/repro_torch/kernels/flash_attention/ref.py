"""Plain torch versions of flash attention (GQA + causal + sliding window):
the exact softmax, the chunked online-softmax form, and the backward."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool: may query position ``qpos[i]`` attend ``kpos[j]``."""
    d = qpos[:, None] - kpos[None, :]
    mask = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        mask &= d >= 0
    if window is not None:
        mask &= d < window
        if not causal:
            mask &= -d < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,Dh); k,v: (B,S,KV,Dh) with H % KV == 0.  Returns (B,S,H,Dh).

    ``window``: position i attends to j with i-window < j <= i (and j <= i
    if causal).  Exact softmax in float32."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    assert H % KV == 0
    groups = H // KV
    scale = 1.0 / math.sqrt(Dh)
    qh = q.reshape(B, S, KV, groups, Dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = attention_mask(pos, pos, causal, window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return ctx.reshape(B, S, H, Dh).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      block_k: int = 1024) -> torch.Tensor:
    """The flash-attention algorithm over KV chunks with the online-softmax
    running state: numerically equivalent to :func:`attention_ref` in
    O(S * block_k) memory instead of O(S^2)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    groups = H // KV
    bk = min(block_k, S)
    while S % bk != 0:
        bk -= 1
    scale = 1.0 / math.sqrt(Dh)
    qh = q.reshape(B, S, KV, groups, Dh).float()
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, groups, S), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, groups, S), device=q.device)
    acc = torch.zeros((B, KV, groups, S, Dh), device=q.device)
    for k0 in range(0, S, bk):
        kblk = k[:, k0:k0 + bk].float()
        vblk = v[:, k0:k0 + bk].float()
        kpos = k0 + torch.arange(bk, device=q.device)
        msk = attention_mask(qpos, kpos, causal, window)
        s = torch.einsum("bqkgd,bskd->bkgqs", qh, kblk) * scale
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(msk, p, torch.zeros_like(p))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                    vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh)
    return out.to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, causal: bool = True,
                      window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`attention_ref` for the output
    gradient ``do``, in float32, each in its input's dtype: with s = scale
    q.k over the allowed keys, P = softmax(s) (masked probabilities 0, the
    denominator clamped at 1e-30, as the kernels have it: a row that
    attends no key has zero gradients), D = rowsum(do * P v),
    dv = P^T do, dS = P (do v^T - D), dq = scale dS k, dk = scale dS^T q,
    dk and dv summed over each KV head's query heads."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    groups = H // KV
    scale = 1.0 / math.sqrt(Dh)
    qh = q.reshape(B, S, KV, groups, Dh).float()
    kf, vf = k.float(), v.float()
    doh = do.reshape(B, S, KV, groups, Dh).float()
    pos = torch.arange(S, device=q.device)
    mask = attention_mask(pos, pos, causal, window)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, kf) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, vf)
    delta = (doh.permute(0, 2, 3, 1, 4) * o).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, doh)
    dp = torch.einsum("bqkgd,bskd->bkgqs", doh, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qh) * scale
    return (dq.reshape(B, S, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
