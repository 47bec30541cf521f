"""The plain reference of the decoder LMs the benchmark runs, in fp32.

Written from the configuration file alone, with plain ``torch`` ops: no
kernel, cache or batching of the program, nothing imported from it.
The model is the one the configuration states:

* token embedding; then per layer, pre-norm RMSNorm (eps from the file),
  grouped-query attention (rotary embedding on non-interleaved halves of
  q and k, causal softmax at 1/sqrt(head_dim), query head h reading KV
  head h // (heads / kv heads)), a residual add, pre-norm RMSNorm and
  the MLP, a residual add; a final RMSNorm and the output head;
* the dense MLP is SwiGLU: down(silu(x gate) * (x up));
* the MoE MLP routes each token to the ``num_experts_per_tok`` experts
  of the largest softmax router probabilities (ties to the lower expert
  index), the chosen probabilities renormalised to sum to 1; each batch
  row gives each expert ``capacity`` slots, filled by the row's
  assignments in (token, choice) order, and an assignment past them is
  dropped (its token keeps only the residual); a token's output is the
  sum of its kept experts' SwiGLU outputs weighted by their
  probabilities.

``Precision`` picks how a product is computed: :class:`Exact` (fp32, no
TF32) or :class:`FP8` (both operands rounded to float8 e4m3 with a
per-tensor scale, the control of the checks).  Weights are a dict of
fp32 tensors by the path names of ``portbench/harness/weights.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE = -1
QUERY_BLOCK = 2048          # query rows a block of attention at once


def exact_matmuls() -> None:
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Exact:
    name = "fp32"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)


class _RoundFP8(torch.autograd.Function):
    """x rounded to e4m3 at the scale that maps its largest magnitude to
    e4m3's largest; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-12)
        scale = torch.finfo(torch.float8_e4m3fn).max / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class FP8:
    name = "fp8"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(_RoundFP8.apply(a), _RoundFP8.apply(b))


def capacity(cfg: dict, tokens: int) -> int:
    """Slots an expert has in one batch row of ``tokens`` tokens."""
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    c = int(tokens * K * cfg["capacity_factor"] / E) + 1
    return max(8, -(-c // 8) * 8)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, Dh) at positions 0..S-1."""
    S, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: dict, w: Dict[str, torch.Tensor], x: torch.Tensor, prec
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(output (B,S,D), k (B,S,KV,Dh) after the rotary embedding, v)."""
    B, S, _ = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = cfg["head_dim"]
    q = prec.mm(x, w["attn.wq.w"]).view(B, S, H, Dh)
    k = prec.mm(x, w["attn.wk.w"]).view(B, S, KV, Dh)
    v = prec.mm(x, w["attn.wv.w"]).view(B, S, KV, Dh)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    G = H // KV
    qh = q.view(B, S, KV, G, Dh).permute(0, 2, 3, 1, 4)      # B,KV,G,S,Dh
    kh = k.permute(0, 2, 1, 3)[:, :, None]                   # B,KV,1,S,Dh
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    keys = torch.arange(S, device=x.device)
    outs = []
    for a in range(0, S, QUERY_BLOCK):
        b = min(S, a + QUERY_BLOCK)
        s = prec.mm(qh[:, :, :, a:b], kh[..., :b, :].transpose(-1, -2)) \
            / math.sqrt(Dh)
        allowed = keys[None, :b] <= torch.arange(a, b, device=x.device)[:, None]
        s = s.masked_fill(~allowed, float("-inf"))
        outs.append(prec.mm(torch.softmax(s, dim=-1), vh[..., :b, :]))
    ctx = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, H * Dh)
    return prec.mm(ctx, w["attn.wo.w"]), k, v


def swiglu(wg, wu, wd, x, prec) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def moe(cfg: dict, w: Dict[str, torch.Tensor], x: torch.Tensor, prec
        ) -> torch.Tensor:
    B, S, D = x.shape
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    C = capacity(cfg, S)
    probs = torch.softmax(prec.mm(x, w["moe.router.w"]), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = top_e.reshape(B, S * K)
    # an assignment's rank among its expert's, in (token, choice) order
    seen = F.one_hot(flat_e, E).cumsum(1)
    rank = seen.gather(2, flat_e[..., None])[..., 0] - 1
    keep = (rank < C).reshape(-1)
    flat_e = flat_e.reshape(-1)
    token = torch.arange(B * S, device=x.device).repeat_interleave(K)
    weight = top_p.reshape(-1)
    xs = x.reshape(B * S, D)
    out = torch.zeros_like(xs)
    for e in range(E):
        idx = torch.nonzero(keep & (flat_e == e))[:, 0]
        if idx.numel() == 0:
            continue
        y = swiglu(w["moe.w_gate"][e], w["moe.w_up"][e], w["moe.w_down"][e],
                   xs[token[idx]], prec)
        out = out.index_add(0, token[idx], y * weight[idx, None])
    return out.view(B, S, D)


def block(cfg: dict, w: Dict[str, torch.Tensor], h: torch.Tensor, prec
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer: (h out, k, v)."""
    eps = cfg["rms_norm_eps"]
    a, k, v = attention(cfg, w, rmsnorm(h, w["ln1.g"], eps), prec)
    h = h + a
    x = rmsnorm(h, w["ln2.g"], eps)
    if cfg.get("num_local_experts"):
        return h + moe(cfg, w, x, prec), k, v
    return h + swiglu(w["mlp.w_gate.w"], w["mlp.w_up.w"], w["mlp.w_down.w"],
                      x, prec), k, v


def layers(w: Dict[str, torch.Tensor], L: int
           ) -> List[Dict[str, torch.Tensor]]:
    """Each layer's weights (names without ``blocks.0.``) as views of the
    stacked leaves, one ``unbind`` a leaf."""
    parts = {k[len("blocks.0."):]: t.unbind(0) for k, t in w.items()
             if k.startswith("blocks.0.")}
    return [{k: t[g] for k, t in parts.items()} for g in range(L)]


def loss(cfg: dict, w: Dict[str, torch.Tensor], ids: torch.Tensor,
         labels: torch.Tensor, prec) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels not ``IGNORE``; each
    layer runs again in the backward (a checkpoint a layer), so that the
    fp32 activations of a full-size batch fit beside fp32 AdamW state."""
    h = w["embed.table"][ids.long()]
    for lw in layers(w, cfg["num_hidden_layers"]):
        h = checkpoint(lambda h_, lw_: block(cfg, lw_, h_, prec)[0], h, lw,
                       use_reentrant=False)
    lg = prec.mm(rmsnorm(h, w["ln_f.g"], cfg["rms_norm_eps"]), w["head.w"])
    mask = labels != IGNORE
    ll = torch.log_softmax(lg, dim=-1).gather(
        -1, torch.where(mask, labels, 0).long()[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


def prefill(cfg: dict, w: Dict[str, torch.Tensor], ids: torch.Tensor, prec
            ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """(the last position's logits (V,), each layer's (k, v) (S,KV,Dh))
    of one prompt (1, S), without gradients."""
    with torch.no_grad():
        h = w["embed.table"][ids.long()]
        kv = []
        for lw in layers(w, cfg["num_hidden_layers"]):
            h, k, v = block(cfg, lw, h, prec)
            kv.append((k[0], v[0]))
        h = rmsnorm(h[:, -1], w["ln_f.g"], cfg["rms_norm_eps"])
        return prec.mm(h, w["head.w"])[0], kv


class AdamW:
    """AdamW as the configuration's optimizer states it, on fp32 leaves:
    the gradients clipped to a global norm, a linear warm-up then a
    cosine to a tenth, bias-corrected moments, decoupled decay on every
    leaf of two or more dims.  ``step`` updates ``w`` in place."""

    def __init__(self, opt: dict, w: Dict[str, torch.Tensor]) -> None:
        self.o = opt
        self.t = 0
        self.m = {k: torch.zeros_like(t) for k, t in w.items()}
        self.v = {k: torch.zeros_like(t) for k, t in w.items()}

    def lr(self, t: int) -> float:
        o = self.o
        warm = min(t / max(o["warmup_steps"], 1), 1.0)
        prog = min(max((t - o["warmup_steps"])
                       / max(o["total_steps"] - o["warmup_steps"], 1), 0.0),
                   1.0)
        return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi
                                                                  * prog)))

    def clipped(self, g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        clip = torch.clamp(self.o["max_grad_norm"] / (norm + 1e-9), max=1.0)
        return {k: x * clip for k, x in g.items()}

    def step(self, w: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]
             ) -> None:
        """``g`` already clipped; its tensors are freed as they are used."""
        o = self.o
        self.t += 1
        lr = self.lr(self.t)
        b1, b2 = o["beta1"], o["beta2"]
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k in list(g):
            gk = g.pop(k)
            m, v, p = self.m[k], self.v[k], w[k]
            m.mul_(b1).add_(gk, alpha=1 - b1)
            v.mul_(b2).addcmul_(gk, gk, value=1 - b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"])
            if p.dim() >= 2:
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
