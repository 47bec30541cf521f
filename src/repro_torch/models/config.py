"""Unified architecture configuration for the assigned model families."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free (rwkv)
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    qk_norm: bool = False
    causal: bool = True         # False: encoder-only (audio)
    # gemma3-style interleaved local:global attention
    window: Optional[int] = None
    local_ratio: int = 0        # L local layers per 1 global (0 = uniform)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # hybrid (recurrentgemma): block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0          # 0 => d_model
    conv_width: int = 4
    # frontend
    input_kind: str = "tokens"  # tokens | embeds (audio frames / vlm patches)
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # rwkv6
    rwkv_head_dim: int = 64

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def unit(self) -> int:
        """Repeating-layer period for scan-over-layers stacking."""
        if self.block_pattern:
            return len(self.block_pattern)
        if self.local_ratio and self.window:
            return self.local_ratio + 1
        return 1

    def layer_kind(self, i: int) -> str:
        """Per-layer block kind: attention variant or recurrent."""
        if self.block_pattern:
            return self.block_pattern[i % len(self.block_pattern)]
        if self.local_ratio and self.window:
            # gemma3: local_ratio local layers, then 1 global
            return "local" if (i % (self.local_ratio + 1)) < self.local_ratio \
                else "global"
        if self.window:
            return "local"
        return "global"

    @property
    def has_decode(self) -> bool:
        return self.causal and self.family != "audio"

    @property
    def subquadratic(self) -> bool:
        """True when 500k-token decode is feasible (no full-attention layer
        whose KV cache would be quadratic-prefill-sized... i.e. SSM/hybrid/
        mostly-local architectures)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return bool(self.local_ratio and self.window)
