"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent per-channel
decay.  O(1)-state decode => long_500k runs.  [arXiv:2404.05892]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv=0, d_ff=8960,
    vocab=65536, rwkv_head_dim=64)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, d_ff=256, vocab=256, rwkv_head_dim=32)
