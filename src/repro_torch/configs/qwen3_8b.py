"""qwen3-8b [dense] — per-head qk-norm, GQA kv=8.  [hf:Qwen/Qwen3-8B]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=12288,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=256, head_dim=16)
