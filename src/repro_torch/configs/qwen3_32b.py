"""qwen3-32b [dense] — largest dense; qk-norm, GQA kv=8; TP-heavy.
[hf:Qwen/Qwen3-32B family]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=128,
    vocab=256, head_dim=8)
