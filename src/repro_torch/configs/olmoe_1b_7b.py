"""olmoe-1b-7b [moe] — 64 experts, top-8, per-expert d_ff=1024.
[arXiv:2409.02060]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024,
    vocab=50304, head_dim=128, n_experts=64, top_k=8)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=32,
    vocab=256, head_dim=16, n_experts=8, top_k=2)
