"""granite-moe-3b-a800m [moe] — 40 experts, top-8, per-expert d_ff=512
(the assignment's config column governs).  [hf:ibm-granite]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512,
    vocab=49155, head_dim=64, n_experts=40, top_k=8)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv=2, d_ff=32,
    vocab=256, head_dim=12, n_experts=5, top_k=2)
