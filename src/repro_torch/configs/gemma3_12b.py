"""gemma3-12b [dense] — 5 local (sliding-window 1024) : 1 global layers,
128k context.  Mostly-local attention makes long_500k decode feasible
(window-sized ring caches on 5/6 of the layers).  [hf:google/gemma-3]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_ff=15360,
    vocab=262144, head_dim=256, window=1024, local_ratio=5,
    rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=256, head_dim=16, window=16, local_ratio=5)
