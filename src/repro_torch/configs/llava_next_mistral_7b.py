"""llava-next-mistral-7b [vlm] — Mistral-7B backbone; the anyres image
frontend is a stub: input_specs provide precomputed patch embeddings
(B, S, D) per the assignment.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=32000, head_dim=128, input_kind="embeds", rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=256, head_dim=16)
