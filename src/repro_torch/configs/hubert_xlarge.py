"""hubert-xlarge [audio] — encoder-only transformer backbone (same arch as
wav2vec2).  The CNN feature extractor is a stub: input_specs provide frame
embeddings (B, S, D).  No decode step exists — decode shapes skip.
[arXiv:2106.07447]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_ff=5120,
    vocab=504, head_dim=80, causal=False, input_kind="embeds")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=32, head_dim=16)
