"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU recurrent blocks + local
attention, pattern (rec, rec, attn) = the assignment's "1:2".  MQA (kv=1),
window 2048.  O(window) decode state => long_500k runs.
[arXiv:2402.19427]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
    vocab=256000, head_dim=256, window=2048,
    block_pattern=("rec", "rec", "attn"), rnn_width=2560, conv_width=4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv=1, d_ff=128,
    vocab=256, head_dim=16, window=16, rnn_width=64)
