"""Assigned input-shape set for the LM-family architectures.

  train_4k     seq 4,096   global batch 256   -> train_step
  prefill_32k  seq 32,768  global batch 32    -> prefill (serve_step)
  decode_32k   seq 32,768  global batch 128   -> decode_step with a 32k cache
  long_500k    seq 524,288 global batch 1     -> decode_step with a 500k
               state; requires sub-quadratic attention (SSM / hybrid /
               mostly-local) — skipped for pure full-attention archs.
Encoder-only architectures (hubert) have no decode -> decode shapes skip.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 512k-token decode needs "
                       "sub-quadratic attention")
    return True, ""


def live_cells(cfgs: List[ModelConfig]) -> List[Tuple[ModelConfig, Shape]]:
    out = []
    for cfg in cfgs:
        for shape in SHAPES.values():
            ok, _ = applicable(cfg, shape)
            if ok:
                out.append((cfg, shape))
    return out
