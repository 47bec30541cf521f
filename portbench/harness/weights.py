"""The weights of a cell, made from ``--seed`` on the device.

The benchmark, not the program, makes the weights: each leaf of the
layout below is drawn by one ``normal_`` call of its own generator,
seeded from the run's seed and the leaf's name, in the dtype the
configuration serves, and scaled: a norm's gain 1, the embedding
N(0, initializer_range^2) as the published configuration initialises it,
a matrix N(0, 1/fan_in) as the JAX package's initialisers do.  One leaf can so be made again alone, as the reference
and the checks do, and both sides get the same numbers.

The layout is the stacked one of the port and of the JAX package:
every repeating layer's leaf carries a leading axis over the layers.
It is written here from the configuration alone; the harness holds the
program's own parameter tree to it before a run.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]      # path, shape, kind


def layout(cfg: dict) -> List[Leaf]:
    """(path, shape, kind) of every leaf; kind is ``ones``, ``embed`` or
    ``dense``.  Stacked leaves start with the layer count."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, F, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    b = "blocks.0."
    out: List[Leaf] = [
        ("embed.table", (V, D), "embed"),
        (b + "ln1.g", (L, D), "ones"),
        (b + "attn.wq.w", (L, D, H * Dh), "dense"),
        (b + "attn.wk.w", (L, D, KV * Dh), "dense"),
        (b + "attn.wv.w", (L, D, KV * Dh), "dense"),
        (b + "attn.wo.w", (L, H * Dh, D), "dense"),
        (b + "ln2.g", (L, D), "ones"),
    ]
    E = cfg.get("num_local_experts", 0)
    if E:
        out += [(b + "moe.router.w", (L, D, E), "dense"),
                (b + "moe.w_gate", (L, E, D, F), "dense"),
                (b + "moe.w_up", (L, E, D, F), "dense"),
                (b + "moe.w_down", (L, E, F, D), "dense")]
    else:
        out += [(b + "mlp.w_gate.w", (L, D, F), "dense"),
                (b + "mlp.w_up.w", (L, D, F), "dense"),
                (b + "mlp.w_down.w", (L, F, D), "dense")]
    out += [("ln_f.g", (D,), "ones"), ("head.w", (D, V), "dense")]
    return out


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg["torch_dtype"]]


def leaf_seed(seed: int, path: str) -> int:
    """A generator seed for one leaf: any whole ``seed`` (also past 2**63)
    and the leaf's name."""
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (1 << 63)


def make_leaf(seed: int, leaf: Leaf, device, dtype, cfg: dict
              ) -> torch.Tensor:
    path, shape, kind = leaf
    t = torch.empty(shape, dtype=dtype, device=device)
    if kind == "ones":
        return t.fill_(1.0)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    t.normal_(generator=gen)
    t.mul_(cfg["initializer_range"] if kind == "embed"
           else 1.0 / math.sqrt(shape[-2]))
    return t


def make(cfg: dict, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """Every leaf, by path, in ``dtype`` (the configuration's by
    default)."""
    dtype = dtype or dtype_of(cfg)
    return {leaf[0]: make_leaf(seed, leaf, device, dtype, cfg)
            for leaf in layout(cfg)}


def slices(path: str, t: torch.Tensor):
    """(name, tensor) of the parts that the checks compare one by one: a
    stacked leaf's layers, any other leaf whole."""
    if path.startswith("blocks."):
        return [(f"{path}[{g}]", t[g]) for g in range(t.shape[0])]
    return [(path, t)]
