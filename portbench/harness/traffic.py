"""The one traffic generator: training batches and prompts from a mix's
parameters (``portbench/traffic/<mix>.json``) and the run's seed.

Every seed gets the same sizes and only another order and other token
ids, so that two seeds ask the program for the same work:

* training: each row is ``seq + 1`` tokens of documents packed end to
  end, the next-token labels ignored (``IGNORE``) where a document ends,
  as ``repro_torch/data/pipeline.py`` packs them (its arithmetic copied
  here).  Document lengths are lognormal, clipped to ``[min, max]``;
  the step's work does not depend on them.
* serving: prompt lengths are a fixed multiset, the ``count`` mid-point
  quantiles of a clipped lognormal; each cycle of ``count`` requests
  sends all of them in an order drawn from the seed.

Token ids are uniform over the vocabulary.  Nothing here touches a
device or the program.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Tuple

import numpy as np

IGNORE = -1


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) for k in key])


def _clipped(rng: np.random.Generator, spec: dict) -> int:
    n = rng.lognormal(math.log(spec["median"]), spec["sigma"])
    return int(min(max(round(n), spec["min"]), spec["max"]))


def train_rows(mix: dict, vocab: int, seed: int, step: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(x, labels), each (batch, seq) int32, of optimizer step ``step``
    (0-based): its rows all differ from each other and from every other
    step's."""
    B, S = mix["batch"], mix["seq"]
    xs = np.empty((B, S), np.int32)
    ys = np.empty((B, S), np.int32)
    for r in range(B):
        rng = _rng(seed, step, r)
        toks: List[np.ndarray] = []
        bounds, n = [], 0
        while n < S + 1:
            doc = rng.integers(0, vocab, size=_clipped(rng, mix["documents"]),
                               dtype=np.int32)
            toks.append(doc)
            n += doc.size
            bounds.append(n)
        row = np.concatenate(toks)[:S + 1]
        xs[r] = row[:-1]
        ys[r] = row[1:]
        for b in bounds:
            if 0 < b <= S:
                ys[r, b - 1] = IGNORE      # no prediction across documents
    return xs, ys


def prompt_lengths(mix: dict) -> List[int]:
    """The multiset of prompt lengths one cycle sends."""
    spec = mix["prompts"]
    z = statistics.NormalDist()
    out = []
    for i in range(spec["count"]):
        n = spec["median"] * math.exp(
            spec["sigma"] * z.inv_cdf((i + 0.5) / spec["count"]))
        out.append(int(min(max(round(n), spec["min"]), spec["max"])))
    return out


class Prompts:
    """Request ``i``'s prompt: its length and token ids."""

    def __init__(self, mix: dict, vocab: int, seed: int) -> None:
        self.lengths = prompt_lengths(mix)
        self.vocab, self.seed = vocab, seed
        self._orders = {}

    def length(self, i: int) -> int:
        n = len(self.lengths)
        cycle, at = divmod(i, n)
        if cycle not in self._orders:
            self._orders[cycle] = _rng(self.seed, cycle).permutation(n)
        return self.lengths[self._orders[cycle][at]]

    def ids(self, i: int) -> np.ndarray:
        """(1, length) int64 token ids."""
        return _rng(self.seed, 1 << 40, i).integers(
            0, self.vocab, size=(1, self.length(i)), dtype=np.int64)
