"""Deterministic, resumable, sharded data pipeline.

Synthetic-corpus tokens (seeded PRNG over document ids) stand in for a real
corpus — the pipeline layer is real: deterministic global order, per-host
sharding by (host_index, num_hosts), exact resume from (epoch, step), and
next-token label construction with document-boundary masking.  Swapping in
a real tokenized corpus only replaces :func:`_document`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.train.step import IGNORE


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    embed_dim: int = 0            # >0: emit embeddings (audio/vlm stub)
    num_docs: int = 0             # >0: finite corpus (documents repeat —
    #                               makes the synthetic stream learnable)

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _document(cfg: DataConfig, doc_id: int) -> np.ndarray:
    """Deterministic synthetic document: length and content from doc_id."""
    rng = np.random.default_rng(cfg.seed * 1_000_003 + doc_id)
    n = int(rng.integers(32, 2 * cfg.seq_len))
    return rng.integers(1, cfg.vocab, size=n, dtype=np.int32)


class Pipeline:
    """Iterator of {x, labels} host-local batches; state = (step,)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0) -> None:
        self.cfg = cfg
        self.step = start_step

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    @classmethod
    def restore(cls, cfg: DataConfig, state: Dict[str, int]) -> "Pipeline":
        return cls(cfg, start_step=state["step"])

    def _sequence(self, global_row: int, step: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack documents into one (seq_len,) window, deterministic in
        (row, step).  Labels are next-token; document boundaries IGNOREd."""
        cfg = self.cfg
        rng_id = step * cfg.global_batch + global_row
        toks = np.empty(0, np.int32)
        bounds = []
        d = 0
        while toks.size < cfg.seq_len + 1:
            doc_id = rng_id * 97 + d
            if cfg.num_docs:
                doc_id %= cfg.num_docs
            doc = _document(cfg, doc_id)
            bounds.append(toks.size + doc.size)
            toks = np.concatenate([toks, doc])
            d += 1
        toks = toks[: cfg.seq_len + 1]
        x = toks[:-1]
        y = toks[1:].copy()
        for b in bounds:
            if 0 < b <= cfg.seq_len:
                y[b - 1] = IGNORE      # do not predict across documents
        return x, y

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = range(cfg.host_index * cfg.host_batch,
                     (cfg.host_index + 1) * cfg.host_batch)
        xs, ys = [], []
        for r in rows:
            x, y = self._sequence(r, self.step)
            xs.append(x)
            ys.append(y)
        self.step += 1
        x = np.stack(xs)
        batch: Dict[str, np.ndarray] = {"labels": np.stack(ys)}
        if cfg.embed_dim:
            # modality stub: deterministic frame/patch embeddings
            rng = np.random.default_rng(cfg.seed + self.step)
            batch["x"] = rng.standard_normal(
                (cfg.host_batch, cfg.seq_len, cfg.embed_dim),
                dtype=np.float32)
        else:
            batch["x"] = x
        return batch
