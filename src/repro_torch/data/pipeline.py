"""Deterministic synthetic LM data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only), so the port's batches are
the reference's bit for bit.

Every batch is a pure function of (seed, step, host_shard), so restarts and
elastic rescaling reproduce the exact token stream with no data server:
after a failure the restored job re-derives batch ``step`` bit-identically,
and a host only materializes its own shard (host-local loading).

The "corpus" is a mixture of Zipf-distributed unigrams with short repeated
motifs — enough structure that a ~100M model visibly learns (loss drops
well below ln V) while remaining fully self-contained.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 512


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank: repeated n-grams give the model learnable signal
        self.motifs = rng.integers(
            0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len), dtype=np.int32
        )
        # Zipf-ish unigram distribution
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def _sample_row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, np.int32)
        i = 0
        while i < cfg.seq_len + 1:
            if rng.random() < 0.7:  # motif
                m = self.motifs[rng.integers(cfg.n_motifs)]
                take = min(len(m), cfg.seq_len + 1 - i)
                out[i : i + take] = m[:take]
                i += take
            else:  # unigram noise
                take = min(int(rng.integers(4, 17)), cfg.seq_len + 1 - i)
                out[i : i + take] = rng.choice(
                    cfg.vocab_size, size=take, p=self.unigram
                )
                i += take
        return out

    def batch(
        self, step: int, host_id: int = 0, n_hosts: int = 1
    ) -> Dict[str, np.ndarray]:
        """Deterministic batch for ``step``; host-local shard if requested."""
        cfg = self.cfg
        assert cfg.global_batch % n_hosts == 0
        local = cfg.global_batch // n_hosts
        rows = np.empty((local, cfg.seq_len + 1), np.int32)
        for r in range(local):
            row_id = step * cfg.global_batch + host_id * local + r
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, row_id])
            )
            rows[r] = self._sample_row(rng)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def batches(
        self, n_steps: int, start: int = 0, host_id: int = 0, n_hosts: int = 1
    ) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(start, start + n_steps):
            yield self.batch(step, host_id, n_hosts)
