"""Deterministic synthetic data: the port of the JAX package's
``data/pipeline.py``.

Every example derives from a counter-based numpy seed ``(seed, global
index)``, so batches are the JAX package's bit for bit, resume is exact,
and each host materializes only its shard.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_s: float = 1.07            # natural-text-like marginal


class SyntheticLM:
    """Zipf-distributed token stream with a deterministic per-example seed."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = torch.device(device)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-dcfg.zipf_s)
        self._pmf = p / p.sum()

    def _example(self, global_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.dcfg.seed, global_idx))
        return rng.choice(self.cfg.vocab, size=self.dcfg.seq_len + 1,
                          p=self._pmf).astype(np.int32)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        """Host-local shard of the global batch for ``step``: int64 tokens
        and labels (B, seq_len) on the device."""
        b = self.dcfg.global_batch
        per_host = b // n_hosts
        base = step * b + host_id * per_host
        toks = np.stack([self._example(base + i) for i in range(per_host)])
        as_t = lambda a: torch.as_tensor(a.astype(np.int64),
                                         device=self.device)
        return {"tokens": as_t(toks[:, :-1]), "labels": as_t(toks[:, 1:])}


def wordcount_corpus(n_words: int, vocab: int, zipf_s: float = 1.07,
                     seed: int = 0) -> np.ndarray:
    """Synthetic Zipf corpus standing in for the paper's wikipedia dump
    (int32 word ids on the host; the byte-complexity models read it)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-zipf_s)
    return rng.choice(vocab, size=n_words, p=p / p.sum()).astype(np.int32)
