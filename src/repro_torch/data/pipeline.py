"""Deterministic synthetic data pipeline (``repro/data/pipeline.py``).

Batches are a pure function of (seed, step, shard) and are drawn with
numpy exactly as the JAX package draws them, so both packages see the
same tokens and the same frontend features: an encoder-decoder's
``frames`` (B, S, d_model), or a frontend config's ``frontend``
embeddings (B, frontend_tokens, d_model) before S - frontend_tokens text
positions, Gaussian stand-ins x 0.1 from a stream of their own.
``MarkovLM`` builds a (vocab, vocab) float64 transition matrix: use it
at reduced vocabularies only (at 64000 it would need about 33 GB per
copy).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig


@dataclasses.dataclass
class MarkovLM:
    """Fixed random bigram transition chain over ``vocab`` tokens."""
    vocab: int
    seed: int = 0
    temperature: float = 3.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        logits = rng.normal(size=(self.vocab, self.vocab)) * self.temperature
        self._probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        self._probs /= self._probs.sum(axis=1, keepdims=True)
        self._cum = np.cumsum(self._probs, axis=1)

    def sample(self, batch: int, seq_len: int, *, step: int, shard: int = 0
               ) -> np.ndarray:
        """(batch, seq_len+1) token ids, deterministic in (step, shard)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        out = np.empty((batch, seq_len + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        u = rng.random((batch, seq_len))
        for t in range(seq_len):
            out[:, t + 1] = (
                self._cum[out[:, t]] < u[:, t:t + 1]).sum(axis=1)
        return out.clip(0, self.vocab - 1)


class Pipeline:
    """Batch source for an LM train loop (CPU tensors; the engine moves
    them to its device)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, *,
                 seed: int = 0, shard: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.shard = shard
        self.lm = MarkovLM(cfg.vocab_size, seed=seed)
        self._feat_seed = seed + 17

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        text = self.seq_len - (cfg.frontend_tokens if cfg.frontend else 0)
        toks = torch.from_numpy(
            self.lm.sample(self.batch, text, step=step, shard=self.shard))
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        rng = np.random.default_rng(
            np.random.SeedSequence([self._feat_seed, step, self.shard]))
        dt = getattr(torch, cfg.dtype)
        if cfg.enc_layers:
            out["frames"] = torch.from_numpy(rng.normal(
                size=(self.batch, self.seq_len, cfg.d_model)) * 0.1).to(dt)
        elif cfg.frontend:
            out["frontend"] = torch.from_numpy(rng.normal(
                size=(self.batch, cfg.frontend_tokens, cfg.d_model))
                * 0.1).to(dt)
        return out
