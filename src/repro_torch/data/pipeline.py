"""Deterministic synthetic data pipeline with restart-safe skip-ahead (port
of ``repro.data.pipeline``, numpy only).

Batches are pure functions of (seed, step), so a restart resumes
bit-identically by construction: ``DataIterator(cfg, start_step=n)`` yields
step n's batch next.  The arithmetic is the reference's, call for call on
the same numpy generators, so every (seed, step) gives the reference's
tokens, labels and mask (and front-end inputs).  A real deployment swaps
``_synthesize`` for tokenized shards; the step-indexed contract stays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    frontend: str = "none"        # mirror of the model config
    frontend_dim: int = 0
    frontend_tokens: int = 0
    encdec: bool = False


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def _synthesize(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Structured synthetic LM data: repeated 16-token motifs (64 of them,
    drawn once from the seed) with 5 % of tokens replaced by noise, so the
    loss has signal to minimize; labels are the tokens shifted by one, the
    last position masked out."""
    rng = _rng_for(cfg.seed, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    motif_len = 16
    n_motifs = 64
    motifs = _rng_for(cfg.seed, 0x5EED0).integers(
        0, v, size=(n_motifs, motif_len))
    picks = rng.integers(0, n_motifs, size=(b, s // motif_len + 1))
    tokens = motifs[picks].reshape(b, -1)[:, :s].astype(np.int32)
    noise = rng.random((b, s)) < 0.05
    tokens = np.where(noise, rng.integers(0, v, size=(b, s)), tokens)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, -1] = 0.0
    out = {"tokens": tokens, "labels": labels, "mask": mask}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.encdec:
        out["enc_frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim or 160)).astype(np.float32)
    return out


class DataIterator:
    """Step-indexed iterator; ``skip_to(step)`` is O(1) (restart-safe)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def skip_to(self, step: int) -> None:
        self.step = step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = _synthesize(self.cfg, self.step)
        self.step += 1
        return batch

    def peek(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        return _synthesize(self.cfg, self.step if step is None else step)
