"""Training traffic: seeded synthetic token rows, held on the device.

``MarkovTokenStream`` is a frozen copy of ``repro_torch.data``'s
stream (a Zipf-weighted order-1 Markov chain over the vocabulary, the
port's stand-in for C4), drawing the same numpy RNG calls, so a shard's
rows equal the port's for the same (seed, shard).  It returns numpy
rows; the benchmark never times it.

``make_pool`` draws ``rows`` packed sequences per worker shard in
set-up, one stream per shard as ``repro_torch.data.make_shard_streams``
makes them, and moves them to the device.  ``PoolStream`` hands them
out through ``next_batch(b)``, the interface the port's trainer reads,
in order and wrapping round, and records every draw so that the check
can give the reference the same rows.

The mixes are the ``*.json`` files beside this module: the sequence
length, workers per trainer, inner steps per round, the rows held per
shard, the AdLoCo settings and the batch settings in multiples of the
configuration's ``b_max``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


class MarkovTokenStream:
    """Per-shard synthetic stream.  Shards use disjoint RNG streams but a
    shared transition structure (same distribution, distinct samples)."""

    def __init__(self, vocab_size: int, seq_len: int, shard: int = 0,
                 seed: int = 0, branch: int = 4):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, shard]))
        struct = np.random.default_rng(np.random.SeedSequence([seed, 12345]))
        ranks = np.arange(1, vocab_size + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.branch = branch
        self.succ = struct.integers(0, vocab_size, (vocab_size, branch))
        self.mix = 0.8          # P(follow chain) vs unigram resample

    def next_batch(self, batch_size: int) -> np.ndarray:
        """-> (batch_size, seq_len) int64 token rows."""
        B, S = batch_size, self.seq_len
        out = np.empty((B, S), np.int64)
        out[:, 0] = self.rng.choice(self.vocab, size=B, p=self.unigram)
        follow = self.rng.random((B, S)) < self.mix
        which = self.rng.integers(0, self.branch, (B, S))
        resample = self.rng.choice(self.vocab, size=(B, S), p=self.unigram)
        for t in range(1, S):
            chained = self.succ[out[:, t - 1], which[:, t]]
            out[:, t] = np.where(follow[:, t], chained, resample[:, t])
        return out


class PoolStream:
    """A shard's rows on the device, handed out in order, wrapping round.
    ``draws`` records each ``next_batch`` as (first row, rows)."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.pos = 0
        self.draws: List[Tuple[int, int]] = []

    def take(self, start: int, b: int) -> torch.Tensor:
        """Rows start .. start+b-1 of the pool, wrapping round."""
        n = self.rows.shape[0]
        start %= n
        if start + b <= n:
            return self.rows[start:start + b]
        idx = (torch.arange(b, device=self.rows.device) + start) % n
        return self.rows[idx]

    def next_batch(self, b: int) -> Dict[str, torch.Tensor]:
        self.draws.append((self.pos, b))
        out = self.take(self.pos, b)
        self.pos = (self.pos + b) % self.rows.shape[0]
        return {"tokens": out}


def make_pool(vocab_size: int, seq_len: int, shards: int, rows: int,
              seed: int, device) -> List[PoolStream]:
    """One ``PoolStream`` of ``rows`` sequences per shard, from
    ``MarkovTokenStream(vocab_size, seq_len, shard, seed)``."""
    return [PoolStream(torch.from_numpy(
        MarkovTokenStream(vocab_size, seq_len, shard=i, seed=seed)
        .next_batch(rows)).to(device)) for i in range(shards)]
