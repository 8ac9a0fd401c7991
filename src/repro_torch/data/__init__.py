"""Deterministic synthetic LM data pipeline (port of ``repro/data``).

A Zipf-weighted order-1 Markov chain over the vocabulary stands in for
C4: learnable, offline, and the same per-shard stream for every method.
Batches come from the same numpy RNG calls as the JAX package's, so the
tokens are bit-identical; they are handed out as int64 tensors on the
stream's device (``cuda`` unless the caller names another).

``next_batch(b)`` accepts a different b every call (adaptive batching)
and stays deterministic given (seed, shard, call sequence).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


class MarkovTokenStream:
    """Per-shard synthetic stream.  Shards use disjoint RNG streams but a
    *shared* transition structure (same distribution, distinct samples)."""

    def __init__(self, vocab_size: int, seq_len: int, shard: int = 0,
                 num_shards: int = 1, seed: int = 0, branch: int = 4, *,
                 device=None):
        self.device = resolve_device(device)
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
        self.tokens_served = 0

    def next_batch(self, batch_size: int):
        """-> {"tokens": (batch_size, seq_len) int64 tensor}."""
        B, S = batch_size, self.seq_len
        out = np.empty((B, S), np.int64)
        out[:, 0] = self.rng.choice(self.vocab, size=B, p=self.unigram)
        follow = self.rng.random((B, S)) < self.mix
        which = self.rng.integers(0, self.branch, (B, S))
        resample = self.rng.choice(self.vocab, size=(B, S), p=self.unigram)
        for t in range(1, S):
            chained = self.succ[out[:, t - 1], which[:, t]]
            out[:, t] = np.where(follow[:, t], chained, resample[:, t])
        self.tokens_served += B * S
        return {"tokens": torch.from_numpy(out).to(self.device)}


def make_shard_streams(vocab_size: int, seq_len: int, num_shards: int,
                       seed: int = 0, *, device=None):
    """One stream per trainer worker (the paper's D_i shards)."""
    return [MarkovTokenStream(vocab_size, seq_len, shard=i,
                              num_shards=num_shards, seed=seed, device=device)
            for i in range(num_shards)]


# ------------------------------------------------------------------
# Convex proxy problem: least squares f(x; (a,b)) = 0.5 (a.x - b)^2
# ------------------------------------------------------------------

class QuadraticProblem:
    """Stochastic least-squares with controllable gradient noise sigma.
    Samples are f32 (JAX runs with x64 off)."""

    def __init__(self, dim: int = 32, noise: float = 1.0, seed: int = 0, *,
                 device=None):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.dim = dim
        self.noise = noise
        self.x_star = rng.standard_normal(dim)
        self.rng = rng

    def sample(self, batch_size: int, shard_rng=None):
        rng = shard_rng or self.rng
        A = rng.standard_normal((batch_size, self.dim))
        b = A @ self.x_star + self.noise * rng.standard_normal(batch_size)
        return (torch.from_numpy(A).to(self.device, torch.float32),
                torch.from_numpy(b).to(self.device, torch.float32))

    @staticmethod
    def loss(x, A, b):
        r = A @ x - b
        return 0.5 * torch.mean(torch.square(r))

    @staticmethod
    def per_sample_grads(x, A, b):
        r = A @ x - b                       # (B,)
        return A * r[:, None]               # (B, dim)
