"""Plain PyTorch version of the gradstats reduction.

Given G (B, D) per-sample gradients (f32 or bf16), in f32:
  gbar (D,) = column mean                      (``colsum_mean_ref``)
  s (B,)    = per-row squared norms ||g_i||²   (``moments_ref``)
  d (B,)    = per-row inner products <g_i, gbar>
  n2 ()     = ||gbar||²
  b ()      = f32 row count
The CPU path of ``ops.gradstats_reduce`` and ``chip_smoke.py``'s kernel
check use it.  ``colsum_chunk_ref`` is the accumulate form of the column
sum, for G streamed in row chunks (``core.batching.per_sample_probe``).
"""
from __future__ import annotations

from typing import Optional

import torch


def colsum_chunk_ref(G: torch.Tensor, acc: torch.Tensor, *,
                     accumulate: bool,
                     divisor: Optional[float] = None) -> torch.Tensor:
    """G's column sums in f32 into ``acc`` (D,) in place, added to its
    values when ``accumulate``, divided by ``divisor`` if given (the
    whole probe's row count, on its last chunk); returns ``acc``.  The
    rows are added one at a time in order, as the colsum kernel adds
    them, so row chunks summed this way give the one-pass sum bit for
    bit."""
    if not accumulate:
        acc.zero_()
    for row in G:
        acc += row.float()
    return acc.div_(divisor) if divisor else acc


def colsum_mean_ref(G: torch.Tensor) -> torch.Tensor:
    acc = torch.empty(G.shape[1], dtype=torch.float32, device=G.device)
    return colsum_chunk_ref(G, acc, accumulate=False,
                            divisor=float(G.shape[0]))


def moments_ref(G: torch.Tensor, gbar: torch.Tensor):
    """Row by row, as the moments kernel takes them, so a row's (s, d)
    does not depend on the other rows of G (a matrix-vector product's
    blocking does, in the last bits)."""
    rows = [row.float() for row in G]
    s = torch.stack([torch.dot(r, r) for r in rows])
    d = torch.stack([torch.dot(r, gbar) for r in rows])
    n2 = torch.dot(gbar, gbar)
    return s, d, n2


def gradstats_reduce_ref(G: torch.Tensor):
    """G (B, D) -> (s (B,), d (B,), n2 (), b ()), all f32."""
    gbar = colsum_mean_ref(G)
    s, d, n2 = moments_ref(G, gbar)
    return s, d, n2, torch.tensor(float(G.shape[0]), device=G.device)
