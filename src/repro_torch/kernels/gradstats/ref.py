"""Plain PyTorch version of the gradstats reduction.

Given G (B, D) per-sample gradients (f32 or bf16), in f32:
  gbar (D,) = column mean                      (``colsum_mean_ref``)
  s (B,)    = per-row squared norms ||g_i||²   (``moments_ref``)
  d (B,)    = per-row inner products <g_i, gbar>
  n2 ()     = ||gbar||²
  b ()      = f32 row count
The CPU path of ``ops.gradstats_reduce`` and ``chip_smoke.py``'s kernel
check use it.
"""
from __future__ import annotations

import torch


def colsum_mean_ref(G: torch.Tensor) -> torch.Tensor:
    return G.float().mean(dim=0)


def moments_ref(G: torch.Tensor, gbar: torch.Tensor):
    G = G.float()
    s = torch.sum(torch.square(G), dim=1)
    d = G @ gbar
    n2 = torch.sum(torch.square(gbar))
    return s, d, n2


def gradstats_reduce_ref(G: torch.Tensor):
    """G (B, D) -> (s (B,), d (B,), n2 (), b ()), all f32."""
    gbar = colsum_mean_ref(G)
    s, d, n2 = moments_ref(G, gbar)
    return s, d, n2, torch.tensor(float(G.shape[0]), device=G.device)
