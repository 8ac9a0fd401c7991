"""Adaptive batch-size tests (AdAdaGrad family — paper §3.3 / eqs 10,12,13).

Port of ``repro/core/batching.py``.  All three tests reduce to three
statistics over per-sample gradients g_i (i = 1..b) with mean ḡ:

  s_i = ||g_i||²,   d_i = <g_i, ḡ>,   n2 = ||ḡ||²

  norm test       σ² = (Σ s_i − b·n2) / (b−1)
                  b⁺ = ceil( σ² / (η² n2) )                       (eq 10)
  inner-product   v  = Σ (d_i − n2)² / (b−1)
                  b⁺ = ceil( v / (ϑ² n2²) )                       (eq 12)
  augmented       o  = Σ (s_i − d_i²/n2) / (b−1)
                  b⁺ = max(ipt, ceil( o / (ν² n2) ))              (eq 13)

Two estimator paths for the statistics: exact per-sample gradients
(``per_sample_stats``: the gradient of each sample as a batch of one),
and the distributed microbatch estimator (σ² = m·Var(G_j) over the
workers' microbatch-mean gradients).  The (B, D) reduction is the
gradstats kernel pair (``use_kernel=True``: two hand-written CUDA
kernels on a CUDA tensor, their plain version on a CPU tensor) or the
plain version directly.

Distributed composition: given the global mean ḡ, every test is a
function of five additive reductions over the rows,
(b, Σ‖g_i‖², Σ<g_i, ḡ>, Σ<g_i, ḡ>², b·‖ḡ‖²); ``distributed_stats``
reduces ``[colsum, b]`` and then those five with a caller-supplied SUM
all-reduce, so every rank derives the identical batch decision.

All statistics are f32.  Gradient matrices are built one row at a time
into a preallocated f32 matrix; the column order of a row is the order
of the parameter dict, which no statistic depends on.

Where the port adds to the JAX package: a per-sample probe whose (B, D)
f32 matrix does not fit the card runs in row chunks
(``per_sample_probe``), two sweeps that recompute each chunk's
gradients: the first adds the chunks' column sums into one f32 mean,
the second takes each chunk's (s, d) against it.  Memory is R x D + D
floats instead of B x D; the statistics are the same statistics (the
kernel route's column sums add the rows in the one-pass order).
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.diloco import value_and_grad

F32 = torch.float32


class GradStats(NamedTuple):
    """Sufficient statistics for all batching tests (f32 scalars)."""
    mean_norm2: torch.Tensor    # ||ḡ||²
    sigma2: torch.Tensor        # trace-variance of per-sample grads
    ip_var: torch.Tensor        # Var(<g_i, ḡ>)
    orth_var: torch.Tensor      # Var of orthogonal residuals
    b: torch.Tensor             # number of samples the stats came from


def _clamp0(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def stats_from_matrix(G: torch.Tensor, *, use_kernel: bool = False
                      ) -> GradStats:
    """G: (B, D) per-sample (or per-microbatch-mean) flattened gradients."""
    if use_kernel:
        from repro_torch.kernels.gradstats.ops import gradstats_reduce
        s, d, gbar_n2, b = gradstats_reduce(G)
    else:
        from repro_torch.kernels.gradstats.ref import gradstats_reduce_ref
        s, d, gbar_n2, b = gradstats_reduce_ref(G)
    return _stats(s, d, gbar_n2, b)


def _stats(s, d, gbar_n2, b) -> GradStats:
    """GradStats from the per-row (s, d), n2 and the f32 row count."""
    bm1 = torch.clamp(b - 1.0, min=1.0)
    sigma2 = (torch.sum(s) - b * gbar_n2) / bm1
    ip_var = torch.sum(torch.square(d - gbar_n2)) / bm1
    orth_var = (torch.sum(s) - torch.sum(torch.square(d))
                / torch.clamp(gbar_n2, min=1e-30)) / bm1
    return GradStats(gbar_n2, _clamp0(sigma2), _clamp0(ip_var),
                     _clamp0(orth_var), b)


def stats_from_microbatch_grads(grads_stack, micro_size: int, *,
                                use_kernel: bool = False) -> GradStats:
    """grads_stack: {name: (J, ...)} per-microbatch mean grads (each over
    ``micro_size`` samples), rescaled to per-sample units."""
    G = flatten_grads(grads_stack)
    return rescale_microbatch(stats_from_matrix(G, use_kernel=use_kernel),
                              micro_size)


def rescale_microbatch(st: GradStats, micro_size: int) -> GradStats:
    """Microbatch-mean rows to per-sample units (σ² = m·Var(G_j))."""
    m = float(micro_size)             # exact in f32
    return GradStats(st.mean_norm2, st.sigma2 * m, st.ip_var * m,
                     st.orth_var * m, st.b)


# ------------------------------------------------------------------
# distributed composition: additive sufficient statistics
# ------------------------------------------------------------------

def shard_moments(G: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """The five additive statistics of shard ``G`` against the *global*
    mean ``gbar``: f32 ``[b, Σ‖g_i‖², Σ<g_i,ḡ>, Σ<g_i,ḡ>², b·‖ḡ‖²]``."""
    G = G.to(F32)
    gbar = gbar.to(F32)
    b = torch.tensor(float(G.shape[0]), dtype=F32, device=G.device)
    s = torch.sum(torch.square(G), dim=1)
    d = G @ gbar
    n2 = torch.sum(torch.square(gbar))
    return torch.stack([b, torch.sum(s), torch.sum(d),
                        torch.sum(torch.square(d)), b * n2])


def stats_from_moments(m: torch.Tensor) -> GradStats:
    """GradStats from summed :func:`shard_moments`."""
    b, sum_s, sum_d, sum_d2, b_n2 = m[0], m[1], m[2], m[3], m[4]
    n2 = b_n2 / torch.clamp(b, min=1.0)
    bm1 = torch.clamp(b - 1.0, min=1.0)
    sigma2 = (sum_s - b * n2) / bm1
    ip_var = (sum_d2 - 2.0 * n2 * sum_d + b * torch.square(n2)) / bm1
    orth_var = (sum_s - sum_d2 / torch.clamp(n2, min=1e-30)) / bm1
    return GradStats(n2, _clamp0(sigma2), _clamp0(ip_var),
                     _clamp0(orth_var), b)


def stats_phase1(G_local: torch.Tensor) -> torch.Tensor:
    """Phase-1 payload: the ``[colsum, b]`` f32 vector whose SUM
    all-reduce yields the global mean direction."""
    G_local = G_local.to(F32)
    b_local = torch.full((1,), float(G_local.shape[0]), dtype=F32,
                         device=G_local.device)
    return torch.cat([torch.sum(G_local, dim=0), b_local])


def stats_finish(tot: torch.Tensor, G_local: torch.Tensor,
                 sum_reduce: Callable, *, micro_size: int = 0) -> GradStats:
    """Finish the two-phase composition from the reduced phase-1 total:
    derive ḡ, reduce the five :func:`shard_moments`, rescale."""
    G_local = G_local.to(F32)
    gbar = tot[:-1] / torch.clamp(tot[-1], min=1.0)
    st = stats_from_moments(sum_reduce(shard_moments(G_local, gbar)))
    return rescale_microbatch(st, micro_size) if micro_size else st


def stats_finish_total(moments_total, *, micro_size: int = 0) -> GradStats:
    """Finish from an already-reduced phase-2 moments total."""
    st = stats_from_moments(torch.as_tensor(moments_total, dtype=F32))
    return rescale_microbatch(st, micro_size) if micro_size else st


def distributed_stats(G_local: torch.Tensor, sum_reduce: Callable, *,
                      micro_size: int = 0) -> GradStats:
    """Two-phase exact composition across shards.  ``sum_reduce`` is an
    elementwise SUM all-reduce of a small 1-D f32 vector over every
    participating process (identity on a single process)."""
    return stats_finish(sum_reduce(stats_phase1(G_local)), G_local,
                        sum_reduce, micro_size=micro_size)


def compose_shards(shards: Sequence[torch.Tensor], *,
                   micro_size: int = 0) -> GradStats:
    """In-process reference of the distributed protocol over a list of
    shards (as if each lived on its own process)."""
    phase1s = [stats_phase1(G) for G in shards]
    tot = sum(phase1s[1:], start=phase1s[0])
    gbar = tot[:-1] / torch.clamp(tot[-1], min=1.0)
    moments = [shard_moments(G, gbar) for G in shards]
    st = stats_from_moments(sum(moments[1:], start=moments[0]))
    return rescale_microbatch(st, micro_size) if micro_size else st


def stats_payload_bytes(n_params: int) -> float:
    """Wire payload of one stats reduction: the phase-1 ``[colsum, b]``
    f32 vector plus the five phase-2 moments."""
    return 4.0 * (n_params + 1 + 5)


def _flatten_into(row: torch.Tensor, grads: Dict[str, torch.Tensor]) -> None:
    off = 0
    for g in grads.values():
        n = g.numel()
        row[off:off + n].copy_(g.reshape(-1))
        off += n


def flatten_grads(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{name: (B, ...)} -> (B, D) f32 matrix."""
    leaves = list(tree.values())
    B = leaves[0].shape[0]
    D = sum(l[0].numel() for l in leaves)
    G = torch.empty((B, D), dtype=F32, device=leaves[0].device)
    off = 0
    for l in leaves:
        n = l[0].numel()
        G[:, off:off + n].copy_(l.reshape(B, -1))
        off += n
    return G


def per_sample_grads(loss_fn: Callable, params, batch,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, D) f32 matrix whose row i is the gradient of sample i as a
    batch of one (JAX's vmap of grad; here a loop, one row at a time).
    ``out``: an f32 buffer of at least B rows to write into (its first B
    rows are returned)."""
    B = next(iter(batch.values())).shape[0]
    D = sum(p.numel() for p in params.values())
    dev = next(iter(params.values())).device
    G = (torch.empty((B, D), dtype=F32, device=dev) if out is None
         else out[:B])
    for i in range(B):
        sample = {k: v[i:i + 1] for k, v in batch.items()}
        _, _, grads = value_and_grad(loss_fn, params, sample)
        _flatten_into(G[i], grads)
    return G


# Device memory a one-pass probe leaves free beside G: the per-sample
# backward (activations, a sample's gradients in the params' dtype) and
# the allocator's slack.  Two more rows of G are added to it.
PROBE_MARGIN_BYTES = 8 * 2 ** 30


def probe_rows(B: int, D: int, device) -> int:
    """Rows of the per-sample matrix to hold at once: all ``B`` when the
    (B, D) f32 matrix fits the card's free memory less
    ``PROBE_MARGIN_BYTES`` and two rows; else as many rows as fit, at
    least 1.  Always ``B`` off the card.  Free memory is the driver's;
    where that is short, it is read again after the caching allocator
    has returned its unused segments (a cached byte inside a segment
    that still holds a live tensor cannot serve one large request, so
    cached bytes are not counted)."""
    device = torch.device(device)
    if device.type != "cuda":
        return B
    row = 4 * D

    def budget():
        return torch.cuda.mem_get_info(device)[0] - PROBE_MARGIN_BYTES \
            - 2 * row

    if B * row <= budget():
        return B
    torch.cuda.empty_cache()
    b = budget()
    return B if B * row <= b else max(1, b // row)


class ProbeStats(NamedTuple):
    """A per-sample probe's statistics and how it ran."""
    stats: GradStats
    rows: int        # rows of G held at once (B: one pass)
    chunks: int      # row chunks per sweep (1: one pass)


def per_sample_probe(loss_fn: Callable, params, batch, *,
                     use_kernel: bool = False, rows: Optional[int] = None,
                     span: Optional[Callable] = None) -> ProbeStats:
    """Exact path: per-sample gradients, then the (B, D) reduction.

    ``rows`` caps the rows of G held at once (default: ``probe_rows``,
    i.e. one pass wherever G fits).  At R < B rows the probe runs in
    ceil(B / R) row chunks, twice: the first sweep adds each chunk's
    column sums into one f32 accumulator (divided by B on the last
    chunk), the second recomputes each chunk's gradients and takes its
    (s, d) against that mean; n2 comes from the first chunk's moments.
    One (R, D) buffer serves every chunk of both sweeps, and it and the
    (D,) accumulator are allocated before any gradient work, so the
    probe's large allocations cannot be split by the backward passes'
    cached blocks.
    ``span(name)`` (a context manager factory, e.g. the round's
    ``PhaseClock``) wraps gradient work as ``stats_grads`` and the
    reductions as ``stats_reduce``."""
    span = span or (lambda name: nullcontext())
    B = next(iter(batch.values())).shape[0]
    D = sum(p.numel() for p in params.values())
    dev = next(iter(params.values())).device
    R = probe_rows(B, D, dev) if rows is None else max(1, min(int(rows), B))
    if R >= B:
        with span("stats_grads"):
            G = per_sample_grads(loss_fn, params, batch)
        with span("stats_reduce"):
            st = stats_from_matrix(G, use_kernel=use_kernel)
        return ProbeStats(st, B, 1)

    from repro_torch.kernels.gradstats import ops, ref
    colsum = ops.colsum_chunk if use_kernel else ref.colsum_chunk_ref
    moments = ops.moments_chunk if use_kernel else ref.moments_ref
    bounds = [(lo, min(lo + R, B)) for lo in range(0, B, R)]

    buf = torch.empty((R, D), dtype=F32, device=dev)
    gbar = torch.empty((D,), dtype=F32, device=dev)

    def grads(lo, hi):
        with span("stats_grads"):
            return per_sample_grads(loss_fn, params,
                                    {k: v[lo:hi] for k, v in batch.items()},
                                    out=buf)

    for lo, hi in bounds:
        G = grads(lo, hi)
        with span("stats_reduce"):
            colsum(G, gbar, accumulate=lo > 0,
                   divisor=float(B) if hi == B else None)
    s, d, n2 = [], [], None
    for lo, hi in bounds:
        G = grads(lo, hi)
        with span("stats_reduce"):
            s_c, d_c, n2_c = moments(G, gbar)
        s.append(s_c)
        d.append(d_c)
        n2 = n2_c if n2 is None else n2
    b = torch.tensor(float(B), device=dev)
    return ProbeStats(_stats(torch.cat(s), torch.cat(d), n2, b), R,
                      len(bounds))


def per_sample_stats(loss_fn: Callable, params, batch, *,
                     use_kernel: bool = False) -> GradStats:
    """Exact path: per-sample gradients, then the (B, D) reduction (in
    row chunks where G does not fit; see ``per_sample_probe``)."""
    return per_sample_probe(loss_fn, params, batch,
                            use_kernel=use_kernel).stats


# ------------------------------------------------------------------
# the batch-size tests
# ------------------------------------------------------------------

def _ceil_robust(x: torch.Tensor) -> torch.Tensor:
    """``ceil`` with a 1e-6 relative guard band below each integer, so
    the decision agrees across numerically different routes to the same
    statistics (f32 re-association noise of about 1e-7 relative)."""
    return torch.ceil(x * (1.0 - 1e-6))


def norm_test(st: GradStats, eta: float) -> torch.Tensor:
    """eq 10.  Returns requested batch (f32, >= 1)."""
    return _ceil_robust(
        st.sigma2 / (eta ** 2 * torch.clamp(st.mean_norm2, min=1e-30)))


def inner_product_test(st: GradStats, theta: float) -> torch.Tensor:
    """eq 12."""
    return _ceil_robust(
        st.ip_var / (theta ** 2
                     * torch.clamp(st.mean_norm2, min=1e-30) ** 2))


def augmented_test(st: GradStats, theta: float, nu: float) -> torch.Tensor:
    """eq 13: max of the inner-product test and the orthogonality test."""
    b_ipt = inner_product_test(st, theta)
    b_orth = _ceil_robust(st.orth_var /
                          (nu ** 2 * torch.clamp(st.mean_norm2, min=1e-30)))
    return torch.maximum(b_ipt, b_orth)


def requested_batch(st: GradStats, acfg, current_b: int) -> int:
    """Apply the configured test; enforce monotone growth (paper Lemma 1:
    b_{k+1} >= b_k) and the global cap."""
    if acfg.batch_test == "norm":
        b = norm_test(st, acfg.eta)
    elif acfg.batch_test == "inner_product":
        b = inner_product_test(st, acfg.theta)
    elif acfg.batch_test == "augmented":
        b = augmented_test(st, acfg.theta, acfg.nu)
    else:
        raise ValueError(acfg.batch_test)
    b = int(b.item())
    b = max(b, int(current_b))          # monotone non-decreasing
    return int(min(b, acfg.max_global_batch))


# ------------------------------------------------------------------
# predicted batch growth (PadaDamp; Lau et al., arXiv 2406.13936)
# ------------------------------------------------------------------

class BatchGrowthPredictor:
    """Fit ``ln b`` against the round index over the exact decisions
    observed so far, and predict the batch on skipped rounds
    (``acfg.k_correct``).  Pure Python float arithmetic over identical
    observations, so every rank predicts the same batch.  Slope clamped
    non-negative, fitted value floored, growth monotone and capped."""

    def __init__(self, max_global_batch: int):
        self.max_global_batch = int(max_global_batch)
        self._rounds: List[int] = []
        self._batches: List[int] = []

    def observe(self, round_i: int, b: int) -> None:
        """Record an exact decision (correction round)."""
        round_i, b = int(round_i), int(b)
        if b < 1:
            return
        if self._rounds and round_i <= self._rounds[-1]:
            return                      # stale/duplicate fold (async)
        self._rounds.append(round_i)
        self._batches.append(b)

    @property
    def num_observations(self) -> int:
        return len(self._rounds)

    def predict(self, round_i: int, current_b: int) -> int:
        """Predicted batch for ``round_i``; ``current_b`` until two exact
        observations anchor the fit."""
        if len(self._rounds) < 2:
            return int(current_b)
        xs, ys = self._rounds, [math.log(b) for b in self._batches]
        n = float(len(xs))
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        slope = max(0.0, sxy / sxx) if sxx > 0.0 else 0.0
        b = int(math.floor(math.exp(my + slope * (round_i - mx)) + 1e-9))
        b = max(b, int(current_b))      # monotone non-decreasing
        return int(min(b, self.max_global_batch))
