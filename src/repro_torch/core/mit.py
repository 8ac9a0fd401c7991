"""Multi-Instance Training (paper §4.1): trainer pool, CheckMerge
(Algorithm 1) and DoMerge (Algorithm 2).  Port of ``repro/core/mit.py``.

``do_merge`` and ``consolidate`` accept the JAX package's ``reduce``
hook (a cross-process collective that returns the merged parameters);
the port has no execution backend yet, so every call site here passes
None and the in-process ``merge_params`` runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.core.comms import CommsMeter, param_bytes
from repro_torch.core.diloco import merge_params

MergeReduce = Callable[..., Any]


@dataclass
class TrainerState:
    """One trainer instance T_i (may span multiple workers/GPUs)."""

    tid: int
    params: Any                           # x_{T_i}: {name: tensor}
    outer_opt_state: Any
    inner_opt_states: List[Any]           # one per worker m in M
    requested_batch: int = 1              # b_i^req
    streams: List[Any] = field(default_factory=list)   # per-worker data


@dataclass
class TrainerPoolState:
    trainers: List[TrainerState]
    comms: CommsMeter = field(default_factory=CommsMeter)
    global_params: Any = None             # final consolidated model
    outer_opt_state: Any = None

    @property
    def k(self) -> int:
        return len(self.trainers)


def check_merge(requested_batches: List[int], w: int) -> List[int]:
    """Algorithm 1: indices of the w trainers with the smallest requested
    batch (proxy for least-advanced optimization).  Empty when w == 0 or
    k <= 1; w is clamped to k, so w >= k merges the whole pool."""
    k = len(requested_batches)
    if w == 0 or k <= 1:
        return []
    w = min(w, k)
    order = sorted(range(k), key=lambda i: (requested_batches[i], i))
    return order[:w]


def do_merge(pool: TrainerPoolState, merge_ids: List[int], step: int,
             *, reduce: Optional[MergeReduce] = None) -> TrainerPoolState:
    """Algorithm 2: weighted average of the merge set, keep the
    representative with the largest requested batch, carry its optimizer
    state forward; pool contracts by |S| − 1."""
    if len(merge_ids) <= 1:
        return pool
    S = [pool.trainers[i] for i in merge_ids]
    weights = [max(t.requested_batch, 1) for t in S]
    rep = max(S, key=lambda t: (t.requested_batch, -t.tid))
    if reduce is not None:
        merged = reduce(S, weights, kind="merge", tid=rep.tid)
    else:
        merged = merge_params([t.params for t in S], weights)
    rep.params = merged
    # the representative inherits the union of data shards
    for t in S:
        if t is not rep:
            rep.streams.extend(t.streams)
    survivors = [t for i, t in enumerate(pool.trainers)
                 if i not in set(merge_ids) or t is rep]
    pool.comms.record("merge", participants=len(S),
                      payload_bytes=param_bytes(rep.params), step=step)
    pool.trainers = survivors
    return pool


def consolidate(pool: TrainerPoolState, step: int,
                *, reduce: Optional[MergeReduce] = None):
    """Final model: batch-size-weighted merge of all surviving trainers.
    A pool of one is free (no comms event), as in the JAX package."""
    weights = [max(t.requested_batch, 1) for t in pool.trainers]
    if reduce is not None:
        pool.global_params = reduce(pool.trainers, weights,
                                    kind="consolidate",
                                    tid=pool.trainers[0].tid)
    elif pool.k == 1:
        pool.global_params = pool.trainers[0].params
        return pool
    else:
        pool.global_params = merge_params(
            [t.params for t in pool.trainers], weights)
    if pool.k > 1:
        pool.comms.record("consolidate", participants=pool.k,
                          payload_bytes=param_bytes(pool.global_params),
                          step=step)
    return pool
