"""Batch-growth autoscaling policies: co-scale the worker pool with the
adaptive batch.  Port of ``repro/cluster/autoscale.py`` (plain Python).

AdLoCo's batch-size tests grow the requested global batch roughly
exponentially over training (Theorem 2's ln-N communication profile).
With a fixed pool each trainer's *share* of that batch — its
gradients-per-worker — grows with it, so late rounds pay ever-longer
compute phases while early rounds under-utilize the fleet.  The adadamp
observation is that scaling the worker pool *with* the batch keeps
gradients-per-worker approximately constant, turning batch growth into
fleet growth instead of per-round slowdown.

An :class:`ElasticPolicy` observes each round boundary's decided batch
(the :class:`~repro_torch.core.adloco.BatchPlanProtocol` output folded into
``TrainerState.requested_batch``) and scripts joins/leaves through the
existing elastic machinery: the runtime turns its verdict into ordinary
``join``/``leave`` cluster events, so scripted scale-ups pay the real
``point_to_point_time`` state-transfer price (and window-edge re-pricing)
that a scenario-driven join would.  Policies therefore need no knowledge
of the event plumbing — they see four numbers and answer with a signed
worker-count delta.

:class:`BandAutoscale` is the reference policy: a hysteresis band on
gradients-per-worker.  ``requested_batch / pool_size`` above ``hi``
requests a join (if spare capacity exists), below ``lo`` requests a
leave (down to ``min_trainers``); a cooldown suppresses thrashing while
a freshly joined trainer's transfer is still in flight.

Use via :class:`~repro_torch.cluster.runtime.ClusterSpec`::

    spec = ClusterSpec(policy="elastic", profiles=profiles,
                       scenario="autoscale_ramp",
                       autoscale=BandAutoscale(lo=2.0, hi=8.0))
    rep, hist = run_cluster(loss_fn, inits, streams, acfg, spec=spec)

Autoscaling requires ``policy="elastic"`` (the only policy with a
spare-node pool) and records ``autoscale`` applied-events plus fabric
trace instants for every action taken.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["ElasticPolicy", "BandAutoscale"]


class ElasticPolicy:
    """Protocol for pool-scaling decisions at round boundaries.

    The runtime calls :meth:`decide` once per completed round-boundary
    (after the batch decision folded, before the policy dispatch) with:

    - ``requested_batch``: the largest decided global batch across the
      alive pool (the batch the fleet must serve next round);
    - ``pool_size``: number of alive trainers;
    - ``spare_capacity``: how many *additional* trainers the free
      stream/node pools could currently stand up;
    - ``rounds_since_change``: round boundaries observed since the last
      non-zero verdict (cooldown clock — resets on every action).

    Return a signed worker delta: ``+n`` scripts ``n`` join events,
    ``-n`` scripts ``n`` leave events, ``0`` holds.  The runtime clamps
    joins to spare capacity (exhausted spares record a ``join_skipped``
    applied-event rather than failing) and never scripts the last
    trainer away.
    """

    def decide(self, *, requested_batch: int, pool_size: int,
               spare_capacity: int, rounds_since_change: int) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class BandAutoscale(ElasticPolicy):
    """Keep gradients-per-worker inside ``[lo, hi]`` (adadamp band).

    One worker per verdict: scale-ups pay a real state transfer each,
    so stepping keeps the transfer pipeline (and its re-pricing) honest
    rather than teleporting the pool to the target size.

    - ``lo``/``hi``: gradients-per-worker band.  Above ``hi`` → join,
      below ``lo`` → leave.  ``hi`` should be ≥ ``2 * lo`` or the
      post-action share immediately re-crosses the far edge and the
      pool oscillates.
    - ``min_trainers``/``max_trainers``: hard pool bounds (``None`` =
      no upper bound beyond physical spares).
    - ``cooldown_rounds``: round boundaries to hold after any action —
      lets a joining trainer's transfer land (and the batch decision
      refresh) before re-evaluating.
    """

    lo: float = 2.0
    hi: float = 8.0
    min_trainers: int = 1
    max_trainers: Optional[int] = None
    cooldown_rounds: int = 1

    def __post_init__(self) -> None:
        if not (0.0 < self.lo < self.hi):
            raise ValueError(
                f"need 0 < lo < hi, got lo={self.lo} hi={self.hi}")
        if self.min_trainers < 1:
            raise ValueError("min_trainers must be >= 1")
        if (self.max_trainers is not None
                and self.max_trainers < self.min_trainers):
            raise ValueError("max_trainers must be >= min_trainers")

    def decide(self, *, requested_batch: int, pool_size: int,
               spare_capacity: int, rounds_since_change: int) -> int:
        if rounds_since_change < self.cooldown_rounds:
            return 0
        g = requested_batch / max(1, pool_size)
        if (g > self.hi and spare_capacity > 0
                and (self.max_trainers is None
                     or pool_size < self.max_trainers)):
            return 1
        if g < self.lo and pool_size > self.min_trainers:
            return -1
        return 0

    def describe(self) -> str:
        cap = "inf" if self.max_trainers is None else str(self.max_trainers)
        return (f"BandAutoscale(lo={self.lo}, hi={self.hi}, "
                f"pool=[{self.min_trainers},{cap}], "
                f"cooldown={self.cooldown_rounds})")
