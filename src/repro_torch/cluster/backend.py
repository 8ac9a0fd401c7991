"""Pluggable execution backends for the cluster runtime.  Port of
``repro/cluster/backend.py``, the protocol and the sim backend.

``Topology`` describes *where* a hierarchical all-reduce runs — which
fabric domains a collective crosses and what each level's paths cost.
A :class:`CollectiveBackend` supplies *how*: the runtime's event loop
calls only this interface, so a backend that executes collectives
across processes plugs in without touching the loop.

:class:`SimBackend`
    The default.  Collectives are *priced* analytically (delegating to
    the wrapped :class:`~repro_torch.cluster.network.NetworkModel` /
    :class:`~repro_torch.cluster.network.Topology`) and *executed* in
    this process: the outer reduction stacks the workers' tensors key
    by key (``torch.stack``) on the params' device.  Pricing is plain
    Python float arithmetic, so the simulated clock agrees with the JAX
    package's ``SimBackend`` to the bit.

The multi-process backend of the JAX package (one process per worker,
real collectives) is not ported here; its hooks (``stats_reducer``,
``merge_reducer``, the ``pop_*`` measurements) keep the protocol's
single-process answers.  Lockstep contract for such a backend: every
process must pop the same events in the same order, so collectives
launch identically everywhere — pricing is pure float arithmetic on
state every process replicates (profiles, network, scenario).
"""
from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.cluster.network import NetworkModel
from repro_torch.cluster.node import NodeProfile
from repro_torch.core.diloco import stack_params


class CollectiveBackend:
    """Protocol: pricing (simulated clock) + execution (numerics).

    Pricing methods mirror the network-model interface so the runtime
    can stay network-agnostic; execution methods carry the actual
    parameter movement.  ``outer_reduce`` must return a ``{name:
    tensor}`` dict whose tensors have a leading *worker* axis ready for
    ``repro_torch.core.diloco.make_outer_step``'s mean — either the
    full (M, ...) stack (sim) or an already-reduced (1, ...) mean (real
    collectives).
    """

    name = "abstract"

    # ------------------------------------------------------------ setup
    def for_run(self) -> "CollectiveBackend":
        """Per-run copy of the mutable pricing state (the runtime opens
        fabric windows and the sim draws jitter); process-level handles
        (meshes, distributed clients) are shared, not copied."""
        raise NotImplementedError

    def bind(self, profiles: Sequence[NodeProfile]) -> None:
        """Associate the run's node profiles (index i = worker i)."""

    def validate(self, acfg, *, policy: str, k: int, M: int,
                 scenario: Sequence[Any] = (),
                 autoscale: Optional[Any] = None) -> None:
        """Reject configurations this backend cannot execute."""

    def attach_trace(self, trace) -> None:
        """Record *wall-clock* spans for executed collectives into
        ``trace`` (see ``repro_torch.cluster.trace``).  Pricing-only backends
        ignore it — the runtime records the simulated spans itself."""

    # ---------------------------------------------------------- pricing
    def allreduce_time(self, payload_bytes: float,
                       nodes: Sequence[NodeProfile], *,
                       now: float = 0.0) -> float:
        raise NotImplementedError

    def point_to_point_time(self, payload_bytes: float, src: NodeProfile,
                            dst: NodeProfile, *, now: float = 0.0) -> float:
        raise NotImplementedError

    def add_fabric_window(self, start: float,
                          duration: Optional[float] = None, *,
                          bw_scale: float = 1.0, extra_latency: float = 0.0,
                          scope: str = "all") -> None:
        raise NotImplementedError

    def fabric_change_points(self) -> List[float]:
        return []

    # -------------------------------------------------------- execution
    def local_workers(self, M: int, *,
                      tid: Optional[int] = None) -> Optional[List[int]]:
        """Worker indices this process computes for trainer ``tid``;
        None means all (the single-process sim).  Multi-group backends
        return ``[]`` on ranks outside the trainer's group — those
        ranks still participate in its collectives (lockstep), they
        just contribute nothing."""
        return None

    def outer_reduce(self, worker_params: List[Any]) -> Any:
        """List of per-worker params dicts (None for workers that live
        on other processes) -> dict with a leading worker axis."""
        raise NotImplementedError

    # ------------------------------------------- dispatch/handle split
    #
    # The nonblocking contract: ``dispatch_outer`` *starts* the outer
    # collective (optionally fused with the phase-1 batch-stats vector —
    # Lau-style piggybacking) and returns an opaque handle immediately;
    # ``wait_outer`` blocks until the wire work is done, records the
    # *true in-flight window* (dispatch -> ready) as the measured
    # wall-clock span, and returns the results.  The runtime dispatches
    # at the sim's launch point and waits at the rebase/fold point, so
    # the next round's inner steps run while the collective is in
    # flight.  Every rank reaches both calls in the same (lockstep)
    # event order, so dispatch order is identical everywhere.  Handles
    # are per-trainer: with k > 1 groups (or async stats) several can
    # be in flight together, dispatched in lockstep order.  A handle
    # abandoned by preemption (a merge superseding an in-flight sync)
    # is safe to drop on real backends too: the collective was already
    # enqueued on *every* rank at dispatch, so nobody blocks on a
    # missing partner — the result is simply never read.

    def dispatch_outer(self, worker_params: List[Any], *,
                       stats_vec: Optional[Any] = None,
                       phase2: Optional[dict] = None,
                       tid: Optional[int] = None,
                       template: Optional[Any] = None) -> Any:
        """Start the outer reduction; with ``stats_vec`` (the phase-1
        ``[colsum, b]`` f32 vector) the collective is fused: one wire
        operation reduces both payloads.  ``phase2`` (the deferred
        stats request carrying ``G_local``/``micro``) lets a real
        backend chain the five-moment phase-2 reduction onto the same
        in-flight window — the summed moments surface later through
        :meth:`pop_phase2_total`.  ``tid``/``template`` support
        multi-group backends: ranks outside trainer ``tid``'s group
        contribute zeros shaped like ``template`` (their group's
        result is discarded).  Returns an opaque handle."""
        raise NotImplementedError

    def wait_outer(self, handle) -> tuple:
        """Block on a :meth:`dispatch_outer` handle.  Returns
        ``(stacked, stats_total)``: the worker-stacked (or already
        reduced ``(1, ...)``) params dict, and the SUM-reduced phase-1
        vector (None when no ``stats_vec`` was fused)."""
        raise NotImplementedError

    def note_real_compute(self, t0: float, dt: float, *,
                          tid: int = 0) -> None:
        """Record a wall-clock inner-compute window (perf_counter
        origin) so real-clock overlap is measurable against the
        in-flight collective spans.  Pricing-only backends ignore it."""

    def mean_scalar(self, value: float, *,
                    tid: Optional[int] = None) -> float:
        """Mean of a per-process scalar over trainer ``tid``'s workers
        (loss logging); identity on single-process backends.  Every
        rank calls it (lockstep) and receives the group's mean."""
        return value

    def merge_reducer(self):
        """Callable executing :func:`repro_torch.core.mit.do_merge` /
        ``consolidate`` averages as a real cross-group collective —
        ``reduce(trainers, weights, *, kind, tid)`` returning the
        weighted parameter average replicated on every rank — or None
        when the pool lives in one process (the in-process
        ``merge_params`` already sees every replica)."""
        return None

    def pop_phase2_total(self) -> Optional[Any]:
        """Summed phase-2 moments vector from a fused
        :meth:`dispatch_outer` ``phase2`` chain (cleared on read), or
        None when the backend finished no fused phase-2."""
        return None

    def stats_reducer(self):
        """SUM all-reduce of a small 1-D f32 vector over every
        process, for the adaptive batch-stats composition — or None
        when all workers live in this process (the in-process
        estimators already see every shard)."""
        return None

    def broadcast_params(self, params: Any) -> Any:
        """Coordinator's params on every process (init sync / joins)."""
        return params

    def pop_measured(self) -> Optional[float]:
        """Wall-clock seconds the last ``outer_reduce`` actually spent
        on the wire, or None for backends that only price."""
        return None

    def pop_stats_measured(self) -> Optional[float]:
        """Wall-clock seconds the last stats reduction spent on the
        wire, or None for backends that only price.  A separate slot
        from :meth:`pop_measured`: under async policies a stats
        reduction and an outer collective can be in flight together."""
        return None

    def pop_merge_measured(self) -> Optional[float]:
        """Wall-clock seconds the last merge/consolidate collective
        spent on the wire, or None for backends that only price."""
        return None


class SimBackend(CollectiveBackend):
    """Analytic pricing + in-process execution — the classic runtime.

    Wraps a :class:`NetworkModel` or :class:`Topology` for the clock and
    stacks worker params locally for the numerics, on their device.
    ``for_run`` deep-copies the network so caller-owned fabric schedules
    stay reusable (the same contract ``run_cluster`` has always had).
    """

    name = "sim"

    def __init__(self, network: Optional[NetworkModel] = None):
        self.network = network if network is not None else NetworkModel()

    def for_run(self) -> "SimBackend":
        return SimBackend(copy.deepcopy(self.network))

    # ---------------------------------------------------------- pricing
    def allreduce_time(self, payload_bytes, nodes, *, now=0.0):
        return self.network.allreduce_time(payload_bytes, nodes, now=now)

    def point_to_point_time(self, payload_bytes, src, dst, *, now=0.0):
        return self.network.point_to_point_time(payload_bytes, src, dst,
                                                now=now)

    def add_fabric_window(self, start, duration=None, *, bw_scale=1.0,
                          extra_latency=0.0, scope="all"):
        if not hasattr(self.network, "add_fabric_window"):
            raise ValueError(
                f"network model {type(self.network).__name__} does not "
                f"support fabric events")
        self.network.add_fabric_window(start, duration, bw_scale=bw_scale,
                                       extra_latency=extra_latency,
                                       scope=scope)

    def fabric_change_points(self):
        if hasattr(self.network, "fabric_change_points"):
            return self.network.fabric_change_points()
        return []

    # -------------------------------------------------------- execution
    def outer_reduce(self, worker_params):
        if any(wp is None for wp in worker_params):
            raise ValueError("SimBackend executes every worker in-process;"
                             " got a partial worker set")
        return stack_params(worker_params)

    def dispatch_outer(self, worker_params, *, stats_vec=None,
                       phase2=None, tid=None, template=None):
        # The sim's "wire" is the priced clock, not real time: the stack
        # happens eagerly at dispatch and the handle is just the result.
        # A fused stats_vec reduces over the one process = identity sum;
        # phase2/tid/template are multi-process concerns (the sim holds
        # every worker and every trainer in-process).
        stats = None
        if stats_vec is not None:
            # the f32 vector lives where the params live
            dev = next(iter(worker_params[0].values())).device
            stats = torch.as_tensor(stats_vec, dtype=torch.float32,
                                    device=dev)
        return (self.outer_reduce(worker_params), stats)

    def wait_outer(self, handle):
        return handle


__all__ = ["CollectiveBackend", "SimBackend"]
