"""Pluggable execution backends for the cluster runtime.  Port of
``repro/cluster/backend.py``.

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
:class:`TorchProcessBackend`
    One OS process per worker on ``torch.distributed`` (see
    ``repro_torch.cluster.launch_mp``): every process runs the *same*
    deterministic event loop, computes only its own worker's inner
    steps, and the outer reduction executes as real all-reduces across
    processes.  The simulated clock still comes from the
    analytic network model (reports stay comparable), while the wall
    clock each collective took is recorded apart
    (``ClusterReport.real_comm_time`` and per-event ``real_s``).  When
    the pricing network is a ``Topology``, the participant-pruned fabric
    tree becomes one process group per sibling set of each level, so
    the reduction runs intra-leaf groups first, then the cross-domain
    groups (an unbalanced participant tree falls back to one flat
    group).

Lockstep contract (distributed backends): every process must pop the
same events in the same order, so collectives launch identically
everywhere — pricing is pure float arithmetic on state every process
replicates (profiles, network, scenario).  Adaptive batching joins the
contract through the batch-stats all-reduce
(:meth:`CollectiveBackend.stats_reducer`): each rank contributes its
worker's gradient rows to the exact two-phase composition of
``repro_torch.core.batching.distributed_stats``, so every rank derives
the identical requested batch from the identical reduced statistics.
Multi-trainer pools (MIT, paper §4.1) map onto *disjoint process
groups*: with ``k > 1`` trainers of ``M`` workers each, trainer t owns
the rank block ``[t*M, (t+1)*M)``, its outer sync reduces over its own
groups only, and merges (``merge_reducer``) are one SUM over every
rank whose result lands replicated everywhere.
:meth:`TorchProcessBackend.validate` rejects what would let processes
diverge: the rank-local per-sample probe estimator across processes,
elastic joins/leaves and autoscaling, and adaptive batching over
``k > 1``.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.cluster.network import NetworkModel
from repro_torch.cluster.node import NodeProfile
from repro_torch.core import batching
from repro_torch.core.diloco import stack_params

F32 = torch.float32


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


class NetworkPricing(CollectiveBackend):
    """The simulated clock every backend here keeps: each pricing call
    goes to ``self.network`` (a :class:`NetworkModel` or
    :class:`Topology`)."""

    network: NetworkModel

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


class SimBackend(NetworkPricing):
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


class TorchProcessBackend(NetworkPricing):
    """Real multi-process execution over ``torch.distributed``.

    Construct *after* ``torch.distributed.init_process_group`` (see
    ``repro_torch.cluster.launch_mp``, which spawns one process per
    worker); without an initialized group the world is this process
    alone and every collective is the identity, which is what the
    in-process tests exercise.  Worker m lives on rank m.  The default
    group must carry CPU tensors (gloo, or a group with a CPU backend):
    ``mean_scalar`` gathers host scalars.

    The JAX package's mesh becomes process groups: the participant
    tree of the pricing ``Topology`` (or one flat level) gives nested
    levels, and each sibling set of each level is one
    ``dist.new_group``.  With ``k > 1`` a leading trainer level indexes
    the disjoint per-trainer blocks; outer syncs never reduce over it,
    merges do.  Every rank creates every group in one fixed order at its
    first collective (``new_group`` is itself collective), and the
    groups are kept for later runs.

    Wire dtype: f32.  The outer reduction flattens the local worker's
    params (and a fused stats vector) into one f32 buffer; each level
    is an ``all_reduce(SUM)`` then a division of the params by the
    level's size, innermost level first — the order of JAX's ``pmean``
    chain.  At M = 2 the sum of two f32 values then ``/2`` is the f32
    mean ``SimBackend``'s outer step takes of the stacked params, bit for
    bit; at M = 4 the transport's summation order may differ from
    ``torch.mean``'s by f32 rounding.  Tensors stay on ``device``; gloo
    stages CUDA tensors through pinned host memory itself.
    """

    name = "torch"

    def __init__(self, network: Optional[NetworkModel] = None, *,
                 device=None):
        self.network = network if network is not None else NetworkModel()
        up = dist.is_available() and dist.is_initialized()
        self.num_processes = dist.get_world_size() if up else 1
        self.rank = dist.get_rank() if up else 0
        self.device = resolve_device(device)
        self._k = 1                  # trainer groups (validate sets it)
        self._M = 1                  # workers per group
        self._last_measured: Optional[float] = None
        self._last_stats_measured: Optional[float] = None
        self._last_merge_measured: Optional[float] = None
        self._last_phase2: Optional[torch.Tensor] = None
        self._profiles: Optional[List[NodeProfile]] = None
        # per level, outermost first: (this rank's group, level size)
        self._levels: Optional[List[tuple]] = None
        self._group_levels: Optional[List[tuple]] = None
        self._groups: Dict[tuple, Any] = {}   # rank set -> group (shared)
        self._warm: set = set()      # (kind, numel) already run once
        self._trace = None           # wall-clock span sink (attach_trace)
        self._trace_origin = 0.0     # perf_counter at attach -> span t=0

    def for_run(self) -> "TorchProcessBackend":
        run = object.__new__(TorchProcessBackend)
        run.__dict__.update(self.__dict__)
        run.network = copy.deepcopy(self.network)
        return run

    def bind(self, profiles):
        self._profiles = list(profiles)
        self._levels = None          # topology of the run may differ

    def attach_trace(self, trace):
        """Wall-clock spans for every executed collective land in
        ``trace`` on the ``real`` clock, timestamped relative to the
        attach point (run start)."""
        self._trace = trace
        self._trace_origin = time.perf_counter()

    def _record_real(self, kind: str, t0: float, dt: float,
                     tid: int = 0) -> None:
        if self._trace is not None:
            rel = t0 - self._trace_origin
            self._trace.begin(tid, kind, rel, rel + dt, clock="real",
                              rank=self.rank)

    def validate(self, acfg, *, policy, k, M, scenario=(), autoscale=None):
        P = self.num_processes
        if policy not in ("sync", "async"):
            raise ValueError(
                f"TorchProcessBackend supports the sync/async policies, "
                f"not {policy!r} (elastic pools mutate in-process state)")
        if autoscale is not None:
            raise ValueError(
                "autoscaling scripts joins/leaves through the elastic "
                "in-process pool; TorchProcessBackend cannot grow or "
                "shrink its process set mid-run")
        if k * M != P:
            if k == 1:
                raise ValueError(
                    f"one worker per process: nodes_per_gpu={M} but "
                    f"{P} processes are initialized")
            raise ValueError(
                f"one worker per process: k={k} trainers x "
                f"nodes_per_gpu={M} need {k * M} processes, but "
                f"{P} are initialized")
        if acfg.adaptive and k != 1:
            raise ValueError(
                "adaptive batching reduces its statistics over every "
                "process, not per trainer group; multi-trainer (k > 1) "
                "pools run fixed-batch on TorchProcessBackend")
        if acfg.adaptive and P > 1 and acfg.stats_estimator != "microbatch":
            raise ValueError(
                "distributed adaptive batching composes each rank's "
                "microbatch-mean gradients through the stats all-reduce; "
                "the per-sample probe estimator is rank-local and would "
                "desynchronize the batch decision — run with "
                "stats_estimator='microbatch'")
        bad = {e.kind for e in scenario} & {"join", "leave"}
        if bad:
            raise ValueError(f"scenario events {sorted(bad)} need the "
                             f"elastic in-process pool")
        self._k = int(k)
        self._M = int(M)
        self._levels = None          # group structure may have changed

    def _member(self, tid: Optional[int]) -> bool:
        """Trainer ``tid``'s workers are the rank block ``[tid*M,
        (tid+1)*M)``; merges never move ranks between groups."""
        if self._k == 1 or tid is None:
            return True
        return self.rank // self._M == tid

    # ----------------------------------------------------------- groups
    def _balanced_shape(self, ptree):
        """(level shape, flat name order) of a participant tree if every
        sibling subtree has the same shape, else None -> one flat level."""
        if ptree and all(isinstance(x, str) for x in ptree):
            return (len(ptree),), list(ptree)
        subs = [self._balanced_shape(c) for c in ptree]
        if any(s is None for s in subs):
            return None
        shapes = {s for s, _ in subs}
        if len(shapes) != 1:
            return None
        shape, _ = subs[0]
        return ((len(ptree),) + shape,
                [nm for _, order in subs for nm in order])

    def _layout(self):
        """(ranks array shaped like the JAX mesh, number of leading
        trainer levels) — ``JaxProcessBackend._build_mesh``'s layout."""
        if self._profiles is None:
            raise RuntimeError("backend not bound to profiles yet")
        P = self.num_processes
        names = [p.name for p in self._profiles[:P]]
        proc_of = {nm: i for i, nm in enumerate(names)}
        if self._k == 1:
            shape, order = (len(names),), list(names)
            if hasattr(self.network, "participant_tree"):
                spec = self._balanced_shape(
                    self.network.participant_tree(names))
                if spec is not None:
                    shape, order = spec
            lead = 0
        else:
            # trainer t = rank block [t*M, (t+1)*M); the fabric levels
            # nest inside it when every group's participant-pruned tree
            # has the same shape, else each group is one flat row
            k, M = self._k, self._M
            groups = [names[t * M:(t + 1) * M] for t in range(k)]
            sub = None
            if hasattr(self.network, "participant_tree"):
                specs = [self._balanced_shape(
                    self.network.participant_tree(g)) for g in groups]
                if (all(s is not None for s in specs)
                        and len({s[0] for s in specs}) == 1):
                    sub = (specs[0][0],
                           [nm for _, order in specs for nm in order])
            if sub is not None:
                shape, order = (k,) + sub[0], sub[1]
            else:
                shape, order = (k, M), [nm for g in groups for nm in g]
            lead = 1
        ranks = np.array([proc_of[nm] for nm in order]).reshape(shape)
        return ranks, lead

    def _build_groups(self):
        """One process group per sibling set of every level with more
        than one member; every rank walks the same sets in the same
        order and creates each group once per process."""
        ranks, lead = self._layout()
        levels = []
        for ax in range(ranks.ndim):
            size = ranks.shape[ax]
            mine = None
            if size > 1:
                for row in np.moveaxis(ranks, ax, -1).reshape(-1, size):
                    key = tuple(int(r) for r in row)
                    if key not in self._groups:
                        self._groups[key] = dist.new_group(list(key))
                    if self.rank in key:
                        mine = self._groups[key]
            levels.append((mine, size))
        self._levels = levels
        self._group_levels = levels[lead:]

    def _ensure_groups(self):
        if self._levels is None:
            self._build_groups()

    # ------------------------------------------------------ reductions
    def _start(self, buf, levels, n_mean: int) -> dict:
        """Start reducing ``buf`` in place over ``levels``, innermost
        first: the first level's ``all_reduce(SUM)`` is issued without
        waiting; the rest follow in :meth:`_finish` (each level needs
        the one before it, and a gloo result cannot be read before its
        ``wait``).  The first ``n_mean`` entries are divided by each
        level's size (a mean); the rest stay sums."""
        todo = [(g, n) for g, n in reversed(levels) if n > 1]
        work = (dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=todo[0][0],
                                async_op=True) if todo else None)
        return {"buf": buf, "todo": todo, "work": work, "n_mean": n_mean}

    def _finish(self, pend: dict) -> torch.Tensor:
        buf, n = pend["buf"], pend["n_mean"]
        for i, (group, size) in enumerate(pend["todo"]):
            if i == 0:
                pend["work"].wait()
            else:
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            if n:
                buf[:n].div_(size)
        if buf.is_cuda:
            torch.cuda.current_stream(buf.device).synchronize()
        return buf

    def _timed(self, kind: str, buf, levels, n_mean: int,
               tid: int = 0) -> float:
        """Blocking reduction of ``buf`` in place, warmed up first;
        records a ``kind`` span and returns its wall seconds."""
        self._warm_up(kind, buf, levels, n_mean)
        t0 = time.perf_counter()
        self._finish(self._start(buf, levels, n_mean))
        dt = time.perf_counter() - t0
        self._record_real(kind, t0, dt, tid=tid)
        return dt

    def _warm_up(self, kind: str, buf, levels, n_mean: int) -> None:
        """Run a reduction of ``buf``'s size once, untimed, the first
        time ``kind`` meets it, so the transport's set-up lands outside
        the measured window (every rank reaches it in lockstep, so the
        extra collective is identical everywhere)."""
        sig = (kind, buf.numel())
        if sig in self._warm:
            return
        if any(n > 1 for _, n in levels):
            self._finish(self._start(torch.zeros_like(buf), levels, n_mean))
        self._warm.add(sig)

    def _flat(self, tree, extra=None, *, zeros: bool = False):
        """One f32 buffer on ``device``: the tree's tensors in key order
        (zeros when ``zeros``), then ``extra``."""
        n = sum(t.numel() for t in tree.values())
        m = 0 if extra is None else int(extra.numel())
        if zeros:
            buf = torch.zeros(n + m, dtype=F32, device=self.device)
        else:
            buf = torch.empty(n + m, dtype=F32, device=self.device)
            off = 0
            for t in tree.values():
                buf[off:off + t.numel()].copy_(t.reshape(-1))
                off += t.numel()
        if extra is not None:
            buf[n:].copy_(torch.as_tensor(extra).reshape(-1))
        return buf, n

    @staticmethod
    def _unflat(buf, template, lead=(1,)):
        """{name: f32 view of ``buf`` shaped ``lead + template[name]``}."""
        out, off = {}, 0
        for k, t in template.items():
            out[k] = buf[off:off + t.numel()].view(lead + tuple(t.shape))
            off += t.numel()
        return out

    # -------------------------------------------------------- execution
    def local_workers(self, M, *, tid=None):
        if self.num_processes == 1 and M == 1:
            return [0]
        if self._k == 1:
            return [self.rank]
        return [self.rank % self._M] if self._member(tid) else []

    def outer_reduce(self, worker_params):
        local = [wp for wp in worker_params if wp is not None]
        if len(local) != 1:
            raise ValueError(f"expected exactly the local worker's "
                             f"params, got {len(local)} entries")
        self._ensure_groups()
        buf, n = self._flat(local[0])
        self._last_measured = self._timed("outer", buf, self._group_levels,
                                          n)
        # every rank now holds its group's mean: a (1, ...) worker axis
        # that make_outer_step's mean passes through unchanged
        return self._unflat(buf, local[0])

    def dispatch_outer(self, worker_params, *, stats_vec=None,
                       phase2=None, tid=None, template=None):
        local = [wp for wp in worker_params if wp is not None]
        member = self._member(tid)
        if member:
            if len(local) != 1:
                raise ValueError(f"expected exactly the local worker's "
                                 f"params, got {len(local)} entries")
            tree = local[0]
        else:
            # outside trainer tid's group: reduce zeros shaped like the
            # template in this rank's own group (lockstep); the runtime
            # discards the result
            if local:
                raise ValueError("rank outside the trainer's group "
                                 "computed worker params")
            if template is None:
                raise ValueError("non-member dispatch needs a params "
                                 "template")
            tree = template
        self._ensure_groups()
        fused = stats_vec is not None
        # piggyback: the phase-1 [colsum, b] vector rides the same
        # buffer as the params — one collective per level, not two
        buf, n = self._flat(tree, stats_vec, zeros=not member)
        self._warm_up("piggyback" if fused else "outer", buf,
                      self._group_levels, n)
        chain = fused and phase2 is not None and self.num_processes > 1
        if chain:
            # the five phase-2 moments are reduced at wait time, inside
            # this window; warm their size now
            self._warm_up("stats", torch.zeros(5, dtype=F32,
                                               device=self.device),
                          self._levels, 0)
        t0 = time.perf_counter()
        handle = {"pend": self._start(buf, self._group_levels, n),
                  "t0": t0, "fused": fused, "n": n, "template": tree}
        if chain:
            handle["phase2"] = phase2
        return handle

    def wait_outer(self, handle):
        buf = self._finish(handle["pend"])
        n = handle["n"]
        if "phase2" in handle:
            # the phase-2 five-moment reduction needs ḡ from the phase-1
            # total, which a gloo collective only yields after its wait:
            # compute and reduce the moments now, inside the window
            tot = buf[n:]
            gbar = tot[:-1] / torch.clamp(tot[-1], min=1.0)
            m = batching.shard_moments(handle["phase2"]["G_local"], gbar)
            self._last_phase2 = self._finish(self._start(m, self._levels, 0))
        t0 = handle["t0"]
        dt = time.perf_counter() - t0
        self._last_measured = dt
        # the recorded span is the true in-flight window: dispatch ->
        # ready, spanning whatever inner compute ran in between (and
        # any chained phase-2 moments reduction)
        self._record_real("piggyback" if handle["fused"] else "outer",
                          t0, dt)
        params = self._unflat(buf, handle["template"])
        return params, (buf[n:] if handle["fused"] else None)

    def pop_phase2_total(self):
        v, self._last_phase2 = self._last_phase2, None
        return v

    def note_real_compute(self, t0, dt, *, tid=0):
        self._record_real("compute", t0, dt, tid=tid)

    def mean_scalar(self, value, *, tid=None):
        if self.num_processes == 1:
            return float(value)
        if self._k == 1:
            contrib = float(value)
        else:
            # group mean as a masked gather-sum: members contribute
            # value/M, everyone else zero; every rank joins (lockstep)
            contrib = (float(value) / self._M) if self._member(tid) else 0.0
        got = [torch.zeros(1, dtype=F32) for _ in range(self.num_processes)]
        dist.all_gather(got, torch.tensor([contrib], dtype=F32))
        got = torch.cat(got)
        return float(torch.mean(got) if self._k == 1 else torch.sum(got))

    def merge_reducer(self):
        """Merges/consolidates as real cross-group collectives: member
        ranks contribute their trainer's replica scaled by ``weight/M``
        (each of the group's M ranks carries 1/M of its share), the
        others zeros, and one SUM over every level folds the weighted
        parameter sum and the total weight; the division lands the
        batch-weighted average replicated on every rank.  None when the
        pool lives in one process."""
        if self.num_processes == 1 or self._k == 1:
            return None

        def merge_reduce(trainers, weights, *, kind="merge", tid=0):
            self._ensure_groups()
            template = trainers[0].params
            mine, w = None, 0.0
            for t, wt in zip(trainers, weights):
                if self._member(t.tid):
                    mine, w = t.params, float(wt)
            if mine is None:
                buf, n = self._flat(template, torch.zeros(1), zeros=True)
            else:
                wrow = w / float(self._M)
                buf, n = self._flat(mine, torch.full((1,), wrow))
                buf[:n].mul_(wrow)
            dt = self._timed(kind, buf, self._levels, 0, tid=tid)
            self._last_merge_measured = (
                (self._last_merge_measured or 0.0) + dt)
            avg = self._unflat(buf[:n] / buf[n], template, ())
            return {k: v.to(template[k].dtype) for k, v in avg.items()}

        return merge_reduce

    def pop_merge_measured(self):
        m, self._last_merge_measured = self._last_merge_measured, None
        return m

    def stats_reducer(self):
        """Cross-process SUM of a small f32 vector over every level —
        the batch-stats phases ride the groups the pricing ``Topology``
        defines.  None on a single process: the in-process estimator
        already sees every worker, and must stay bit-identical to the
        SimBackend."""
        if self.num_processes == 1:
            return None

        def reduce_sum(vec):
            self._ensure_groups()
            buf = torch.as_tensor(vec, dtype=F32).reshape(-1).to(
                self.device, copy=True)
            dt = self._timed("stats", buf, self._levels, 0)
            self._last_stats_measured = (
                (self._last_stats_measured or 0.0) + dt)
            return buf

        return reduce_sum

    def pop_stats_measured(self):
        m, self._last_stats_measured = self._last_stats_measured, None
        return m

    def broadcast_params(self, params):
        """Rank 0's params on every rank, tensor by tensor in sorted key
        order (the caller's tensors are not written)."""
        if self.num_processes == 1:
            return params
        out = {}
        for k in sorted(params):
            t = params[k].detach().clone(memory_format=torch.contiguous_format)
            dist.broadcast(t, src=0)
            out[k] = t
        return {k: out[k] for k in params}

    def pop_measured(self):
        m, self._last_measured = self._last_measured, None
        return m


__all__ = ["CollectiveBackend", "SimBackend", "TorchProcessBackend"]
