"""Event-driven virtual-cluster runtime for AdLoCo.  Port of
``repro/cluster/runtime.py``.

Drives the :class:`repro_torch.core.adloco.TrainerRound` primitive over
a set of simulated heterogeneous nodes (``node.py``) connected by a
latency + bandwidth fabric (``network.py``).  Numerics are real — every
inner and outer step runs through the same code as the host loop
``train_adloco``, on the params' device (``cuda`` unless the caller
names another) — while *time* is simulated: each round's compute is
costed by the node roofline, each outer sync by the ring all-reduce
model, and a heap of timestamped events decides what happens next.

Sync policies
-------------
``sync``     Barrier semantics of ``train_adloco``: a trainer blocks on
             its outer all-reduce before starting the next round.  With
             identical configs (and merging disabled so trainers stay
             independent) this reproduces the legacy loop bit-for-bit —
             only the clock differs.
``async``    ACCO-style overlap: workers keep accumulating inner steps
             while the outer all-reduce is in flight.  The pseudo-
             gradient is computed against the anchor captured at launch
             and applied when the collective arrives; workers rebase
             (``wp <- x_new + (wp - snapshot)``) at the first round
             boundary after arrival, so in-flight progress is kept.
             With a zero-cost network this degenerates to ``sync``.
``elastic``  ``async`` + scenario events: trainers leave (their state is
             folded into the pool via ``mit.do_merge``) and join
             (cloning the most-advanced trainer onto spare nodes and
             streams) mid-run.

Simulation granularity: compute for a round is executed eagerly when the
round is scheduled, so a collective that arrives mid-round takes effect
at the next round boundary; a merge interrupts the in-flight round of
the surviving representative (that round's compute is discarded, as a
real preemption would).

Fabric dynamics: outer syncs are priced through the network model at
launch time — under a :class:`~repro_torch.cluster.network.Topology`
that means reduce-scatter down the fabric levels, a shard ring across the
top bottleneck, and all-gathers back up — and every ``fabric`` scenario
event (congestion window opening or closing) re-prices what is in
flight: collectives (outer syncs *and* adaptive batch-stats
reductions) and join-time point-to-point parameter transfers all have
the fraction already transferred credited and the remainder re-costed
under the new fabric state (model-scale joins spanning a window edge
would otherwise be silently mispriced).

Adaptive batching: when ``acfg.adaptive`` is on, every round ends with
a batch-stats reduction — a real collective on the wire (the two-phase
composition of ``repro_torch.core.batching``: a ``[colsum, count]`` phase-1
vector of one f32 per parameter — the same order as a gradient
all-reduce — plus five scalar moments) priced through the same network
model, counted in ``ClusterReport.num_stats_syncs`` and re-priced at
fabric window edges like any other in-flight collective.  Under the
``sync`` (and ``elastic``) policies the next round's plan depends on
the reduced statistics, so the stats agreement gates the round
boundary.  Under ``async`` the stats cost is *piggybacked* (the Lau et
al. trick): the round's phase-1 vector rides the outer all-reduce as
one fused ``"piggyback"`` collective — priced once at params + stats
bytes — and the batch decision folds when that collective lands
(:meth:`repro_torch.core.adloco.TrainerRound.apply_stats`), giving
one-round-stale plan semantics instead of a serial gradient-sized
reduction per round.  Batch growth then feeds straight back into the
clock: a bigger effective batch means more roofline FLOPs per node per
round, which is how sync/async/elastic trade off under a growing batch
(scenarios ``adaptive_ramp`` / ``congested_adaptive``).

Nonblocking collectives: the runtime *dispatches* every outer sync at
its launch point (:meth:`CollectiveBackend.dispatch_outer`) and waits
for the result only at the arrival event
(:meth:`CollectiveBackend.wait_outer`).  Under the sim backend that is
a semantic no-op (the stack is eager); a process backend enqueues the
collective there and the next round's inner compute runs while it is
in flight.

Where the port adds to the JAX package: tensors the runtime holds for
a collective in flight (the launch snapshot, the stacked reduction, the
anchor) are dropped at its arrival, and a trainer that leaves or is
merged away drops its workers' tensors, so device memory follows the
live pool; ``ClusterReport.round_wall_s`` keeps the wall seconds of
every round's compute (the window ``note_real_compute`` sees; on a card
the round's ``float(loss)`` is what waits for its kernels).
"""
from __future__ import annotations

import copy
import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.cluster.backend import CollectiveBackend, SimBackend
from repro_torch.cluster.network import NetworkModel
from repro_torch.cluster.node import NodeProfile, make_heterogeneous_profiles
from repro_torch.cluster.trace import FABRIC_TID, Trace
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core.adloco import History, RoundOutput, TrainerRound
from repro_torch.core.comms import TimedCommsMeter, param_bytes
from repro_torch.core.diloco import merge_params
from repro_torch.core.mit import (TrainerPoolState, check_merge, consolidate,
                                  do_merge)

POLICIES = ("sync", "async", "elastic")


@dataclass
class ClusterEvent:
    """Scripted scenario event.

    kind="slowdown": node ``node`` computes ``factor``x slower for
        ``duration`` simulated seconds.
    kind="leave":    trainer ``tid`` (default: smallest requested batch)
        leaves; its knowledge is merged into the pool via ``do_merge``.
        Scripted leaves model *preemptions*: the leaver's capacity
        slice (nodes and data shards alike) returns to the spare
        pools so the pool can re-grow after churn.  Leaves synthesized
        by an autoscale policy (``autoscaled=True``) model deliberate
        *consolidation* instead: the survivor keeps the unioned shards
        per Algorithm 2 and only the nodes are freed.
    kind="join":     a new trainer joins on spare nodes/streams, cloned
        from the most-advanced trainer.
    kind="fabric":   a congestion window opens on the network for
        ``duration`` simulated seconds (<= 0: permanently): link
        bandwidth is multiplied by ``bw_scale`` and each hop pays
        ``extra_latency``; ``scope`` picks which links of a
        :class:`~repro_torch.cluster.network.Topology` suffer — "all",
        "intra" (leaf domains), "inter" (every internal level),
        "level:<k>" (one level, 0 = leaves) or "domain:<name>" (one
        named domain; the flat model has a single fabric and treats
        every scope as the wire).  In-flight collectives and join
        transfers are re-priced at every window edge.
    """

    time: float
    kind: str
    node: Optional[int] = None
    tid: Optional[int] = None
    factor: float = 2.0
    duration: float = 0.0
    bw_scale: float = 1.0
    extra_latency: float = 0.0
    scope: str = "all"
    # set by maybe_autoscale on the join/leave events it synthesizes;
    # scripted scenario events leave it False
    autoscaled: bool = False


@dataclass
class ClusterReport:
    policy: str
    sim_time: float = 0.0           # simulated seconds to drain the run
    compute_time: float = 0.0       # sum of per-worker busy seconds
    comm_time: float = 0.0          # sum of collective durations
    # measured wire seconds when an execution backend ran the
    # collectives for real (0.0 under the sim backend); deliberately
    # not part of summary() so golden digests stay backend-agnostic
    real_comm_time: float = 0.0
    num_syncs: int = 0
    # batch-stats reductions priced on the wire (adaptive rounds only;
    # their duration is folded into comm_time).  Not part of summary()
    # so pre-adaptive golden digests stay byte-identical; the adaptive
    # golden traces pin it alongside the batch/plan trajectory.
    num_stats_syncs: int = 0
    # adaptive rounds whose batch came from the fitted growth predictor
    # instead of an exact stats reduction (acfg.k_correct > 1); the gap
    # between this and num_stats_syncs is the measured comms cut
    num_predicted_rounds: int = 0
    # scaling actions the ClusterSpec.autoscale policy scripted
    num_autoscale_events: int = 0
    # name of the compiled Scenario the run was driven by (None for raw
    # event lists); extended-summary only, so golden digests stay put
    scenario: Optional[str] = None
    rounds: Dict[int, int] = field(default_factory=dict)   # tid -> rounds
    applied_events: List[dict] = field(default_factory=list)
    # the span/event trace the run recorded into, when one was passed to
    # ``run_cluster(trace=)``; excluded from comparisons so report
    # equality (and the golden digests built on it) stays trace-agnostic
    trace: Optional[Trace] = field(default=None, repr=False, compare=False)
    # wall seconds of each round's compute, in event order (the window
    # the backend's note_real_compute sees); outside summary(), like the
    # trace, so digests stay hardware-agnostic
    round_wall_s: List[float] = field(default_factory=list, repr=False,
                                      compare=False)

    def summary(self, extended: bool = False) -> dict:
        """Aggregate scalars.  The default call is byte-identical to the
        pre-trace runtime (the golden digests in
        ``tests/goldens/scenarios.json`` pin it); ``extended=True``
        additionally exposes the measured wire time, the stats-reduction
        count and — when the run recorded a trace — the utilization
        ledger aggregate and the overlap fraction (ROADMAP item 1)."""
        s = {"policy": self.policy, "sim_time": self.sim_time,
             "compute_time": self.compute_time,
             "comm_time": self.comm_time, "num_syncs": self.num_syncs,
             "rounds": dict(self.rounds)}
        if extended:
            s["real_comm_time"] = self.real_comm_time
            s["num_stats_syncs"] = self.num_stats_syncs
            s["num_predicted_rounds"] = self.num_predicted_rounds
            s["num_autoscale_events"] = self.num_autoscale_events
            s["scenario"] = self.scenario
            if self.trace is not None:
                util = self.trace.utilization_summary()
                s["utilization"] = util["utilization"]
                s["blocked_frac"] = util["blocked_frac"]
                s["idle_frac"] = util["idle_frac"]
                s["overlap_frac"] = self.trace.overlap_fraction()
                # measured wall-clock overlap (collective in-flight
                # windows vs noted compute); 0.0 under pricing-only
                # backends, > 0 on async runs of a real backend
                s["real_overlap_frac"] = self.trace.overlap_fraction(
                    clock="real")
        return s


@dataclass
class _TrainerRT:
    """Runtime bookkeeping wrapped around a TrainerState."""

    tr: Any
    nodes: List[NodeProfile]
    target: int                     # rounds to run
    round: int = 0                  # completed rounds
    synced: int = 0                 # last round covered by a launched sync
    gen: int = 0                    # bumped on merge/leave to drop stale events
    alive: bool = True
    inflight: bool = False
    worker_params: Optional[List[Any]] = None   # None -> start from tr.params
    pending: Optional[dict] = None  # arrived comm awaiting worker rebase
    last_loss: float = 0.0          # mean loss of the last completed round
    comm_ev: Optional[dict] = None  # in-flight collective (for re-pricing)
    stats_ev: Optional[dict] = None  # in-flight stats reduction (ditto)
    cspan: Optional[Any] = None     # open compute span (tracing only)
    # deferred batch-stats handle awaiting the next outer launch (async
    # piggybacking); a fresher round's handle supersedes an unfused one
    stats_req: Optional[dict] = None


class _Sim:
    def __init__(self, loss_fn: Callable, acfg: AdLoCoConfig, *,
                 policy: str, profiles: List[NodeProfile],
                 backend: CollectiveBackend, eval_fn: Optional[Callable],
                 fixed_batch: Optional[int], verbose: bool,
                 trace: Optional[Trace] = None, autoscale=None):
        self.rnd = TrainerRound(loss_fn, acfg)
        self.trace = trace
        self.acfg = acfg
        self.policy = policy
        self.profiles = profiles
        self.backend = backend
        # ElasticPolicy driving pool size off the batch trajectory; the
        # policy itself is pure — the sim owns the cooldown counter
        self.autoscale = autoscale
        self.autoscale_ticks = 0    # round boundaries since last action
        # async adaptive rounds defer the batch decision and fuse the
        # phase-1 stats vector onto the outer sync (one "piggyback"
        # collective); sync/elastic keep the inline gated stats path
        self.piggyback = (policy == "async" and acfg.adaptive)
        self.eval_fn = eval_fn
        self.fixed_batch = fixed_batch
        self.verbose = verbose
        self.heap: list = []
        self.seq = itertools.count()
        self.hist = History()
        self.report = ClusterReport(policy=policy)
        self.rts: Dict[int, _TrainerRT] = {}
        self.free_nodes: List[NodeProfile] = []
        self.free_streams: List[Any] = []
        self.samples_total = 0
        self.xfers: List[dict] = []     # in-flight join transfers
        self.merged_rounds: set = set()
        self.next_tid = 0
        self.t0 = time.time()
        self.pool: Optional[TrainerPoolState] = None

    # ------------------------------------------------------------ heap
    def push(self, when: float, kind: str, payload: dict) -> None:
        heapq.heappush(self.heap, (when, next(self.seq), kind, payload))

    @staticmethod
    def drop_inflight(rt: _TrainerRT) -> None:
        """A gen bump superseded the trainer's collective in flight: its
        queued arrival returns before reading the tensors, so drop them
        now rather than when the stale event pops."""
        if rt.comm_ev is not None:
            for key in ("handle", "snapshot", "x_prev"):
                rt.comm_ev.pop(key, None)

    def release(self, rt: _TrainerRT) -> None:
        """A trainer left the pool: drop the tensors its runtime state
        still holds (workers, optimizer states, a collective in flight)
        so device memory follows the live pool."""
        rt.worker_params = rt.pending = rt.stats_req = None
        rt.tr.inner_opt_states = []
        rt.tr.outer_opt_state = None
        self.drop_inflight(rt)

    # ----------------------------------------------------------- alive
    def alive_rts(self) -> List[_TrainerRT]:
        return [rt for rt in self.rts.values() if rt.alive]

    # ------------------------------------------------------ scheduling
    def start_round(self, rt: _TrainerRT, now: float) -> None:
        """Eagerly run the round's compute and schedule its completion."""
        ri = rt.round + 1
        self.maybe_merge(ri, now, caller=rt)
        if not rt.alive or rt.round >= rt.target:
            return
        share = None
        if self.autoscale is not None and self.acfg.adaptive:
            # adadamp: the pool serves the requested batch together, so
            # each trainer executes its gradients-per-worker share (the
            # batch *decision* stays the trainer's full requested batch)
            alive_k = max(1, len(self.alive_rts()))
            share = max(1, -(-int(rt.tr.requested_batch) // alive_k))
        w0 = time.perf_counter()
        out = self.rnd.inner(
            rt.tr, fixed_batch=self.fixed_batch,
            worker_starts=rt.worker_params,
            workers=self.backend.local_workers(
                len(rt.tr.inner_opt_states), tid=rt.tr.tid),
            stats_reduce=self.backend.stats_reducer(),
            defer_stats=self.piggyback, round_i=ri, batch_share=share)
        if out.predicted:
            self.report.num_predicted_rounds += 1
            if self.trace is not None:
                self.trace.instant(rt.tr.tid, "predict", now, round=ri,
                                   batch=int(rt.tr.requested_batch))
        # distributed backends: every process logs the same group loss
        out.mean_loss = self.backend.mean_scalar(out.mean_loss,
                                                 tid=rt.tr.tid)
        # real-clock compute window (mean_scalar forces the round's
        # results): a dispatched collective in flight across this window
        # is measured overlap on the wall clock, not just in the sim
        w1 = time.perf_counter() - w0
        self.report.round_wall_s.append(w1)
        self.backend.note_real_compute(w0, w1, tid=rt.tr.tid)
        dts = [node.compute_time(out.flops_per_worker, out.bytes_per_worker,
                                 now)
               for node in rt.nodes[:len(out.worker_params)]]
        self.report.compute_time += sum(dts)
        if self.trace is not None:
            # one span per inner-compute block; the planned end is final
            # unless a merge/leave preempts the round (truncated then)
            rt.cspan = self.trace.begin(
                rt.tr.tid, "compute", now, now + max(dts), round=ri,
                mode=out.mode, samples=out.samples,
                flops=out.flops_per_worker)
        self.push(now + max(dts), "round",
                  {"rt": rt, "out": out, "gen": rt.gen})

    def launch_sync(self, rt: _TrainerRT, now: float,
                    loss: float, mode: str) -> None:
        # callers only launch after a completed round, so worker params
        # are always materialized.  The network model routes the
        # collective: under a Topology the outer all-reduce is priced as
        # reduce-scatter down the fabric levels -> shard ring across the
        # top bottleneck -> all-gathers back up.
        snapshot = list(rt.worker_params)
        payload = param_bytes(rt.tr.params)
        kind, stats_vec, sreq = "outer", None, rt.stats_req
        if sreq is not None:
            # piggyback: the deferred phase-1 stats vector rides this
            # sync as ONE fused collective, priced (and fabric-edge
            # re-priced) once at params + stats bytes
            rt.stats_req = None
            payload += sreq["bytes"]
            kind = "piggyback"
            self.report.num_stats_syncs += 1
            if "phase1" in sreq["req"]:
                stats_vec = sreq["req"]["phase1"]
        dur = self.backend.allreduce_time(payload, rt.nodes, now=now)
        self.pool.comms.record_timed(
            kind, participants=len(rt.tr.inner_opt_states),
            payload_bytes=payload, step=rt.round, duration=dur)
        self.report.comm_time += dur
        self.report.num_syncs += 1
        rt.inflight = True
        rt.synced = rt.round
        ev = {"rt": rt, "gen": rt.gen, "snapshot": snapshot,
              "x_prev": rt.tr.params, "round": rt.round,
              "loss": loss, "mode": mode, "stats_req": sreq,
              # re-pricing state: fraction done as of t_last under the
              # total duration cur_total priced at the last fabric edge
              "payload_bytes": payload, "t_last": now, "frac": 0.0,
              "cur_total": dur, "t_end": now + dur,
              "log": self.pool.comms.log[-1]}
        # nonblocking dispatch: the collective starts NOW (on real
        # backends it is enqueued without a ready-wait and runs under
        # the rounds computed before on_comm_done waits on the handle).
        # A distributed deferred-stats request also hands the backend
        # its phase-2 material so the five-moment reduction can chain
        # onto the same in-flight window (no standalone fold-time sync)
        ev["handle"] = self.backend.dispatch_outer(
            snapshot, stats_vec=stats_vec,
            phase2=(sreq["req"] if sreq is not None
                    and "G_local" in sreq["req"] else None),
            tid=rt.tr.tid, template=rt.tr.params)
        if self.trace is not None:
            ev["span"] = self.trace.begin(
                rt.tr.tid, kind, now, now + dur, round=rt.round,
                mode=mode, payload_bytes=payload)
        rt.comm_ev = ev
        self.push(ev["t_end"], "comm", ev)

    def reprice_inflight(self, now: float) -> None:
        """A fabric window just opened or closed: credit every in-flight
        collective and join transfer with the fraction already
        transferred and re-price the remainder under the new state."""
        for rt in self.rts.values():
            for ev, kind in ((rt.comm_ev, "comm"), (rt.stats_ev, "stats")):
                if (ev is None or not rt.alive
                        or (kind == "comm" and not rt.inflight)
                        or ev["gen"] != rt.gen or ev["t_end"] <= now):
                    continue
                done = ev["frac"]
                if ev["cur_total"] > 0.0:
                    done = min(1.0, done + (now - ev["t_last"])
                               / ev["cur_total"])
                new_total = self.backend.allreduce_time(
                    ev["payload_bytes"], rt.nodes, now=now)
                new_end = now + (1.0 - done) * new_total
                ev.update(frac=done, t_last=now, cur_total=new_total)
                if new_end == ev["t_end"]:
                    continue        # the queued completion is still valid
                delta = new_end - ev["t_end"]
                self.report.comm_time += delta
                self.pool.comms.total_time += delta
                ev["log"]["time_s"] = ev["log"].get("time_s", 0.0) + delta
                if self.trace is not None:
                    self.trace.end(ev.get("span"), new_end)
                    self.trace.instant(
                        rt.tr.tid, "reprice", now, target=kind,
                        frac_done=done, new_total=new_total,
                        delta=delta)
                ev["t_end"] = new_end
                self.push(new_end, kind, ev)
        for ev in self.xfers:
            rt = ev["rt"]
            if (not rt.alive or ev["gen"] != rt.gen
                    or ev["t_end"] <= now):
                continue
            done = ev["frac"]
            if ev["cur_total"] > 0.0:
                done = min(1.0, done + (now - ev["t_last"])
                           / ev["cur_total"])
            new_total = self.backend.point_to_point_time(
                ev["payload_bytes"], ev["src"], ev["dst"], now=now)
            new_end = now + (1.0 - done) * new_total
            ev.update(frac=done, t_last=now, cur_total=new_total)
            if new_end == ev["t_end"]:
                continue
            # the join record appended at launch is a snapshot (its
            # ``xfer_s`` is the launch-time price); a window edge that
            # moves the transfer emits an explicit annotation instead of
            # mutating the already-published event in place, so a
            # consumer that copied ``applied_events`` isn't silently
            # stale.  ``xfer_s`` here is the new effective total —
            # launch to (re-priced) arrival.
            self.report.applied_events.append(
                {"time": now, "kind": "xfer_reprice", "tid": rt.tr.tid,
                 "xfer_s": new_end - ev["log"]["time"]})
            if self.trace is not None:
                self.trace.end(ev.get("span"), new_end)
                self.trace.instant(
                    rt.tr.tid, "reprice", now, target="xfer",
                    frac_done=done, new_total=new_total,
                    delta=new_end - ev["t_end"])
            ev["t_end"] = new_end
            self.push(new_end, "xfer", ev)

    # --------------------------------------------------------- history
    def record(self, rt: _TrainerRT, now: float, round_i: int,
               loss: float, mode: str) -> None:
        hist, pool = self.hist, self.pool
        hist.outer_step.append(round_i)
        hist.loss.append(loss)
        hist.pool_size.append(len(self.alive_rts()))
        hist.requested_batches.append(
            [t.requested_batch for t in pool.trainers])
        hist.comm_events.append(pool.comms.events)
        hist.comm_bytes.append(pool.comms.total_bytes)
        hist.samples.append(self.samples_total)
        hist.modes.append([mode])
        hist.wall.append(time.time() - self.t0)
        hist.sim_time.append(now)
        if self.eval_fn is not None:
            val = float(self.eval_fn(rt.tr.params))
            hist.eval_loss.append(val)
            hist.eval_loss_by_trainer.append({rt.tr.tid: val})
            # what the consolidated model would score *now*: the batch-
            # weighted average of the live pool (mirrors ``consolidate``)
            # — the honest convergence curve for autoscaled pools, where
            # averaging k anchors divides the noise floor the way the
            # paper's merge does
            anchors = [t.tr for t in self.alive_rts()]
            if len(anchors) > 1:
                avg = merge_params(
                    [t.params for t in anchors],
                    [max(t.requested_batch, 1) for t in anchors])
                hist.eval_loss_pool.append(float(self.eval_fn(avg)))
            else:
                hist.eval_loss_pool.append(val)
        if self.verbose:
            print(f"[cluster/{self.policy}] t={now * 1e3:9.3f}ms "
                  f"tid={rt.tr.tid} round={round_i} loss={loss:.4f} "
                  f"k={len(self.alive_rts())}")

    # ---------------------------------------------------------- tracing
    def truncate_spans(self, rt: _TrainerRT, now: float,
                       reason: str) -> None:
        """A gen bump (merge/leave) just preempted this trainer's
        in-flight work: close any open compute/collective spans at the
        preemption time so the trace reflects what actually ran."""
        if self.trace is None:
            return
        open_spans = [rt.cspan,
                      rt.comm_ev.get("span") if rt.comm_ev else None,
                      rt.stats_ev.get("span") if rt.stats_ev else None]
        for span in open_spans:
            if span is not None and span.t1 is not None and span.t1 > now:
                self.trace.end(span, now, **{reason: True})
                self.trace.instant(rt.tr.tid, "preempt", now,
                                   target=span.kind, reason=reason)
        rt.cspan = None

    # -------------------------------------------------------- handlers
    def fold_pending(self, rt: _TrainerRT) -> None:
        """Rebase the workers onto a delayed outer update that arrived
        since the last fold (``wp <- x_new + (wp - snapshot)``) — must
        run before anything is launched from the workers, or the next
        pseudo-gradient diffs against the wrong anchor."""
        if rt.pending is None or rt.worker_params is None:
            return
        x_new, snap = rt.pending["x_new"], rt.pending["snapshot"]
        rt.worker_params = [
            None if wp is None else
            {k: xn + (wp[k] - sm[k]) for k, xn in x_new.items()}
            for wp, sm in zip(rt.worker_params, snap)]
        rt.pending = None

    def on_round_done(self, now: float, ev: dict) -> None:
        rt: _TrainerRT = ev["rt"]
        if not rt.alive or ev["gen"] != rt.gen:
            return
        out: RoundOutput = ev["out"]
        self.report.sim_time = max(self.report.sim_time, now)
        rt.cspan = None                   # compute span closed on time
        rt.round += 1
        self.report.rounds[rt.tr.tid] = rt.round
        self.samples_total += out.samples
        rt.worker_params = out.worker_params
        rt.last_loss = out.mean_loss
        self.fold_pending(rt)             # delayed outer arrived mid-round

        if out.stats_bytes > 0.0:
            if self.piggyback and out.stats_request is not None:
                # async adaptive: no standalone stats collective — stash
                # the stale stats handle; the next outer launch fuses
                # its phase-1 vector onto the sync and the decision
                # folds when that collective lands (one-round-stale plan
                # semantics).  A fresher handle supersedes an unfused
                # predecessor so the decision always uses the newest
                # gradients that reached a launch point.
                rt.stats_req = {"req": out.stats_request,
                                "bytes": out.stats_bytes,
                                "round": rt.round}
                self.after_stats(rt, now, out.mean_loss, out.mode)
                return
            # sync/elastic: the batch-stats reduction is a collective
            # on the wire — the next round's plan depends on its result,
            # so it gates the round boundary
            self.launch_stats(rt, now, out.mean_loss, out.mode,
                              out.stats_bytes)
            return
        self.after_stats(rt, now, out.mean_loss, out.mode)

    def launch_stats(self, rt: _TrainerRT, now: float, loss: float,
                     mode: str, payload: float) -> None:
        dur = self.backend.allreduce_time(payload, rt.nodes, now=now)
        self.pool.comms.record_timed(
            "stats", participants=len(rt.tr.inner_opt_states),
            payload_bytes=payload, step=rt.round, duration=dur)
        self.report.comm_time += dur
        self.report.num_stats_syncs += 1
        ev = {"rt": rt, "gen": rt.gen, "loss": loss, "mode": mode,
              "payload_bytes": payload, "t_last": now, "frac": 0.0,
              "cur_total": dur, "t_end": now + dur,
              "log": self.pool.comms.log[-1]}
        if self.trace is not None:
            ev["span"] = self.trace.begin(
                rt.tr.tid, "stats", now, now + dur, round=rt.round,
                payload_bytes=payload)
        rt.stats_ev = ev
        self.push(ev["t_end"], "stats", ev)

    def on_stats_done(self, now: float, ev: dict) -> None:
        rt: _TrainerRT = ev["rt"]
        if not rt.alive or ev["gen"] != rt.gen:
            return
        if ev is not rt.stats_ev or now != ev["t_end"]:
            return                   # superseded by a fabric re-pricing
        self.report.sim_time = max(self.report.sim_time, now)
        rt.stats_ev = None
        measured = self.backend.pop_stats_measured()
        if measured is not None:
            self.report.real_comm_time += measured
            self.pool.comms.add_real_time(ev["log"], measured)
        self.after_stats(rt, now, ev["loss"], ev["mode"])

    def after_stats(self, rt: _TrainerRT, now: float, loss: float,
                    mode: str) -> None:
        """Round boundary proper (after any stats agreement arrived)."""
        # a delayed outer can land while the stats reduction is in
        # flight (async/elastic): fold it before launching, exactly as
        # the un-gated round boundary would have
        self.fold_pending(rt)
        self.maybe_autoscale(now)
        if self.policy == "sync":
            # barrier: wait for the collective before the next round
            self.launch_sync(rt, now, loss, mode)
            return

        # async / elastic: overlap — launch if the wire is free, keep
        # computing either way
        if not rt.inflight:
            self.launch_sync(rt, now, loss, mode)
        if rt.round < rt.target:
            self.start_round(rt, now)

    def on_comm_done(self, now: float, ev: dict) -> None:
        rt: _TrainerRT = ev["rt"]
        if not rt.alive or ev["gen"] != rt.gen:
            return
        if ev is not rt.comm_ev or now != ev["t_end"]:
            return                   # superseded by a fabric re-pricing
        self.report.sim_time = max(self.report.sim_time, now)
        rt.inflight = False
        rt.comm_ev = None
        stacked, stats_tot = self.backend.wait_outer(ev["handle"])
        ev["handle"] = None
        # measured staleness in rounds: rounds already folded since the
        # snapshot, plus the in-flight round that will rebase onto this
        # update at its boundary (async steady state: 1; sync: 0)
        delay = float(rt.round - ev["round"])
        if self.policy != "sync" and rt.round < rt.target:
            delay += 1.0
        self.rnd.outer(rt.tr, ev["snapshot"], x_prev=ev.pop("x_prev"),
                       reduce=lambda _wp: stacked, delay=delay)
        del stacked
        measured = self.backend.pop_measured()
        if measured is not None:
            self.report.real_comm_time += measured
            self.pool.comms.add_real_time(ev["log"], measured)
        sreq = ev.get("stats_req")
        if sreq is not None:
            # fold the piggybacked batch decision: local-estimator
            # requests carry finished statistics; distributed requests
            # finish from the phase-2 moments total the backend chained
            # onto the outer window at dispatch time (pop_phase2_total),
            # falling back to the small standalone reducer for backends
            # that didn't chain it
            self.rnd.apply_stats(rt.tr, sreq["req"],
                                 phase1_total=stats_tot,
                                 phase2_total=(
                                     self.backend.pop_phase2_total()),
                                 sum_reduce=self.backend.stats_reducer(),
                                 round_i=sreq.get("round"))
            ms = self.backend.pop_stats_measured()
            if ms is not None:
                self.report.real_comm_time += ms
                self.pool.comms.add_real_time(ev["log"], ms)
        self.record(rt, now, ev["round"], ev["loss"], ev["mode"])

        snapshot = ev.pop("snapshot")
        if self.policy == "sync":
            rt.worker_params = None            # workers restart from x_new
            del snapshot
            if rt.round < rt.target:
                self.start_round(rt, now)
            return

        rt.pending = {"x_new": rt.tr.params, "snapshot": snapshot}
        if rt.round >= rt.target:
            # workers idle: fold the rebase now and flush any unsynced
            # progress so the final anchor includes every round
            self.fold_pending(rt)
            if rt.synced < rt.round:
                self.launch_sync(rt, now, rt.last_loss, "flush")

    # ------------------------------------------------------- autoscale
    def maybe_autoscale(self, now: float) -> None:
        """Let the ``ClusterSpec.autoscale`` policy observe the batch
        trajectory at a round boundary and script joins/leaves through
        the same machinery scenario events use (joins pay real
        point-to-point transfer prices, re-priced at fabric edges)."""
        if self.autoscale is None:
            return
        alive = self.alive_rts()
        if not alive:
            return
        M = self.acfg.nodes_per_gpu
        self.autoscale_ticks += 1
        b = max(int(rt.tr.requested_batch) for rt in alive)
        k = len(alive)
        spare = min(len(self.free_streams) // M, len(self.free_nodes) // M)
        action = int(self.autoscale.decide(
            requested_batch=b, pool_size=k, spare_capacity=spare,
            rounds_since_change=self.autoscale_ticks))
        if action == 0:
            return
        self.autoscale_ticks = 0
        kind = "join" if action > 0 else "leave"
        for _ in range(abs(action)):
            self.push(now, "scenario",
                      {"ev": ClusterEvent(time=now, kind=kind,
                                          autoscaled=True)})
        self.report.num_autoscale_events += 1
        self.report.applied_events.append(
            {"time": now, "kind": "autoscale", "action": action,
             "pool": k, "requested_batch": b,
             "gradients_per_worker": b / k})
        if self.trace is not None:
            self.trace.instant(FABRIC_TID, "autoscale", now, action=action,
                               pool=k, requested_batch=b)

    # ---------------------------------------------------------- merges
    def maybe_merge(self, round_i: int, now: float,
                    caller: Optional[_TrainerRT]) -> None:
        acfg = self.acfg
        alive = self.alive_rts()
        if not (acfg.enable_merge and len(alive) > 1
                and round_i % acfg.merge_frequency == 0
                and round_i not in self.merged_rounds):
            return
        # Merges are tagged with their originating round and fire ON
        # TIME: trainers whose round counter drifted more than
        # ``merge_drift_window`` behind the caller's are skipped (their
        # params are rounds stale — folding them in would drag the
        # survivor backwards), instead of the old behavior of stalling
        # the whole merge until the slowest trainer caught up and then
        # merging arbitrarily drifted states.  The window is measured
        # against ``round_i - 1`` (the round the caller just folded);
        # same-speed peers whose fold event shares this timestamp but
        # has not popped yet read one behind, so the default window of
        # 1 is the tightest setting that keeps lockstep peers eligible.
        self.merged_rounds.add(round_i)
        eligible = [rt for rt in alive
                    if (round_i - 1) - rt.round <= acfg.merge_drift_window]
        skipped = sorted(rt.tr.tid for rt in alive if rt not in eligible)
        if len(eligible) <= 1:
            self.report.applied_events.append(
                {"time": now, "kind": "merge_skipped", "round": round_i,
                 "skipped": skipped})
            return
        elig_tids = {rt.tr.tid for rt in eligible}
        elig_ids = [i for i, t in enumerate(self.pool.trainers)
                    if t.tid in elig_tids]
        sub = check_merge(
            [self.pool.trainers[i].requested_batch for i in elig_ids],
            acfg.merge_w + 1)
        ids = [elig_ids[j] for j in sub]
        if len(ids) <= 1:
            return
        involved = [self.pool.trainers[i] for i in ids]
        # on multi-group backends the weighted average executes as a
        # real cross-group collective (merge_reducer); its wall-clock
        # cost lands in real_comm_time like any other collective, while
        # the sim clock stays the analytic price
        self.pool = do_merge(self.pool, ids, step=round_i,
                             reduce=self.backend.merge_reducer())
        ms = self.backend.pop_merge_measured()
        if ms is not None:
            self.report.real_comm_time += ms
            self.pool.comms.add_real_time(self.pool.comms.log[-1], ms)
        # survivor detection is rank-indexable (tids are stable and
        # unique), not keyed on in-process object identity
        surviving = {t.tid for t in self.pool.trainers}
        for t in involved:
            rt = self.rts[t.tid]
            self.truncate_spans(rt, now, "merged")
            if t.tid in surviving:
                # representative: a merge preempts its in-flight round
                # and supersedes any in-flight sync or deferred stats
                self.drop_inflight(rt)
                rt.gen += 1
                rt.inflight = False
                rt.pending = None
                rt.worker_params = None
                rt.stats_req = None
                if rt is not caller and rt.round < rt.target:
                    self.start_round(rt, now)
            else:
                rt.alive = False
                self.release(rt)
                self.free_nodes.extend(rt.nodes)
                if self.trace is not None:
                    self.trace.trainer_dead(t.tid, now)
        merged_away = [t.tid for t in involved if t.tid not in surviving]
        if self.trace is not None:
            for tid in merged_away:
                self.trace.instant(tid, "merge", now, round=round_i,
                                   skipped=skipped)
        self.report.applied_events.append(
            {"time": now, "kind": "merge", "round": round_i,
             "merged": merged_away, "skipped": skipped})

    # -------------------------------------------------------- scenario
    def on_scenario(self, now: float, ev: ClusterEvent) -> None:
        if ev.kind == "slowdown":
            idx = ev.node if ev.node is not None else 0
            if 0 <= idx < len(self.profiles):
                self.profiles[idx].add_slowdown(now, ev.duration, ev.factor)
                self.report.applied_events.append(
                    {"time": now, "kind": "slowdown", "node": idx,
                     "factor": ev.factor, "duration": ev.duration})
                if self.trace is not None:
                    self.trace.instant(FABRIC_TID, "slowdown", now,
                                       node=idx, factor=ev.factor,
                                       duration=ev.duration)
            return
        if ev.kind == "leave":
            self.do_leave(now, ev.tid, reclaim=not ev.autoscaled)
            return
        if ev.kind == "join":
            self.do_join(now)
            return
        if ev.kind == "fabric":
            self.backend.add_fabric_window(
                now, ev.duration, bw_scale=ev.bw_scale,
                extra_latency=ev.extra_latency, scope=ev.scope)
            self.report.applied_events.append(
                {"time": now, "kind": "fabric", "scope": ev.scope,
                 "bw_scale": ev.bw_scale, "extra_latency": ev.extra_latency,
                 "duration": ev.duration})
            if self.trace is not None:
                # permanent windows (duration <= 0) stay open until
                # Trace.finalize clamps them to the end of the run
                self.trace.begin(
                    FABRIC_TID, "fabric", now,
                    now + ev.duration if ev.duration > 0 else None,
                    scope=ev.scope, bw_scale=ev.bw_scale,
                    extra_latency=ev.extra_latency)
            self.reprice_inflight(now)
            if ev.duration > 0:      # re-price again when the window closes
                self.push(now + ev.duration, "reprice", {})
            return
        raise ValueError(f"unknown scenario event kind: {ev.kind!r}")

    def do_leave(self, now: float, tid: Optional[int], *,
                 reclaim: bool = True) -> None:
        alive = self.alive_rts()
        if len(alive) <= 1:
            return                               # last trainer can't leave
        if tid is None:
            leaver = min(alive, key=lambda rt: rt.tr.requested_batch).tr
        else:
            if tid not in self.rts or not self.rts[tid].alive:
                return
            leaver = self.rts[tid].tr
        # a leaving trainer stops requesting work, so it can never be the
        # merge representative and its merge weight drops to the floor
        leaver.requested_batch = 0
        others = [t for t in self.pool.trainers if t is not leaver]
        best = max(others, key=lambda t: t.requested_batch)
        ids = [self.pool.trainers.index(leaver),
               self.pool.trainers.index(best)]
        keep = len(best.streams)
        self.pool = do_merge(self.pool, ids, step=self.rts[leaver.tid].round)
        lrt = self.rts[leaver.tid]
        self.truncate_spans(lrt, now, "left")
        lrt.alive = False
        self.release(lrt)
        # On a preemption (scripted leave) both halves of the leaver's
        # capacity return to the spare pools: its nodes, and the data
        # shards do_merge just unioned onto the survivor (the
        # survivor's own M workers never read past streams[M-1], so
        # the union was pure bookkeeping) are reclaimed as spares —
        # appended at the BACK, so joins keep drawing the
        # originally-provisioned spares first.  Without the
        # reclamation a preemption storm permanently exhausted join
        # capacity: streams were hoarded by survivors while nodes sat
        # free, and the autoscaler's spare_capacity stuck at zero.
        # Autoscaler-decided shrinks (reclaim=False) keep the union on
        # the survivor: a policy shrink consolidates data coverage
        # onto fewer trainers, it does not evict capacity.
        if reclaim:
            reclaimed = best.streams[keep:]
            del best.streams[keep:]
            self.free_streams.extend(reclaimed)
        self.free_nodes.extend(lrt.nodes)
        brt = self.rts[best.tid]
        self.truncate_spans(brt, now, "absorbed_leave")
        self.drop_inflight(brt)
        brt.gen += 1
        brt.inflight = False
        brt.pending = None
        brt.worker_params = None
        brt.stats_req = None
        if brt.round < brt.target:
            self.start_round(brt, now)
        if self.trace is not None:
            self.trace.trainer_dead(leaver.tid, now)
            self.trace.instant(leaver.tid, "leave", now, into=best.tid)
        self.report.applied_events.append(
            {"time": now, "kind": "leave", "tid": leaver.tid,
             "into": best.tid})

    def do_join(self, now: float) -> None:
        M = self.acfg.nodes_per_gpu
        alive = self.alive_rts()
        if not alive:
            return                               # nothing to clone from
        remaining = max(rt.target - rt.round for rt in alive)
        if remaining <= 0:
            return                               # run is over anyway
        if len(self.free_streams) < M or len(self.free_nodes) < M:
            # spare pool exhausted: record the skip (like drifted-merge
            # skips) instead of silently dropping the join — sweeps that
            # under-provision spares can now see it in applied_events
            self.report.applied_events.append(
                {"time": now, "kind": "join_skipped",
                 "free_streams": len(self.free_streams),
                 "free_nodes": len(self.free_nodes), "needed": M})
            if self.trace is not None:
                self.trace.instant(FABRIC_TID, "join", now, skipped=True,
                                   free_streams=len(self.free_streams),
                                   free_nodes=len(self.free_nodes))
            return
        src = max(alive, key=lambda rt: rt.tr.requested_batch)
        streams = [self.free_streams.pop(0) for _ in range(M)]
        nodes = [self.free_nodes.pop(0) for _ in range(M)]
        tr = self.rnd.new_trainer(self.next_tid, src.tr.params, streams)
        if self.autoscale is not None:
            # an autoscaled joiner inherits the source's batch
            # trajectory: the pool co-serves the requested batch, so a
            # newcomer restarting from the initial batch would skew the
            # gradients-per-worker share it was recruited to absorb
            tr.requested_batch = src.tr.requested_batch
        self.next_tid += 1
        self.pool.trainers.append(tr)
        rt = _TrainerRT(tr=tr, nodes=nodes, target=remaining)
        self.rts[tr.tid] = rt
        # parameter shipping to the newcomer costs one point-to-point
        # xfer, tracked in flight so fabric window edges re-price it
        # (fraction done credited) exactly like a collective
        payload = param_bytes(tr.params)
        xfer = self.backend.point_to_point_time(
            payload, src.nodes[0], nodes[0], now=now)
        log = {"time": now, "kind": "join", "tid": tr.tid,
               "cloned_from": src.tr.tid, "xfer_s": xfer}
        self.report.applied_events.append(log)
        ev = {"rt": rt, "gen": rt.gen, "payload_bytes": payload,
              "src": src.nodes[0], "dst": nodes[0],
              "t_last": now, "frac": 0.0, "cur_total": xfer,
              "t_end": now + xfer, "log": log}
        if self.trace is not None:
            # the joiner is alive (and comm-blocked) from the moment its
            # parameters start shipping
            self.trace.trainer_alive(tr.tid, now)
            self.trace.instant(tr.tid, "join", now,
                               cloned_from=src.tr.tid)
            ev["span"] = self.trace.begin(
                tr.tid, "xfer", now, now + xfer, payload_bytes=payload,
                src=src.nodes[0].name, dst=nodes[0].name,
                cloned_from=src.tr.tid)
        self.xfers.append(ev)
        self.push(ev["t_end"], "xfer", ev)

    def on_xfer_done(self, now: float, ev: dict) -> None:
        rt: _TrainerRT = ev["rt"]
        if ev["t_end"] != now:
            return                   # superseded by a fabric re-pricing
        self.xfers.remove(ev)
        if not rt.alive or ev["gen"] != rt.gen:
            return
        self.start_round(rt, now)


@dataclass(frozen=True)
class ClusterSpec:
    """Everything about a cluster run that is not the model or the data.

    ``run_cluster`` grew one keyword per feature until the autoscaler
    would have been the fourteenth; the spec is the one record that
    carries them all.  Legacy keywords still work (each is a thin alias
    that builds this spec), but a spec cannot be combined with them —
    mixing the two spellings raises.

    ``autoscale`` is an :class:`~repro_torch.cluster.autoscale.ElasticPolicy`
    observing the adaptive batch trajectory at every round boundary and
    scripting joins/leaves through the elastic machinery; it requires
    ``policy="elastic"``.
    """

    policy: str = "sync"
    profiles: Optional[List[NodeProfile]] = None
    network: Optional[NetworkModel] = None
    backend: Optional[CollectiveBackend] = None
    num_outer_steps: Optional[int] = None
    eval_fn: Optional[Callable] = None
    fixed_batch: Optional[int] = None
    scenario: Any = ()
    trace: Optional[Trace] = None
    autoscale: Optional[Any] = None
    verbose: bool = False


_UNSET = object()    # distinguishes "kwarg not passed" from its default


def run_cluster(loss_fn: Callable, init_params_list: List[Any],
                streams: List[Any], acfg: AdLoCoConfig, *,
                spec: Optional[ClusterSpec] = None,
                policy=_UNSET, profiles=_UNSET, network=_UNSET,
                backend=_UNSET, num_outer_steps=_UNSET, eval_fn=_UNSET,
                fixed_batch=_UNSET, scenario=_UNSET, trace=_UNSET,
                autoscale=_UNSET, verbose=_UNSET, device=None):
    """Train AdLoCo on a simulated heterogeneous cluster, the numerics on
    ``device`` (``cuda`` unless named; raises without a card; the
    initial params are moved there, and ``streams`` must yield batches
    on it).

    The run is configured by a :class:`ClusterSpec` — ``spec=`` is the
    canonical spelling; every individual keyword below is a deprecated
    alias that builds the same spec (bit-identical behavior, pinned by
    the golden-digest suite) and cannot be mixed with ``spec=``.

    ``streams`` beyond the initial k*M shards form the spare pool handed
    to trainers that join mid-run (elastic scenarios); ``profiles``
    beyond k*M likewise.  ``network`` is a flat :class:`NetworkModel`
    (default) or an n-level
    :class:`~repro_torch.cluster.network.Topology` (tree of fabric
    domains) — the choice changes the simulated clock,
    never the numerics.  ``backend`` picks *how* collectives execute
    (see ``repro_torch.cluster.backend``): the default
    :class:`~repro_torch.cluster.backend.SimBackend` wraps ``network``
    and prices them analytically; a backend that runs collectives for
    real carries its own pricing network — passing both ``backend=``
    and ``network=`` is an error.
    ``scenario`` is a sequence of :class:`ClusterEvent`\\ s, a compiled
    :class:`~repro_torch.cluster.scenarios.Scenario`, or the name of a
    registered scenario (see ``repro_torch.cluster.scenarios``); a named
    scenario's name is threaded into ``summary(extended=True)``.
    ``autoscale`` hands the elastic pool to an
    :class:`~repro_torch.cluster.autoscale.ElasticPolicy` (see the
    "Autoscaling" section of ``repro_torch.cluster``'s docstring).
    ``trace`` is an optional :class:`~repro_torch.cluster.trace.Trace` (or
    ``True`` to allocate one) the event loop records typed spans into —
    inner-compute blocks, outer collectives, stats reductions, join
    transfers, fabric windows — plus instant annotations for
    re-pricings, merges, joins, leaves, slowdowns, autoscale actions
    and predicted batch decisions; real backends add measured
    wall-clock spans.  Recording never changes the schedule, and with
    the default ``None`` the instrumentation is a no-op.  The populated
    trace is also attached to ``ClusterReport.trace`` so
    ``report.summary(extended=True)`` can expose the utilization ledger
    and the overlap fraction.
    Returns (TrainerPoolState, History, ClusterReport) — the History
    carries ``sim_time`` so convergence can be plotted against the
    simulated clock.
    """
    legacy = {name: val for name, val in (
        ("policy", policy), ("profiles", profiles), ("network", network),
        ("backend", backend), ("num_outer_steps", num_outer_steps),
        ("eval_fn", eval_fn), ("fixed_batch", fixed_batch),
        ("scenario", scenario), ("trace", trace), ("autoscale", autoscale),
        ("verbose", verbose)) if val is not _UNSET}
    if spec is not None:
        if legacy:
            raise ValueError(
                f"configure the run through spec= OR the legacy keyword "
                f"aliases, not both (got spec= plus {sorted(legacy)})")
    else:
        spec = ClusterSpec(**legacy)

    policy, scenario = spec.policy, spec.scenario
    profiles, network, backend = spec.profiles, spec.network, spec.backend
    eval_fn, fixed_batch, trace = spec.eval_fn, spec.fixed_batch, spec.trace
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    if isinstance(scenario, str):
        from repro_torch.cluster.scenarios import build_scenario
        scenario = build_scenario(scenario)
    scenario_name = getattr(scenario, "name", None)
    if spec.autoscale is not None and policy != "elastic":
        raise ValueError(
            f"autoscale= scripts joins/leaves and needs the elastic "
            f"pool; run with policy='elastic', not {policy!r}")
    k, M = len(init_params_list), acfg.nodes_per_gpu
    T = spec.num_outer_steps or acfg.num_outer_steps
    if profiles is None:
        profiles = make_heterogeneous_profiles(k * M)
    if len(profiles) < k * M:
        raise ValueError(f"need >= {k * M} node profiles, got "
                         f"{len(profiles)}")
    if backend is not None and network is not None:
        raise ValueError("pass the pricing network inside the backend, "
                         "not both backend= and network=")
    if backend is None:
        backend = SimBackend(network)
    # the sim mutates node and fabric state (jitter RNG draws, scenario
    # slowdowns, congestion windows): work on copies so caller-owned
    # profiles/networks stay reusable and repeated runs are independent
    # and reproducible (``for_run`` copies the backend's pricing state)
    profiles = [copy.deepcopy(p) for p in profiles]
    backend = backend.for_run()
    backend.bind(profiles)
    backend.validate(acfg, policy=policy, k=k, M=M, scenario=scenario,
                     autoscale=spec.autoscale)
    dev = resolve_device(device)
    init_params_list = [{k: v.to(dev) for k, v in p.items()}
                        for p in init_params_list]
    if trace is True:
        trace = Trace()
    if trace is not None:
        backend.attach_trace(trace)

    sim = _Sim(loss_fn, acfg, policy=policy, profiles=list(profiles),
               backend=backend, eval_fn=eval_fn, fixed_batch=fixed_batch,
               verbose=spec.verbose, trace=trace, autoscale=spec.autoscale)
    sim.report.scenario = scenario_name
    sim.pool = sim.rnd.init_pool(init_params_list, streams[:k * M])
    sim.pool.comms = TimedCommsMeter()
    if fixed_batch is not None and not acfg.adaptive:
        for t in sim.pool.trainers:
            t.requested_batch = fixed_batch
    sim.free_streams = list(streams[k * M:])
    sim.free_nodes = list(profiles[k * M:])
    sim.next_tid = k
    for i, t in enumerate(sim.pool.trainers):
        sim.rts[t.tid] = _TrainerRT(
            tr=t, nodes=list(profiles[i * M:(i + 1) * M]), target=T)
        if trace is not None:
            trace.trainer_alive(t.tid, 0.0)

    for ev in sorted(scenario, key=lambda e: e.time):
        sim.push(ev.time, "scenario", {"ev": ev})
    # windows pre-installed on the caller's fabric schedules must also
    # re-price in-flight collectives at their edges (scenario-delivered
    # windows handle this when the fabric event is applied)
    for t in backend.fabric_change_points():
        sim.push(t, "reprice", {})
    for rt in sim.rts.values():
        sim.start_round(rt, 0.0)

    while sim.heap:
        when, _, kind, payload = heapq.heappop(sim.heap)
        if kind == "round":
            sim.on_round_done(when, payload)
        elif kind == "comm":
            sim.on_comm_done(when, payload)
        elif kind == "stats":        # batch-stats reduction arrived
            sim.on_stats_done(when, payload)
        elif kind == "xfer":         # join transfer finished shipping
            sim.on_xfer_done(when, payload)
        elif kind == "reprice":      # a fabric window closed
            sim.reprice_inflight(when)
        else:
            sim.on_scenario(when, payload["ev"])

    if trace is not None:
        trace.finalize(sim.report.sim_time)
        sim.report.trace = trace
    # on multi-group backends the final consolidate is a real global
    # collective even for a pool of one — it doubles as the broadcast
    # that re-replicates the surviving model on every rank after merges
    pool = consolidate(sim.pool, step=T, reduce=backend.merge_reducer())
    ms = backend.pop_merge_measured()
    if ms is not None:
        sim.report.real_comm_time += ms
        if pool.comms.log and pool.comms.log[-1]["kind"] == "consolidate":
            pool.comms.add_real_time(pool.comms.log[-1], ms)
    return pool, sim.hist, sim.report
