"""Structured span/event trace for the cluster runtime.

Port of ``repro/cluster/trace.py`` (plain Python; every payload value
the runtime records is a Python ``int``, ``float``, ``str`` or ``bool``,
never a tensor, so ``sim_digest`` hashes the same text as the JAX
package's).  The event loop in ``repro_torch.cluster.runtime`` only
reports aggregate scalars (``ClusterReport``); this module records
*where* the time goes: one :class:`Span` per inner-compute block, outer
collective, batch-stats reduction, join transfer and fabric window,
plus instant :class:`TraceEvent` annotations (re-pricings, merges,
joins, leaves, slowdowns, autoscale actions and predicted batch
decisions).  Two clocks coexist — ``sim`` spans carry the runtime's
simulated timestamps, ``real`` spans carry wall-clock seconds measured
inside an execution backend's collectives (a process backend) — so
the simulated schedule and the machine's actual behavior can be laid
side by side on the same timeline.

Derived metrics
---------------
:meth:`Trace.utilization`
    Per-trainer ledger: every trainer's alive window is partitioned into
    *busy* (inner compute in flight), *comm-blocked* (a collective or
    join transfer in flight with no concurrent compute) and *idle*
    seconds.  ``busy + blocked + idle == alive`` is asserted — the
    ledger is a partition, not an approximation.
:meth:`Trace.overlap_fraction`
    The ROADMAP item-1 metric: collective in-flight time coincident
    with the same trainer's inner compute, divided by total collective
    time.  The sync policy scores exactly 0.0 (every collective is a
    barrier); async scores > 0 wherever an outer all-reduce hides
    behind the next round's compute.  Computable today for the
    simulated schedule and, via ``real`` spans, ready for the
    truly-overlapped real backend.
:meth:`Trace.to_perfetto`
    Chrome-trace/Perfetto JSON (load in https://ui.perfetto.dev); see
    ``repro_torch.cluster.trace_report`` for the CLI that prints the
    ledger and validates the schema.

Recording is strictly opt-in: ``run_cluster(trace=Trace())``.  With the
default ``trace=None`` the runtime's instrumentation points are single
``if`` checks and nothing is allocated, so the scenario digests are
unchanged by the instrumentation.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: schema version stamped into every Perfetto export; bump on any
#: breaking change to span kinds / required fields so stale consumers
#: fail loudly in ``trace_report --validate``
TRACE_SCHEMA = 1

#: span kinds the runtime emits on the simulated clock ("piggyback" is
#: the fused outer+phase-1-stats collective of the async adaptive path)
SIM_SPAN_KINDS = ("compute", "outer", "stats", "xfer", "fabric",
                  "piggyback")
#: span kinds an execution backend emits on the wall clock: collective
#: in-flight windows (dispatch -> ready) plus the inner-compute windows
#: the runtime notes so real-clock overlap is measurable; merge /
#: consolidate are the cross-group pool collectives of multi-trainer
#: (k > 1) runs
REAL_SPAN_KINDS = ("outer", "stats", "piggyback", "compute", "merge",
                   "consolidate")
#: instant-event kinds ("autoscale" marks an ElasticPolicy scaling
#: action, "predict" a batch decision the growth predictor supplied
#: without a stats reduction)
EVENT_KINDS = ("reprice", "join", "leave", "merge", "slowdown",
               "preempt", "autoscale", "predict")
#: span kinds that count as "a collective in flight" for the
#: utilization ledger and the overlap fraction
COMM_KINDS = ("outer", "stats", "xfer", "piggyback")

#: synthetic track id for fabric-window spans (not owned by a trainer)
FABRIC_TID = -1


@dataclass
class Span:
    """One timed block.  ``t1`` may be ``None`` while still open; the
    runtime closes every span it begins (``Trace.finalize`` closes any
    survivor at the end of the run)."""

    tid: int
    kind: str
    t0: float
    t1: Optional[float] = None
    clock: str = "sim"
    payload: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


@dataclass
class TraceEvent:
    """Instant annotation (zero duration) on a trainer's track."""

    tid: int
    kind: str
    t: float
    payload: Dict[str, Any] = field(default_factory=dict)


# ------------------------------------------------- interval arithmetic

def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """Merge possibly-overlapping [a, b) intervals into a sorted
    disjoint union."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(intervals: Sequence[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def _total(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


def _subtract(a: Sequence[Tuple[float, float]],
              b: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """Disjoint-union ``a`` minus disjoint-union ``b`` (both sorted)."""
    out: List[Tuple[float, float]] = []
    bs = list(b)
    for lo, hi in a:
        cur = lo
        for b0, b1 in bs:
            if b1 <= cur or b0 >= hi:
                continue
            if b0 > cur:
                out.append((cur, b0))
            cur = max(cur, b1)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def _overlap_total(interval: Tuple[float, float],
                   union: Sequence[Tuple[float, float]]) -> float:
    a, b = interval
    return sum(min(b, u1) - max(a, u0) for u0, u1 in union
               if min(b, u1) > max(a, u0))


class Trace:
    """Span/event recorder the runtime (and backends) write into."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.events: List[TraceEvent] = []
        #: tid -> [birth, death]; death is None while alive
        self.alive: Dict[int, List[Optional[float]]] = {}
        self.finalized_at: Optional[float] = None

    # ------------------------------------------------------- recording
    def begin(self, tid: int, kind: str, t0: float,
              t1: Optional[float] = None, *, clock: str = "sim",
              **payload: Any) -> Span:
        span = Span(tid=tid, kind=kind, t0=t0, t1=t1, clock=clock,
                    payload=payload)
        self.spans.append(span)
        return span

    def end(self, span: Optional[Span], t1: float,
            **payload: Any) -> None:
        if span is None:
            return
        span.t1 = t1
        span.payload.update(payload)

    def instant(self, tid: int, kind: str, t: float,
                **payload: Any) -> None:
        self.events.append(TraceEvent(tid=tid, kind=kind, t=t,
                                      payload=payload))

    def trainer_alive(self, tid: int, t0: float) -> None:
        self.alive.setdefault(tid, [t0, None])

    def trainer_dead(self, tid: int, t1: float) -> None:
        if tid in self.alive and self.alive[tid][1] is None:
            self.alive[tid][1] = t1

    def finalize(self, t_end: float) -> None:
        """Close every still-open span and alive window at ``t_end``
        (end of the run)."""
        self.finalized_at = t_end
        for s in self.spans:
            if s.t1 is None:
                s.t1 = max(t_end, s.t0)
        for w in self.alive.values():
            if w[1] is None:
                w[1] = max(t_end, w[0])

    # --------------------------------------------------------- queries
    def sim_spans(self, kinds: Optional[Sequence[str]] = None
                  ) -> List[Span]:
        return [s for s in self.spans if s.clock == "sim"
                and (kinds is None or s.kind in kinds)]

    def real_spans(self, kinds: Optional[Sequence[str]] = None
                   ) -> List[Span]:
        return [s for s in self.spans if s.clock == "real"
                and (kinds is None or s.kind in kinds)]

    def _spans_on(self, clock: str, kinds: Optional[Sequence[str]] = None
                  ) -> List[Span]:
        return (self.sim_spans(kinds) if clock == "sim"
                else self.real_spans(kinds))

    def _busy_union(self, clock: str = "sim"
                    ) -> Dict[int, List[Tuple[float, float]]]:
        per: Dict[int, List[Tuple[float, float]]] = {}
        for s in self._spans_on(clock, ("compute",)):
            per.setdefault(s.tid, []).append((s.t0, s.t1))
        return {tid: _union(ivs) for tid, ivs in per.items()}

    def utilization(self) -> Dict[int, Dict[str, float]]:
        """Per-trainer ledger: absolute seconds of ``busy`` (inner
        compute), ``blocked`` (a collective/transfer in flight and no
        compute running) and ``idle``, partitioning the ``alive``
        window exactly (asserted)."""
        busy_u = self._busy_union()
        comm_ivs: Dict[int, List[Tuple[float, float]]] = {}
        for s in self.sim_spans(COMM_KINDS):
            comm_ivs.setdefault(s.tid, []).append((s.t0, s.t1))
        ledger: Dict[int, Dict[str, float]] = {}
        for tid, (t0, t1) in sorted(self.alive.items()):
            alive = max(t1 - t0, 0.0)
            busy = _clip(busy_u.get(tid, []), t0, t1)
            comm = _clip(_union(comm_ivs.get(tid, [])), t0, t1)
            blocked = _subtract(comm, busy)
            idle = _subtract([(t0, t1)], _union(list(busy)
                                                + list(blocked)))
            led = {"alive": alive, "busy": _total(busy),
                   "blocked": _total(blocked), "idle": _total(idle)}
            parts = led["busy"] + led["blocked"] + led["idle"]
            if abs(parts - alive) > 1e-9 * max(alive, 1.0):
                raise AssertionError(
                    f"trainer {tid} ledger does not partition its alive "
                    f"span: busy+blocked+idle={parts!r} != alive={alive!r}")
            ledger[tid] = led
        return ledger

    def utilization_summary(self) -> Dict[str, float]:
        """Fleet aggregate of :meth:`utilization`: fractions of total
        alive trainer-seconds.  ``utilization`` is the busy fraction."""
        ledger = self.utilization()
        alive = sum(l["alive"] for l in ledger.values())
        if alive <= 0.0:
            return {"utilization": 0.0, "busy_frac": 0.0,
                    "blocked_frac": 0.0, "idle_frac": 0.0}
        busy = sum(l["busy"] for l in ledger.values())
        blocked = sum(l["blocked"] for l in ledger.values())
        idle = sum(l["idle"] for l in ledger.values())
        return {"utilization": busy / alive, "busy_frac": busy / alive,
                "blocked_frac": blocked / alive,
                "idle_frac": idle / alive}

    def overlap_fraction(self,
                         kinds: Sequence[str] = ("outer", "stats",
                                                 "piggyback"),
                         *, clock: str = "sim") -> float:
        """Collective in-flight time coincident with the same trainer's
        inner compute, over total collective time (ROADMAP item 1).
        Standalone ``stats`` reductions are in the denominator on
        purpose: they gate the round boundary when not piggybacked, so
        their zero overlap is the measured cost the Lau-style fusing
        removes.  ``clock="real"`` scores the *measured* wall-clock
        windows instead — collective in-flight spans (dispatch ->
        ready) against the noted inner-compute spans — so a truly
        nonblocking backend shows real overlap, not just a simulated
        schedule that claims it."""
        busy_u = self._busy_union(clock)
        total = overlap = 0.0
        for s in self._spans_on(clock, kinds):
            total += s.duration
            overlap += _overlap_total((s.t0, s.t1),
                                      busy_u.get(s.tid, []))
        return overlap / total if total > 0.0 else 0.0

    def overlap_by_kind(self, *, clock: str = "sim"
                        ) -> Dict[str, Dict[str, float]]:
        """Per-kind breakdown of :meth:`overlap_fraction`."""
        out: Dict[str, Dict[str, float]] = {}
        busy_u = self._busy_union(clock)
        for kind in ("outer", "stats", "xfer", "piggyback"):
            total = overlap = 0.0
            for s in self._spans_on(clock, (kind,)):
                total += s.duration
                overlap += _overlap_total((s.t0, s.t1),
                                          busy_u.get(s.tid, []))
            out[kind] = {"total": total, "overlap": overlap,
                         "frac": overlap / total if total > 0 else 0.0}
        return out

    # --------------------------------------------------------- digests
    def _sim_schema(self) -> list:
        """Canonical, JSON-stable view of the simulated schedule: every
        sim span and instant with its payload.  Real spans are excluded
        — the digest must agree between ``SimBackend`` and
        process-backend runs of the same fixture."""
        spans = [[s.tid, s.kind, s.t0, s.t1,
                  dict(sorted(s.payload.items()))]
                 for s in self.sim_spans()]
        events = [[e.tid, e.kind, e.t, dict(sorted(e.payload.items()))]
                  for e in self.events]
        alive = {str(t): w for t, w in sorted(self.alive.items())}
        return [spans, events, alive]

    def sim_digest(self) -> str:
        blob = json.dumps(self._sim_schema(), sort_keys=True,
                          default=float)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -------------------------------------------------------- perfetto
    def to_perfetto(self) -> dict:
        """Chrome-trace JSON (Perfetto-loadable).  pid 0 carries the
        simulated clock, pid 1 the measured wall clock; thread ids are
        trainer ids (fabric windows on a synthetic track).  ``ts`` is
        microseconds, as the format requires."""
        tids = sorted(set(self.alive)
                      | {s.tid for s in self.spans if s.tid != FABRIC_TID}
                      | {e.tid for e in self.events if e.tid != FABRIC_TID})
        track = {tid: tid for tid in tids}
        track[FABRIC_TID] = (max(tids) + 1) if tids else 0
        evs: List[dict] = []
        for pid, name in ((0, "sim"), (1, "real")):
            evs.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": name}})
        for tid in tids:
            evs.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": track[tid],
                        "args": {"name": f"trainer {tid}"}})
        evs.append({"ph": "M", "name": "thread_name", "pid": 0,
                    "tid": track[FABRIC_TID], "args": {"name": "fabric"}})
        # args carry the exact second-resolution endpoints (t0/t1/t):
        # the µs ts/dur the format requires are lossy under float
        # round-trip, and from_perfetto must rebuild digest-identically
        for s in self.spans:
            pid = 0 if s.clock == "sim" else 1
            evs.append({"ph": "X", "name": s.kind, "cat": s.clock,
                        "pid": pid, "tid": track.get(s.tid, s.tid),
                        "ts": s.t0 * 1e6, "dur": s.duration * 1e6,
                        "args": dict(s.payload, trace_tid=s.tid,
                                     t0=s.t0, t1=s.t1)})
        for e in self.events:
            evs.append({"ph": "i", "name": e.kind, "cat": "sim",
                        "pid": 0, "tid": track.get(e.tid, e.tid),
                        "ts": e.t * 1e6, "s": "t",
                        "args": dict(e.payload, trace_tid=e.tid, t=e.t)})
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {
                    "schema": TRACE_SCHEMA,
                    "producer": "repro_torch.cluster.trace",
                    "alive": {str(t): list(w)
                              for t, w in sorted(self.alive.items())},
                    "finalized_at": self.finalized_at}}

    @classmethod
    def from_perfetto(cls, data: dict) -> "Trace":
        """Rebuild a Trace from :meth:`to_perfetto` output (the
        ``trace_report`` CLI path).  Raises ``ValueError`` on schema
        violations — run :func:`validate_perfetto` first for a full
        problem list instead of a first-error exception."""
        problems = validate_perfetto(data)
        if problems:
            raise ValueError("invalid trace JSON:\n  "
                             + "\n  ".join(problems))
        tr = cls()
        for ev in data["traceEvents"]:
            if ev["ph"] == "X":
                args = ev["args"]
                payload = {k: v for k, v in args.items()
                           if k not in ("trace_tid", "t0", "t1")}
                tr.spans.append(Span(
                    tid=args["trace_tid"], kind=ev["name"],
                    t0=args.get("t0", ev["ts"] / 1e6),
                    t1=args.get("t1", (ev["ts"] + ev["dur"]) / 1e6),
                    clock=ev["cat"], payload=payload))
            elif ev["ph"] == "i":
                args = ev["args"]
                payload = {k: v for k, v in args.items()
                           if k not in ("trace_tid", "t")}
                tr.events.append(TraceEvent(
                    tid=args["trace_tid"], kind=ev["name"],
                    t=args.get("t", ev["ts"] / 1e6), payload=payload))
        other = data["otherData"]
        tr.alive = {int(t): list(w) for t, w in other["alive"].items()}
        tr.finalized_at = other.get("finalized_at")
        return tr


def validate_perfetto(data: Any) -> List[str]:
    """Schema check for :meth:`Trace.to_perfetto` output; returns a
    list of human-readable problems (empty means valid)."""
    probs: List[str] = []
    if not isinstance(data, dict):
        return ["top level is not a JSON object"]
    other = data.get("otherData")
    if not isinstance(other, dict):
        probs.append("missing otherData block")
        other = {}
    if other.get("schema") != TRACE_SCHEMA:
        probs.append(f"schema version {other.get('schema')!r} != "
                     f"expected {TRACE_SCHEMA}")
    alive = other.get("alive")
    if not isinstance(alive, dict):
        probs.append("otherData.alive missing or not an object")
        alive = {}
    for t, w in alive.items():
        if (not isinstance(w, list) or len(w) != 2
                or any(not isinstance(x, (int, float)) for x in w)
                or w[1] < w[0]):
            probs.append(f"alive window for trainer {t} malformed: {w!r}")
    evs = data.get("traceEvents")
    if not isinstance(evs, list):
        return probs + ["traceEvents missing or not a list"]
    span_tids = set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict) or "ph" not in ev:
            probs.append(f"traceEvents[{i}] is not a phase event")
            continue
        if ev["ph"] == "M":
            continue
        if ev["ph"] not in ("X", "i"):
            probs.append(f"traceEvents[{i}] has unknown phase "
                         f"{ev['ph']!r}")
            continue
        args = ev.get("args")
        if not isinstance(args, dict) or "trace_tid" not in args:
            probs.append(f"traceEvents[{i}] missing args.trace_tid")
            continue
        if ev["ph"] == "X":
            clock = ev.get("cat")
            allowed = (SIM_SPAN_KINDS if clock == "sim"
                       else REAL_SPAN_KINDS if clock == "real" else None)
            if allowed is None:
                probs.append(f"traceEvents[{i}] has unknown clock "
                             f"{clock!r}")
            elif ev.get("name") not in allowed:
                probs.append(f"traceEvents[{i}] has unknown {clock} "
                             f"span kind {ev.get('name')!r}")
            if not isinstance(ev.get("ts"), (int, float)) \
                    or not isinstance(ev.get("dur"), (int, float)) \
                    or ev.get("dur", 0) < 0 or ev.get("ts", 0) < 0:
                probs.append(f"traceEvents[{i}] has malformed ts/dur")
            if (clock == "sim" and ev.get("name") != "fabric"
                    and args["trace_tid"] != FABRIC_TID):
                span_tids.add(args["trace_tid"])
        else:
            if ev.get("name") not in EVENT_KINDS:
                probs.append(f"traceEvents[{i}] has unknown event kind "
                             f"{ev.get('name')!r}")
            if not isinstance(ev.get("ts"), (int, float)):
                probs.append(f"traceEvents[{i}] has malformed ts")
    known = {int(t) for t in alive} if not probs else None
    if known is not None:
        orphans = {t for t in span_tids if t not in known}
        if orphans:
            probs.append(f"sim spans reference trainers with no alive "
                         f"window: {sorted(orphans)}")
    return probs


__all__ = ["COMM_KINDS", "EVENT_KINDS", "FABRIC_TID", "REAL_SPAN_KINDS",
           "SIM_SPAN_KINDS", "Span", "TRACE_SCHEMA", "Trace",
           "TraceEvent", "validate_perfetto"]
