"""Scripted scenario library: named, deterministic generators that
compile to :class:`~repro_torch.cluster.runtime.ClusterEvent` streams.
Port of ``repro/cluster/scenarios.py``: the same registry, generators
and default knobs, so a scenario compiles to the same event stream in
both packages.

Benchmarks and tests run the *same* scenario by name — ``run_cluster``
accepts ``scenario="spot_churn"`` directly — so a scheduler refactor
that changes simulated behavior is caught by the stored scenario
digests.  Every generator is a pure function of its
keyword knobs (``spot_churn`` draws from a generator seeded by its
``seed`` knob), so the same knobs always compile to the same event
stream.

Registered scenarios and their knobs
------------------------------------
``baseline()``
    No events: the undisturbed fabric, the control arm of every sweep.
``bursty_congestion(start, period, burst, depth, extra_latency, count,
scope)``
    ``count`` congestion windows of ``burst`` seconds, one every
    ``period`` seconds starting at ``start``: bandwidth is multiplied by
    ``depth`` (< 1) and every hop pays ``extra_latency`` while a window
    is open.  ``scope`` picks which links suffer ("inter" squeezes only
    the cross-pod bottleneck of a :class:`Topology`).
``spot_churn(seed, rate, horizon, rejoin_after, start)``
    Poisson spot-instance churn: leave events with exponential
    inter-arrival gaps (``rate`` per simulated second, until
    ``horizon``), each followed ``rejoin_after`` seconds later by a join
    that restores capacity from the spare pool.  A scripted leave is a
    *preemption*: the survivor briefly absorbs the leaver's data
    shards, then the absorbed streams are reclaimed into the spare
    pool along with the nodes, so churn returns the full capacity it
    took and rejoins can land indefinitely.  (Only autoscaler-scripted
    shrinks — deliberate consolidations — leave the union on the
    survivor; see ``runtime.ClusterEvent``.)
``pod_partition(start, duration, residual, extra_latency)``
    The cross-pod links all but fail for ``duration`` seconds:
    bandwidth drops to ``residual`` of nominal and hops pay
    ``extra_latency`` — a fabric partition that intra-pod traffic never
    notices.
``flash_crowd_join(start, joins, spacing)``
    ``joins`` trainers join in quick succession (every ``spacing``
    seconds) — a flash crowd landing on the spare pool.  Joins beyond
    the spare capacity are no-ops.

Co-scripted scenarios (node dynamics + fabric windows together)
---------------------------------------------------------------
``correlated_pod_failure(start, duration, factor, nodes, depth,
extra_latency, scope)``
    One pod fails together: its nodes compute ``factor``x slower *and*
    the fabric joining pods degrades (``depth`` bandwidth scale,
    ``extra_latency`` per hop) for the same window.  ``nodes`` are the
    afflicted pod's indices into the profile list handed to
    ``run_cluster`` (defaults match pod 1 of a 2-pod interleaved
    layout); ``scope`` defaults to ``domain:cluster`` — the level whose
    paths are the pods' uplinks (the ring across pods is bottlenecked by
    its slowest path, so degrading the level prices like degrading the
    one uplink).
``diurnal_congestion(start, period, depth, cycles, steps, scope)``
    Smooth periodic congestion: each ``period`` is cut into ``steps``
    piecewise-constant windows whose bandwidth scale traces a cosine
    from 1.0 down to ``depth`` and back — the diurnal load curve of a
    shared fabric, repeated ``cycles`` times.
``rack_flap(start, period, burst, depth, extra_latency, count, domain)``
    One rack's level-0 fabric oscillates: ``count`` windows of ``burst``
    seconds every ``period`` on the named leaf domain only (default
    ``p0r0`` — the first rack of a 3-level
    ``Topology.from_profiles(..., pod_bw=...)`` tree); every other
    domain keeps its nominal links.
``straggler_cascade(start, window, depth, extra_latency, nodes, factor,
slow_for, stagger, scope)``
    Stragglers inside a congestion window: the fabric degrades for
    ``window`` seconds and, while it is open, ``nodes`` slow down one
    after another (``stagger`` apart, each ``factor``x slower for
    ``slow_for`` seconds) — the compounded worst case where the wire
    and the workers degrade together.
``drifted_merge(start, factor, duration, nodes)``
    One trainer's nodes slow hard enough that its round counter drifts
    past ``merge_drift_window`` by the first merge round: the
    round-tagged merge fires on time among the up-to-date trainers and
    records the laggard in the ``skipped`` list instead of stalling.

Adaptive-aware scenarios (run with ``acfg.adaptive=True``)
----------------------------------------------------------
These two are the adaptive-batching arms of the sweep: the *ramp* is
driven by the config (requested batches grow via the paper's §3.3
tests, so every round ends in a priced batch-stats reduction and the
per-round roofline compute grows with the batch), and the scenario
supplies the fabric the ramp runs on.

``adaptive_ramp()``
    No events: the undisturbed fabric — the control arm, isolating the
    cost/benefit of batch growth itself (stats collectives + growing
    compute vs fewer rounds to target).
``autoscale_ramp()``
    No events, like ``adaptive_ramp`` — but meant to run with a
    ``ClusterSpec.autoscale`` policy (see ``repro_torch.cluster.autoscale``):
    the batch ramp drives the pool, joins and leaves are scripted by the
    autoscaler at round boundaries rather than by the event stream.
``preemption_storm_growth(start, leaves, spacing)``
    A burst of trainer evictions timed to land mid-growth; with an
    autoscale policy the band re-grows the pool from the spares, paying
    real join-transfer prices through the re-pricing registry.
``congested_adaptive(start, duration, depth, extra_latency, scope)``
    One deep congestion window timed to collide with the batch ramp —
    the paper's motivating trade: exactly as rounds lengthen (growing
    batches) and outer payloads matter most, the fabric degrades, and
    the stats reductions in flight are re-priced along with the outer
    syncs.  The default window opens early enough that a fixed-batch
    control arm of the same length also runs through it (both arms of
    the bench sweep see the same weather).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from repro_torch.cluster.runtime import ClusterEvent

#: name -> generator; use :func:`register_scenario` to extend
SCENARIOS: Dict[str, Callable[..., List[ClusterEvent]]] = {}


@dataclass(frozen=True)
class Scenario:
    """A compiled scenario: the generator's name, the knobs it was built
    with, and the event stream they compiled to.

    Behaves as a plain sequence of :class:`~repro_torch.cluster.runtime.
    ClusterEvent`\\ s (iteration, ``len``, indexing, slicing, ``+`` with
    a list concatenates to a raw event list), so every call site that
    accepted a raw list still works — but the *name* now travels with
    the events, and ``run_cluster`` threads it into
    ``ClusterReport.summary(extended=True)``.
    """

    name: str
    knobs: Dict[str, Any] = field(default_factory=dict)
    events: Tuple[ClusterEvent, ...] = ()

    def __len__(self) -> int:
        return len(self.events)

    def __getitem__(self, idx):
        return self.events[idx]

    def __iter__(self):
        return iter(self.events)

    def __add__(self, other) -> List[ClusterEvent]:
        return list(self.events) + list(other)

    def __radd__(self, other) -> List[ClusterEvent]:
        return list(other) + list(self.events)


def register_scenario(name: str):
    """Decorator: register a generator under ``name``.  Generators must
    be deterministic functions of their keyword arguments."""
    def deco(fn: Callable[..., List[ClusterEvent]]):
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        SCENARIOS[name] = fn
        return fn
    return deco


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def build_scenario(name: str, **knobs) -> Scenario:
    """Compile the registered scenario ``name`` to a named
    :class:`Scenario` record (a sequence of its events)."""
    try:
        gen = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; registered: "
                         f"{list_scenarios()}") from None
    return Scenario(name=name, knobs=dict(knobs), events=tuple(gen(**knobs)))


@register_scenario("baseline")
def baseline() -> List[ClusterEvent]:
    return []


@register_scenario("bursty_congestion")
def bursty_congestion(*, start: float = 0.005, period: float = 0.02,
                      burst: float = 0.01, depth: float = 0.1,
                      extra_latency: float = 8e-3, count: int = 6,
                      scope: str = "inter") -> List[ClusterEvent]:
    if not 0.0 < depth:
        raise ValueError(f"depth must be positive, got {depth}")
    return [ClusterEvent(time=start + i * period, kind="fabric",
                         scope=scope, bw_scale=depth,
                         extra_latency=extra_latency, duration=burst)
            for i in range(count)]


@register_scenario("spot_churn")
def spot_churn(*, seed: int = 0, rate: float = 50.0, horizon: float = 0.06,
               rejoin_after: float = 0.015,
               start: float = 0.005) -> List[ClusterEvent]:
    if rate <= 0.0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    events: List[ClusterEvent] = []
    t = start
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= horizon:
            break
        events.append(ClusterEvent(time=t, kind="leave"))
        events.append(ClusterEvent(time=t + rejoin_after, kind="join"))
    return events


@register_scenario("pod_partition")
def pod_partition(*, start: float = 0.02, duration: float = 0.03,
                  residual: float = 0.05,
                  extra_latency: float = 2e-2) -> List[ClusterEvent]:
    return [ClusterEvent(time=start, kind="fabric", scope="inter",
                         bw_scale=residual, extra_latency=extra_latency,
                         duration=duration)]


@register_scenario("flash_crowd_join")
def flash_crowd_join(*, start: float = 0.02, joins: int = 2,
                     spacing: float = 0.01) -> List[ClusterEvent]:
    return [ClusterEvent(time=start + i * spacing, kind="join")
            for i in range(joins)]


@register_scenario("correlated_pod_failure")
def correlated_pod_failure(*, start: float = 0.01, duration: float = 0.03,
                           factor: float = 3.0, nodes=(1, 3, 5),
                           depth: float = 0.15, extra_latency: float = 6e-3,
                           scope: str = "domain:cluster"
                           ) -> List[ClusterEvent]:
    if not 0.0 < depth:
        raise ValueError(f"depth must be positive, got {depth}")
    evs = [ClusterEvent(time=start, kind="slowdown", node=int(i),
                        factor=factor, duration=duration)
           for i in nodes]
    evs.append(ClusterEvent(time=start, kind="fabric", scope=scope,
                            bw_scale=depth, extra_latency=extra_latency,
                            duration=duration))
    return evs


@register_scenario("diurnal_congestion")
def diurnal_congestion(*, start: float = 0.0, period: float = 0.04,
                       depth: float = 0.25, cycles: int = 2,
                       steps: int = 8,
                       scope: str = "inter") -> List[ClusterEvent]:
    if not 0.0 < depth <= 1.0:
        raise ValueError(f"depth must be in (0, 1], got {depth}")
    if steps < 1 or cycles < 1:
        raise ValueError(f"steps and cycles must be >= 1, got "
                         f"{steps}/{cycles}")
    dt = period / steps
    evs = []
    for c in range(cycles):
        for s in range(steps):
            # midpoint of the step on the cosine load curve: scale 1.0
            # at the period edges, `depth` at its trough
            phase = (s + 0.5) / steps
            scale = depth + (1.0 - depth) * 0.5 * (
                1.0 + math.cos(2.0 * math.pi * phase))
            evs.append(ClusterEvent(time=start + (c * steps + s) * dt,
                                    kind="fabric", scope=scope,
                                    bw_scale=scale, duration=dt))
    return evs


@register_scenario("rack_flap")
def rack_flap(*, start: float = 0.004, period: float = 0.016,
              burst: float = 0.008, depth: float = 0.1,
              extra_latency: float = 4e-3, count: int = 5,
              domain: str = "p0r0") -> List[ClusterEvent]:
    if not 0.0 < depth:
        raise ValueError(f"depth must be positive, got {depth}")
    return [ClusterEvent(time=start + i * period, kind="fabric",
                         scope=f"domain:{domain}", bw_scale=depth,
                         extra_latency=extra_latency, duration=burst)
            for i in range(count)]


@register_scenario("straggler_cascade")
def straggler_cascade(*, start: float = 0.01, window: float = 0.04,
                      depth: float = 0.2, extra_latency: float = 5e-3,
                      nodes=(0, 2, 4), factor: float = 4.0,
                      slow_for: float = 0.02, stagger: float = 0.006,
                      scope: str = "inter") -> List[ClusterEvent]:
    if not 0.0 < depth:
        raise ValueError(f"depth must be positive, got {depth}")
    evs = [ClusterEvent(time=start, kind="fabric", scope=scope,
                        bw_scale=depth, extra_latency=extra_latency,
                        duration=window)]
    for i, n in enumerate(nodes):
        t = start + (i + 1) * stagger
        if t >= start + window:      # cascade stays inside the window
            break
        evs.append(ClusterEvent(time=t, kind="slowdown", node=int(n),
                                factor=factor, duration=slow_for))
    return evs


@register_scenario("drifted_merge")
def drifted_merge(*, start: float = 0.0, factor: float = 8.0,
                  duration: float = 10.0, nodes=(2, 3)) -> List[ClusterEvent]:
    """Drift one trainer past the merge window: the given nodes (default
    trainer 1's pair in a k=3, M=2 layout) compute ``factor``x slower
    from ``start``, so by the first merge round that trainer's round
    counter lags the callers'.  Round-tagged merging fires ON TIME and
    skips the drifted trainer (``merge_drift_window``) instead of the
    old behavior — stalling every merge until the slowest trainer
    caught up and then folding rounds-stale params into the pool.
    Pinned by the ``GOLDENM`` digest in ``tests/goldens/scenarios.json``."""
    return [ClusterEvent(time=start, kind="slowdown", node=int(n),
                         factor=factor, duration=duration)
            for n in nodes]


@register_scenario("adaptive_ramp")
def adaptive_ramp() -> List[ClusterEvent]:
    """Clean fabric for the batch ramp (see the module docstring): the
    adaptivity lives in the config, not the event stream."""
    return []


@register_scenario("autoscale_ramp")
def autoscale_ramp() -> List[ClusterEvent]:
    """Clean fabric for the batch-growth *autoscaling* arm: like
    ``adaptive_ramp`` the adaptivity lives in the config, and the pool
    dynamics live in the ``ClusterSpec.autoscale`` policy (joins/leaves
    are scripted by the autoscaler at round boundaries, not by the event
    stream), so the scenario itself contributes no events."""
    return []


@register_scenario("preemption_storm_growth")
def preemption_storm_growth(*, start: float = 0.08, leaves: int = 2,
                            spacing: float = 0.02) -> List[ClusterEvent]:
    """A burst of preemptions timed to land mid-growth: ``leaves``
    trainers are evicted every ``spacing`` seconds starting at ``start``
    (defaults hit the exponential phase of the adaptive ramp).  Run with
    an autoscale policy: the band detects the collapsed pool against the
    still-large batch and re-grows from the spare pool, paying real
    join-transfer prices.  Each eviction returns the leaver's streams
    and nodes to the spares, so the storm never permanently shrinks the
    join capacity — the bench gates the gradients-per-worker band
    re-closing after the last eviction."""
    return [ClusterEvent(time=start + i * spacing, kind="leave")
            for i in range(leaves)]


@register_scenario("congested_adaptive")
def congested_adaptive(*, start: float = 0.015, duration: float = 0.12,
                       depth: float = 0.1, extra_latency: float = 8e-3,
                       scope: str = "inter") -> List[ClusterEvent]:
    if not 0.0 < depth:
        raise ValueError(f"depth must be positive, got {depth}")
    return [ClusterEvent(time=start, kind="fabric", scope=scope,
                         bw_scale=depth, extra_latency=extra_latency,
                         duration=duration)]


__all__ = ["SCENARIOS", "Scenario", "register_scenario", "list_scenarios",
           "build_scenario", "baseline", "bursty_congestion", "spot_churn",
           "pod_partition", "flash_crowd_join", "correlated_pod_failure",
           "diurnal_congestion", "rack_flap", "straggler_cascade",
           "adaptive_ramp", "autoscale_ramp", "congested_adaptive",
           "drifted_merge", "preemption_storm_growth"]
