"""The port's scenario registry against the JAX package's, run for run.

Each registered scenario runs through ``tests/test_scenarios.py``'s
harness for its group (the 2-pod elastic fixture, the 3-level
rack/pod/cluster fixture, the merge-enabled drifted fixture, the async
adaptive fixture and the autoscaled elastic fixture) in both packages,
on the seeded quadratic of ``tests/test_torch_adloco.py`` with the same
TOY profiles.  The digest is that file's: ``ClusterReport.summary()``
and ``applied_events`` (plus the batch/plan trajectory and stats count
for the adaptive arms).

- Non-adaptive scenarios time pure Python floats, so the port's digest
  must equal the one stored in ``tests/goldens/scenarios.json`` (read,
  never written here).
- Every scenario's digest must equal a live JAX run's.  For the
  adaptive arms the batch decisions come from f32 statistics; a
  decision may differ only where both packages' ratios lie within 1e-5
  of the same integer (``test_torch_adloco._first_excused_divergence``,
  printed), and then only the records before it are compared.  The
  stored adaptive goldens are not used: the JAX package fails them
  itself (ROADMAP §3.2).
"""
import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest

import repro.cluster as J
import repro.cluster.runtime as j_runtime
import repro_torch.cluster as P
import repro_torch.cluster.runtime as p_runtime
from repro.configs.base import AdLoCoConfig as JAdLoCoConfig
from repro_torch.configs.base import AdLoCoConfig
from test_torch_adloco import (JQuadStream, TQuadStream,  # noqa: F401
                               _first_excused_divergence, decisions,
                               j_quad_loss, quad_setup, t_quad_loss)
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

GOLDENS = json.loads((pathlib.Path(__file__).parent / "goldens"
                      / "scenarios.json").read_text())

TOY = dict(flops=1e6, hbm_bw=1e9, link_bw=2e5, link_latency=2e-3)

# tests/test_scenarios.py's configurations
ACFG = dict(num_outer_steps=8, num_inner_steps=5, lr_inner=0.05,
            lr_outer=0.7, outer_momentum=0.5, nodes_per_gpu=2,
            num_init_trainers=3, initial_batch_size=2, merge_frequency=3,
            eta=0.8, max_batch=16, inner_optimizer="sgd",
            stats_probe_size=32, enable_merge=False, adaptive=False)
ACFG_ADAPTIVE = dict(ACFG, adaptive=True, stats_estimator="microbatch",
                     num_outer_steps=12, max_global_batch=256)

ADAPTIVE = set(GOLDENS["GOLDENA"]) | set(GOLDENS["GOLDENAS"])
FIXED = sorted(set(GOLDENS["GOLDEN"]) | set(GOLDENS["GOLDEN3"])
               | set(GOLDENS["GOLDENM"]))
ALL = sorted(FIXED + sorted(ADAPTIVE))

#: per package: cluster module, config class, loss, stream class and
#: run_cluster's device keyword
PKG = {"jax": (J, JAdLoCoConfig, j_quad_loss, JQuadStream, {}),
       "port": (P, AdLoCoConfig, t_quad_loss, TQuadStream,
                {"device": "cpu"})}


def group_of(name):
    return next(g for g in ("GOLDEN", "GOLDEN3", "GOLDENA", "GOLDENM",
                            "GOLDENAS") if name in GOLDENS[g])


def setup(pkg, k, spares):
    """Inits and streams of the seeded quadratic (k trainers of M=2 and
    ``spares`` spare shards) for one package."""
    jinits, jstreams, tinits, tstreams = quad_setup(k=k, M=2)
    inits, streams = ((jinits, jstreams) if pkg == "jax"
                      else (tinits, tstreams))
    Stream = PKG[pkg][3]
    return inits, streams + [Stream(streams[0].prob, 100 + i)
                             for i in range(spares)]


def pods(pkg, sizes):
    """Interleaved pod profiles and their 2-pod topology (the 2-pod
    fixture's fabric)."""
    C = PKG[pkg][0]
    profiles = C.make_pod_profiles(sizes, ratio=2.0, **TOY)
    topo = C.Topology.from_profiles(profiles, inter_bw=1e5,
                                    inter_latency=4e-3)
    return C.interleave_pods(profiles), topo


def tree_cluster(pkg):
    """3-level fixture: 2 pods x 2 racks x 2 nodes, pod 1 at half
    speed, interleaved."""
    C = PKG[pkg][0]
    profiles = C.make_rack_profiles([[2, 2], [2, 2]], ratio=2.0, **TOY)
    topo = C.Topology.from_profiles(profiles, inter_bw=1e5,
                                    inter_latency=4e-3, pod_bw=1.5e5,
                                    pod_latency=3e-3)
    return C.interleave_pods(profiles), topo


def run(pkg, name, trace=None):
    """``tests/test_scenarios.py``'s harness for ``name``'s group, in
    package ``pkg`` ("jax" or "port")."""
    C, Cfg, loss, _, dev = PKG[pkg]
    group = group_of(name)
    if group == "GOLDENAS":
        profiles, topo = pods(pkg, [6, 6])
        inits, streams = setup(pkg, 2, 8)
        spec = C.ClusterSpec(policy="elastic", profiles=profiles,
                             network=topo, scenario=name, trace=trace,
                             autoscale=C.BandAutoscale(lo=2.0, hi=8.0,
                                                       cooldown_rounds=2))
        return C.run_cluster(loss, inits, streams,
                             Cfg(**ACFG_ADAPTIVE, k_correct=3), spec=spec,
                             **dev)
    if group == "GOLDENA":
        profiles, topo = pods(pkg, [5, 5])
        inits, streams = setup(pkg, 3, 0)
        return C.run_cluster(loss, inits, streams, Cfg(**ACFG_ADAPTIVE),
                             policy="async", profiles=profiles,
                             network=topo, scenario=name, trace=trace,
                             **dev)
    if group == "GOLDEN3":
        profiles, topo = tree_cluster(pkg)
        inits, streams = setup(pkg, 3, 2)
        acfg = Cfg(**ACFG)
    else:
        profiles, topo = pods(pkg, [5, 5])
        inits, streams = setup(pkg, 3, 4)
        acfg = Cfg(**(dict(ACFG, enable_merge=True, merge_frequency=6)
                      if group == "GOLDENM" else ACFG))
    return C.run_cluster(loss, inits, streams, acfg, policy="elastic",
                         profiles=profiles, network=topo, scenario=name,
                         fixed_batch=4, trace=trace, **dev)


def schedule(rep, hist=None):
    """``tests/test_scenarios.py``'s ``_trace``: what the digest hashes."""
    t = {"summary": rep.summary(), "events": rep.applied_events}
    if hist is not None:
        t["stats_syncs"] = rep.num_stats_syncs
        t["batches"] = hist.requested_batches
        t["modes"] = hist.modes
    return t


def digest(rep, hist=None) -> str:
    blob = json.dumps(schedule(rep, hist), sort_keys=True, default=float)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@pytest.fixture
def record_marks(decisions, monkeypatch):
    """Per package, the number of batch decisions made before each
    history record (``_Sim.record``)."""
    marks = {"jax": [], "port": []}
    for key, mod in (("jax", j_runtime), ("port", p_runtime)):
        orig = mod._Sim.record

        def recorded(self, *a, _orig=orig, _key=key, **kw):
            marks[_key].append(len(decisions[_key]))
            return _orig(self, *a, **kw)
        monkeypatch.setattr(mod._Sim, "record", recorded)
    return marks


def records_before(marks, i):
    """Leading history records that reflect no decision from index
    ``i`` on (all records when ``i`` is None)."""
    if i is None:
        return len(marks)
    return sum(1 for m in marks if m <= i)


def compare_adaptive(jout, tout, decisions, marks):
    """Port run against the JAX run of an adaptive arm: equal digests
    unless an excused divergence, then equal schedules up to it.
    Returns the number of history records compared."""
    (_, jh, jr), (_, th, tr) = jout, tout
    assert decisions["port"] and decisions["jax"]
    i = _first_excused_divergence(decisions)
    if i is None:
        assert schedule(tr, th) == schedule(jr, jh)
        assert digest(tr, th) == digest(jr, jh)
        return len(jh.loss)
    n = records_before(marks["port"], i)
    assert n == records_before(marks["jax"], i)
    for field in ("requested_batches", "modes", "sim_time", "pool_size",
                  "comm_events", "comm_bytes", "outer_step"):
        assert getattr(th, field)[:n] == getattr(jh, field)[:n], field
    return n


@pytest.mark.parametrize("name", FIXED)
def test_fixed_batch_scenario_matches_stored_golden(name):
    _, hist, rep = run("port", name)
    assert digest(rep) == GOLDENS[group_of(name)][name], schedule(rep)


@pytest.mark.parametrize("name", ALL)
def test_scenario_matches_live_jax(name, decisions, record_marks):
    jout, tout = run("jax", name), run("port", name)
    if name in ADAPTIVE:
        n = compare_adaptive(jout, tout, decisions, record_marks)
        np.testing.assert_allclose(tout[1].loss[:n], jout[1].loss[:n],
                                   rtol=1e-5, atol=1e-5)
        return
    (_, jh, jr), (_, th, tr) = jout, tout
    assert schedule(tr) == schedule(jr)
    assert digest(tr) == digest(jr)
    # fixed batches: the trajectory and the comm log agree too
    assert th.requested_batches == jh.requested_batches
    assert th.sim_time == jh.sim_time
    assert [(e["kind"], e["step"], e["participants"], e["bytes"],
             e["time_s"]) for e in tout[0].comms.log if "time_s" in e] == \
        [(e["kind"], e["step"], e["participants"], e["bytes"], e["time_s"])
         for e in jout[0].comms.log if "time_s" in e]
    np.testing.assert_allclose(tout[0].global_params["x"].numpy(),
                               np.asarray(jout[0].global_params["x"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ALL)
def test_scenario_is_deterministic(name):
    _, h1, r1 = run("port", name)
    _, h2, r2 = run("port", name)
    assert r1.summary() == r2.summary()
    assert r1.applied_events == r2.applied_events
    assert h1.requested_batches == h2.requested_batches
    assert r1.num_stats_syncs == r2.num_stats_syncs


def test_registry_matches_the_jax_package():
    """Same names, same default knobs, the same compiled events."""
    assert P.list_scenarios() == J.list_scenarios() == sorted(ALL)
    for name in ALL:
        jsc, tsc = J.build_scenario(name), P.build_scenario(name)
        assert tsc.name == jsc.name and tsc.knobs == jsc.knobs
        assert [dataclasses.astuple(e) for e in tsc] == \
            [dataclasses.astuple(e) for e in jsc]
    for knobs in ({"seed": 7, "rate": 80.0}, {"seed": 3, "horizon": 0.2}):
        assert [dataclasses.astuple(e)
                for e in P.build_scenario("spot_churn", **knobs)] == \
            [dataclasses.astuple(e)
             for e in J.build_scenario("spot_churn", **knobs)]


def test_scenarios_exercise_their_event_kinds():
    """The harness reaches each scenario's events (the adaptive ramp
    has none; the autoscaled arms script joins and leaves)."""
    expected = {"bursty_congestion": {"fabric"}, "pod_partition": {"fabric"},
                "flash_crowd_join": {"join"},
                "spot_churn": {"leave", "join"},
                "correlated_pod_failure": {"slowdown", "fabric"},
                "diurnal_congestion": {"fabric"}, "rack_flap": {"fabric"},
                "straggler_cascade": {"slowdown", "fabric"},
                "congested_adaptive": {"fabric"},
                "drifted_merge": {"slowdown", "merge"},
                "autoscale_ramp": {"autoscale", "join", "leave"},
                "preemption_storm_growth": {"autoscale", "join", "leave"}}
    for name, kinds in expected.items():
        _, _, rep = run("port", name)
        assert kinds <= {e["kind"] for e in rep.applied_events}, name


def test_adaptive_ramp_grows_and_piggybacks_its_stats():
    pool, hist, rep = run("port", "adaptive_ramp")
    firsts = [bs[0] for bs in hist.requested_batches]
    assert firsts[-1] > firsts[0]
    assert any(m == "accum" for ms in hist.modes for m in ms)
    fused = [e for e in pool.comms.log if e["kind"] == "piggyback"]
    assert len(fused) == rep.num_stats_syncs > 0
    assert not [e for e in pool.comms.log if e["kind"] == "stats"]


def test_unknown_scenario_is_rejected():
    with pytest.raises(ValueError, match="unknown scenario"):
        P.build_scenario("nope")
    inits, streams = setup("port", 3, 0)
    with pytest.raises(ValueError, match="unknown scenario"):
        P.run_cluster(t_quad_loss, inits, streams, AdLoCoConfig(**ACFG),
                      scenario="nope", device="cpu")
