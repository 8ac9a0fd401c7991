"""The port's autoscaling layer and run configuration against the JAX
package's: ``BandAutoscale`` verdicts (hypothesis), ``ClusterSpec`` and
its legacy keyword aliases, the ``Scenario`` record, the
exhausted-spares ``join_skipped`` record and autoscaled adaptive runs
(``tests/test_autoscale.py``'s fixture, both packages live; the batch
decisions keep ``tests/test_torch_adloco.py``'s excuse rule).
"""
import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

import repro.cluster.autoscale as jauto
import repro_torch.cluster.autoscale as pauto
from test_torch_adloco import decisions  # noqa: F401
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)
from test_torch_scenarios import (PKG, TOY, compare_adaptive,  # noqa: F401
                                  record_marks, setup)

P = PKG["port"][0]

ACFG = dict(num_outer_steps=6, num_inner_steps=5, lr_inner=0.05,
            lr_outer=0.7, outer_momentum=0.5, nodes_per_gpu=2,
            num_init_trainers=2, initial_batch_size=2, merge_frequency=3,
            eta=0.8, max_batch=16, inner_optimizer="sgd",
            stats_probe_size=32, enable_merge=False, adaptive=False)


def cluster(pkg, k=2, pods=(4, 4), spares=0):
    C = PKG[pkg][0]
    profiles = C.interleave_pods(C.make_pod_profiles(list(pods), ratio=2.0,
                                                     **TOY))
    topo = C.Topology.from_profiles(
        C.make_pod_profiles(list(pods), ratio=2.0, **TOY), inter_bw=1e5,
        inter_latency=4e-3)
    inits, streams = setup(pkg, k, spares)
    return profiles, topo, inits, streams


# ------------------------------------------------------- BandAutoscale

bands = st.tuples(st.floats(0.1, 50.0), st.floats(1.01, 10.0)).map(
    lambda t: (t[0], t[0] * t[1]))


@given(band=bands, min_t=st.integers(1, 4),
       max_t=st.one_of(st.none(), st.integers(4, 12)),
       cooldown=st.integers(0, 3), b=st.integers(1, 4096),
       k=st.integers(1, 16), spare=st.integers(0, 8),
       since=st.integers(0, 5))
@settings(max_examples=200, deadline=None)
def test_band_autoscale_verdicts_match_jax(band, min_t, max_t, cooldown, b,
                                           k, spare, since):
    lo, hi = band
    kw = dict(lo=lo, hi=hi, min_trainers=min_t, max_trainers=max_t,
              cooldown_rounds=cooldown)
    obs = dict(requested_batch=b, pool_size=k, spare_capacity=spare,
               rounds_since_change=since)
    assert pauto.BandAutoscale(**kw).decide(**obs) == \
        jauto.BandAutoscale(**kw).decide(**obs)
    assert pauto.BandAutoscale(**kw).describe() == \
        jauto.BandAutoscale(**kw).describe()


def test_band_autoscale_edges_and_bounds():
    pol = P.BandAutoscale(lo=2.0, hi=8.0, cooldown_rounds=0)

    def dec(**kw):
        return pol.decide(rounds_since_change=99, **kw)
    assert dec(requested_batch=16, pool_size=2, spare_capacity=5) == 0
    assert dec(requested_batch=17, pool_size=2, spare_capacity=5) == 1
    assert dec(requested_batch=17, pool_size=2, spare_capacity=0) == 0
    assert dec(requested_batch=3, pool_size=2, spare_capacity=5) == -1
    assert dec(requested_batch=3, pool_size=1, spare_capacity=5) == 0
    capped = P.BandAutoscale(lo=2.0, hi=8.0, max_trainers=2)
    assert capped.decide(requested_batch=100, pool_size=2,
                         spare_capacity=5, rounds_since_change=9) == 0


@pytest.mark.parametrize("kw, match", [
    (dict(lo=8.0, hi=2.0), "0 < lo < hi"), (dict(lo=0.0, hi=2.0),
                                            "0 < lo < hi"),
    (dict(min_trainers=0), "min_trainers"),
    (dict(min_trainers=3, max_trainers=2), "max_trainers")])
def test_band_autoscale_validates_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        P.BandAutoscale(**kw)


def test_elastic_policy_protocol_is_abstract():
    with pytest.raises(NotImplementedError):
        P.ElasticPolicy().decide(requested_batch=1, pool_size=1,
                                 spare_capacity=0, rounds_since_change=0)
    assert P.ElasticPolicy().describe() == "ElasticPolicy"


# ----------------------------------------------------- Scenario record

def test_scenario_record_behaves_as_event_sequence():
    sc = P.build_scenario("spot_churn")
    assert isinstance(sc, P.Scenario)
    assert sc.name == "spot_churn" and sc.knobs == {}
    assert len(sc) == len(sc.events) > 0
    assert sc[0] is sc.events[0] and list(sc) == list(sc.events)
    extra = [P.ClusterEvent(time=9.9, kind="join")]
    assert sc + extra == list(sc.events) + extra
    assert extra + sc == extra + list(sc.events)
    assert P.build_scenario("preemption_storm_growth",
                            leaves=3).knobs == {"leaves": 3}
    with pytest.raises(ValueError, match="already registered"):
        P.register_scenario("baseline")(lambda: [])


# ------------------------------------------------- ClusterSpec aliases

def test_spec_and_legacy_kwargs_are_equivalent_and_match_jax():
    outs = {}
    for pkg in ("jax", "port"):
        C, Cfg, loss, _, dev = PKG[pkg]
        for via_spec in (True, False):
            profiles, topo, inits, streams = cluster(pkg, spares=4)
            kw = dict(policy="elastic", profiles=profiles, network=topo,
                      scenario="spot_churn", fixed_batch=4)
            if via_spec:
                out = C.run_cluster(loss, inits, streams, Cfg(**ACFG),
                                    spec=C.ClusterSpec(**kw), **dev)
            else:
                out = C.run_cluster(loss, inits, streams, Cfg(**ACFG),
                                    **kw, **dev)
            outs[pkg, via_spec] = out
    ref = outs["jax", True][2]
    for key, (_, hist, rep) in outs.items():
        assert rep.summary(extended=True) == ref.summary(extended=True), key
        assert rep.applied_events == ref.applied_events, key
        assert hist.requested_batches == outs["jax", True][1] \
            .requested_batches
        assert hist.sim_time == outs["jax", True][1].sim_time


def test_spec_cannot_be_mixed_with_legacy_kwargs():
    profiles, topo, inits, streams = cluster("port")
    spec = P.ClusterSpec(policy="elastic", profiles=profiles, network=topo,
                         fixed_batch=4)
    with pytest.raises(ValueError, match="not both"):
        P.run_cluster(PKG["port"][2], inits, streams,
                      PKG["port"][1](**ACFG), spec=spec, fixed_batch=4,
                      device="cpu")


def test_spec_is_frozen_with_the_jax_fields():
    spec = P.ClusterSpec()
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.policy = "elastic"
    assert [f.name for f in dataclasses.fields(P.ClusterSpec)] == \
        [f.name for f in dataclasses.fields(PKG["jax"][0].ClusterSpec)]


@pytest.mark.parametrize("policy", ["sync", "async"])
def test_autoscale_requires_elastic_policy(policy):
    profiles, topo, inits, streams = cluster("port")
    with pytest.raises(ValueError, match="elastic"):
        P.run_cluster(PKG["port"][2], inits, streams,
                      PKG["port"][1](**ACFG), device="cpu",
                      spec=P.ClusterSpec(policy=policy, profiles=profiles,
                                         network=topo, fixed_batch=4,
                                         autoscale=P.BandAutoscale()))


# ------------------------------------------- join_skipped (regression)

def test_exhausted_spares_record_join_skipped_as_jax_does():
    reps = {}
    for pkg in ("jax", "port"):
        C, Cfg, loss, _, dev = PKG[pkg]
        profiles, topo, inits, streams = cluster(pkg, spares=0)
        reps[pkg] = C.run_cluster(
            loss, inits, streams, Cfg(**ACFG), **dev,
            spec=C.ClusterSpec(
                policy="elastic", profiles=profiles, network=topo,
                fixed_batch=4,
                scenario=[C.ClusterEvent(time=0.01, kind="join")]))[2]
    assert reps["port"].applied_events == reps["jax"].applied_events
    skips = [e for e in reps["port"].applied_events
             if e["kind"] == "join_skipped"]
    assert len(skips) == 1 and skips[0]["free_streams"] == 0
    assert skips[0]["needed"] == ACFG["nodes_per_gpu"]


# --------------------------------------------------- end-to-end runs

def autoscaled_run(pkg, k_correct):
    C, Cfg, loss, _, dev = PKG[pkg]
    profiles, topo, inits, streams = cluster(pkg, k=2, pods=(6, 6),
                                             spares=8)
    acfg = Cfg(**dict(ACFG, adaptive=True, stats_estimator="microbatch",
                      num_outer_steps=12, max_global_batch=256,
                      k_correct=k_correct))
    spec = C.ClusterSpec(policy="elastic", profiles=profiles, network=topo,
                         scenario="autoscale_ramp",
                         autoscale=C.BandAutoscale(lo=2.0, hi=8.0,
                                                   cooldown_rounds=2))
    return C.run_cluster(loss, inits, streams, acfg, spec=spec, **dev)


@pytest.mark.parametrize("k_correct", [1, 3])
def test_autoscaled_run_matches_jax(k_correct, decisions, record_marks):
    jout = autoscaled_run("jax", k_correct)
    tout = autoscaled_run("port", k_correct)
    n = compare_adaptive(jout, tout, decisions, record_marks)
    assert n > 0
    _, hist, rep = tout
    assert rep.num_autoscale_events > 0
    assert max(hist.pool_size) > 2
    # joiners inherit the source's batch instead of the initial one
    grew = next(i for i in range(1, len(hist.pool_size))
                if hist.pool_size[i] > hist.pool_size[i - 1])
    assert min(hist.requested_batches[grew]) > ACFG["initial_batch_size"]
    if k_correct > 1:
        # tests/test_autoscale.py's fixture: it shrinks first, then grows
        assert min(hist.pool_size) < 2
    s = rep.summary(extended=True)
    assert s["scenario"] == "autoscale_ramp"
    assert (s["num_predicted_rounds"] > 0) == (k_correct > 1)
