"""The port's cluster runtime (``repro_torch.cluster``) against the JAX
package's ``repro.cluster`` on the CPU.

- Cost models: ``ring_allreduce_time``, ``hierarchical_allreduce_time``
  (pod spelling and ``CommDomain`` trees), ``NetworkModel`` and
  ``Topology`` pricing under fabric windows of every scope equal the
  JAX package's **exactly** (hypothesis, cases drawn as
  ``tests/test_network_props.py`` draws them): the clock is Python float
  arithmetic in the same order.
- ``run_cluster`` under sync, async and elastic, adaptive batching on,
  on the seeded quadratic of ``tests/test_torch_adloco.py`` with TOY
  profiles: ``summary()`` and ``applied_events`` equal, the batch
  trajectory and the comm log equal, final params within 1e-5 (f32).
  A batch decision may differ only at an integer ratio
  (``_first_excused_divergence``, printed); records after it are not
  compared.
- The sync policy with merging off equals the port's own
  ``train_adloco`` bitwise.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.cluster as J
import repro.core.comms as jcomms
import repro_torch.cluster as P
import repro_torch.core.comms as pcomms
from repro_torch.cluster import node as pnode
from repro_torch.core import train_adloco
from repro_torch.core.adloco import TrainerRound
from test_torch_adloco import decisions  # noqa: F401
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)
from test_torch_scenarios import (PKG, TOY, compare_adaptive,  # noqa: F401
                                  record_marks, setup)

BASE = dict(num_outer_steps=8, num_inner_steps=5, lr_inner=0.05,
            lr_outer=0.7, outer_momentum=0.5, nodes_per_gpu=2,
            num_init_trainers=3, initial_batch_size=2, merge_frequency=3,
            eta=0.8, max_batch=16, inner_optimizer="sgd",
            stats_probe_size=32)

bws = st.floats(min_value=1e-6, max_value=1e12)
payloads = st.floats(min_value=1.0, max_value=1e12)
lats = st.floats(min_value=0.0, max_value=1.0)


# ----------------------------------------------------------- cost models

@given(payload=st.floats(0.0, 1e12), p=st.integers(0, 64), bw=bws,
       lat=lats)
@settings(max_examples=200, deadline=None)
def test_ring_allreduce_time_matches_jax(payload, p, bw, lat):
    assert pcomms.ring_allreduce_time(payload, p, bw, lat) == \
        jcomms.ring_allreduce_time(payload, p, bw, lat)


@given(payload=payloads,
       pods=st.lists(st.integers(0, 8), min_size=1, max_size=6),
       intra=st.one_of(bws, st.lists(bws, min_size=6, max_size=6)),
       inter=bws, lat_i=st.one_of(lats, st.lists(lats, min_size=6,
                                                  max_size=6)),
       lat_x=lats)
@settings(max_examples=200, deadline=None)
def test_hierarchical_pod_spelling_matches_jax(payload, pods, intra, inter,
                                               lat_i, lat_x):
    if isinstance(intra, list):
        intra = intra[:len(pods)]
    if isinstance(lat_i, list):
        lat_i = lat_i[:len(pods)]
    args = (payload, pods, intra, inter)
    kw = dict(intra_latency=lat_i, inter_latency=lat_x)
    assert pcomms.hierarchical_allreduce_time(*args, **kw) == \
        jcomms.hierarchical_allreduce_time(*args, **kw)


def _domain_trees(depth):
    """Random (possibly unbalanced, possibly empty-leafed) domain trees
    as nested tuples: ('leaf', size, bw, lat) / ('node', bw, lat, kids)."""
    leaf = st.tuples(st.just("leaf"), st.integers(0, 5), bws, lats)
    if depth == 0:
        return leaf
    return st.one_of(leaf, st.tuples(
        st.just("node"), bws, lats,
        st.lists(_domain_trees(depth - 1), min_size=1, max_size=4)))


def _build(comms, t):
    if t[0] == "leaf":
        return comms.CommDomain(bw=t[2], latency=t[3], size=t[1])
    return comms.CommDomain(bw=t[1], latency=t[2],
                            children=tuple(_build(comms, c) for c in t[3]))


@given(payload=payloads, tree=_domain_trees(3))
@settings(max_examples=200, deadline=None)
def test_hierarchical_domain_trees_match_jax(payload, tree):
    pt, jt = _build(pcomms, tree), _build(jcomms, tree)
    assert pt.leaves() == jt.leaves()
    assert pcomms.hierarchical_allreduce_time(payload, pt) == \
        jcomms.hierarchical_allreduce_time(payload, jt)


def test_pricing_errors_match_jax():
    for comms in (pcomms, jcomms):
        with pytest.raises(ValueError, match="link_bw must be positive"):
            comms.ring_allreduce_time(1e3, 4, 0.0)
        with pytest.raises(ValueError, match="not both"):
            comms.CommDomain(bw=1.0, size=2,
                             children=(comms.CommDomain(bw=1.0, size=1),))
        with pytest.raises(ValueError, match="inter_bw must be positive"):
            comms.hierarchical_allreduce_time(1e3, [2, 2], 1e9, 0.0)
        with pytest.raises(ValueError, match="intra_bw is required"):
            comms.hierarchical_allreduce_time(1e3, [2, 2])


windows = st.lists(st.tuples(
    st.floats(0.0, 1.0), st.one_of(st.none(), st.floats(-0.1, 1.0)),
    st.floats(0.01, 2.0), st.floats(0.0, 0.05),
    st.sampled_from(["all", "intra", "inter", "level:0", "level:1",
                     "domain:cluster", "domain:p0", "domain:p1r0",
                     "edge:p1", "edge:p0r1"])), max_size=5)


def _fabric(pkg, shape, ratio, three_level, inter_bw, pod_bw, wins):
    C = PKG[pkg][0]
    profiles = C.make_rack_profiles(shape, ratio=ratio, **TOY)
    kw = dict(inter_bw=inter_bw, inter_latency=3e-3)
    if three_level:
        kw.update(pod_bw=pod_bw, pod_latency=1e-3)
    topo = C.Topology.from_profiles(profiles, **kw)
    flat = C.NetworkModel()
    for start, dur, scale, extra, scope in wins:
        for net in (topo, flat):
            try:
                net.add_fabric_window(start, dur, bw_scale=scale,
                                      extra_latency=extra, scope=scope)
            except ValueError:       # the scope names no domain here
                pass
    return profiles, topo, flat


@given(shape=st.lists(st.lists(st.integers(1, 3), min_size=1, max_size=2),
                      min_size=2, max_size=2),
       ratio=st.floats(1.0, 4.0), three_level=st.booleans(),
       inter_bw=st.floats(1e3, 1e6), pod_bw=st.floats(1e3, 1e6),
       wins=windows, payload=payloads,
       picks=st.lists(st.integers(0, 99), min_size=1, max_size=6),
       now=st.floats(0.0, 1.5))
@settings(max_examples=150, deadline=None)
def test_topology_and_network_pricing_match_jax(shape, ratio, three_level,
                                                inter_bw, pod_bw, wins,
                                                payload, picks, now):
    pp, ptopo, pflat = _fabric("port", shape, ratio, three_level, inter_bw,
                               pod_bw, wins)
    jp, jtopo, jflat = _fabric("jax", shape, ratio, three_level, inter_bw,
                               pod_bw, wins)
    idx = sorted({i % len(pp) for i in picks})
    pn, jn = [pp[i] for i in idx], [jp[i] for i in idx]
    assert ptopo.domain_names() == jtopo.domain_names()
    assert ptopo.pods == jtopo.pods
    assert ptopo.fabric_change_points() == jtopo.fabric_change_points()
    assert pflat.fabric_change_points() == jflat.fabric_change_points()
    assert ptopo.participant_tree([n.name for n in pn]) == \
        jtopo.participant_tree([n.name for n in jn])
    for pnet, jnet in ((ptopo, jtopo), (pflat, jflat)):
        assert pnet.allreduce_time(payload, pn, now=now) == \
            jnet.allreduce_time(payload, jn, now=now)
        assert pnet.point_to_point_time(payload, pn[0], pn[-1], now=now) \
            == jnet.point_to_point_time(payload, jn[0], jn[-1], now=now)


def test_fabric_scope_errors_match_jax():
    for pkg in ("port", "jax"):
        C = PKG[pkg][0]
        profiles = C.make_pod_profiles([2, 2], **TOY)
        topo = C.Topology.from_profiles(profiles, inter_bw=1e5)
        for scope, match in (("nowhere", "scope must be"),
                             ("domain:zz", "unknown domain"),
                             ("edge:cluster", "no uplink"),
                             ("level:7", "no domains at level")):
            with pytest.raises(ValueError, match=match):
                topo.add_fabric_window(0.0, 1.0, bw_scale=0.5, scope=scope)
        with pytest.raises(ValueError, match="bw_scale must be positive"):
            C.NetworkModel().add_fabric_window(0.0, 1.0, bw_scale=0.0)
    assert P.FABRIC_SCOPES == J.FABRIC_SCOPES


# ------------------------------------------------------------ node model

def test_node_defaults_are_the_h100_figures():
    """One H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at
    450 GB/s each way (NVIDIA H100 datasheet); none of the JAX
    package's TPU constants."""
    n = P.NodeProfile.from_roofline()
    assert (n.flops, n.hbm_bw, n.link_bw) == (989e12, 3.35e12, 450e9)
    assert n.link_latency == pnode.DEFAULT_LATENCY == 2e-6
    assert n.name == "h100"
    slow = P.make_heterogeneous_profiles(3, ratio=2.0)[-1]
    assert (slow.flops, slow.hbm_bw, slow.link_bw) == (989e12 / 2,
                                                       3.35e12 / 2, 225e9)
    from repro.launch import roofline
    for const in (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW):
        assert const not in (pnode.PEAK_FLOPS, pnode.HBM_BW, pnode.LINK_BW)


@pytest.mark.parametrize("maker, arg", [
    ("make_heterogeneous_profiles", 5), ("make_pod_profiles", [3, 2]),
    ("make_rack_profiles", [[2, 1], [3]])])
def test_profiles_and_jitter_draws_match_jax(maker, arg):
    """Same names, pods, racks, speeds and per-node seeds; lognormal
    jitter draws bit-identical (numpy, ``SeedSequence([seed,
    crc32(name)])``), slowdowns applied alike."""
    kw = dict(ratio=3.0, jitter=0.3, seed=4, **TOY)
    tp = P.interleave_pods(getattr(P, maker)(arg, **kw))
    jp = J.interleave_pods(getattr(J, maker)(arg, **kw))
    for t, j in zip(tp, jp):
        t.add_slowdown(0.1, 0.2, 3.0)
        j.add_slowdown(0.1, 0.2, 3.0)
    assert [(p.name, p.pod, p.rack, p.flops, p.hbm_bw, p.link_bw, p.seed)
            for p in tp] == [(p.name, p.pod, p.rack, p.flops, p.hbm_bw,
                              p.link_bw, p.seed) for p in jp]
    for now in (0.0, 0.15, 0.25, 0.31, 1.0):
        assert [p.compute_time(3e6, 5e5, now) for p in tp] == \
            [p.compute_time(3e6, 5e5, now) for p in jp]


# ---------------------------------------------------------- comms meter

def test_timed_comms_meter_matches_jax():
    meters = (pcomms.TimedCommsMeter(), jcomms.TimedCommsMeter())
    for m in meters:
        m.record_timed("outer", participants=4, payload_bytes=1000, step=1,
                       duration=0.25)
        m.record_timed("stats", participants=2, payload_bytes=76, step=1,
                       duration=0.125)
        m.record("merge", participants=3, payload_bytes=64, step=3)
        m.add_real_time(m.log[0], 0.5)
        m.add_real_time(m.log[0], 0.25)
    p, j = meters
    assert (p.log, p.events, p.total_bytes, p.total_time,
            p.total_real_time) == (j.log, j.events, j.total_bytes,
                                   j.total_time, j.total_real_time)
    assert pcomms.param_bytes({"a": torch.zeros(3, 4),
                               "b": torch.zeros(5, dtype=torch.bfloat16)}) \
        == 3 * 4 * 4 + 5 * 2


# ----------------------------------------------------------- the backend

def test_sim_backend_stacks_on_the_params_device():
    be = P.SimBackend()
    assert be.for_run() is not be and be.for_run().network is not be.network
    wps = [{"x": torch.full((3,), float(i)), "y": torch.ones(2, 2) * i}
           for i in range(2)]
    stacked, stats = be.wait_outer(be.dispatch_outer(
        wps, stats_vec=np.arange(4, dtype=np.float64)))
    assert stacked["x"].shape == (2, 3) and stacked["y"].shape == (2, 2, 2)
    assert torch.equal(stacked["x"][1], wps[1]["x"])
    assert stats.dtype == torch.float32 and stats.device == wps[0]["x"].device
    assert torch.equal(stats, torch.arange(4, dtype=torch.float32))
    assert be.wait_outer(be.dispatch_outer(wps))[1] is None
    with pytest.raises(ValueError, match="partial worker set"):
        be.outer_reduce([wps[0], None])
    for hook in (be.merge_reducer, be.stats_reducer, be.pop_measured,
                 be.pop_stats_measured, be.pop_merge_measured,
                 be.pop_phase2_total):
        assert hook() is None
    assert be.local_workers(2) is None and be.mean_scalar(1.5) == 1.5


def test_new_trainer_has_fresh_states_on_the_params_device():
    acfg = PKG["port"][1](**dict(BASE, inner_optimizer="adamw"))
    rnd = TrainerRound(PKG["port"][2], acfg)
    params = {"x": torch.randn(16, dtype=torch.float32)}
    tr = rnd.new_trainer(7, params, ["s0", "s1", "s2"])
    assert tr.tid == 7 and tr.params is params
    assert tr.requested_batch == acfg.initial_batch_size
    assert tr.streams == ["s0", "s1", "s2"]
    assert len(tr.inner_opt_states) == acfg.nodes_per_gpu
    for st_ in tr.inner_opt_states:
        for v in st_["m"].values():
            assert v.device == params["x"].device and not v.any()


def test_run_cluster_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inits, streams = setup("port", 3, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run_cluster(PKG["port"][2], inits, streams,
                      PKG["port"][1](**BASE), policy="sync",
                      profiles=P.make_heterogeneous_profiles(6, **TOY))


def test_rejects_unknown_policy_short_profiles_and_backend_network():
    inits, streams = setup("port", 3, 0)
    kw = dict(device="cpu")
    cfg = PKG["port"][1](**BASE)
    with pytest.raises(ValueError, match="policy"):
        P.run_cluster(PKG["port"][2], inits, streams, cfg, policy="warp",
                      **kw)
    with pytest.raises(ValueError, match="profiles"):
        P.run_cluster(PKG["port"][2], inits, streams, cfg,
                      profiles=P.make_heterogeneous_profiles(2, **TOY), **kw)
    with pytest.raises(ValueError, match="backend"):
        P.run_cluster(PKG["port"][2], inits, streams, cfg,
                      backend=P.SimBackend(), network=P.NetworkModel(), **kw)


# ------------------------------------------------------------ policies

def _policy_run(pkg, policy, extra=None):
    C, Cfg, loss, _, dev = PKG[pkg]
    extra = dict(extra or {})
    scenario = ()
    if policy == "elastic":
        inits, streams = setup(pkg, 3, 2)
        profiles = C.make_heterogeneous_profiles(8, ratio=2.0, **TOY)
        scenario = [C.ClusterEvent(time=0.01, kind="slowdown", node=5,
                                   factor=4.0, duration=0.2),
                    C.ClusterEvent(time=0.05, kind="leave"),
                    C.ClusterEvent(time=0.15, kind="join")]
        network = C.NetworkModel()
    else:
        inits, streams = setup(pkg, 3, 0)
        pods = C.make_pod_profiles([3, 3], ratio=2.0, **TOY)
        profiles = C.interleave_pods(pods)
        network = C.Topology.from_profiles(pods, inter_bw=1e5,
                                           inter_latency=4e-3)
        scenario = C.build_scenario("bursty_congestion")
    acfg = Cfg(**dict(BASE, enable_merge=(policy == "elastic"), **extra))
    return C.run_cluster(loss, inits, streams, acfg, policy=policy,
                         profiles=profiles, network=network,
                         scenario=scenario, **dev)


CASES = {"sync": ("sync", {}), "async": ("async", {}),
         "async_microbatch": ("async", {"stats_estimator": "microbatch"}),
         "async_delay_comp": ("async", {"delay_compensation": True,
                                        "outer_momentum": 0.9}),
         "elastic": ("elastic", {})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_run_matches_jax(case, decisions, record_marks):
    policy, extra = CASES[case]
    jout = _policy_run("jax", policy, extra)
    tout = _policy_run("port", policy, extra)
    n = compare_adaptive(jout, tout, decisions, record_marks)
    (jp, jh, jr), (tp, th, tr) = jout, tout
    np.testing.assert_allclose(th.loss[:n], jh.loss[:n], rtol=1e-5,
                               atol=1e-5)
    if n == len(jh.loss):
        # the comm log (kinds, steps, bytes, simulated seconds) and the
        # final params
        assert [(e["kind"], e["step"], e["bytes"], e.get("time_s"))
                for e in tp.comms.log] == \
            [(e["kind"], e["step"], e["bytes"], e.get("time_s"))
             for e in jp.comms.log]
        assert tr.summary(extended=True) == jr.summary(extended=True)
        np.testing.assert_allclose(tp.global_params["x"].numpy(),
                                   np.asarray(jp.global_params["x"]),
                                   rtol=1e-5, atol=1e-5)
    if policy == "elastic":
        kinds = [e["kind"] for e in tr.applied_events]
        assert {"slowdown", "leave", "join"} <= set(kinds)


def test_sync_policy_is_train_adloco_bitwise():
    """Merging off: trainers are independent, so the sync policy gives
    the host loop's numerics exactly, under a congested 2-pod fabric."""
    acfg = PKG["port"][1](**dict(BASE, enable_merge=False))

    def checksum(p):                  # the eval: tells records apart
        return float(p["x"].double().sum())
    inits, streams = setup("port", 3, 0)
    pool_l, hist_l = train_adloco(PKG["port"][2], inits, streams, acfg,
                                  eval_fn=checksum, device="cpu")
    inits, streams = setup("port", 3, 0)
    pods = P.make_pod_profiles([3, 3], ratio=2.0, **TOY)
    pool_c, hist_c, rep = P.run_cluster(
        PKG["port"][2], inits, streams, acfg, policy="sync",
        profiles=P.interleave_pods(pods),
        network=P.Topology.from_profiles(pods, inter_bw=1e5),
        scenario="bursty_congestion", eval_fn=checksum, device="cpu")
    assert torch.equal(pool_c.global_params["x"], pool_l.global_params["x"])
    for tc, tl in zip(pool_c.trainers, pool_l.trainers):
        assert tc.tid == tl.tid and torch.equal(tc.params["x"],
                                                tl.params["x"])
    # per (trainer, round): params, requested batch and loss; the host
    # loop's round loss is the mean over trainers in tid order
    per = {}
    for t, (ev,) , loss, bs in zip(hist_c.outer_step,
                                   [tuple(d.items())
                                    for d in hist_c.eval_loss_by_trainer],
                                   hist_c.loss, hist_c.requested_batches):
        per[t, ev[0]] = (ev[1], loss, bs[ev[0]])
    k = acfg.num_init_trainers
    for t in hist_l.outer_step:
        assert [per[t, i][0] for i in range(k)] == \
            [hist_l.eval_loss_by_trainer[t - 1][i] for i in range(k)]
        assert [per[t, i][2] for i in range(k)] == \
            hist_l.requested_batches[t - 1]
        assert sum([per[t, i][1] for i in range(k)]) / k == \
            hist_l.loss[t - 1]
    outer = sorted((e["step"], e["bytes"]) for e in pool_c.comms.log
                   if e["kind"] in ("outer", "consolidate"))
    assert outer == sorted((e["step"], e["bytes"])
                           for e in pool_l.comms.log)
    assert rep.sim_time > 0 and rep.num_stats_syncs == \
        sum(rep.rounds.values())


def test_dead_trainers_release_their_tensors():
    """Merged-away and leaving trainers keep no worker or optimizer
    tensors; the in-flight ones of the live pool are released at
    arrival."""
    from repro_torch.cluster import runtime
    seen = {}
    orig = runtime._Sim.on_comm_done

    def spy(self, now, ev):
        orig(self, now, ev)
        seen["sim"] = self
        if ev.get("handle") is None and "snapshot" not in ev:
            seen["freed"] = seen.get("freed", 0) + 1
    runtime._Sim.on_comm_done = spy
    try:
        pool, _, rep = _policy_run("port", "elastic")
    finally:
        runtime._Sim.on_comm_done = orig
    sim = seen["sim"]
    dead = [rt for rt in sim.rts.values() if not rt.alive]
    assert dead and seen["freed"] > 0
    for rt in dead:
        assert rt.worker_params is None and rt.pending is None
        assert rt.tr.inner_opt_states == []
    assert {t.tid for t in pool.trainers} == \
        {rt.tr.tid for rt in sim.rts.values() if rt.alive}
    # one wall time per round computed (preempted rounds included)
    assert len(rep.round_wall_s) >= sum(rep.rounds.values())
    assert all(w > 0.0 for w in rep.round_wall_s)
