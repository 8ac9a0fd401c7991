"""The port's multi-process backend (``repro_torch.cluster.backend.
TorchProcessBackend``) and launcher (``repro_torch.cluster.launch_mp``),
the counterparts of ``tests/test_backend.py``'s, on the CPU.

- In-process: one process (no initialized group) makes every collective
  the identity, so a run must equal ``SimBackend`` bit for bit while
  going through the flat f32 wire buffer; the validation messages.
- ``mp``: real gloo process groups between spawned interpreters (two,
  and four for k = 2 with merges), held to the port's ``SimBackend``
  and ``train_adloco`` within ``PARITY_ATOL``.
- Against the JAX package: the launcher fixture's priced clock equals
  ``repro.cluster.launch_mp.run_sim``'s (it does not depend on the
  inits), and the adaptive arm equals ``repro.cluster.run_cluster`` on
  the port fixture's numpy inits.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as J
from repro.cluster import launch_mp as j_launch
from repro_torch.cluster import (ClusterEvent, Trace, TorchProcessBackend,
                                 make_heterogeneous_profiles, run_cluster,
                                 validate_perfetto)
from repro_torch.cluster import launch_mp
from repro_torch.cluster.autoscale import BandAutoscale
from repro_torch.cluster.launch_mp import run_mp, run_sim
from repro_torch.core import train_adloco
from repro_torch.examples.common import quad_init, quad_loss
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOY = launch_mp.TOY
CPU = {"device": "cpu"}

#: parity tolerance for the real backend: a chain of grouped means may
#: re-associate the mean, so f32 tolerance, not bitwise (the 2-process
#: runs come out bit-identical: one sum of two values, then /2)
PARITY_ATOL = 1e-6


def _x(pool):
    return np.asarray(pool.global_params["x"].double())


def _in_process(rounds, **kw):
    acfg, inits, streams, profiles, network = launch_mp.fixture(
        1, rounds=rounds, device="cpu", **kw)
    return run_cluster(
        quad_loss, inits, streams, acfg, policy="sync", profiles=profiles,
        backend=TorchProcessBackend(network, device="cpu"),
        fixed_batch=None if acfg.adaptive else 4, device="cpu")


# ------------------------------------------------------- in-process

def test_torch_backend_single_process_matches_sim_bitwise():
    """With one process every collective is the identity: the run must
    match the SimBackend bit for bit through the f32 wire buffer."""
    pool, hist, rep = _in_process(3)
    ref = run_sim(1, rounds=3, **CPU)
    np.testing.assert_array_equal(_x(pool), np.asarray(ref["x"]))
    assert rep.sim_time == ref["sim_time"]
    assert rep.num_syncs == ref["num_syncs"]
    # measured wire time is recorded per event and in aggregate
    assert rep.real_comm_time > 0.0
    outer = [e for e in pool.comms.log if e["kind"] == "outer"]
    assert outer and all("real_s" in e for e in outer)
    assert pool.comms.total_real_time == pytest.approx(rep.real_comm_time)


def test_torch_backend_single_process_predicted_matches_sim_bitwise():
    """k_correct > 1 on one process: the predictor is local float
    arithmetic, so the trajectory equals the SimBackend's."""
    pool, hist, rep = _in_process(6, adaptive=True, k_correct=3)
    ref = run_sim(1, rounds=6, adaptive=True, k_correct=3, **CPU)
    np.testing.assert_array_equal(_x(pool), np.asarray(ref["x"]))
    assert hist.requested_batches == ref["batches"]
    assert hist.modes == ref["modes"]
    # corrections at rounds 1 and 4; the other four rounds predicted
    assert rep.num_stats_syncs == ref["num_stats_syncs"] == 2
    assert rep.num_predicted_rounds == 4


def test_torch_backend_single_process_adaptive_matches_sim_bitwise():
    """Adaptive + switch on one process: the stats reducer is None (all
    workers local), so the in-process estimator path is shared."""
    pool, hist, rep = _in_process(4, adaptive=True)
    ref = run_sim(1, rounds=4, adaptive=True, **CPU)
    np.testing.assert_array_equal(_x(pool), np.asarray(ref["x"]))
    assert rep.sim_time == ref["sim_time"]
    assert hist.requested_batches == ref["batches"]
    assert hist.modes == ref["modes"]
    assert rep.num_stats_syncs == ref["num_stats_syncs"] > 0


def test_torch_backend_validates_unsupported_configs():
    acfg, inits, streams, profiles, network = launch_mp.fixture(
        1, rounds=2, **CPU)
    many = make_heterogeneous_profiles(4, **TOY)

    def go(acfg=acfg, inits=inits, streams=streams, profiles=profiles,
           **kw):
        return run_cluster(quad_loss, inits, streams, acfg,
                           profiles=profiles,
                           backend=TorchProcessBackend(network, **CPU),
                           fixed_batch=4, device="cpu", **kw)

    with pytest.raises(ValueError, match="sync/async"):
        go(policy="elastic")
    with pytest.raises(ValueError, match="one worker per process"):
        go(acfg=dataclasses.replace(acfg, nodes_per_gpu=2),
           streams=streams * 2, profiles=many)
    with pytest.raises(ValueError, match="k=2"):
        go(inits=inits * 2, streams=streams * 2, profiles=many,
           acfg=dataclasses.replace(acfg, num_init_trainers=2))
    with pytest.raises(ValueError, match="elastic in-process pool"):
        go(scenario=[ClusterEvent(time=0.0, kind="join")])

    # k=2 with merging validates when the process count matches k x M...
    backend = TorchProcessBackend(network, **CPU)
    backend.num_processes = 2
    merged = dataclasses.replace(acfg, enable_merge=True,
                                 num_init_trainers=2)
    backend.validate(merged, policy="sync", k=2, M=1)
    # ...but adaptive batching reduces stats over every process
    with pytest.raises(ValueError, match="trainer group"):
        backend.validate(dataclasses.replace(merged, adaptive=True),
                         policy="sync", k=2, M=1)


def test_torch_backend_adaptive_validation():
    """Across processes only the composable microbatch estimator."""
    acfg, _, _, _, network = launch_mp.fixture(1, rounds=2, **CPU)
    backend = TorchProcessBackend(network, **CPU)
    backend.num_processes = 2
    bad = dataclasses.replace(acfg, adaptive=True,
                              stats_estimator="per_sample")
    with pytest.raises(ValueError, match="microbatch"):
        backend.validate(bad, policy="sync", k=1, M=2)
    ok = dataclasses.replace(acfg, adaptive=True,
                             stats_estimator="microbatch")
    backend.validate(ok, policy="sync", k=1, M=2)
    # single process: every worker is local, both estimators fine
    backend.num_processes = 1
    backend.validate(bad, policy="sync", k=1, M=1)


def test_torch_backend_rejects_autoscale():
    acfg, _, _, _, network = launch_mp.fixture(1, rounds=2, **CPU)
    backend = TorchProcessBackend(network, **CPU)
    with pytest.raises(ValueError, match="cannot grow or shrink"):
        backend.validate(acfg, policy="sync", k=1, M=1,
                         autoscale=BandAutoscale())
    backend.validate(acfg, policy="sync", k=1, M=1)  # None: accepted


def test_torch_backend_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchProcessBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_mp.fixture(2, rounds=1)


@pytest.mark.parametrize("procs,kw,ranks", [
    (2, {}, [0, 1]),
    # one node per pod: the pods are the only level of size > 1
    (2, {"pods": True}, [[0], [1]]),
    # 2 pods x 2 nodes, interleaved: rank r sits in pod r % 2
    (4, {"pods": True}, [[0, 2], [1, 3]]),
    # k = 2 trainers of 2: a leading trainer level
    (4, {"k": 2, "merge": True}, [[0, 1], [2, 3]]),
])
def test_group_layout_follows_the_jax_mesh(procs, kw, ranks):
    """The ranks laid out as ``JaxProcessBackend._build_mesh`` lays its
    devices: participant tree for the levels, the trainer level first."""
    acfg, _, _, profiles, network = launch_mp.fixture(
        procs, rounds=1, **CPU, **kw)
    backend = TorchProcessBackend(network, **CPU)
    backend.num_processes = procs
    backend.bind(profiles)
    backend.validate(acfg, policy="sync", k=acfg.num_init_trainers,
                     M=acfg.nodes_per_gpu)
    got, lead = backend._layout()
    assert got.tolist() == ranks
    assert lead == (1 if acfg.num_init_trainers > 1 else 0)


# ------------------------------------------ real multi-process runs

@pytest.mark.mp
def test_two_process_sync_run_matches_sim_and_host_loop():
    """A 2-process sync run over gloo lands on the SimBackend's params
    and on the host loop ``train_adloco``'s."""
    res = run_mp(2, rounds=6, policy="sync", **CPU)
    assert res["num_syncs"] == 6 and res["real_comm_time"] > 0.0
    assert res["backend"] == "torch"
    ref = run_sim(2, rounds=6, policy="sync", **CPU)
    np.testing.assert_allclose(res["x"], ref["x"], rtol=0, atol=PARITY_ATOL)
    assert res["sim_time"] == ref["sim_time"]

    acfg, inits, streams, _, _ = launch_mp.fixture(2, rounds=6, **CPU)
    pool, _ = train_adloco(quad_loss, inits, streams, acfg, fixed_batch=4,
                           device="cpu")
    np.testing.assert_allclose(res["x"], _x(pool), rtol=0, atol=PARITY_ATOL)


@pytest.mark.mp
def test_two_process_async_run_matches_sim():
    res = run_mp(2, rounds=5, policy="async", **CPU)
    ref = run_sim(2, rounds=5, policy="async", **CPU)
    np.testing.assert_allclose(res["x"], ref["x"], rtol=0, atol=PARITY_ATOL)
    assert res["sim_time"] == ref["sim_time"]
    assert res["num_syncs"] == ref["num_syncs"]


@pytest.mark.mp
def test_two_process_hierarchical_groups_match_sim():
    res = run_mp(2, rounds=4, policy="sync", pods=True, **CPU)
    ref = run_sim(2, rounds=4, policy="sync", pods=True, **CPU)
    np.testing.assert_allclose(res["x"], ref["x"], rtol=0, atol=PARITY_ATOL)
    assert res["sim_time"] == ref["sim_time"]


@pytest.mark.mp
def test_two_process_adaptive_switch_run_agrees():
    """Batch stats composed by a real all-reduce each round: every rank
    on the identical plan sequence (the worker exits 4 otherwise) and
    on the SimBackend's trajectory and params."""
    res = run_mp(2, rounds=6, policy="sync", adaptive=True, **CPU)
    ref = run_sim(2, rounds=6, policy="sync", adaptive=True, **CPU)
    assert res["batches"] == ref["batches"]
    assert res["modes"] == ref["modes"]
    assert res["num_stats_syncs"] == ref["num_stats_syncs"] > 0
    # this fixture's trajectory ramps (36 -> 64) and switch mode engages
    firsts = [b[0] for b in res["batches"]]
    assert firsts[-1] > firsts[0]
    assert any(m == "accum" for ms in res["modes"] for m in ms)
    np.testing.assert_allclose(res["x"], ref["x"], rtol=0, atol=PARITY_ATOL)
    assert res["sim_time"] == ref["sim_time"]
    assert res["real_comm_time"] > 0.0


@pytest.mark.mp
def test_four_process_two_trainer_merge_matches_sim():
    """k = 2 groups of 2 ranks: grouped outer syncs, the merge one SUM
    over every rank; params, merge trajectory and clock as the sim's."""
    res = run_mp(4, rounds=6, policy="sync", k=2, merge=True, **CPU)
    ref = run_sim(4, rounds=6, policy="sync", k=2, merge=True, **CPU)
    assert res["merge_events"] == ref["merge_events"]
    assert any(e["kind"] == "merge" for e in res["merge_events"])
    np.testing.assert_allclose(res["x"], ref["x"], rtol=0, atol=PARITY_ATOL)
    assert res["sim_time"] == ref["sim_time"]
    assert res["num_syncs"] == ref["num_syncs"]
    assert res["real_comm_time"] > 0.0


@pytest.mark.mp
def test_two_process_trace_digest_matches_sim(tmp_path):
    """The sim spans of a traced 2-process async adaptive run equal the
    SimBackend's digest; the wall clock holds one in-flight window per
    dispatched outer collective ("piggyback" with the stats vector),
    no standalone "stats" span (phase 2 is reduced inside the window),
    and measured compute that the windows overlap."""
    out = tmp_path / "mp.perfetto.json"
    res = run_mp(2, rounds=4, policy="async", adaptive=True,
                 trace=str(out), **CPU)
    ref = run_sim(2, rounds=4, policy="async", adaptive=True, trace=True,
                  **CPU)
    assert res["trace_digest"] == ref["trace_digest"]
    assert res["overlap_frac"] == ref["overlap_frac"] > 0.0
    assert res["utilization"] == ref["utilization"]
    assert res["real_span_time"] > 0.0
    assert res["real_overlap_frac"] > 0.0
    data = json.loads(out.read_text())
    assert validate_perfetto(data) == []
    tr = Trace.from_perfetto(data)
    assert tr.sim_digest() == ref["trace_digest"]
    reals = tr.real_spans()
    assert len(reals) == res["num_real_spans"]
    kinds = {}
    for s in reals:
        kinds[s.kind] = kinds.get(s.kind, 0) + 1
    assert (kinds.get("outer", 0) + kinds.get("piggyback", 0)
            == res["num_syncs"])
    assert kinds.get("piggyback", 0) == res["num_stats_syncs"] > 0
    assert kinds.get("stats", 0) == 0
    assert kinds.get("compute", 0) > 0
    assert all(s.duration > 0.0 for s in reals)


# ------------------------------------------------- the JAX package

@pytest.mark.parametrize("procs,kw", [
    (2, {"rounds": 6}),
    (2, {"rounds": 5, "policy": "async"}),
    (2, {"rounds": 4, "pods": True}),
    (4, {"rounds": 6, "k": 2, "merge": True}),
])
def test_fixed_batch_clock_matches_jax_launcher(procs, kw):
    """The priced clock of a fixed-batch run does not depend on the
    inits: the port's ``run_sim`` equals the JAX package's."""
    jres = j_launch.run_sim(procs, **kw)
    tres = run_sim(procs, **kw, **CPU)
    for key in ("sim_time", "num_syncs", "comm_time", "merge_events"):
        assert tres[key] == jres[key], key


def test_adaptive_arm_matches_jax_on_the_port_inits():
    """The JAX package's ``run_cluster`` on the port fixture's numpy
    inits takes the port's batch/plan trajectory, clock and params."""
    acfg, _, streams, profiles, network = j_launch.fixture(
        2, rounds=6, adaptive=True)
    inits = [{"x": jnp.asarray(quad_init(launch_mp.DIM, 0, 0))}]
    pool, hist, rep = J.run_cluster(
        j_launch.quad_loss, inits, streams, acfg, policy="sync",
        profiles=profiles, backend=J.SimBackend(network))
    ref = run_sim(2, rounds=6, adaptive=True, **CPU)
    assert hist.requested_batches == ref["batches"]
    assert hist.modes == ref["modes"]
    assert rep.sim_time == ref["sim_time"]
    np.testing.assert_allclose(np.asarray(pool.global_params["x"]),
                               ref["x"], rtol=0, atol=1e-6)
