"""The port's span trace (``repro_torch.cluster.trace``) against the JAX
package's.

- The sim-span digests of ``adaptive_ramp`` and
  ``correlated_pod_failure`` (``tests/test_trace.py``'s harnesses)
  equal a live JAX run's; the adaptive arm keeps
  ``tests/test_torch_adloco.py``'s excuse rule for a decision at an
  integer ratio (printed), and is then compared only before it.
- The port's Perfetto export passes both packages' ``validate_perfetto``
  and rebuilds digest-identically in both; the JAX package's committed
  export (``tests/goldens/adaptive_ramp.perfetto.json``, read only)
  loads in the port.
- The utilization ledger, the overlap fractions and the interval
  helpers equal the JAX package's on the same inputs (hypothesis).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.cluster.trace as jtrace
import repro_torch.cluster as P
import repro_torch.cluster.trace as ptrace
from repro_torch.cluster import trace_report
from test_torch_adloco import _first_excused_divergence  # noqa: F401
from test_torch_adloco import decisions  # noqa: F401
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)
from test_torch_scenarios import (ACFG, PKG, TOY, record_marks,  # noqa: F401
                                  records_before, run, setup)

GOLDEN_EXPORT = (pathlib.Path(__file__).parent / "goldens"
                 / "adaptive_ramp.perfetto.json")


def traced(pkg, name):
    C = PKG[pkg][0]
    tr = C.Trace()
    out = run(pkg, name, trace=tr)
    return tr, out


def _values(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _values(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _values(v)
    else:
        yield obj


@pytest.mark.parametrize("name", ["adaptive_ramp", "correlated_pod_failure"])
def test_trace_digest_matches_live_jax(name, decisions, record_marks):
    jtr, (_, jh, _) = traced("jax", name)
    ttr, (_, th, _) = traced("port", name)
    # payloads hold plain Python numbers: a tensor would change the text
    # the digest hashes
    for v in _values(ttr._sim_schema()):
        assert v is None or type(v) in (int, float, str, bool), type(v)
    i = (_first_excused_divergence(decisions) if name == "adaptive_ramp"
         else None)
    if i is None:
        assert ttr._sim_schema() == jtr._sim_schema()
        assert ttr.sim_digest() == jtr.sim_digest()
        return
    n = records_before(record_marks["port"], i)
    assert th.sim_time[:n] == jh.sim_time[:n]
    t_end = th.sim_time[n - 1] if n else 0.0
    early = [[s.tid, s.kind, s.t0, s.t1] for s in ttr.sim_spans()
             if s.t1 <= t_end]
    assert early == [[s.tid, s.kind, s.t0, s.t1] for s in jtr.sim_spans()
                     if s.t1 <= t_end]


@pytest.mark.parametrize("name", ["adaptive_ramp", "correlated_pod_failure"])
def test_perfetto_export_validates_and_round_trips(name, tmp_path, capsys):
    tr, _ = traced("port", name)
    data = tr.to_perfetto()
    assert ptrace.validate_perfetto(data) == []
    assert jtrace.validate_perfetto(data) == []
    blob = json.loads(json.dumps(data))
    for Trace in (ptrace.Trace, jtrace.Trace):
        assert Trace.from_perfetto(blob).sim_digest() == tr.sim_digest()
    rebuilt = ptrace.Trace.from_perfetto(blob)
    assert json.loads(json.dumps(rebuilt.to_perfetto())) == blob
    # the CLI reads it
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(data))
    assert trace_report.main(["--validate", str(path)]) == 0
    assert "schema OK" in capsys.readouterr().out
    assert trace_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "overlap_frac=" in out and "utilization=" in out


def test_jax_export_loads_in_the_port(tmp_path):
    data = json.loads(GOLDEN_EXPORT.read_text())
    assert ptrace.validate_perfetto(data) == []
    assert ptrace.Trace.from_perfetto(data).sim_digest() == \
        jtrace.Trace.from_perfetto(data).sim_digest()
    assert trace_report.main(["--validate", str(GOLDEN_EXPORT)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": [{"ph": "X"}]}')
    assert trace_report.main(["--validate", str(bad)]) == 1


def test_schema_constants_match():
    for name in ("TRACE_SCHEMA", "SIM_SPAN_KINDS", "REAL_SPAN_KINDS",
                 "EVENT_KINDS", "COMM_KINDS", "FABRIC_TID"):
        assert getattr(ptrace, name) == getattr(jtrace, name), name


# ------------------------------------------------ ledger against JAX's

def _random_scenario(pkg, rng, n_nodes):
    """``tests/test_trace.py``'s fuzzed chaos: slowdowns, fabric
    windows, maybe a leave and a join."""
    Ev = PKG[pkg][0].ClusterEvent
    events = []
    for _ in range(rng.integers(0, 4)):
        events.append(Ev(time=float(rng.uniform(0.0, 0.2)), kind="slowdown",
                         node=int(rng.integers(0, n_nodes)),
                         factor=float(rng.uniform(1.5, 6.0)),
                         duration=float(rng.uniform(0.01, 0.2))))
    for _ in range(rng.integers(0, 3)):
        events.append(Ev(time=float(rng.uniform(0.0, 0.2)), kind="fabric",
                         bw_scale=float(rng.uniform(0.05, 0.8)),
                         extra_latency=float(rng.uniform(0.0, 0.01)),
                         duration=float(rng.uniform(0.02, 0.15))))
    if rng.random() < 0.5:
        events.append(Ev(time=float(rng.uniform(0.02, 0.1)), kind="leave"))
    if rng.random() < 0.5:
        events.append(Ev(time=float(rng.uniform(0.05, 0.2)), kind="join"))
    return sorted(events, key=lambda e: e.time)


def _chaos(pkg, seed):
    C, Cfg, loss, _, dev = PKG[pkg]
    rng = np.random.default_rng(seed)
    inits, streams = setup(pkg, 3, 4)
    profiles = C.make_heterogeneous_profiles(
        10, ratio=float(rng.uniform(1.0, 4.0)), **TOY)
    policy = str(rng.choice(["sync", "async", "elastic"]))
    tr = C.Trace()
    C.run_cluster(loss, inits, streams, Cfg(**dict(ACFG, num_outer_steps=6)),
                  policy=policy, profiles=profiles,
                  scenario=_random_scenario(pkg, rng, 10), fixed_batch=4,
                  trace=tr, **dev)
    return tr


@given(seed=st.integers(0, 2 ** 32 - 1))
@settings(max_examples=10, deadline=None)
def test_ledger_and_overlap_match_jax_under_chaos(seed):
    jtr, ttr = _chaos("jax", seed), _chaos("port", seed)
    assert ttr.sim_digest() == jtr.sim_digest()
    ledger = ttr.utilization()          # raises unless it partitions
    assert ledger == jtr.utilization()
    assert ttr.utilization_summary() == jtr.utilization_summary()
    assert ttr.overlap_fraction() == jtr.overlap_fraction()
    assert ttr.overlap_by_kind() == jtr.overlap_by_kind()


intervals = st.lists(st.tuples(st.floats(0, 10), st.floats(0, 10)),
                     max_size=8)


@given(a=intervals, b=intervals, lo=st.floats(0, 10), hi=st.floats(0, 10))
@settings(max_examples=100, deadline=None)
def test_interval_helpers_match_jax(a, b, lo, hi):
    ua, ub = ptrace._union(a), ptrace._union(b)
    assert ua == jtrace._union(a) and ub == jtrace._union(b)
    assert ptrace._clip(a, lo, hi) == jtrace._clip(a, lo, hi)
    assert ptrace._total(ua) == jtrace._total(ua)
    assert ptrace._subtract(ua, ub) == jtrace._subtract(ua, ub)
    for iv in a:
        assert ptrace._overlap_total(iv, ub) == jtrace._overlap_total(iv, ub)


# ------------------------------------------------------------ invariants

def _flat_run(policy, trace):
    inits, streams = setup("port", 3, 0)
    profiles = P.make_heterogeneous_profiles(6, ratio=2.0, **TOY)
    return P.run_cluster(PKG["port"][2], inits, streams,
                         PKG["port"][1](**ACFG), policy=policy,
                         profiles=profiles, fixed_batch=4, trace=trace,
                         device="cpu")


def test_sync_overlap_is_zero_async_positive():
    fracs = {}
    for policy in ("sync", "async"):
        tr = P.Trace()
        _flat_run(policy, tr)
        fracs[policy] = tr.overlap_fraction()
    assert fracs["sync"] == 0.0 and fracs["async"] > 0.0


def test_tracing_does_not_perturb_scheduling():
    reps = [_flat_run("async", trace)[2] for trace in (None, P.Trace())]
    assert reps[0].summary() == reps[1].summary()
    assert reps[0].applied_events == reps[1].applied_events
    assert reps[0].trace is None and reps[1].trace is not None


def test_extended_summary_is_opt_in_and_trace_true():
    _, _, rep = _flat_run("async", True)
    assert isinstance(rep.trace, P.Trace)
    default = rep.summary()
    assert set(default) == {"policy", "sim_time", "compute_time",
                            "comm_time", "num_syncs", "rounds"}
    ext = rep.summary(extended=True)
    assert {k: ext[k] for k in default} == default
    assert ext["overlap_frac"] == rep.trace.overlap_fraction()
    assert ext["real_comm_time"] == 0.0 == ext["real_overlap_frac"]
    assert ext["utilization"] + ext["blocked_frac"] + ext["idle_frac"] \
        == pytest.approx(1.0)


def test_xfer_reprice_annotation_matches_jax():
    """A join transfer crossing a window edge: the join record keeps its
    launch price, the re-price lands as an annotation and an extended
    ``xfer`` span — equal to the JAX package's."""
    out = {}
    for pkg in ("jax", "port"):
        C, Cfg, loss, _, dev = PKG[pkg]
        scen = (C.build_scenario("flash_crowd_join", start=0.02, joins=1)
                + [C.ClusterEvent(time=0.025, kind="fabric", bw_scale=1e-3,
                                  extra_latency=0.05, duration=0.0)])
        inits, streams = setup(pkg, 3, 2)
        profiles = C.make_heterogeneous_profiles(8, **dict(TOY, link_bw=6e3))
        tr = C.Trace()
        _, _, rep = C.run_cluster(
            loss, inits, streams, Cfg(**dict(ACFG, num_outer_steps=12)),
            policy="elastic", profiles=profiles, network=C.NetworkModel(),
            scenario=scen, fixed_batch=4, trace=tr, **dev)
        out[pkg] = (rep, tr)
    (jrep, jtr), (trep, ttr) = out["jax"], out["port"]
    assert trep.applied_events == jrep.applied_events
    rp = next(e for e in trep.applied_events if e["kind"] == "xfer_reprice")
    xfer = next(s for s in ttr.sim_spans(("xfer",)))
    assert xfer.t0 == 0.02 and xfer.t1 - xfer.t0 == pytest.approx(
        rp["xfer_s"], rel=1e-12)
    assert ttr.sim_digest() == jtr.sim_digest()


def test_span_records_match_jax_fields():
    """``Span`` / ``TraceEvent`` carry the JAX package's fields."""
    assert [f.name for f in dataclasses.fields(ptrace.Span)] == \
        [f.name for f in dataclasses.fields(jtrace.Span)]
    assert [f.name for f in dataclasses.fields(ptrace.TraceEvent)] == \
        [f.name for f in dataclasses.fields(jtrace.TraceEvent)]
