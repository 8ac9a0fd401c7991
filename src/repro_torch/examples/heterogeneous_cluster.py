"""Tour of the virtual-cluster runtime: AdLoCo on simulated
heterogeneous hardware with stragglers, a trainer leaving, a fresh one
joining, a 2-pod topology whose cross-pod bottleneck gets congested,
and a 3-level rack/pod/cluster fabric where a whole pod fails at once —
comparing sync vs async outer-sync policies on the simulated clock,
then tracing a run to see *where* the time goes (per-trainer
busy/blocked/idle ledger, overlap fraction, Perfetto export).  Port of
``examples/heterogeneous_cluster.py``; the numerics run on the card
(``--device cpu`` on the CPU).

  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_cluster
  # then load build/examples/trace.json in https://ui.perfetto.dev
"""
import dataclasses
import json
import os

from repro_torch.cluster import (ClusterEvent, Topology, Trace,
                                 interleave_pods,
                                 make_heterogeneous_profiles,
                                 make_pod_profiles, make_rack_profiles,
                                 run_cluster)
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.examples.common import (QuadStream, example_args,
                                         quad_loss, quad_setup)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "..", "build", "examples")

# toy-scale hardware so the 16-dim proxy's compute and its 64-byte
# all-reduces both land in the millisecond range (see cluster_bench)
TOY = dict(flops=1e6, hbm_bw=1e9, link_bw=2e5, link_latency=2e-3)

ACFG = AdLoCoConfig(
    num_outer_steps=16, num_inner_steps=5, lr_inner=0.05, lr_outer=0.7,
    outer_momentum=0.5, num_init_trainers=3, nodes_per_gpu=2,
    initial_batch_size=2, merge_frequency=3, eta=0.8, max_batch=16,
    inner_optimizer="sgd", stats_probe_size=32, enable_merge=False,
    stats_use_kernel=True)


def timeline(hist, width: int = 56):
    """eval loss vs simulated time, one row per sync arrival (thinned)."""
    if not hist.eval_loss:
        return
    lo = min(hist.eval_loss)
    hi = max(hist.eval_loss)
    step = max(len(hist.eval_loss) // 12, 1)
    for i in range(0, len(hist.eval_loss), step):
        v, s = hist.eval_loss[i], hist.sim_time[i]
        bar = int((v - lo) / max(hi - lo, 1e-9) * (width - 1))
        print(f"    {s * 1e3:9.2f}ms |{'#' * (bar + 1):<{width}}| "
              f"E[f]={v:.3f}")


def main(argv=None):
    dev = example_args(__doc__, argv).device
    print("=== 1. heterogeneous nodes: 6 nodes, fastest 4x the slowest")
    profiles = make_heterogeneous_profiles(6, ratio=4.0, jitter=0.1, **TOY)
    for p in profiles:
        print(f"    {p.name}: {p.flops / 1e6:.2f} MFLOP/s, "
              f"link {p.link_bw / 1e3:.0f} KB/s")

    results = {}
    for policy in ("sync", "async"):
        prob, inits, streams, eval_fn = quad_setup(k=3, M=2, seed=0,
                                                   device=dev)
        pool, hist, rep = run_cluster(
            quad_loss, inits, streams, ACFG, policy=policy,
            profiles=profiles, eval_fn=eval_fn, device=dev)
        results[policy] = (hist, rep, eval_fn(pool.global_params))

    print("\n=== 2. sync policy (barrier on every outer all-reduce)")
    hist, rep, final = results["sync"]
    timeline(hist)
    print(f"    total {rep.sim_time * 1e3:.1f}ms simulated "
          f"({rep.comm_time * 1e3:.1f}ms in collectives), "
          f"final E[f]={final:.4f}")

    print("\n=== 3. async policy (ACCO-style: accumulate while the "
          "all-reduce flies)")
    hist, rep, final = results["async"]
    timeline(hist)
    print(f"    total {rep.sim_time * 1e3:.1f}ms simulated "
          f"({rep.comm_time * 1e3:.1f}ms in collectives, hidden behind "
          f"compute), final E[f]={final:.4f}")
    sync_t = results["sync"][1].sim_time
    print(f"    speedup over sync: {sync_t / rep.sim_time:.2f}x at equal "
          f"outer steps")

    print("\n=== 4. elastic: straggler burst, one trainer leaves, a "
          "fresh one joins")
    prob, inits, streams, eval_fn = quad_setup(k=3, M=2, seed=0,
                                               device=dev)
    streams += [QuadStream(prob, 100 + i) for i in range(2)]  # spare shards
    profiles8 = make_heterogeneous_profiles(8, ratio=2.0, **TOY)
    scen = [ClusterEvent(time=0.01, kind="slowdown", node=5, factor=4.0,
                         duration=0.2),
            ClusterEvent(time=0.05, kind="leave"),
            ClusterEvent(time=0.15, kind="join")]
    acfg = dataclasses.replace(ACFG, enable_merge=True)
    pool, hist, rep = run_cluster(
        quad_loss, inits, streams, acfg, policy="elastic",
        profiles=profiles8, eval_fn=eval_fn, scenario=scen, device=dev)
    for e in rep.applied_events:
        print(f"    t={e['time'] * 1e3:8.2f}ms  {e['kind']:9s} "
              f"{ {k: v for k, v in e.items() if k not in ('time', 'kind')} }")
    print(f"    final pool k={pool.k}, E[f]={eval_fn(pool.global_params):.4f} "
          f"after {rep.sim_time * 1e3:.1f}ms simulated")

    print("\n=== 5. topology: 2 pods, every trainer spanning the "
          "cross-pod bottleneck,\n       with bursty congestion windows "
          "on the inter-pod links")
    profiles = make_pod_profiles([3, 3], ratio=2.0, **TOY)
    # interleave so each trainer's M=2 workers sit in different pods:
    # every outer all-reduce is a per-pod reduce + cross-pod exchange
    interleaved = interleave_pods(profiles)
    topo = Topology.from_profiles(profiles, inter_bw=1e5,
                                  inter_latency=4e-3)
    for pi, pod in enumerate(topo.pods):
        print(f"    pod{pi}: {', '.join(pod)}")
    for policy in ("sync", "async"):
        prob, inits, streams, eval_fn = quad_setup(k=3, M=2, seed=0,
                                                   device=dev)
        pool, hist, rep = run_cluster(
            quad_loss, inits, streams, ACFG, policy=policy,
            profiles=interleaved, network=topo, eval_fn=eval_fn,
            scenario="bursty_congestion",   # registered scenario, by name
            device=dev)
        n_win = sum(1 for e in rep.applied_events if e["kind"] == "fabric")
        print(f"    {policy:5s}: {rep.sim_time * 1e3:6.1f}ms simulated "
              f"({rep.comm_time * 1e3:6.1f}ms in collectives, {n_win} "
              f"congestion windows re-priced in flight), "
              f"E[f]={eval_fn(pool.global_params):.4f}")

    print("\n=== 6. three levels: 2 pods x 2 racks x 2 nodes, and a "
          "correlated pod\n       failure (the pod's nodes slow down AND "
          "the pod uplinks degrade together)")
    profiles = make_rack_profiles([[2, 2], [2, 2]], ratio=2.0, **TOY)
    interleaved = interleave_pods(profiles)
    topo = Topology.from_profiles(profiles, inter_bw=1e5,
                                  inter_latency=4e-3, pod_bw=1.5e5,
                                  pod_latency=3e-3)
    print(f"    domains: {', '.join(topo.domain_names())}")
    for policy in ("sync", "async"):
        prob, inits, streams, eval_fn = quad_setup(k=3, M=2, seed=0,
                                                   device=dev)
        pool, hist, rep = run_cluster(
            quad_loss, inits, streams, ACFG, policy=policy,
            profiles=interleaved, network=topo, eval_fn=eval_fn,
            scenario="correlated_pod_failure", device=dev)
        kinds = [e["kind"] for e in rep.applied_events]
        print(f"    {policy:5s}: {rep.sim_time * 1e3:6.1f}ms simulated "
              f"({rep.comm_time * 1e3:6.1f}ms in collectives), "
              f"events={'+'.join(kinds)}, "
              f"E[f]={eval_fn(pool.global_params):.4f}")

    print("\n=== 7. tracing: where does the async run's time actually "
          "go?")
    # re-run the 2-pod congested sweep with a trace attached: the event
    # loop records one span per compute block / collective / stats
    # reduction, and the ledger partitions every trainer's lifetime
    profiles = make_pod_profiles([3, 3], ratio=2.0, **TOY)
    interleaved = interleave_pods(profiles)
    topo = Topology.from_profiles(profiles, inter_bw=1e5,
                                  inter_latency=4e-3)
    prob, inits, streams, eval_fn = quad_setup(k=3, M=2, seed=0,
                                               device=dev)
    tr = Trace()
    pool, hist, rep = run_cluster(
        quad_loss, inits, streams, ACFG, policy="async",
        profiles=interleaved, network=topo, eval_fn=eval_fn,
        scenario="bursty_congestion", trace=tr, device=dev)
    print("    tid   alive      busy         blocked      idle")
    for tid, led in tr.utilization().items():
        print(f"    {tid:3d} {led['alive'] * 1e3:6.1f}ms "
              + " ".join(f"{led[k] * 1e3:6.1f}ms "
                         f"({led[k] / led['alive']:4.0%})"
                         for k in ("busy", "blocked", "idle")))
    summ = tr.utilization_summary()
    print(f"    fleet utilization={summ['utilization']:.3f} "
          f"(blocked={summ['blocked_frac']:.3f}, "
          f"idle={summ['idle_frac']:.3f})")
    print(f"    overlap fraction={tr.overlap_fraction():.3f} — the share "
          f"of collective\n    in-flight time hidden behind compute "
          f"(sync would score exactly 0)")
    os.makedirs(OUT, exist_ok=True)
    out = os.path.normpath(os.path.join(OUT, "trace.json"))
    with open(out, "w") as f:
        json.dump(tr.to_perfetto(), f)
    print(f"    wrote {out} — load it in https://ui.perfetto.dev, or:\n"
          f"      PYTHONPATH=src python -m repro_torch.cluster.trace_report "
          f"{os.path.relpath(out)}")


if __name__ == "__main__":
    main()
