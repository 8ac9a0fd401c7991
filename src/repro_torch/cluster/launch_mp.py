"""Multi-process launcher: the cluster runtime on real ``torch.distributed``.
Port of ``repro/cluster/launch_mp.py``.

Spawns one OS process per worker on this host (fresh interpreters, never
a fork), joins them in one gloo process group (``tcp://127.0.0.1``; rank
0's results are the run's results), and drives the *same*
``run_cluster`` event loop as the simulator — with a
:class:`~repro_torch.cluster.backend.TorchProcessBackend`, so every outer
all-reduce executes as a real collective across processes instead of
being priced analytically.  Every process runs the identical
deterministic event loop (pricing is pure float arithmetic on replicated
state), computes only its own worker's inner steps, and meets the others
inside the collectives; rank 0 writes the report.  Tensors live on
``--device`` (``cuda`` unless named; raises without a card): with one
card every rank shares it, and gloo moves CUDA tensors through host
memory.

The canonical workload is the 16-dim quadratic of
``repro_torch.examples.common`` (one trainer, M = nprocs workers, fixed
batch), which is what makes the sim/real differential guarantee
checkable:

    # one sync outer round over 2 local CPU processes + parity check
    PYTHONPATH=src python -m repro_torch.cluster.launch_mp \\
        --procs 2 --rounds 1 --check --device cpu

    # async policy on a 2-pod topology (hierarchical process groups)
    PYTHONPATH=src python -m repro_torch.cluster.launch_mp \\
        --procs 2 --rounds 8 --policy async --pods --device cpu

``--check`` re-runs the identical fixture through the in-process
:class:`~repro_torch.cluster.backend.SimBackend` and asserts the final
parameters match to float tolerance — the contract
``tests/test_torch_backend.py`` pins.

``--adaptive`` switches the fixture to adaptive batching + switch mode
(``stats_estimator="microbatch"``): each rank contributes its worker's
microbatch-mean gradient to the batch-stats all-reduce, every rank
derives the identical requested-batch/plan sequence (divergence is a
hard failure, checked by all-gather), and ``--check`` pins the whole
trajectory — params, batch sizes, modes — against the SimBackend
reference::

    PYTHONPATH=src python -m repro_torch.cluster.launch_mp \\
        --procs 2 --rounds 6 --adaptive --check --device cpu

``--k-correct N`` (with ``--adaptive``) enables the PadaDamp-style
batch-growth predictor: between every N-th exact estimate the ranks
*predict* the next batch from the fitted growth curve instead of
running the batch-stats all-reduce.

Outer collectives are *dispatched* nonblocking (``dispatch_outer`` /
``wait_outer``): under ``--policy async`` the next round's inner steps
run while the reduction is in flight, and under ``--adaptive`` the
phase-1 batch-stats vector rides the same collective (piggybacking).
``--trace`` records the measured dispatch->ready windows alongside the
noted compute windows, and ``--check`` on async runs additionally gates
``real_overlap_frac > 0`` — wall-clock proof the overlap is real, not
simulated.

``--k N`` splits the processes into N trainer groups of ``procs // N``
workers each (MIT, paper §4.1): each trainer's outer sync is a grouped
collective over its own block of ranks, and ``--merge`` turns on merge
events — executed as real cross-group weighted sums — so the paper's
three-stage method runs end-to-end on real collectives.  ``--check``
then also pins the merge applied-events against the SimBackend
reference::

    PYTHONPATH=src python -m repro_torch.cluster.launch_mp \\
        --procs 4 --k 2 --rounds 6 --merge --check --device cpu

Scope: sync/async policies; multi-trainer pools are fixed-batch (the
stats reductions are global, not per-group — see
``TorchProcessBackend.validate``).  The per-sample probe estimator stays
rejected under multi-process adaptive runs (its probe is rank-local);
elastic pools (joins/leaves/autoscale) stay simulator-only.  Exit codes:
1 a parity failure under ``--check``, 3 parameters that diverge across
ranks, 4 a batch/plan trajectory that diverges across ranks.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

#: toy-scale hardware constants shared with the test fixtures so
#: compute and comm land in comparable (simulated) regimes
TOY = dict(flops=1e6, hbm_bw=1e9, link_bw=2e5, link_latency=2e-3)

DIM = 16


def fixture(procs: int, *, rounds: int, pods: bool = False, seed: int = 0,
            adaptive: bool = False, k_correct: int = 0, k: int = 1,
            merge: bool = False, device=None):
    """(acfg, inits, streams, profiles, network) for the canonical run:
    ``k`` trainers x ``procs // k`` workers (the default is the single
    trainer with M = ``procs`` workers, merging off), tensors on
    ``device``.  ``pods`` splits the workers across a 2-pod
    :class:`Topology` so the hierarchical group mapping is exercised;
    otherwise the fabric is the flat :class:`NetworkModel`.
    ``adaptive`` swaps the fixed batch for adaptive batching + switch
    mode with the composable microbatch estimator; ``k_correct > 1``
    additionally turns on predicted batch growth between exact
    estimates.  ``merge`` enables MIT merge events (every 3rd round,
    ``merge_w + 1 = 2`` smallest-batch trainers fold into their
    representative).  The inits are numpy draws from ``seed``
    (``examples.common.quad_init``)."""
    import dataclasses

    import torch

    from repro_torch import resolve_device
    from repro_torch.cluster.network import NetworkModel, Topology
    from repro_torch.cluster.node import (interleave_pods,
                                          make_heterogeneous_profiles,
                                          make_pod_profiles)
    from repro_torch.configs.base import AdLoCoConfig
    from repro_torch.data import QuadraticProblem
    from repro_torch.examples.common import QuadStream, quad_init

    if procs % k != 0:
        raise ValueError(f"--k {k} must divide --procs {procs}")
    dev = resolve_device(device)
    M = procs // k
    acfg = AdLoCoConfig(num_outer_steps=rounds, num_inner_steps=5,
                        lr_inner=0.05, lr_outer=0.7, outer_momentum=0.5,
                        nodes_per_gpu=M, num_init_trainers=k,
                        initial_batch_size=4, merge_frequency=3, eta=0.8,
                        max_batch=16, inner_optimizer="sgd",
                        stats_probe_size=32, enable_merge=merge,
                        adaptive=False)
    if adaptive:
        acfg = dataclasses.replace(
            acfg, adaptive=True, stats_estimator="microbatch",
            eta=0.25, max_batch=8, switch_multiplier=2,
            max_global_batch=64, k_correct=max(1, k_correct))
    prob = QuadraticProblem(dim=DIM, noise=2.0, seed=seed, device=dev)
    inits = [{"x": torch.from_numpy(quad_init(DIM, seed, i)).to(dev)}
             for i in range(k)]
    streams = [QuadStream(prob, i, seed=seed) for i in range(procs)]
    if pods and procs >= 2:
        profiles = make_pod_profiles(
            [procs - procs // 2, procs // 2], ratio=2.0, **TOY)
        profiles = interleave_pods(profiles)
        network = Topology.from_profiles(profiles, inter_bw=1e5,
                                         inter_latency=4e-3)
    else:
        profiles = make_heterogeneous_profiles(procs, ratio=2.0, **TOY)
        network = NetworkModel()
    return acfg, inits, streams, profiles, network


def merge_events_of(rep) -> List[dict]:
    """The merge-related applied events (executed and skipped) — the
    MIT trajectory the parity check pins across backends."""
    return [e for e in rep.applied_events
            if e.get("kind") in ("merge", "merge_skipped")]


def _x(pool) -> list:
    return pool.global_params["x"].detach().cpu().double().tolist()


def run_sim(procs: int, *, rounds: int, policy: str = "sync",
            pods: bool = False, seed: int = 0, adaptive: bool = False,
            k_correct: int = 0, k: int = 1, merge: bool = False,
            trace: bool = False, device=None):
    """The same fixture through the in-process SimBackend — the
    reference arm of the parity check.  ``trace`` records the span
    trace and adds its backend-invariant ``trace_digest`` (the
    sim-span digest the real run must reproduce)."""
    from repro_torch.cluster.backend import SimBackend
    from repro_torch.cluster.runtime import run_cluster
    from repro_torch.examples.common import quad_loss

    acfg, inits, streams, profiles, network = fixture(
        procs, rounds=rounds, pods=pods, seed=seed, adaptive=adaptive,
        k_correct=k_correct, k=k, merge=merge, device=device)
    pool, hist, rep = run_cluster(
        quad_loss, inits, streams, acfg, policy=policy, profiles=profiles,
        backend=SimBackend(network), trace=trace or None,
        fixed_batch=None if adaptive else 4, device=device)
    res = {"x": _x(pool),
           "sim_time": rep.sim_time, "comm_time": rep.comm_time,
           "num_syncs": rep.num_syncs,
           "num_stats_syncs": rep.num_stats_syncs,
           "batches": hist.requested_batches, "modes": hist.modes,
           "merge_events": merge_events_of(rep),
           "policy": policy, "procs": procs, "k": k,
           "merge": bool(merge), "backend": "sim"}
    if rep.trace is not None:
        res["trace_digest"] = rep.trace.sim_digest()
        res["overlap_frac"] = rep.trace.overlap_fraction()
        res["utilization"] = rep.trace.utilization_summary()["utilization"]
    return res


# --------------------------------------------------------------- worker

def worker_device(device: str, rank: int):
    """The rank's device: ``cuda`` names card ``rank % count`` (every
    rank shares a lone card); any other name is taken as it is."""
    import torch

    from repro_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_group(init_method: str, rank: int, procs: int,
               timeout: float) -> None:
    """Join the gloo group of ``procs`` ranks at ``init_method``; a
    collective that waits longer than ``timeout`` seconds raises."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=procs,
        timeout=datetime.timedelta(seconds=timeout))


def allgather_rows(values) -> np.ndarray:
    """Every rank's f64 row (same length everywhere), stacked."""
    import torch
    import torch.distributed as dist

    row = torch.as_tensor(np.asarray(values, np.float64).reshape(-1))
    got = [torch.zeros_like(row) for _ in range(dist.get_world_size())]
    dist.all_gather(got, row)
    return torch.stack(got).numpy()


def worker_main(args) -> int:
    import torch.distributed as dist

    from repro_torch.cluster.backend import TorchProcessBackend
    from repro_torch.cluster.runtime import run_cluster
    from repro_torch.examples.common import quad_loss

    init_group(args.coordinator, args.rank, args.procs, args.timeout)
    dev = worker_device(args.device, args.rank)
    acfg, inits, streams, profiles, network = fixture(
        args.procs, rounds=args.rounds, pods=args.pods, seed=args.seed,
        adaptive=args.adaptive, k_correct=args.k_correct, k=args.k,
        merge=args.merge, device=dev)
    backend = TorchProcessBackend(network, device=dev)
    # every rank builds the same seeded inits; the broadcast makes the
    # coordinator's copies authoritative (and exercises the transfer
    # path) — one broadcast per trainer, lockstep on every rank
    inits = [backend.broadcast_params(p) for p in inits]

    # every rank records (the event loop is lockstep, so the sim spans
    # are identical everywhere); only rank 0 exports
    record = bool(args.trace) or args.record_trace

    t0 = time.perf_counter()
    pool, hist, rep = run_cluster(
        quad_loss, inits, streams, acfg, policy=args.policy,
        profiles=profiles, backend=backend, trace=record or None,
        fixed_batch=None if args.adaptive else 4, device=dev)
    wall = time.perf_counter() - t0

    # the collectives must have left every rank with identical params
    x = _x(pool)
    gathered = allgather_rows(x)
    if not np.allclose(gathered, gathered[0], rtol=0, atol=1e-6):
        print(f"[rank {args.rank}] parameter divergence across ranks: "
              f"{gathered}", file=sys.stderr)
        return 3

    # shape agreement: every rank must have derived the identical
    # batch/plan trajectory (a diverged shape would already have
    # deadlocked the collectives, but check the decision sequence)
    traj = [[b[0], 0 if m[0] == "plain" else 1]
            for b, m in zip(hist.requested_batches, hist.modes)]
    all_traj = allgather_rows(traj)
    if all_traj.size and not (all_traj == all_traj[0]).all():
        print(f"[rank {args.rank}] batch/plan trajectory divergence "
              f"across ranks: {all_traj.tolist()}", file=sys.stderr)
        return 4

    if args.rank == 0 and args.out:
        result = {"x": x, "sim_time": rep.sim_time,
                  "comm_time": rep.comm_time,
                  "real_comm_time": rep.real_comm_time,
                  "num_syncs": rep.num_syncs,
                  "num_stats_syncs": rep.num_stats_syncs,
                  "batches": hist.requested_batches, "modes": hist.modes,
                  "merge_events": merge_events_of(rep),
                  "rounds": dict(rep.rounds), "loss": hist.loss,
                  "policy": args.policy, "procs": args.procs,
                  "pods": bool(args.pods), "wall_s": wall,
                  "adaptive": bool(args.adaptive),
                  "k_correct": int(args.k_correct),
                  "k": int(args.k), "merge": bool(args.merge),
                  "device": str(dev), "backend": "torch"}
        if rep.trace is not None:
            reals = rep.trace.real_spans()
            result["trace_digest"] = rep.trace.sim_digest()
            result["overlap_frac"] = rep.trace.overlap_fraction()
            # measured wall-clock overlap: dispatched collective windows
            # (dispatch -> ready) coincident with real inner compute —
            # nonzero only when the backend is actually nonblocking
            result["real_overlap_frac"] = rep.trace.overlap_fraction(
                clock="real")
            result["utilization"] = (
                rep.trace.utilization_summary()["utilization"])
            result["num_real_spans"] = len(reals)
            result["real_span_time"] = sum(
                s.duration for s in reals if s.kind != "compute")
            if args.trace:
                with open(args.trace, "w") as f:
                    json.dump(rep.trace.to_perfetto(), f)
        with open(args.out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
    return 0


# --------------------------------------------------------------- parent

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmds: List[List[str]], *, timeout: float, env=None) -> List[str]:
    """Run one fresh interpreter per command (rank order) and wait for
    all of them; returns each one's output.  A rank that fails ends the
    others (they would wait on its collectives), and every child still
    running when ``timeout`` seconds have passed is killed; both raise."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    children: List[subprocess.Popen] = []
    try:
        for cmd, log in zip(cmds, logs):
            children.append(subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.time() + timeout
        while any(ch.poll() is None for ch in children):
            failed = any(ch.returncode not in (None, 0) for ch in children)
            if failed or time.time() > deadline:
                break
            time.sleep(0.05)
        running = [r for r, ch in enumerate(children) if ch.poll() is None]
        for r in running:
            children[r].kill()
        for ch in children:
            ch.wait()
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read())
        bad = [r for r, ch in enumerate(children)
               if ch.returncode != 0 and r not in running]
        if bad:
            detail = "\n".join(
                f"--- rank {r} (exit {children[r].returncode}) ---\n"
                f"{tails[r][-2000:]}" for r in bad)
            raise RuntimeError(f"launch_mp workers failed:\n{detail}")
        if running:
            raise RuntimeError(
                f"launch_mp ranks {running} timed out after {timeout}s")
        return tails
    finally:
        for ch in children:
            if ch.poll() is None:
                ch.kill()
                ch.wait()
        for log in logs:
            log.close()


def child_env() -> dict:
    """The parent's environment with this checkout's ``src`` first on
    ``PYTHONPATH``."""
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_mp(procs: int, *, rounds: int = 2, policy: str = "sync",
           pods: bool = False, seed: int = 0, adaptive: bool = False,
           k_correct: int = 0, k: int = 1, merge: bool = False,
           trace: Optional[str] = None, record_trace: bool = False,
           device: str = "cuda", timeout: float = 600.0) -> dict:
    """Spawn ``procs`` local worker processes, run the fixture through
    the real backend on ``device``, and return rank 0's result dict.
    ``trace`` names a Perfetto JSON path for rank 0 to export;
    ``record_trace`` records spans (digest + real wall-time stats in the
    result dict) without writing a file."""
    from repro_torch import resolve_device

    resolve_device(device)           # no card: raise before spawning
    coord = f"tcp://127.0.0.1:{free_port()}"
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    cmds = []
    for rank in range(procs):
        cmd = [sys.executable, "-m", "repro_torch.cluster.launch_mp",
               "--worker", "--rank", str(rank), "--procs", str(procs),
               "--coordinator", coord, "--rounds", str(rounds),
               "--policy", policy, "--seed", str(seed),
               "--k-correct", str(k_correct), "--k", str(k),
               "--device", device, "--timeout", str(timeout),
               "--out", out]
        if pods:
            cmd.append("--pods")
        if adaptive:
            cmd.append("--adaptive")
        if merge:
            cmd.append("--merge")
        if trace and rank == 0:
            cmd.extend(["--trace", trace])
        elif trace or record_trace:
            cmd.append("--record-trace")
        cmds.append(cmd)
    try:
        spawn(cmds, timeout=timeout, env=child_env())
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, default=2,
                    help="local worker processes (= workers per trainer)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="outer rounds to run")
    ap.add_argument("--policy", choices=("sync", "async"), default="sync")
    ap.add_argument("--pods", action="store_true",
                    help="2-pod Topology (hierarchical process groups) "
                         "instead of the flat NetworkModel")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive batching + switch mode (microbatch "
                         "estimator; batch-stats all-reduce over every "
                         "process) instead of the fixed batch")
    ap.add_argument("--k-correct", type=int, default=0, dest="k_correct",
                    help="with --adaptive: run the exact batch-stats "
                         "reduction only every Nth round and predict "
                         "the batch from the fitted growth curve in "
                         "between (0/1 = exact every round)")
    ap.add_argument("--k", type=int, default=1,
                    help="trainer groups: split the processes into k "
                         "disjoint groups of procs//k workers each "
                         "(MIT multi-instance pool; must divide --procs)")
    ap.add_argument("--merge", action="store_true",
                    help="with --k > 1: enable MIT merge events, "
                         "executed as real cross-group collectives")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where every rank's tensors live: cuda (card "
                         "rank %% count; raises without a card) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="also run the SimBackend reference in-process "
                         "and assert final-parameter parity (plus "
                         "sim-span trace-digest parity when tracing)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the span trace and write rank 0's "
                         "Perfetto JSON here (wall-clock collective "
                         "spans alongside the sim spans)")
    ap.add_argument("--out", default=None, help="write rank-0 result JSON")
    ap.add_argument("--timeout", type=float, default=600.0)
    # internal: worker mode (spawned by run_mp)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--record-trace", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.adaptive and args.k > 1:
        ap.error("--adaptive needs --k 1 (the batch-stats reductions "
                 "are global, not per trainer group)")
    if args.worker:
        return worker_main(args)

    res = run_mp(args.procs, rounds=args.rounds, policy=args.policy,
                 pods=args.pods, seed=args.seed, adaptive=args.adaptive,
                 k_correct=args.k_correct, k=args.k, merge=args.merge,
                 trace=args.trace, record_trace=args.check,
                 device=args.device, timeout=args.timeout)
    n_merges = sum(1 for e in res.get("merge_events", ())
                   if e["kind"] == "merge")
    print(f"[launch_mp] procs={res['procs']} k={res['k']} "
          f"policy={res['policy']} "
          f"pods={res['pods']} adaptive={res['adaptive']} "
          f"device={res['device']} "
          f"syncs={res['num_syncs']} stats={res['num_stats_syncs']} "
          f"merges={n_merges} "
          f"sim_time={res['sim_time']:.4f}s "
          f"real_comm={res['real_comm_time']:.4f}s "
          f"wall={res['wall_s']:.2f}s")
    if "trace_digest" in res:
        print(f"[launch_mp] trace: digest={res['trace_digest']} "
              f"overlap_frac={res['overlap_frac']:.4f} "
              f"real_overlap_frac={res['real_overlap_frac']:.4f} "
              f"utilization={res['utilization']:.4f} "
              f"real_spans={res['num_real_spans']} "
              f"({res['real_span_time']:.6f}s wall)"
              + (f" -> {args.trace}" if args.trace else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    if args.check:
        traced = "trace_digest" in res
        ref = run_sim(args.procs, rounds=args.rounds, policy=args.policy,
                      pods=args.pods, seed=args.seed,
                      adaptive=args.adaptive, k_correct=args.k_correct,
                      k=args.k, merge=args.merge, trace=traced,
                      device=args.device)
        diff = float(np.max(np.abs(np.asarray(res["x"])
                                   - np.asarray(ref["x"]))))
        same_clock = (res["sim_time"] == ref["sim_time"]
                      and res["num_syncs"] == ref["num_syncs"])
        same_plan = (res["batches"] == ref["batches"]
                     and res["modes"] == ref["modes"])
        # the merge trajectory (executed + skipped events, with their
        # rounds and participants) must match the simulator exactly;
        # with --merge at least one merge must actually have executed
        # or the cross-group collective path wasn't exercised
        same_merges = (res.get("merge_events") == ref.get("merge_events"))
        merged_ok = (not args.merge
                     or any(e["kind"] == "merge"
                            for e in res.get("merge_events", ())))
        # the sim-span digest must be backend-invariant, and the real
        # backend must have measured actual wall time on the wire
        same_trace = (not traced
                      or res["trace_digest"] == ref["trace_digest"])
        real_ok = not traced or res["real_span_time"] > 0.0
        # nonblocking contract: on async runs the dispatched outer
        # collective must measurably overlap real inner compute — a
        # wall-clock fact, not a property of the simulated schedule
        overlap_ok = (not traced or args.policy != "async"
                      or res["real_overlap_frac"] > 0.0)
        print(f"[launch_mp] parity vs SimBackend: max|dx|={diff:.3e} "
              f"same_sim_clock={same_clock} same_plan_seq={same_plan} "
              f"same_merge_events={same_merges} merged_ok={merged_ok} "
              f"same_trace_digest={same_trace} real_spans_ok={real_ok} "
              f"real_overlap_ok={overlap_ok}")
        if (diff > 1e-5 or not same_clock or not same_plan
                or not same_merges or not merged_ok
                or not same_trace or not real_ok or not overlap_ok):
            print("[launch_mp] PARITY FAILURE", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
