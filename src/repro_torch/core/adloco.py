"""AdLoCo — Algorithm 3: Adaptive Batching + Merging + SwitchMode on the
DiLoCo core.  Port of ``repro/core/adloco.py``: a host-level
orchestrator over the primitives in ``diloco.py``.

The per-trainer round body (inner steps -> batch statistics -> requested
batch update -> outer sync) lives in :class:`TrainerRound`, shared by
:func:`train_adloco` (the synchronous host loop) and
``repro_torch.cluster.run_cluster`` (the event-driven cluster runtime).

Ablations (paper Fig. 2) via AdLoCoConfig flags:
  adaptive=False       -> fixed-batch DiLoCo-style training
  enable_merge=False   -> no trainer consolidation
  enable_switch=False  -> no gradient accumulation (batch hard-capped)
Vanilla DiLoCo baseline = adaptive off, merge off, switch off.

Parameters are ``{name: tensor}`` dicts.  All M workers of a trainer
start from the same ``x_start`` tensors; every step builds new tensors,
so ``inner`` never writes ``tr.params`` (the pseudo-gradient and the
merge read it afterwards).

Where the port adds to the JAX package: on a CUDA device,
:class:`PhaseClock` records CUDA events around each round's phases
(``inner``, ``stats_grads``, ``stats_reduce``, ``outer``, ``merge``) and
``History.phase_ms`` keeps their device times in ms per round.  The
per-sample probe runs in row chunks where its (B, D) f32 matrix does
not fit the card (``batching.per_sample_probe``); ``History.stats_probe``
records each round's probes as (B, rows held at once, chunks per
sweep).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import optim, resolve_device
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import batching
from repro_torch.core.comms import CommsMeter, param_bytes
from repro_torch.core.diloco import (StepCache, make_outer_step,
                                     reshape_for_plan, stack_params)
from repro_torch.core.mit import (TrainerPoolState, TrainerState, check_merge,
                                  consolidate, do_merge)
from repro_torch.core.switch import ExecutionPlan, plan_execution


@dataclass
class History:
    outer_step: List[int] = field(default_factory=list)
    loss: List[float] = field(default_factory=list)
    eval_loss: List[float] = field(default_factory=list)
    # per-record {tid: eval loss}
    eval_loss_by_trainer: List[Dict[int, float]] = field(default_factory=list)
    # eval loss of the batch-weighted average of the live pool at each
    # record (what ``consolidate`` would return); cluster runtime only
    eval_loss_pool: List[float] = field(default_factory=list)
    pool_size: List[int] = field(default_factory=list)
    requested_batches: List[List[int]] = field(default_factory=list)
    comm_events: List[int] = field(default_factory=list)
    comm_bytes: List[float] = field(default_factory=list)
    samples: List[int] = field(default_factory=list)     # cumulative
    modes: List[List[str]] = field(default_factory=list)
    wall: List[float] = field(default_factory=list)
    # simulated seconds (``repro_torch.cluster`` runtime only; empty for
    # the host loop, which has no cluster clock)
    sim_time: List[float] = field(default_factory=list)
    # device ms per phase per round (CUDA events; empty dicts on the CPU)
    phase_ms: List[Dict[str, float]] = field(default_factory=list)
    # per round, each per-sample probe run as [B, rows, chunks]
    # (rows == B, chunks == 1: one pass)
    stats_probe: List[List[List[int]]] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return self.__dict__.copy()


@dataclass
class RoundOutput:
    """Result of one trainer round's compute phase (inner steps + batch
    adaptation), before the outer sync is applied."""

    worker_params: List[Any]        # per-worker end-of-round params
    x_start: Any                    # params the pseudo-gradient diffs against
    mean_loss: float
    mode: str                       # execution plan mode this round
    samples: int                    # total samples consumed (all workers)
    samples_per_worker: int
    flops_per_worker: float         # estimated compute cost (6*N*samples)
    bytes_per_worker: float         # estimated device traffic per worker
    # wire payload of the round's batch-stats reduction (0.0 when the
    # round ran fixed-batch)
    stats_bytes: float = 0.0
    # deferred-stats handle (``inner(..., defer_stats=True)``): either
    # ``{"st": GradStats}`` or ``{"phase1", "G_local", "micro"}``; None
    # when the decision was applied inline
    stats_request: Optional[Dict[str, Any]] = None
    # True when the decision came from the fitted growth predictor
    predicted: bool = False


class PhaseClock:
    """Device time of named phases from CUDA events, summed by name
    until :meth:`collect`.  Records nothing for a CPU device."""

    def __init__(self):
        self._spans: list = []

    @contextmanager
    def span(self, name: str, device: torch.device):
        if device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._spans.append((name, start, end))

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, start, end in self._spans:
            end.synchronize()
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        self._spans.clear()
        return out


def _device(params) -> torch.device:
    return next(iter(params.values())).device


class BatchPlanProtocol:
    """Shape-agreement protocol: reduced statistics -> one batch
    decision -> one deterministic :class:`ExecutionPlan`.  ``decide`` and
    ``plan_for`` are pure functions of the reduced statistics and the
    shared config, so every rank agrees without further coordination
    (which needs bit-identical statistics: the gradstats kernels use no
    float atomics)."""

    def __init__(self, acfg: AdLoCoConfig):
        self.acfg = acfg

    # ------------------------------------------------------- reduction
    def reduce(self, G_local, sum_reduce, *,
               micro_size: int) -> batching.GradStats:
        """Compose this process's gradient rows with every other
        process's through ``sum_reduce`` (exact two-phase composition)."""
        return batching.distributed_stats(G_local, sum_reduce,
                                          micro_size=micro_size)

    def payload_bytes(self, n_params: int) -> float:
        return batching.stats_payload_bytes(n_params)

    # ------------------------------------------- deferred (split) phases
    def begin(self, G_local) -> torch.Tensor:
        """Phase-1 payload for a deferred reduction."""
        return batching.stats_phase1(G_local)

    def finish(self, phase1_total, G_local, sum_reduce, *,
               micro_size: int) -> batching.GradStats:
        """Finish a deferred reduction from the phase-1 total."""
        return batching.stats_finish(phase1_total, G_local, sum_reduce,
                                     micro_size=micro_size)

    def finish_total(self, phase2_total, *,
                     micro_size: int) -> batching.GradStats:
        """Finish from an already-summed phase-2 moments vector."""
        return batching.stats_finish_total(phase2_total,
                                           micro_size=micro_size)

    # -------------------------------------------------------- decision
    def decide(self, st: batching.GradStats, current_b: int) -> int:
        """The configured batch test + monotone-growth/cap policy."""
        return batching.requested_batch(st, self.acfg, current_b)

    def plan_for(self, b_req: int) -> ExecutionPlan:
        acfg = self.acfg
        mult = (acfg.switch_multiplier if acfg.enable_switch
                else 10 ** 9)  # switch off => never accumulate
        return plan_execution(b_req, acfg.max_batch, mult)


class TrainerRound:
    """Reusable per-trainer round primitive (Alg 3 lines 17–44).

    ``inner`` runs the compute phase: M workers x H inner steps from
    ``worker_starts`` (default: the trainer's synced params), updates the
    inner optimizer states and — when adaptive — the requested batch.
    ``outer`` applies the outer (pseudo-gradient) step to the trainer and
    meters the all-reduce."""

    def __init__(self, loss_fn: Callable, acfg: AdLoCoConfig):
        self.loss_fn = loss_fn
        self.acfg = acfg
        self.protocol = BatchPlanProtocol(acfg)
        self.inner_opt = optim.get_optimizer(
            acfg.inner_optimizer, acfg.lr_inner,
            **({"weight_decay": acfg.weight_decay}
               if acfg.inner_optimizer == "adamw" else {}))
        self._delay_aware = (acfg.delay_compensation
                             and acfg.outer_optimizer == "nesterov")
        if self._delay_aware:
            self.outer_opt = optim.delay_compensated_nesterov(
                acfg.lr_outer, momentum=acfg.outer_momentum)
        else:
            self.outer_opt = optim.get_optimizer(
                acfg.outer_optimizer, acfg.lr_outer,
                **({"momentum": acfg.outer_momentum}
                   if acfg.outer_optimizer in ("nesterov", "sgd") else {}))
        self.cache = StepCache(loss_fn, self.inner_opt)
        self.outer_step = make_outer_step(self.outer_opt,
                                          delay_aware=self._delay_aware)
        self.clock = PhaseClock()
        # [B, rows, chunks] of each per-sample probe since the last drain
        self.probes: List[List[int]] = []
        self._n_params: Optional[int] = None
        self._predictors: Dict[int, batching.BatchGrowthPredictor] = {}

    # ----------------------------------------------- predicted growth
    def _predictor_for(self, tid: int) -> batching.BatchGrowthPredictor:
        pred = self._predictors.get(tid)
        if pred is None:
            pred = batching.BatchGrowthPredictor(self.acfg.max_global_batch)
            self._predictors[tid] = pred
        return pred

    def _is_correction(self, round_i: Optional[int]) -> bool:
        """Rounds that run the exact stats: round 1 and every
        ``k_correct``'th round after it (all of them when k_correct <= 1
        or no round index is threaded)."""
        k = self.acfg.k_correct
        return k <= 1 or round_i is None or (round_i - 1) % k == 0

    # ---------------------------------------------------------- pool
    def init_pool(self, init_params_list: List[Any],
                  streams: List[Any]) -> TrainerPoolState:
        acfg = self.acfg
        M = acfg.nodes_per_gpu
        trainers = []
        for i, params in enumerate(init_params_list):
            trainers.append(TrainerState(
                tid=i,
                params=params,
                outer_opt_state=self.outer_opt.init(params),
                inner_opt_states=[self.inner_opt.init(params)
                                  for _ in range(M)],
                requested_batch=acfg.initial_batch_size,
                streams=[streams[i * M + m] for m in range(M)],
            ))
        return TrainerPoolState(trainers=trainers)

    def new_trainer(self, tid: int, params: Any,
                    streams: List[Any]) -> TrainerState:
        """Fresh trainer (elastic join): given params, fresh optimizer
        states on the params' device."""
        M = self.acfg.nodes_per_gpu
        return TrainerState(
            tid=tid, params=params,
            outer_opt_state=self.outer_opt.init(params),
            inner_opt_states=[self.inner_opt.init(params) for _ in range(M)],
            requested_batch=self.acfg.initial_batch_size,
            streams=list(streams))

    # --------------------------------------------------------- plans
    def plan_for(self, tr: TrainerState,
                 fixed_batch: Optional[int] = None) -> ExecutionPlan:
        acfg = self.acfg
        b_req = (fixed_batch if (fixed_batch is not None
                                 and not acfg.adaptive)
                 else tr.requested_batch)
        return self.protocol.plan_for(b_req)

    def _count_params(self, params) -> int:
        if self._n_params is None:
            self._n_params = int(sum(t.numel() for t in params.values()))
        return self._n_params

    # --------------------------------------------------------- inner
    def inner(self, tr: TrainerState, *,
              fixed_batch: Optional[int] = None,
              worker_starts: Optional[List[Any]] = None,
              workers: Optional[List[int]] = None,
              stats_reduce: Optional[Callable] = None,
              defer_stats: bool = False,
              round_i: Optional[int] = None,
              batch_share: Optional[int] = None) -> RoundOutput:
        """Compute phase of one round.  Mutates ``tr.inner_opt_states``
        and (adaptive) ``tr.requested_batch``; never touches
        ``tr.params``.  ``workers`` restricts which of the M workers this
        process computes (``worker_params`` keeps length M with ``None``
        elsewhere).  ``stats_reduce`` (a cross-process SUM all-reduce of
        a small f32 vector) runs the exact two-phase composition over
        every process's workers.  ``defer_stats`` returns the stats
        handle in ``RoundOutput.stats_request`` for :meth:`apply_stats`
        instead of deciding inline.  ``round_i`` (1-based) enables
        predicted growth when ``acfg.k_correct > 1``.  ``batch_share``
        overrides the executed plan without touching the decision."""
        acfg = self.acfg
        M = len(tr.inner_opt_states)
        H = acfg.num_inner_steps
        idxs = list(range(M)) if workers is None else list(workers)
        plan = self.plan_for(tr, fixed_batch)
        if batch_share is not None and acfg.adaptive:
            plan = self.protocol.plan_for(max(1, int(batch_share)))
        step_fn = self.cache.get(plan)

        x_start = tr.params
        dev = _device(x_start)
        worker_params: List[Any] = [None] * M
        worker_grads, last_losses = [], []
        # the statistics read the workers' last gradients only on these
        # paths; elsewhere none is kept past its step (device memory)
        keep_grads = acfg.adaptive and (
            stats_reduce is not None
            or (acfg.stats_estimator == "microbatch" and len(idxs) >= 2))
        with self.clock.span("inner", dev):
            for m in idxs:
                wp = (worker_starts[m] if worker_starts is not None
                      else x_start)
                opt_m = tr.inner_opt_states[m]
                # the slot gives up the old state while the worker's
                # steps build new ones: one optimizer state per worker
                # fewer held at a time
                tr.inner_opt_states[m] = None
                stream = tr.streams[m % len(tr.streams)]
                for _ in range(H):
                    batch = stream.next_batch(plan.effective_batch)
                    batch = reshape_for_plan(batch, plan)
                    wp, opt_m, loss, grads = step_fn(wp, opt_m, batch)
                    if not keep_grads:
                        grads = None    # freed before the next step
                worker_params[m] = wp
                if keep_grads:
                    worker_grads.append(grads)
                tr.inner_opt_states[m] = opt_m
                last_losses.append(float(loss))

        # ---- requested batch for the next round (Alg 3 line 31) ------
        stats_bytes = 0.0
        stats_request: Optional[Dict[str, Any]] = None
        predicted = False
        if acfg.adaptive and not self._is_correction(round_i):
            tr.requested_batch = self._predictor_for(tr.tid).predict(
                round_i, tr.requested_batch)
            predicted = True
        elif acfg.adaptive:
            n = self._count_params(x_start)
            if stats_reduce is not None:
                # each worker's microbatch-mean grad is one shard of the
                # exact two-phase composition across processes
                G_local = batching.flatten_grads(stack_params(worker_grads))
                if defer_stats:
                    st = None
                    stats_request = {"phase1": self.protocol.begin(G_local),
                                     "G_local": G_local,
                                     "micro": plan.effective_batch}
                else:
                    st = self.protocol.reduce(
                        G_local, stats_reduce,
                        micro_size=plan.effective_batch)
            elif acfg.stats_estimator == "microbatch" and len(idxs) >= 2:
                # free distributed estimator: Var over the M workers'
                # last microbatch-mean grads, times m, estimates sigma^2
                with self.clock.span("stats_grads", dev):
                    G = batching.flatten_grads(stack_params(worker_grads))
                with self.clock.span("stats_reduce", dev):
                    st = batching.rescale_microbatch(
                        batching.stats_from_matrix(
                            G, use_kernel=acfg.stats_use_kernel),
                        plan.effective_batch)
                del G
            else:
                # per-sample stats on a probe of the current batch size;
                # stats_probe_size is only a memory cap
                probe_b = max(4, min(acfg.stats_probe_size,
                                     plan.effective_batch))
                probe = tr.streams[0].next_batch(probe_b)
                res = batching.per_sample_probe(
                    self.loss_fn, worker_params[idxs[0]], probe,
                    use_kernel=acfg.stats_use_kernel,
                    span=lambda name: self.clock.span(name, dev))
                st = res.stats
                self.probes.append([probe_b, res.rows, res.chunks])
            if defer_stats:
                if stats_request is None:
                    stats_request = {"st": st}
            else:
                tr.requested_batch = self.protocol.decide(
                    st, tr.requested_batch)
                if acfg.k_correct > 1 and round_i is not None:
                    self._predictor_for(tr.tid).observe(
                        round_i, tr.requested_batch)
            stats_bytes = self.protocol.payload_bytes(n)

        spw = plan.effective_batch * H
        n = self._count_params(x_start)
        return RoundOutput(
            worker_params=worker_params, x_start=x_start,
            mean_loss=(sum(last_losses) / len(last_losses)
                       if last_losses else 0.0),
            mode=plan.mode, samples=spw * M, samples_per_worker=spw,
            flops_per_worker=6.0 * n * spw,
            bytes_per_worker=3.0 * param_bytes(x_start) * H,
            stats_bytes=stats_bytes, stats_request=stats_request,
            predicted=predicted)

    # ---------------------------------------------------- stale stats
    def apply_stats(self, tr: TrainerState, request: Dict[str, Any], *,
                    phase1_total=None, phase2_total=None,
                    sum_reduce: Optional[Callable] = None,
                    round_i: Optional[int] = None) -> int:
        """Fold a stats handle from ``inner(..., defer_stats=True)`` into
        the trainer's requested batch: finished statistics (``{"st"}``),
        a summed phase-2 vector, or a phase-1 total plus ``sum_reduce``.
        Returns the updated requested batch."""
        if "st" in request:
            st = request["st"]
        elif phase2_total is not None:
            st = self.protocol.finish_total(
                phase2_total, micro_size=request["micro"])
        else:
            st = self.protocol.finish(
                phase1_total, request["G_local"], sum_reduce,
                micro_size=request["micro"])
        tr.requested_batch = self.protocol.decide(st, tr.requested_batch)
        if self.acfg.k_correct > 1 and round_i is not None:
            self._predictor_for(tr.tid).observe(round_i, tr.requested_batch)
        return tr.requested_batch

    # --------------------------------------------------------- outer
    def outer(self, tr: TrainerState, worker_params: List[Any], *,
              x_prev: Optional[Any] = None,
              comms: Optional[CommsMeter] = None, step: int = 0,
              reduce: Optional[Callable] = None,
              delay: float = 0.0) -> None:
        """Apply the outer (pseudo-gradient) step: Alg 3 lines 40–44.
        ``x_prev`` defaults to the trainer's synced params; ``reduce``
        maps the per-worker params list to the worker-stacked dict the
        step averages (default: an in-process stack); ``delay`` reaches
        the optimizer only with ``delay_compensation`` on."""
        x_prev = x_prev if x_prev is not None else tr.params
        with self.clock.span("outer", _device(x_prev)):
            stacked = (stack_params(worker_params) if reduce is None
                       else reduce(worker_params))
            tr.params, tr.outer_opt_state = self.outer_step(
                x_prev, stacked, tr.outer_opt_state, float(delay))
        if comms is not None:
            comms.record("outer", participants=len(worker_params),
                         payload_bytes=param_bytes(tr.params), step=step)


def record_eval(hist: History, pool: TrainerPoolState,
                eval_fn: Optional[Callable]) -> None:
    """Evaluate every trainer, keep the per-tid map, and track the best
    (largest requested batch = most advanced) trainer's loss."""
    if eval_fn is None:
        return
    per = {tr.tid: float(eval_fn(tr.params)) for tr in pool.trainers}
    hist.eval_loss_by_trainer.append(per)
    best = max(pool.trainers, key=lambda tr: tr.requested_batch)
    hist.eval_loss.append(per[best.tid])


def train_adloco(loss_fn: Callable, init_params_list: List[Any],
                 streams: List[Any], acfg: AdLoCoConfig, *,
                 num_outer_steps: Optional[int] = None,
                 eval_fn: Optional[Callable] = None,
                 fixed_batch: Optional[int] = None,
                 verbose: bool = False,
                 restore_from: Optional[tuple] = None,
                 device=None):
    """Run Algorithm 3 (synchronous host loop) on ``device`` (``cuda``
    unless named; raises without a card).

    loss_fn(params, batch) -> (loss, aux);  streams: k*M data shards with
    ``next_batch(b)`` on the same device;  init_params_list: k
    independent ``{name: tensor}`` inits (moved to ``device``).
    ``restore_from``: optional (ckpt_dir, step) to restore the trainer
    pool from before training.  Returns (TrainerPoolState, History).
    """
    dev = resolve_device(device)
    init_params_list = [{k: v.to(dev) for k, v in p.items()}
                        for p in init_params_list]
    T = num_outer_steps or acfg.num_outer_steps
    rnd = TrainerRound(loss_fn, acfg)
    pool = rnd.init_pool(init_params_list, streams)
    if restore_from is not None:
        from repro_torch.checkpoint import restore_train_state
        pool, _ = restore_train_state(restore_from[0], restore_from[1], pool)
    if fixed_batch is not None and not acfg.adaptive:
        for tr in pool.trainers:
            tr.requested_batch = fixed_batch
    hist = History()
    samples_total = 0
    t0 = time.time()

    for t in range(1, T + 1):
        # ---- CheckMerge / DoMerge (Alg 3 lines 11–16) ----------------
        if (acfg.enable_merge and pool.k > 1
                and t % acfg.merge_frequency == 0):
            ids = check_merge([tr.requested_batch for tr in pool.trainers],
                              acfg.merge_w + 1)  # w worst + representative
            if len(ids) > 1:
                with rnd.clock.span("merge", dev):
                    pool = do_merge(pool, ids, step=t)

        round_losses, modes = [], []
        for tr in pool.trainers:
            out = rnd.inner(tr, fixed_batch=fixed_batch, round_i=t)
            round_losses.append(out.mean_loss)
            modes.append(out.mode)
            samples_total += out.samples
            # ---- outer sync (Alg 3 lines 40–44) ----------------------
            rnd.outer(tr, out.worker_params, comms=pool.comms, step=t)
            out = None   # the workers' params go before the next round

        hist.outer_step.append(t)
        hist.loss.append(sum(round_losses) / len(round_losses))
        hist.pool_size.append(pool.k)
        hist.requested_batches.append(
            [tr.requested_batch for tr in pool.trainers])
        hist.comm_events.append(pool.comms.events)
        hist.comm_bytes.append(pool.comms.total_bytes)
        hist.samples.append(samples_total)
        hist.modes.append(modes)
        hist.phase_ms.append(rnd.clock.collect())
        hist.stats_probe.append(rnd.probes[:])
        rnd.probes.clear()
        hist.wall.append(time.time() - t0)
        record_eval(hist, pool, eval_fn)
        if verbose:
            print(f"[adloco] t={t} loss={hist.loss[-1]:.4f} "
                  f"k={pool.k} b={hist.requested_batches[-1]} "
                  f"comm={pool.comms.events}")

    pool = consolidate(pool, step=T)
    return pool, hist
