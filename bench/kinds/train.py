"""Training cells: AdLoCo rounds of the port's ``TrainerRound``.

The system under test is ``repro_torch.core.adloco.TrainerRound`` with
one trainer (k = 1) of M workers on the card, round by round: ``inner``
(M workers x H inner steps of ``models.loss_fn`` with remat, built by
``launch.train.build_loss_fn``, and AdamW; in adaptive cells the
per-sample probe through the gradstats kernels and the batch decision)
and then ``outer`` (Nesterov on the averaged pseudo-gradient), as
``train_adloco``'s loop runs them.  Weights come from ``bench.weights``,
tokens from a device pool of the traffic's Markov rows.

Set-up builds the trainer once and runs round 1 through the window's
own calls; ``Capture`` reads the program's side of the check there
(every worker's first steps, the probe, the outer step).  The window then
runs rounds 2, 3, ... until ``seconds`` have passed and ends at the end
of the round in progress, after a synchronize.  The reference runs
after the window, once the program's state is freed.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional

import torch

from bench import trace as btrace
from bench.record import Round, Run
from bench.reference import train as ref
from bench.spec import Cell
from bench.traffic import make_pool
from bench.weights import Dense, make_weights
from repro_torch.configs.base import AdLoCoConfig, ModelConfig
from repro_torch.core.adloco import BatchPlanProtocol, TrainerRound
from repro_torch.core.diloco import StepCache
from repro_torch.kernels.gradstats import ops as gradstats_ops
from repro_torch.launch.train import build_loss_fn

ADAMW_B1 = 0.9      # optim.adamw's default, which TrainerRound keeps


def model_config(config: dict) -> ModelConfig:
    keys = ModelConfig.__dataclass_fields__
    return ModelConfig(**{k: v for k, v in config.items() if k in keys})


def adloco_config(config: dict, traffic: dict) -> AdLoCoConfig:
    """The trainer's settings: the traffic's, with batch sizes in
    multiples of the configuration's ``b_max``."""
    b = int(config["b_max"])
    batch = traffic["batch"]
    return AdLoCoConfig(
        num_inner_steps=int(traffic["inner_steps"]),
        num_init_trainers=1, nodes_per_gpu=int(config["nodes_per_gpu"]),
        initial_batch_size=b * batch["initial_x"],
        max_batch=b * batch["max_x"],
        max_global_batch=b * batch["max_global_x"],
        stats_use_kernel=True, **traffic["adloco"])


class Capture:
    """The program's side of the check, read in set-up's round 1 at two
    seams of the window's own call: the inner step that the trainer's
    step cache hands out, and the protocol's batch decision (the probe's
    statistics).  Each worker's steps are told apart by its AdamW state,
    which each step hands on to the worker's next: for every worker its
    first three losses, its first gradient (from the AdamW state after
    one step), the parameters its step 4 receives and those its last
    step returns.  ``detach`` restores both seams."""

    def __init__(self, rnd: TrainerRound, tr):
        self.rnd, self.x0 = rnd, tr.params
        M = len(tr.inner_opt_states)
        self.owner = {id(s): (m, 0) for m, s in enumerate(tr.inner_opt_states)}
        self.losses: List[List[float]] = [[] for _ in range(M)]
        self.g1: List[Optional[dict]] = [None] * M
        self.change: List[Optional[dict]] = [None] * M
        self.final: List[Optional[dict]] = [None] * M
        self.probe: Optional[Dict[str, float]] = None
        rnd.cache.get = self._get
        rnd.protocol.decide = self._decide

    def _get(self, plan):
        step = StepCache.get(self.rnd.cache, plan)

        def wrapped(params, opt_state, batch):
            m, i = self.owner.pop(id(opt_state), (None, 0))
            if m is not None and i == ref.STEPS:
                self.change[m] = ref.leaf_norms(params, self.x0)
            out = step(params, opt_state, batch)
            if m is None:
                return out
            if i < ref.STEPS:
                self.losses[m].append(float(out[2]))
            if i == 0:
                self.g1[m] = {n: v / (1 - ADAMW_B1) for n, v in
                              ref.leaf_norms(out[1]["m"]).items()}
            self.final[m] = out[0]
            self.owner[id(out[1])] = (m, i + 1)
            return out
        return wrapped

    def _decide(self, st, current_b: int) -> int:
        b = BatchPlanProtocol.decide(self.rnd.protocol, st, current_b)
        if self.probe is None:
            self.probe = {"n2": float(st.mean_norm2),
                          "sigma2": float(st.sigma2),
                          "decision": float(b), "current": current_b}
        return b

    def detach(self) -> None:
        del self.rnd.cache.get
        del self.rnd.protocol.decide


ALLOC_STATS = ("num_alloc_retries",)


def _alloc_stats(dev) -> Dict[str, int]:
    """The CUDA caching allocator's counters named in ``ALLOC_STATS``."""
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: int(st.get(k, 0)) for k in ALLOC_STATS}


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    """The system under test, built once from the cell and the seed: one
    ``TrainerRound`` and its trainer, fed by the token pool."""

    def __init__(self, cell: Cell, seed: int, device):
        self.dev = torch.device(device)
        config, traffic = cell.config, cell.traffic
        self.model = Dense.of(config)
        self.acfg = acfg = adloco_config(config, traffic)
        self.seq_len = int(traffic["seq_len"])
        if acfg.num_inner_steps <= ref.STEPS:
            raise ValueError(f"{cell.name}: the check reads the parameters "
                             f"step {ref.STEPS + 1} receives; H is "
                             f"{acfg.num_inner_steps}")
        self.fixed = None if acfg.adaptive else int(config["b_max"])
        self.seed = seed
        self.streams = make_pool(self.model.vocab_size, self.seq_len,
                                 acfg.nodes_per_gpu,
                                 int(traffic["pool_rows"]), seed, self.dev)
        self.rnd = TrainerRound(build_loss_fn(model_config(config)), acfg)
        self.pool = self.rnd.init_pool(
            [make_weights(self.model, seed, self.dev)], self.streams)
        self.tr = self.pool.trainers[0]
        self.t = 0

    def round(self) -> Round:
        """One round: ``inner`` then ``outer``, as ``train_adloco``."""
        self.t += 1
        rnd, tr = self.rnd, self.tr
        t0, a0 = time.perf_counter(), _alloc_stats(self.dev)
        o = rnd.inner(tr, fixed_batch=self.fixed, round_i=self.t)
        rnd.outer(tr, o.worker_params, step=self.t)
        r = Round(o.samples, o.mode, rnd.clock.collect(), rnd.probes[:],
                  time.perf_counter() - t0,
                  {k: v - a0[k] for k, v in _alloc_stats(self.dev).items()})
        rnd.probes.clear()
        return r

    def round1(self):
        """Round 1 with ``Capture`` on -> (the program's readings, the
        reference's inputs)."""
        rnd, tr, acfg = self.rnd, self.tr, self.acfg
        cap = Capture(rnd, tr)
        self.t = 1
        out = rnd.inner(tr, fixed_batch=self.fixed, round_i=1)
        # the outer step's reference starts from what each worker's last
        # step returned, not from what the round hands the outer step
        missing = [m for m, w in enumerate(cap.final) if w is None]
        if missing:
            raise RuntimeError(f"the step cache handed out no step of "
                               f"worker(s) {missing} in round 1")
        workers = [{k: t.to("cpu") for k, t in w.items()}
                   for w in cap.final]
        x_prev = tr.params
        rnd.outer(tr, out.worker_params, step=1)
        prog = ref.Readings(cap.losses, cap.g1, cap.change,
                            ref.leaf_norms(tr.params, x_prev), cap.probe)
        cap.detach()
        del out, x_prev, cap
        rnd.clock.collect()
        rnd.probes.clear()
        s0 = self.streams[0]
        inputs = ref.Inputs(
            model=self.model, seed=self.seed,
            steps=[[s.take(*d) for d in s.draws[:ref.STEPS]]
                   for s in self.streams],
            lr=acfg.lr_inner, weight_decay=acfg.weight_decay,
            lr_outer=acfg.lr_outer, momentum=acfg.outer_momentum,
            workers=workers, eta=acfg.eta,
            max_global_batch=acfg.max_global_batch)
        if prog.probe is not None:
            inputs.probe_rows = s0.take(*s0.draws[acfg.num_inner_steps])
            inputs.probe_current = acfg.initial_batch_size
        return prog, inputs

    def free(self) -> None:
        """Drop the program's state (before the reference runs)."""
        del self.tr, self.pool, self.rnd
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a training cell -> {"run": Run, "numbers": {name:
    value}, "attempted", "failed", "peak_bytes"}."""
    tn = Trainer(cell, seed, device)
    dev = tn.dev
    prog, inputs = tn.round1()
    setup_peak = _peak(dev)

    def window():
        rounds: List[Round] = []
        t0 = time.perf_counter()
        while True:
            rounds.append(tn.round())
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        return rounds, time.perf_counter() - t0

    launched0 = (gradstats_ops.colsum_launches,
                 gradstats_ops.moments_launches)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    if trace:
        prof, (rounds, window_s) = btrace.record(window)
    else:
        rounds, window_s = window()
    window_peak = _peak(dev)
    launches = {"colsum": gradstats_ops.colsum_launches - launched0[0],
                "moments": gradstats_ops.moments_launches - launched0[1]}
    record = Run(cell=cell.name, model=tn.model, seq_len=tn.seq_len,
                 setup_s=setup_s, window_s=window_s, rounds=rounds,
                 window_peak_bytes=window_peak, launches=launches)
    if trace:
        record.trace = btrace.summarize(prof, launches)
        del prof

    # ---- the check, once the program's state is freed -----------------
    tn.free()
    t_ref = time.perf_counter()
    numbers = ref.compare(prog, ref.reference(inputs, dev))
    print(f"[bench] reference: {time.perf_counter() - t_ref:.1f} s; "
          f"rounds in the window (plan, sequences, s): "
          f"{[(r.mode, r.samples, round(r.seconds, 3)) for r in rounds]}; "
          f"allocator per round: {[r.alloc for r in rounds]}; "
          f"probe: {prog.probe}", file=sys.stderr)
    return {"run": record, "numbers": numbers,
            "attempted": sum(r.samples for r in rounds), "failed": 0,
            "peak_bytes": max(setup_peak, window_peak)}
