"""LocalSGD baseline (Stich 2019, paper §3.1): M workers do independent
SGD steps, parameters are plain-averaged every H steps (eq 5).  Also
the vanilla-DiLoCo baseline configuration helper.  Port of
``repro/core/local_sgd.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from repro_torch import optim, resolve_device
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core.adloco import History, train_adloco
from repro_torch.core.comms import CommsMeter, param_bytes
from repro_torch.core.diloco import StepCache, reshape_for_plan
from repro_torch.core.switch import plan_execution


def train_local_sgd(loss_fn: Callable, init_params: Any, streams: List[Any],
                    *, num_rounds: int, inner_steps: int, lr: float,
                    batch_size: int, verbose: bool = False, device=None):
    """eq 5: H local SGD steps then parameter averaging, repeated, on
    ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    M = len(streams)
    opt = optim.sgd(lr)
    cache = StepCache(loss_fn, opt)
    plan = plan_execution(batch_size, batch_size, 10 ** 9)
    step_fn = cache.get(plan)
    comms = CommsMeter()
    hist = History()
    params = {k: v.to(dev) for k, v in init_params.items()}
    opt_states = [opt.init(params) for _ in range(M)]
    samples = 0
    t0 = time.time()

    for r in range(1, num_rounds + 1):
        worker_params, losses = [], []
        for m in range(M):
            wp = params
            for _ in range(inner_steps):
                batch = streams[m].next_batch(batch_size)
                batch = reshape_for_plan(batch, plan)
                wp, opt_states[m], loss, _ = step_fn(wp, opt_states[m], batch)
                samples += batch_size
            worker_params.append(wp)
            losses.append(float(loss))
        params = {k: torch.mean(torch.stack([w[k].to(torch.float32)
                                             for w in worker_params]),
                                dim=0).to(p.dtype)
                  for k, p in params.items()}
        comms.record("avg", participants=M,
                     payload_bytes=param_bytes(params), step=r)
        hist.outer_step.append(r)
        hist.loss.append(sum(losses) / len(losses))
        hist.pool_size.append(1)
        hist.requested_batches.append([batch_size])
        hist.comm_events.append(comms.events)
        hist.comm_bytes.append(comms.total_bytes)
        hist.samples.append(samples)
        hist.wall.append(time.time() - t0)
        if verbose:
            print(f"[localsgd] r={r} loss={hist.loss[-1]:.4f}")
    return params, hist


def diloco_config(acfg: AdLoCoConfig, fixed_batch: int) -> AdLoCoConfig:
    """Vanilla DiLoCo = AdLoCo with adaptivity/merging/switching off and a
    single trainer of M workers at a fixed batch size."""
    return dataclasses.replace(
        acfg, adaptive=False, enable_merge=False, enable_switch=False,
        num_init_trainers=1, initial_batch_size=fixed_batch)


def train_diloco(loss_fn: Callable, init_params: Any, streams: List[Any],
                 acfg: AdLoCoConfig, *, fixed_batch: int,
                 num_outer_steps: Optional[int] = None, verbose: bool = False,
                 eval_fn: Optional[Callable] = None, device=None):
    cfg = diloco_config(acfg, fixed_batch)
    return train_adloco(loss_fn, [init_params], streams, cfg,
                        num_outer_steps=num_outer_steps, eval_fn=eval_fn,
                        fixed_batch=fixed_batch, verbose=verbose,
                        device=device)
