"""DiLoCo primitives: the inner step (with SwitchMode gradient
accumulation) and the outer step (Nesterov on averaged
pseudo-gradients).  Port of ``repro/core/diloco.py``.

Parameters, gradients and optimizer states are ``{name: tensor}``
dicts.  Every step returns new tensors and leaves its inputs as they
were (JAX arrays are immutable, and the orchestrator starts all M
workers and the outer step from the same ``x_start``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import optim
from repro_torch.core.switch import ExecutionPlan

Params = Dict[str, torch.Tensor]


def value_and_grad(loss_fn: Callable, params: Params, batch):
    """``loss_fn(params, batch) -> (loss, aux)`` and its gradient with
    respect to every tensor of ``params`` (the JAX package's
    ``jax.value_and_grad(..., has_aux=True)``).  Returns (loss, aux,
    grads), detached; ``params`` is not modified."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: (torch.zeros_like(v) if g is None else g)
             for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), aux, grads


def make_inner_step(loss_fn: Callable, inner_opt: optim.Optimizer,
                    accum_steps: int):
    """fn(params, opt_state, batch) -> (params, opt_state, loss, grads).

    ``batch`` leaves are shaped (accum_steps, micro, ...); the
    micro-batches run one after another.  ``grads`` is the mean gradient
    the update used (the microbatch stats estimator reuses it).  With
    accum_steps == 1 there is no f32 accumulator: grads stay in the
    param dtype, as in JAX."""

    def step_noaccum(params, opt_state, batch):
        mb = {k: v[0] for k, v in batch.items()}
        loss, _, grads = value_and_grad(loss_fn, params, mb)
        updates, opt_state = inner_opt.update(grads, opt_state, params)
        return (optim.apply_updates(params, updates, consume=True),
                opt_state, loss, grads)

    def step(params, opt_state, batch):
        # zeros_like keeps a sharded (DTensor) parameter's layout
        g_sum = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        l_sum = torch.zeros((), dtype=torch.float32,
                            device=next(iter(params.values())).device)
        for a in range(accum_steps):
            mb = {k: v[a] for k, v in batch.items()}
            loss, _, g = value_and_grad(loss_fn, params, mb)
            g_sum = {k: g_sum[k] + g[k].to(torch.float32) for k in g_sum}
            l_sum = l_sum + loss
        inv = 1.0 / accum_steps
        grads = {k: g * inv for k, g in g_sum.items()}
        del g_sum                   # freed before the update (memory)
        updates, opt_state = inner_opt.update(grads, opt_state, params)
        return (optim.apply_updates(params, updates, consume=True),
                opt_state, l_sum * inv, grads)

    return step_noaccum if accum_steps == 1 else step


def stack_params(worker_params: List[Params]) -> Params:
    """[{name: (...)}] * M -> {name: (M, ...)}."""
    return {k: torch.stack([w[k] for w in worker_params])
            for k in worker_params[0]}


def make_outer_step(outer_opt: optim.Optimizer, *,
                    delay_aware: bool = False):
    """fn(x_prev, worker_params [stacked leading M axis], outer_state,
    delay) -> (x_new, outer_state).

    Pseudo-gradient Δ = x_prev − mean_m(x_m) (paper Alg 3 line 42), in
    f32.  ``delay`` (rounds of staleness) reaches the optimizer only
    with ``delay_aware=True`` (``optim.delay_compensated_nesterov``)."""

    def step(x_prev, worker_params, outer_state, delay=0.0):
        delta = {k: xp.to(torch.float32)
                 - torch.mean(worker_params[k].to(torch.float32), dim=0)
                 for k, xp in x_prev.items()}
        if delay_aware:
            updates, outer_state = outer_opt.update(
                delta, outer_state, x_prev, delay=delay)
        else:
            updates, outer_state = outer_opt.update(delta, outer_state,
                                                    x_prev)
        return optim.apply_updates(x_prev, updates), outer_state

    return step


def merge_params(params_list: List[Params], weights) -> Params:
    """Batch-size-weighted parameter average (paper Alg 2, DoMerge): an
    f32 weighted sum, cast back to each param's dtype."""
    w = torch.tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    out = {}
    for k, p in params_list[0].items():
        acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for wi, params in zip(w.tolist(), params_list):
            acc = acc + wi * params[k].to(torch.float32)
        out[k] = acc.to(p.dtype)
    return out


class StepCache:
    """Inner steps keyed by (micro_batch, accum_steps).  PyTorch runs
    eagerly, so nothing is compiled; the cache keeps the JAX package's
    interface and its count of distinct step shapes."""

    def __init__(self, loss_fn: Callable, inner_opt: optim.Optimizer):
        self.loss_fn = loss_fn
        self.inner_opt = inner_opt
        self._cache: Dict[Tuple[int, int], Callable] = {}

    def get(self, plan: ExecutionPlan):
        key = (plan.micro_batch, plan.accum_steps)
        if key not in self._cache:
            self._cache[key] = make_inner_step(
                self.loss_fn, self.inner_opt, plan.accum_steps)
        return self._cache[key]

    @property
    def num_compiled(self) -> int:
        return len(self._cache)


def reshape_for_plan(batch, plan: ExecutionPlan):
    """Leaves (plan.effective_batch, ...) -> (accum, micro, ...)."""
    return {k: x.reshape(plan.accum_steps, plan.micro_batch, *x.shape[1:])
            for k, x in batch.items()}
