"""Functional optimizers over ``{name: tensor}`` parameter dicts.

Port of ``repro/optim``.  An optimizer is an (init, update) pair:
  state = init(params)
  updates, state = update(grads, state, params)
  params = apply_updates(params, updates)
Updates are *added* to params (update = -lr * direction).  State is
f32.  Every function returns new tensors and never writes its inputs,
as in JAX: the training loop starts several workers from the same
parameters, so an in-place update would corrupt the others.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Params, updates: Params, *,
                  consume: bool = False) -> Params:
    """The update is cast to the param dtype first, then added: a bf16
    param gets a bf16 add, as in JAX.  ``consume=True`` empties
    ``updates`` as it goes, so each f32 update is freed once applied
    (the caller must hold no other reference to the dict)."""
    take = updates.pop if consume else updates.__getitem__
    return {k: p + take(k).to(p.dtype) for k, p in params.items()}


def _zeros_like_f32(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _f32(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.float32)


# ------------------------------------------------------------------
# SGD (+ momentum / Nesterov) — DiLoCo's outer optimizer
# ------------------------------------------------------------------

def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return {"m": _zeros_like_f32(params)}

    def update(grads, state, params=None):
        if momentum == 0.0:
            return {k: -lr * _f32(g) for k, g in grads.items()}, state
        m = {k: momentum * state["m"][k] + _f32(g) for k, g in grads.items()}
        if nesterov:
            upd = {k: -lr * (momentum * m[k] + _f32(g))
                   for k, g in grads.items()}
        else:
            upd = {k: -lr * m_ for k, m_ in m.items()}
        return upd, {"m": m}

    return Optimizer(init, update)


def nesterov_outer(lr: float, momentum: float = 0.9) -> Optimizer:
    """DiLoCo's outer optimizer: Nesterov momentum SGD applied to the
    averaged pseudo-gradient (delta)."""
    return sgd(lr, momentum=momentum, nesterov=True)


def delay_compensated_nesterov(lr: float, momentum: float = 0.9) -> Optimizer:
    """Staleness-aware Nesterov for delayed (async) outer application:
    the momentum is scaled by ``1 / (1 + delay)``, so delay 0 equals
    :func:`nesterov_outer`.  ``update`` takes an extra ``delay`` keyword
    (rounds between the pseudo-gradient's snapshot and its
    application)."""

    def init(params):
        return {"m": _zeros_like_f32(params)}

    def update(grads, state, params=None, delay=0.0):
        mu = momentum / (1.0 + delay)
        m = {k: mu * state["m"][k] + _f32(g) for k, g in grads.items()}
        upd = {k: -lr * (mu * m[k] + _f32(g)) for k, g in grads.items()}
        return upd, {"m": m}

    return Optimizer(init, update)


# ------------------------------------------------------------------
# AdamW — the inner optimizer
# ------------------------------------------------------------------

def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device
        return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        m = {k: b1 * state["m"][k] + (1 - b1) * _f32(g)
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(_f32(g))
             for k, g in grads.items()}
        # f32 powers of the int32 step count, as in JAX
        mhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b1, device=tf.device),
                                          tf))
        vhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b2, device=tf.device),
                                          tf))
        updates = {}
        for k, p in params.items():
            step = m[k] * mhat_scale / (torch.sqrt(v[k] * vhat_scale) + eps)
            updates[k] = -lr * (step + weight_decay * _f32(p))
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


# ------------------------------------------------------------------
# AdaGrad (AdAdaGrad's base adaptive method)
# ------------------------------------------------------------------

def adagrad(lr: float, eps: float = 1e-10) -> Optimizer:
    def init(params):
        return {"acc": _zeros_like_f32(params)}

    def update(grads, state, params=None):
        acc = {k: state["acc"][k] + torch.square(_f32(g))
               for k, g in grads.items()}
        updates = {k: -lr * _f32(g) / (torch.sqrt(acc[k]) + eps)
                   for k, g in grads.items()}
        return updates, {"acc": acc}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "adagrad": adagrad,
            "nesterov": nesterov_outer,
            "delay_nesterov": delay_compensated_nesterov}[name](lr, **kw)
