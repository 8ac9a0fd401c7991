"""The readings of a DeepSeek-V2 training cell.

The same readings and comparison as ``bench.reference.train`` (every
worker's first three losses, each leaf's norm of its first gradient and
of its change over three steps, the first outer step's change), made
with the MoE model of ``bench.reference.moe_model``: the rows of a step
go through it together, since the capacity of an expert couples every
token of the batch, and it routes by itself.

``stand_in(inp, fault)`` is the reference in the program's place with
``fp8`` (every product in float8 e4m3, the control), ``half_batch``
(the first half of each step's rows), ``no_exchange`` (the outer step
from worker 0 alone) or ``one_worker_unchanged`` (the last worker's
steps return their input).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from bench.reference.moe_model import batch_loss
from bench.reference.moe_weights import make_weights
from bench.reference.optim import AdamW
from bench.reference.train import (STEPS, Inputs, Readings, _outer, _TF32Off,
                                   compare, leaf_norms)

FAULTS = ("fp8", "half_batch", "no_exchange", "one_worker_unchanged")
__all__ = ["FAULTS", "STEPS", "compare", "reference", "stand_in"]


def batch_grads(inp: Inputs, params, rows, quant):
    """(loss, f32 gradient) of the rows (B, S) of one step, all rows at
    once."""
    w = {k: p.float().requires_grad_(True) for k, p in params.items()}
    loss = batch_loss(inp.model, w, rows, quant)
    grads = torch.autograd.grad(loss, list(w.values()))
    return float(loss.detach()), dict(zip(w, grads))


def _worker(inp: Inputs, m: int, x0, quant=None, half=False, frozen=False):
    """Worker m's first three steps from ``x0`` -> (losses, g1, change)."""
    params = {k: t.clone() for k, t in x0.items()}
    opt = AdamW(params, inp.lr, inp.weight_decay)
    losses, g1 = [], None
    for rows in inp.steps[m][:STEPS]:
        rows = rows[:max(1, rows.shape[0] // 2)] if half else rows
        loss, grads = batch_grads(inp, params, rows, quant)
        if g1 is None:
            g1 = leaf_norms(grads)
        stepped = opt.step(params, grads)
        params = params if frozen else stepped
        losses.append(loss)
        del grads, stepped
    return losses, g1, leaf_norms(params, x0)


def _inner(inp: Inputs, x0, quant=None, half=False, frozen=()):
    """Every worker's readings, each a list over the workers."""
    runs = [_worker(inp, m, x0, quant, half, m in frozen)
            for m in range(len(inp.steps))]
    return tuple(list(r) for r in zip(*runs))


def reference(inp: Inputs, device) -> Readings:
    """The plain float32 reading."""
    with _TF32Off():
        x0 = make_weights(inp.model, inp.seed, device)
        losses, g1, change = _inner(inp, x0)
        outer = _outer(inp, x0, inp.workers)
    return Readings(losses, g1, change, outer)


def stand_in(inp: Inputs, fault: str, device,
             ref: Optional[Readings] = None) -> Readings:
    """The reference in the program's place with ``fault`` (one of
    ``FAULTS``); ``ref`` supplies the parts the fault leaves alone."""
    ref = ref or reference(inp, device)
    with _TF32Off():
        x0 = make_weights(inp.model, inp.seed, device)
        if fault in ("fp8", "half_batch"):
            quant = "fp8" if fault == "fp8" else None
            losses, g1, change = _inner(inp, x0, quant, fault == "half_batch")
            return Readings(losses, g1, change, ref.outer)
        if fault == "no_exchange":
            return replace(ref, outer=_outer(inp, x0, inp.workers[:1]))
        if fault == "one_worker_unchanged":
            last = len(inp.steps) - 1
            losses, g1, change = _inner(inp, x0, frozen=(last,))
            return Readings(losses, g1, change,
                            _outer(inp, x0, inp.workers[:last] + [x0]))
    raise ValueError(f"unknown fault {fault!r}")
