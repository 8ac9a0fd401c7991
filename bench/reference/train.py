"""The readings a training cell compares, and the comparison.

A reading is what one side made of the same inputs (``Inputs``), for
every worker of the trainer, each from the initial parameters on its
own shard:

- ``losses``: the loss of each worker's first three inner steps;
- ``g1``: each leaf's norm of each worker's first gradient;
- ``change``: each leaf's norm of each worker's change over its three
  steps (the parameters its step 4 receives, less the initial ones);
- ``probe``: the per-sample probe's ||mean g||^2 and trace variance on
  the probe's rows at the program's worker-0 parameters after round 1,
  and the batch it asks for (adaptive cells);
- ``outer``: each leaf's norm of the first outer step's change, from the
  initial parameters and the parameters that each worker's last step of
  round 1 returned.

The probe and the outer step start from the program's own round-1
state (the reference follows three of the four inner steps only); the
first steps are followed from the benchmark's weights alone.

``reference(inp)`` is the plain float32 reading.  ``stand_in(inp,
fault)`` is the reference put in the program's place with a fault or
in a lower precision: ``fp8`` (every product in float8 e4m3, the
control), ``half_batch`` (the steps and the probe on half of their
rows), ``no_exchange`` (the outer step from worker 0 alone),
``decision`` (the probe's answer doubled) and ``one_worker_unchanged``
(the last worker's steps return their input).  ``compare`` turns two
readings into the numbers that are held to a cell's limits.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import torch

from bench.reference.model import row_loss
from bench.reference.optim import AdamW, nesterov_first
from bench.weights import Dense, make_weights

Leaves = Dict[str, torch.Tensor]
Norms = Dict[str, float]
STEPS = 3
FAULTS = ("fp8", "half_batch", "no_exchange", "decision",
          "one_worker_unchanged")


@dataclass
class Inputs:
    """What both sides are given: the weights' seed, each worker's first
    batches, the probe's rows and the trainer's settings; ``workers``
    (the parameters each worker's last step of round 1 returned, on the
    host) start the probe and the outer step."""
    model: Dense
    seed: int
    steps: List[List[torch.Tensor]]      # per worker, (B, S) rows a step
    lr: float
    weight_decay: float
    lr_outer: float
    momentum: float
    workers: List[Leaves]
    probe_rows: Optional[torch.Tensor] = None
    probe_current: int = 0               # requested batch before the probe
    eta: float = 0.8
    max_global_batch: int = 0


@dataclass
class Readings:
    losses: List[List[float]]            # per worker
    g1: List[Optional[Norms]]            # per worker
    change: List[Optional[Norms]]        # per worker
    outer: Norms
    probe: Optional[Dict[str, float]] = None


def leaf_norms(a: Leaves, b: Optional[Leaves] = None) -> Norms:
    """Each leaf's f32 norm of ``a`` (less ``b`` where given)."""
    with torch.no_grad():
        vals = [torch.linalg.vector_norm(
            t.float() if b is None else t.float() - b[k].float())
            for k, t in a.items()]
        return dict(zip(a, torch.stack(vals).tolist()))


def batch_grads(m: Dense, params: Leaves, rows: torch.Tensor,
                quant: Optional[str]):
    """(mean loss, f32 mean gradient) of ``rows`` (B, S), one row at a
    time."""
    w = {k: p.float().requires_grad_(True) for k, p in params.items()}
    grads = {k: torch.zeros_like(t) for k, t in w.items()}
    loss = 0.0
    for r in rows:
        lr_ = row_loss(m, w, r, quant)
        gs = torch.autograd.grad(lr_, list(w.values()))
        with torch.no_grad():
            for g_acc, g in zip(grads.values(), gs):
                g_acc.add_(g, alpha=1.0 / len(rows))
        loss += float(lr_.detach()) / len(rows)
    return loss, grads


def _worker(inp: Inputs, x0: Leaves, steps: List[torch.Tensor],
            quant=None, half=False, frozen=False):
    """One worker's first three steps from ``x0`` -> (losses, g1,
    change); ``frozen``: each step returns its input parameters."""
    params = {k: t.clone() for k, t in x0.items()}
    opt = AdamW(params, inp.lr, inp.weight_decay)
    losses, g1 = [], None
    for rows in steps[:STEPS]:
        rows = rows[:max(1, rows.shape[0] // 2)] if half else rows
        loss, grads = batch_grads(inp.model, params, rows, quant)
        if g1 is None:
            g1 = leaf_norms(grads)
        stepped = opt.step(params, grads)
        params = params if frozen else stepped
        losses.append(loss)
        del grads, stepped
    change = leaf_norms(params, x0)
    return losses, g1, change


def _inner(inp: Inputs, x0: Leaves, quant=None, half=False, frozen=()):
    """Every worker's reading -> (losses, g1, change), each a list over
    the workers; the workers in ``frozen`` return their input."""
    runs = [_worker(inp, x0, steps, quant, half, m in frozen)
            for m, steps in enumerate(inp.steps)]
    return tuple(list(r) for r in zip(*runs))


def norm_decision(n2: float, sigma2: float, eta: float, current: int,
                  cap: int) -> int:
    """The norm test (eq 10) with monotone growth and the global cap, in
    float32 as the configuration's statistics are: ceil of sigma2 /
    (eta^2 n2) with a 1e-6 relative guard band below each integer."""
    f32 = torch.float32
    ratio = (torch.tensor(sigma2, dtype=f32)
             / (eta ** 2 * torch.clamp(torch.tensor(n2, dtype=f32),
                                       min=1e-30)))
    b = int(torch.ceil(ratio * (1.0 - 1e-6)).item())
    return int(min(max(b, current), cap))


def _probe(inp: Inputs, quant=None, half=False) -> Dict[str, float]:
    dev = inp.probe_rows.device
    w = {k: t.to(dev) for k, t in inp.workers[0].items()}
    rows = inp.probe_rows
    rows = rows[:max(2, rows.shape[0] // 2)] if half else rows
    wf = {k: t.float().requires_grad_(True) for k, t in w.items()}
    gsum = {k: torch.zeros_like(t) for k, t in wf.items()}
    s = 0.0
    for r in rows:
        gs = torch.autograd.grad(row_loss(inp.model, wf, r, quant),
                                 list(wf.values()))
        with torch.no_grad():
            for acc, g in zip(gsum.values(), gs):
                acc.add_(g)
            s += float(sum(torch.sum(torch.square(g.double()))
                           for g in gs))
    P = rows.shape[0]
    with torch.no_grad():
        n2 = float(sum(torch.sum(torch.square(g.double() / P))
                       for g in gsum.values()))
    sigma2 = max(0.0, (s - P * n2) / max(P - 1, 1))
    return {"n2": n2, "sigma2": sigma2,
            "decision": float(norm_decision(n2, sigma2, inp.eta,
                                            inp.probe_current,
                                            inp.max_global_batch)),
            "eta": inp.eta, "current": float(inp.probe_current),
            "cap": float(inp.max_global_batch)}


def _outer(inp: Inputs, x0: Leaves, workers: List[Leaves]) -> Norms:
    dev = next(iter(x0.values())).device
    ws = [{k: t.to(dev) for k, t in w.items()} for w in workers]
    return leaf_norms(nesterov_first(x0, ws, inp.lr_outer, inp.momentum), x0)


class _TF32Off:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _weights(inp: Inputs, device) -> Leaves:
    return make_weights(inp.model, inp.seed, device)


def reference(inp: Inputs, device) -> Readings:
    """The plain float32 reading."""
    with _TF32Off():
        x0 = _weights(inp, device)
        losses, g1, change = _inner(inp, x0)
        probe = _probe(inp) if inp.probe_rows is not None else None
        outer = _outer(inp, x0, inp.workers)
    return Readings(losses, g1, change, outer, probe)


def stand_in(inp: Inputs, fault: str, device,
             ref: Optional[Readings] = None) -> Readings:
    """The reference in the program's place with ``fault`` (one of
    ``FAULTS``); ``ref`` supplies the parts the fault leaves alone."""
    ref = ref or reference(inp, device)
    with _TF32Off():
        x0 = _weights(inp, device)
        if fault in ("fp8", "half_batch"):
            quant = "fp8" if fault == "fp8" else None
            half = fault == "half_batch"
            losses, g1, change = _inner(inp, x0, quant, half)
            probe = (_probe(inp, quant, half)
                     if inp.probe_rows is not None else None)
            return Readings(losses, g1, change, ref.outer, probe)
        if fault == "no_exchange":
            return replace(ref, outer=_outer(inp, x0, inp.workers[:1]))
        if fault == "one_worker_unchanged":
            last = len(inp.steps) - 1
            losses, g1, change = _inner(inp, x0, frozen=(last,))
            workers = inp.workers[:last] + [x0]
            return Readings(losses, g1, change, _outer(inp, x0, workers),
                            ref.probe)
        if fault == "decision":
            if ref.probe is None:
                raise ValueError("no probe in this cell")
            probe = dict(ref.probe, decision=2.0 * ref.probe["decision"])
            return replace(ref, probe=probe)
    raise ValueError(f"unknown fault {fault!r}")


def _worst_leaf(p: Norms, r: Norms, keep=None) -> float:
    """max over leaves of |p - r| / max(r, the median leaf's r)."""
    keys = [k for k in r if keep is None or k in keep]
    med = statistics.median(r[k] for k in keys)
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys)


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def _per_worker(gap, prog: list, ref: list) -> float:
    """The largest of ``gap(p, r, m)`` over the workers; inf where the
    program has no reading of a worker that the reference has."""
    if len(prog) != len(ref) or any(p is None for p in prog):
        return math.inf
    return max(gap(p, r, m) for m, (p, r) in enumerate(zip(prog, ref)))


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers held to a cell's limits (each 0 when both agree), each
    the largest over the workers.  Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of ``change_gap``.  ``decision_gap`` holds the program's
    decision to the norm test on the program's own statistics, which
    ``probe_gap`` holds to the reference's."""
    moved = []
    for g in ref.g1:
        med_g = statistics.median(g.values())
        moved.append({k for k, v in g.items() if v >= 1e-3 * med_g})

    def losses(p, r, m):
        if len(p) != len(r):
            return math.inf
        return max(_rel(a, b) for a, b in zip(p, r))
    out = {
        "loss_gap": _per_worker(losses, prog.losses, ref.losses),
        "grad_gap": _per_worker(lambda p, r, m: _worst_leaf(p, r),
                                prog.g1, ref.g1),
        "change_gap": _per_worker(lambda p, r, m: _worst_leaf(p, r, moved[m]),
                                  prog.change, ref.change),
        "outer_gap": _worst_leaf(prog.outer, ref.outer),
    }
    if ref.probe is not None:
        p, r = prog.probe, ref.probe
        if p is None:
            out["probe_gap"] = out["decision_gap"] = math.inf
            return out
        out["probe_gap"] = max(_rel(p["n2"], r["n2"]),
                               _rel(p["sigma2"], r["sigma2"]))
        want = norm_decision(p["n2"], p["sigma2"], r["eta"],
                             int(r["current"]), int(r["cap"]))
        out["decision_gap"] = _rel(p["decision"], want)
    return out
