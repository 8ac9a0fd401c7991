"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``run_cell`` on the CPU, a tiny float32 cell added as new files)
with one fault planted in the port: a step that returns its state
unchanged, the same for the last worker alone, half of the batch left
out (the mean over the rest), the exchange of the workers' parameters
left out of the outer step, and the probe's answer altered where it is
produced.  The unbroken run is
correct.  The control, the reference in float8 in the program's place,
fails a tiny bfloat16 cell's numbers where the program passes them.
"""
from __future__ import annotations

import pytest

import repro_torch.core.adloco as adloco
import repro_torch.core.batching as batching
import repro_torch.core.diloco as diloco
from bench.kinds import train as ktrain
from bench.reference import train as rtrain
from bench.run import run_cell
from conftest import add_tiny_cell


def _unchanged(monkeypatch, cell, last_only=False):
    """Each step (``last_only``: the last worker's steps alone) returns
    its input parameters.  The trainer runs its workers one after
    another, H steps each."""
    make = diloco.make_inner_step
    H = int(cell.traffic["inner_steps"])
    M = int(cell.config["nodes_per_gpu"])

    def make_inner_step(loss_fn, inner_opt, accum_steps):
        step = make(loss_fn, inner_opt, accum_steps)
        calls = [0]

        def broken(params, opt_state, batch):
            calls[0] += 1
            out = step(params, opt_state, batch)
            if last_only and (calls[0] - 1) // H % M != M - 1:
                return out
            _, st, loss, grads = out
            return params, st, loss, grads
        return broken
    monkeypatch.setattr(diloco, "make_inner_step", make_inner_step)


def _one_worker_unchanged(monkeypatch, cell):
    _unchanged(monkeypatch, cell, last_only=True)


def _half_batch(monkeypatch, cell):
    build = ktrain.build_loss_fn

    def build_loss_fn(cfg):
        loss = build(cfg)

        def broken(params, batch):
            t = batch["tokens"]
            return loss(params, {"tokens": t[:max(1, t.shape[0] // 2)]})
        return broken
    monkeypatch.setattr(ktrain, "build_loss_fn", build_loss_fn)


def _no_exchange(monkeypatch, cell):
    stack = adloco.stack_params
    monkeypatch.setattr(adloco, "stack_params",
                        lambda ws: stack([ws[0]] * len(ws)))


def _answer(monkeypatch, cell):
    decide = batching.requested_batch
    monkeypatch.setattr(batching, "requested_batch",
                        lambda st, acfg, b: 2 * decide(st, acfg, b))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "answer": _answer,
          "one_worker_unchanged": _one_worker_unchanged}


def test_unbroken_run_is_correct(checkout):
    cell = add_tiny_cell(checkout)
    out = run_cell(cell, 11, 0.2, False, device="cpu", root=checkout)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(checkout, monkeypatch, fault):
    cell = add_tiny_cell(checkout)
    FAULTS[fault](monkeypatch, cell)
    out = run_cell(cell, 11, 0.2, False, device="cpu", root=checkout)
    assert out["correct"] is False, out["checks"]


def test_fp8_control_fails_where_the_program_passes(checkout):
    """Tiny bfloat16 cell, limits between the program's readings and the
    control's on these seeds (program: loss gap about 2e-4, gradient gap
    about 3e-3; control: about 4e-3 and 2.5e-2)."""
    cell = add_tiny_cell(checkout)
    cell = ktrain.Cell(**{**cell.__dict__,
                          "config": dict(cell.config, dtype="bfloat16")})
    limits = {"loss_gap": 1.5e-3, "grad_gap": 1e-2}
    for seed in (3, 4, 5):
        tn = ktrain.Trainer(cell, seed, "cpu")
        prog, inputs = tn.round1()
        tn.free()
        ref = rtrain.reference(inputs, "cpu")
        ctrl = rtrain.stand_in(inputs, "fp8", "cpu", ref)
        p, c = rtrain.compare(prog, ref), rtrain.compare(ctrl, ref)
        assert all(p[k] <= v for k, v in limits.items()), p
        assert any(c[k] > v for k, v in limits.items()), c
