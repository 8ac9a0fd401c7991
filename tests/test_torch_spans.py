"""The spans of ``TrainerRound``'s ``PhaseClock`` on the CPU.

One round of M = 2 workers x H = 3 AdamW steps on a least-squares loss:
every step opens ``forward``, ``backward`` and ``adamw`` under
``inner``; the adaptive round's ``probe`` holds ``stats_grads`` and
``stats_reduce``, and its batch-1 passes open no ``forward``; an
accumulation plan opens one ``forward`` per micro-batch.  The spans
change no number: the workers' losses, parameters and AdamW states are
bitwise those of the same steps run without them.  The allocator's
counters (CUDA only) are checked against a scripted allocator.
"""
import copy

import pytest
import torch

from test_torch_lm import one_torch_thread  # noqa: F401
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core.adloco import PhaseClock, TrainerRound
from repro_torch.core.diloco import make_inner_step, reshape_for_plan

M, H, DIM = 2, 3, 8
ACFG = dict(num_inner_steps=H, nodes_per_gpu=M, num_init_trainers=1,
            initial_batch_size=4, max_batch=4, stats_probe_size=4,
            lr_inner=1e-2, enable_merge=False, inner_optimizer="adamw")
# a fixed batch of 8 at b_max 4: two micro-batches a step
ACCUM = dict(adaptive=False, initial_batch_size=8, switch_multiplier=1)


def loss_fn(params, batch):
    r = batch["A"] @ params["x"] - batch["y"]
    return 0.5 * torch.mean(torch.square(r)), {}


class Stream:
    def __init__(self, shard):
        self.g = torch.Generator().manual_seed(1000 + shard)

    def next_batch(self, b):
        return {"A": torch.randn(b, DIM, generator=self.g),
                "y": torch.randn(b, generator=self.g)}


def x0():
    return {"x": torch.linspace(-1.0, 1.0, DIM)}


def one_round(**kw):
    rnd = TrainerRound(loss_fn, AdLoCoConfig(**dict(ACFG, **kw)))
    tr = rnd.init_pool([x0()], [Stream(m) for m in range(M)]).trainers[0]
    out = rnd.inner(tr, round_i=1)
    return rnd, tr, out, rnd.clock.collect()


def test_adaptive_round_spans():
    rnd, _, _, rec = one_round()
    assert rec == {}                                   # CPU: no times
    assert rec.counts == {"inner": 1, "forward": M * H, "backward": M * H,
                          "adamw": M * H, "probe": 1, "stats_grads": 1,
                          "stats_reduce": 1}
    assert rec.parents == {"inner": None, "forward": "inner",
                           "backward": "inner", "adamw": "inner",
                           "probe": None, "stats_grads": "probe",
                           "stats_reduce": "probe"}
    # the probe ran 4 batch-1 passes, none of them counted as forward
    assert rnd.probes == [[4, 4, 1]]
    assert rec.alloc_retries == {} and rec.peak_span is None
    assert rnd.clock.collect().counts == {}           # collect drains


def test_accumulation_plan_opens_a_forward_per_micro_batch():
    _, _, out, rec = one_round(**ACCUM)
    assert out.mode == "accum"
    assert rec.counts == {"inner": 1, "forward": 2 * M * H,
                          "backward": 2 * M * H, "adamw": M * H}
    assert "probe" not in rec.parents


@pytest.mark.parametrize("kw", [{}, ACCUM], ids=["plain", "accum"])
def test_spans_change_no_number(kw):
    rnd, tr, out, _ = one_round(**kw)
    plan = rnd.protocol.plan_for(rnd.acfg.initial_batch_size)
    step = make_inner_step(loss_fn, rnd.inner_opt, plan.accum_steps)
    losses = []
    for m in range(M):
        stream, wp = Stream(m), x0()
        opt = rnd.inner_opt.init(wp)
        for _ in range(H):
            batch = reshape_for_plan(
                stream.next_batch(plan.effective_batch), plan)
            wp, opt, loss, _ = step(wp, opt, batch)
        losses.append(float(loss))
        assert torch.equal(out.worker_params[m]["x"], wp["x"])
        for k in ("m", "v"):
            assert torch.equal(tr.inner_opt_states[m][k]["x"], opt[k]["x"])
    assert out.mean_loss == sum(losses) / len(losses)


class FakeEvent:
    """A CUDA event off the card: ``elapsed_time`` counts the records
    between two events, in ms."""
    clock = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_allocator_counters_go_to_the_innermost_span(monkeypatch):
    stats = {"num_alloc_retries": 0,
             "allocated_bytes": {"all": {"current": 100, "peak": 100}}}
    now = stats["allocated_bytes"]["all"]

    def alloc(n, retries=0):
        now["current"] += n
        now["peak"] = max(now["peak"], now["current"])
        stats["num_alloc_retries"] += retries

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device: copy.deepcopy(stats))
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    clock, dev = PhaseClock(), torch.device("cuda")

    def step(peak_in):
        clock.note_resident(dev)
        with clock.span("forward", dev):
            alloc(10)
        with clock.span("backward", dev):
            alloc(50 if peak_in == "backward" else 20, retries=2)
            alloc(-(50 if peak_in == "backward" else 20))
        with clock.span("adamw", dev):
            alloc(60 if peak_in == "adamw" else 30, retries=1)
            alloc(-(60 if peak_in == "adamw" else 30) - 10)

    with clock.span("inner", dev):
        step("backward")
        alloc(7)                                       # between steps
        step("backward")
    rec = clock.collect()
    assert set(rec) == {"inner", "forward", "backward", "adamw"}
    assert rec["forward"] > 0 and rec["inner"] > rec["forward"]
    assert rec.alloc_retries == {"forward": 0, "backward": 4, "adamw": 2,
                                 "inner": 6}
    assert rec.resident_bytes == 107
    assert (rec.peak_bytes, rec.peak_span) == (167, "backward")

    # the benchmark resets the peak between rounds: the next round's
    # highest peak is put down again, here to adamw
    now["peak"] = now["current"]
    with clock.span("inner", dev):
        step("adamw")
    rec = clock.collect()
    assert (rec.peak_bytes, rec.peak_span) == (177, "adamw")
    assert rec.alloc_retries["adamw"] == 1

    # a round whose peak does not rise names no span
    with clock.span("inner", dev):
        step("backward")
    rec = clock.collect()
    assert (rec.peak_bytes, rec.peak_span) == (0, None)
