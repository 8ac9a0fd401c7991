"""Idle device time put down to the program's spans (``bench.spans``),
on synthetic records: each gap goes to the innermost span open on the
host at its start, the idle by span sums to the window's idle exactly,
and the program's ranges leave ``bench.trace.summarize``'s reading of a
window as it is without them."""
from __future__ import annotations

import random
from types import SimpleNamespace

import pytest
import torch

from bench import spans as bspans
from bench import trace as btrace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def test_innermost_span_over_time():
    times, names = bspans.innermost([
        (0, 100, "inner"), (10, 30, "forward"), (30, 60, "backward"),
        (70, 80, "adamw"), (120, 150, "probe"), (125, 130, "stats_grads")])
    assert list(zip(times, names)) == [
        (0, "inner"), (10, "forward"), (30, "backward"), (60, "inner"),
        (70, "adamw"), (80, "inner"), (100, None), (120, "probe"),
        (125, "stats_grads"), (130, "probe"), (150, None)]


def test_gap_goes_to_the_span_open_at_its_start():
    spans = [(0, 100, "inner"), (10, 30, "forward"), (30, 60, "backward"),
             (70, 80, "adamw")]
    busy = [[12, 25], [28, 65], [75, 78], [90, 95]]
    idle = bspans.idle_by_span(busy, 0, 110, spans)
    # 0-12 inner then forward: inner at 0; 25-28 forward, running on
    # past nothing; 65-75 inner (backward closed at 60), although adamw
    # opens inside it; 78-90 adamw; 95-110 inner, to the window's end
    assert idle == {"inner": 12 + 10 + 15, "forward": 3, "adamw": 12}
    assert sum(idle.values()) == 110 - (13 + 37 + 3 + 5)


def test_no_span_before_the_first_and_after_the_last():
    idle = bspans.idle_by_span([[5, 10]], 0, 20, [(6, 9, "outer")])
    assert idle == {bspans.NO_SPAN: 5 + 10}
    idle = bspans.idle_by_span([[5, 10]], 0, 20, [(10, 12, "outer")])
    assert idle == {bspans.NO_SPAN: 5, "outer": 10}


@pytest.mark.parametrize("seed", range(5))
def test_idle_by_span_sums_to_the_window_idle(seed):
    rng = random.Random(seed)
    spans, t = [], 0
    for _ in range(40):                          # rounds of nested spans
        a = t + rng.randrange(0, 50)
        b = a + rng.randrange(1, 400)
        spans.append((a, b, "inner"))
        c = a
        while c < b:
            d = min(b, c + rng.randrange(1, 60))
            spans.append((c, d, rng.choice(["forward", "backward",
                                              "adamw"])))
            c = d + rng.randrange(0, 5)
        t = b
    dev = []
    for _ in range(3000):
        s = rng.randrange(0, t + 100)
        dev.append((s, s + rng.randrange(1, 20)))
    busy, merged = btrace._busy(dev)
    idle = bspans.idle_by_span(merged, 0, t + 200, spans)
    assert sum(idle.values()) == t + 200 - busy      # integers: exact


class Event:
    """A raw kineto record as ``bench.trace.summarize`` reads it."""

    def __init__(self, kind, name, start_us, dur_us):
        self.kind, self.n = kind, name
        self.s, self.d = int(start_us * 1000), int(dur_us * 1000)

    def device_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


# a window: the schedule's step on the host and mirrored on the device,
# host ops, kernels, a copy; then the program's ranges on the host and a
# device record mirroring one of them
WINDOW = [
    Event(CPU, "ProfilerStep#2", 0, 1000),
    Event(CUDA, "ProfilerStep#2", 5, 990),
    Event(CPU, "aten::mm", 10, 5), Event(CUDA, "gemm_kernel", 20, 100),
    Event(CPU, "cudaLaunchKernel", 11, 2),
    Event(CPU, "aten::exp", 200, 5), Event(CUDA, "exp_kernel", 300, 50),
    Event(CPU, "aten::add", 500, 5), Event(CUDA, "add_kernel", 520, 30),
    Event(CUDA, "Memcpy DtoD (Device -> Device)", 700, 40),
    Event(CPU, "aten::_local_scalar_dense", 800, 100),
]
RANGES = [
    Event(CPU, "phase/inner", 8, 600), Event(CPU, "phase/forward", 9, 190),
    Event(CPU, "phase/backward", 199, 250),
    Event(CPU, "phase/adamw", 480, 100),
    Event(CPU, "phase/outer", 690, 50),
    Event(CUDA, "phase/inner", 20, 560),
]


def test_ranges_leave_the_trace_reading_as_without_them():
    plain = btrace.summarize(prof(WINDOW), {})
    assert btrace.summarize(bspans.without_ranges(prof(WINDOW + RANGES)),
                            {}) == plain
    # kept in, the device mirror would read as busy time
    assert btrace.summarize(prof(WINDOW + RANGES), {}).busy_s > plain.busy_s


def test_window_idle_by_span_matches_the_trace_reading():
    plain = btrace.summarize(prof(WINDOW), {})
    idle, window_idle = bspans.window_idle_by_span(prof(WINDOW + RANGES))
    assert window_idle == pytest.approx(plain.window_s - plain.busy_s,
                                        abs=1e-12)
    assert sum(idle.values()) == pytest.approx(window_idle, abs=1e-12)
    # gaps (us): 0-20 none, 120-300 forward (opened at 9, closes 199),
    # 350-520 backward, 550-700 adamw, 740-1000 none (outer closed 740)
    assert idle == pytest.approx({
        bspans.NO_SPAN: (20 + 260) * 1e-6, "forward": 180e-6,
        "backward": 170e-6, "adamw": 150e-6}, abs=1e-12)
