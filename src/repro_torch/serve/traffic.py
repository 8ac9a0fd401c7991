"""Request-arrival traces for the serving scheduler and bench.

A copy of the JAX package's ``repro/serve/traffic.py`` (numpy only).
The registry mirrors the cluster scenario shapes (the JAX package's
``repro.cluster.scenarios``) as *request arrival processes* instead of
congestion processes: the same traffic patterns that stress the
training fabric stress the serving admission layer.

  steady       uniform spacing — the control arm
  bursty       groups of simultaneous arrivals every period
               (cluster ``bursty_congestion`` windows)
  diurnal      arrival rate follows a cosine "day": dense at peak,
               sparse at trough (cluster ``diurnal_congestion``)
  flash_crowd  a background trickle, then a crowd lands at one tick
               (cluster ``flash_crowd_join``)

Every trace is deterministic given (n_requests, seed): shapes come from
closed-form schedules, per-request prompt/generation lengths from a
seeded ``np.random.default_rng``.  ``make_arrivals`` returns tick-sorted
``Arrival`` specs; ``materialize`` turns them into scheduler
``Request`` objects with random token ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np


@dataclass(frozen=True)
class Arrival:
    rid: int
    tick: int
    prompt_len: int
    max_new_tokens: int


_TRACES: Dict[str, Callable[[int], List[int]]] = {}


def register(name: str):
    def deco(fn):
        _TRACES[name] = fn
        return fn
    return deco


def trace_names() -> List[str]:
    return sorted(_TRACES)


@register("steady")
def _steady(n: int) -> List[int]:
    return [2 * i for i in range(n)]


@register("bursty")
def _bursty(n: int) -> List[int]:
    burst, period = 6, 16
    return [(i // burst) * period for i in range(n)]


@register("diurnal")
def _diurnal(n: int) -> List[int]:
    # inter-arrival gap follows one cosine day over the trace: short
    # gaps at the peak (phase 0.5), long gaps at the troughs
    ticks, t = [], 0.0
    for i in range(n):
        phase = i / max(n - 1, 1)
        rate = 0.5 - 0.5 * np.cos(2.0 * np.pi * phase)   # 0 .. 1 .. 0
        ticks.append(int(t))
        t += 1.0 + 6.0 * (1.0 - rate)
    return ticks


@register("flash_crowd")
def _flash_crowd(n: int) -> List[int]:
    # a trickle of n - n//2 requests every 3 ticks; the remaining n//2
    # all land mid-trickle at once
    k = n // 2
    trickle = [3 * i for i in range(n - k)]
    crowd_tick = trickle[len(trickle) // 2] if trickle else 0
    return sorted(trickle + [crowd_tick] * k)


def make_arrivals(name: str, *, n_requests: int, seed: int = 0,
                  prompt_lo: int = 4, prompt_hi: int = 12,
                  new_lo: int = 4, new_hi: int = 10) -> List[Arrival]:
    """Tick-sorted arrival specs for a named trace (deterministic)."""
    ticks = _TRACES[name](n_requests)
    assert ticks == sorted(ticks)
    rng = np.random.default_rng(seed)
    return [Arrival(rid=i, tick=int(t),
                    prompt_len=int(rng.integers(prompt_lo, prompt_hi + 1)),
                    max_new_tokens=int(rng.integers(new_lo, new_hi + 1)))
            for i, t in enumerate(ticks)]


def materialize(arrivals: List[Arrival], vocab_size: int, *,
                seed: int = 0, temperature: float = 0.0, top_k: int = 0):
    """[(tick, Request)] with deterministic random prompt token ids."""
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(seed)
    out = []
    for a in arrivals:
        toks = rng.integers(0, vocab_size, (a.prompt_len,))
        out.append((a.tick, Request(rid=a.rid, tokens=[int(t) for t in toks],
                                    max_new_tokens=a.max_new_tokens,
                                    temperature=temperature, top_k=top_k)))
    return out
