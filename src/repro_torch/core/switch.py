"""SwitchMode (paper §4.2): gradient accumulation only once the requested
batch exceeds n × max_batch; in the band (max_batch, n·max_batch] keep
plain capped steps to avoid early-accumulation variance.

A logic copy of ``repro/core/switch.py`` (it imports no framework).
"""
from __future__ import annotations

import math
from typing import NamedTuple


class ExecutionPlan(NamedTuple):
    micro_batch: int        # per-step device batch
    accum_steps: int        # sequential accumulation steps
    mode: str               # "plain" | "accum"

    @property
    def effective_batch(self) -> int:
        return self.micro_batch * self.accum_steps


def plan_execution(b_req: int, max_batch: int, switch_multiplier: int,
                   *, bucket: bool = True) -> ExecutionPlan:
    """Paper Algorithm 3 lines 17–27.

    ``bucket``: round micro_batch up to a power of two and accum_steps to
    a power of two so the number of distinct step shapes stays
    logarithmic (kept so the port plans exactly what the JAX package
    plans).

    Invariant (pinned by the regression suite): the plan never consumes
    more than twice the requested batch — ``effective_batch <= 2·b_req``.
    With the current rounding this holds arithmetically: in the accum
    branch ``a = ceil(b/m) >= 2``, ``pow2(a) <= 2(a-1)`` and
    ``m·(a-1) < b``, so ``m·pow2(a) < 2b`` — though right at the switch
    boundary (b_req = n·max + 1) it lands *just* under the bound.  The
    guard below is therefore provably unreachable today; it exists so
    the bound is structural rather than an accident of that arithmetic:
    a future rounding change (e.g. bucketing the micro batch in accum
    mode too, where the factors would compound) degrades to the exact
    accum count — which always satisfies ``b_req <= m·a < b_req + m <=
    2·b_req`` — instead of silently overshooting.
    """
    b_req = max(1, int(b_req))
    if b_req > switch_multiplier * max_batch:
        accum = math.ceil(b_req / max_batch)
        if bucket:
            bucketed = 1 << (accum - 1).bit_length()
            if max_batch * bucketed <= 2 * b_req:
                accum = bucketed
        return ExecutionPlan(max_batch, accum, "accum")
    micro = min(b_req, max_batch)
    if bucket:
        micro = min(1 << (micro - 1).bit_length(), max_batch)
    return ExecutionPlan(micro, 1, "plain")
