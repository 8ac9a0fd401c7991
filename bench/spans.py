"""Idle device time put down to the program's spans, in a traced window.

The port's ``PhaseClock`` opens each span as a host range
``RANGE_PREFIX + name`` on the profiler's clock.
``idle_by_span`` gives each idle gap of the device to the innermost such
range open on the host at the gap's start, or to ``(no span)``: the
gaps are ``bench.trace``'s (the device records' union over the window),
so the idle by span sums to the window's idle.  ``without_ranges`` is a
window's records less the program's ranges, on which
``bench.trace.summarize`` reads what it reads of a program that opens
none.

    python3 -m bench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and a traced window as ``bench.run --trace 1``
does (no check) and prints one JSON line: per round the spans' device
ms, counts, parents and allocator counters (``PhaseRecord``), the
round's retries, and over the window ``bench.trace``'s reading with and
without the ranges and the idle by span.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
# as bench.run: read when the CUDA allocator starts
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench import spec  # noqa: E402
from bench import trace as btrace  # noqa: E402
from bench.kinds import train as ktrain  # noqa: E402
from repro_torch.core.adloco import PhaseClock  # noqa: E402
from repro_torch.kernels.gradstats import ops as gradstats_ops  # noqa: E402

RANGE_PREFIX = PhaseClock.RANGE_PREFIX
NO_SPAN = "(no span)"

Interval = Tuple[float, float]


def innermost(spans: Iterable[Tuple[float, float, str]]
              ) -> Tuple[List[float], List[Optional[str]]]:
    """(times, names): from ``times[i]`` on, ``names[i]`` is the
    innermost open span (None: none), for spans (start, end, name) that
    nest, as one host thread's do."""
    times: List[float] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[float, str]] = []

    def at(t, name):
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            at(end, stack[-1][1] if stack else None)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        stack.append((e, name))
        at(s, name)
    close_until(float("inf"))
    return times, names


def idle_by_span(busy: List[Interval], start: float, end: float,
                 spans: Iterable[Tuple[float, float, str]]
                 ) -> Dict[str, float]:
    """Idle time of the window [start, end] outside the merged, sorted
    ``busy`` intervals, by the innermost of ``spans`` open at each gap's
    start (``NO_SPAN`` where none is), in the intervals' unit."""
    times, names = innermost(spans)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    out: Dict[str, float] = {}
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        i = bisect.bisect_right(times, gs) - 1
        name = names[i] if i >= 0 and names[i] is not None else NO_SPAN
        out[name] = out.get(name, 0.0) + (ge - gs)
    return out


def without_ranges(prof):
    """``prof`` as ``bench.trace.summarize`` reads it, less the
    program's ranges (on the host, and on the device if mirrored)."""
    kept = [e for e in prof.profiler.kineto_results.events()
            if not e.name().startswith(RANGE_PREFIX)]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: kept)))


def window_idle_by_span(prof) -> Tuple[Dict[str, float], float]:
    """(idle seconds by span, the window's idle seconds), with
    ``bench.trace.summarize``'s window and device intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns() * 1e-3
        rec = (s, s + e.duration_ns() * 1e-3)
        if e.device_type() == cuda:
            if not name.startswith((btrace.STEP_ANNOTATION, RANGE_PREFIX)):
                dev.append(rec)
        else:
            host.append(rec)
            if name.startswith(RANGE_PREFIX):
                spans.append(rec + (name[len(RANGE_PREFIX):],))
    busy, merged = btrace._busy(dev)
    start = min([s for s, _ in host] + [merged[0][0]])
    end = max([e for _, e in host] + [merged[-1][1]])
    idle = idle_by_span(merged, start, end, spans)
    return ({k: v * 1e-6 for k, v in idle.items()},
            (end - start - busy) * 1e-6)


def _trace_fields(tr) -> dict:
    return {"window_s": tr.window_s, "busy_s": tr.busy_s,
            "idle_share": 1.0 - tr.busy_s / tr.window_s,
            "kernels": tr.kernels, "breakdown": btrace.breakdown(tr)}


def _round(r) -> dict:
    rec = r.phase_ms
    return {"mode": r.mode, "samples": r.samples, "seconds": r.seconds,
            "alloc_retries": r.alloc.get("num_alloc_retries"),
            "phase_ms": dict(rec),
            "counts": getattr(rec, "counts", None),
            "parents": getattr(rec, "parents", None),
            "span_retries": getattr(rec, "alloc_retries", None),
            "resident_bytes": getattr(rec, "resident_bytes", None),
            "peak": [getattr(rec, "peak_bytes", None),
                     getattr(rec, "peak_span", None)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[spans] needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    tn = ktrain.Trainer(cell, args.seed, "cuda")
    tn.round1()

    def window():
        rounds = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds or not rounds:
            rounds.append(tn.round())
        torch.cuda.synchronize()
        return rounds

    launched0 = (gradstats_ops.colsum_launches,
                 gradstats_ops.moments_launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof, rounds = btrace.record(window)
    peak = torch.cuda.max_memory_allocated()
    launches = {"colsum": gradstats_ops.colsum_launches - launched0[0],
                "moments": gradstats_ops.moments_launches - launched0[1]}
    idle, window_idle = window_idle_by_span(prof)
    out = {
        "cell": cell.name, "seed": args.seed,
        "card": torch.cuda.get_device_name(0),
        "window_peak_bytes": peak,
        "rounds": [_round(r) for r in rounds],
        "trace": _trace_fields(btrace.summarize(prof, launches)),
        "trace_without_ranges": _trace_fields(
            btrace.summarize(without_ranges(prof), launches)),
        "idle_by_span_s": idle, "window_idle_s": window_idle,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
