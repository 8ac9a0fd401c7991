"""The device trace of a measured window (``torch.profiler``).

The arithmetic is a copy of ``repro_torch.launch.profile``'s: busy
time is the union of the device records' intervals, the idle share is
one less busy over the window, and the session's schedule records a
discarded warm-up step first (a session that records from its start
loses its first kernels' device records).  A trace that holds no
device kernel, or fewer of the gradstats kernels than their wrapper's
launch counters counted, raises: its device time cannot be read, and
there is no fallback to the host's clock.

Each idle gap is put down to the host op that started last before it
(CUDA runtime calls skipped), the breakdown's ``idle_gaps``.
"""
from __future__ import annotations

import bisect
import re
import sys
import time
from typing import Callable, Dict, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from bench.record import Trace

# the schedule's step range, mirrored on the device timeline: not an op
STEP_ANNOTATION = "ProfilerStep"
GRADSTATS = {"colsum": re.compile(r"\bcolsum_kernel\b"),
             "moments": re.compile(r"\bmoments_kernel\b")}
GRADSTATS_ALL = re.compile(r"\b(colsum_kernel|moments_kernel|finish_kernel)\b")
_NOT_KERNEL = ("Memcpy", "Memset")
_RUNTIME = ("cuda", "cu")


def record(fn: Callable) -> Tuple[torch.profiler.profile, object]:
    """Run ``fn`` under the profiler after a discarded warm-up step."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=acts, schedule=sched) as prof:
        a = torch.ones((256, 256), device="cuda")
        for _ in range(4):
            a = a @ a * 0.5
        torch.cuda.synchronize()
        prof.step()
        result = fn()
        torch.cuda.synchronize()
        prof.step()
    return prof, result


def _busy(intervals) -> Tuple[float, list]:
    """Union length of ``intervals`` and the merged intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(prof, launched: Dict[str, int]) -> Trace:
    """The traced window's busy and idle time, device ops by name and
    idle time by host op.  Raises ``RuntimeError`` on a trace without
    device kernels or short of the gradstats launches counted."""
    t0 = time.perf_counter()
    dev, host = [], []
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # the raw records: ``prof.events()`` builds each op's tree of children,
    # minutes for the records of a window of training
    for e in prof.profiler.kineto_results.events():
        kind, name = e.device_type(), e.name()
        start = e.start_ns() * 1e-3
        rec = (start, start + e.duration_ns() * 1e-3, name)
        if kind == cuda:
            if not name.startswith(STEP_ANNOTATION):
                dev.append(rec)
        elif kind == cpu:
            host.append(rec)
    kernels = [d for d in dev if not d[2].startswith(_NOT_KERNEL)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel; the "
                           "window's device time cannot be read")
    seen = {k: sum(1 for d in kernels if pat.search(d[2]))
            for k, pat in GRADSTATS.items()}
    short = {k: (seen[k], n) for k, n in launched.items() if seen[k] < n}
    if short:
        raise RuntimeError(f"the trace misses gradstats launches (seen, "
                           f"counted): {short}")
    busy, merged = _busy([(s, e) for s, e, _ in dev])
    start = min([s for s, _, _ in host] + [merged[0][0]])
    end = max([e for _, e, _ in host] + [merged[-1][1]])
    by_name: Dict[str, Tuple[float, int]] = {}
    for s, e, name in dev:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s) * 1e-6, n + 1)
    ops = sorted((s, name) for s, _, name in host
                 if not name.startswith(_RUNTIME)
                 and not name.startswith(STEP_ANNOTATION))
    starts = [s for s, _ in ops]
    idle: Dict[str, float] = {}
    edges = [start] + [x for iv in merged for x in iv] + [end]
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        i = bisect.bisect_right(starts, gs) - 1
        label = ops[i][1] if i >= 0 else "(before the first host op)"
        idle[label] = idle.get(label, 0.0) + (ge - gs) * 1e-6
    print(f"[bench] trace: {len(dev)} device and {len(host)} host records "
          f"read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return Trace(window_s=(end - start) * 1e-6, busy_s=busy * 1e-6,
                 kernels=len(kernels), by_name=by_name, idle_by_host=idle)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The ten device ops with most time and the ten host ops under
    which the device sat idle longest, each [name, seconds]."""
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], t] for n, (t, _) in ops],
            "idle_gaps": [[n[:160], t] for n, t in gaps]}
