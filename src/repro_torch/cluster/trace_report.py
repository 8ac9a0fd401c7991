"""CLI: summarize and validate cluster-runtime Perfetto traces.

Port of ``repro/cluster/trace_report.py``.  Reads one or more trace JSON
files produced by :meth:`repro_torch.cluster.trace.Trace.to_perfetto`
(``run_cluster(trace=)``; the JAX package's exports share the schema)
and prints, per file, the per-trainer utilization ledger (busy /
comm-blocked / idle seconds, partitioning each trainer's alive window),
the overlap fraction broken down by collective kind, and the longest
spans::

    PYTHONPATH=src python -m repro_torch.cluster.trace_report trace.json
    PYTHONPATH=src python -m repro_torch.cluster.trace_report --validate *.json

``--validate`` runs the schema check (span kinds, clock tags,
timestamps, alive windows, schema version) and exits nonzero on any
violation, so schema drift fails fast instead of silently breaking
downstream consumers.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.cluster.trace import Trace, validate_perfetto


def report(tr: Trace, *, top: int = 8, out=None) -> None:
    out = sys.stdout if out is None else out   # the stream at call time
    sim = tr.sim_spans()
    real = tr.real_spans()
    print(f"  {len(sim)} sim spans, {len(real)} real spans, "
          f"{len(tr.events)} instants, {len(tr.alive)} trainers, "
          f"end t={tr.finalized_at}", file=out)
    ledger = tr.utilization()
    print("  tid      alive_s       busy        blocked      idle",
          file=out)
    for tid, led in ledger.items():

        def pct(x: float) -> str:
            return (f"{x:9.4f} ({x / led['alive'] * 100:3.0f}%)"
                    if led["alive"] > 0 else f"{x:9.4f} (  -%)")

        print(f"  {tid:3d} {led['alive']:10.4f} {pct(led['busy'])} "
              f"{pct(led['blocked'])} {pct(led['idle'])}", file=out)
    summ = tr.utilization_summary()
    by_kind = tr.overlap_by_kind()
    kinds = ", ".join(
        f"{k}: {v['frac']:.3f} of {v['total']:.4f}s"
        for k, v in by_kind.items() if v["total"] > 0) or "none"
    print(f"  utilization={summ['utilization']:.4f} "
          f"(blocked={summ['blocked_frac']:.4f}, "
          f"idle={summ['idle_frac']:.4f})", file=out)
    print(f"  overlap_frac={tr.overlap_fraction():.4f}  [{kinds}]",
          file=out)
    if real:
        wall = sum(s.duration for s in real)
        print(f"  real wall-clock in collectives: {wall:.6f}s over "
              f"{len(real)} spans", file=out)
    longest = sorted(tr.spans, key=lambda s: -s.duration)[:top]
    print(f"  top {len(longest)} spans by duration:", file=out)
    for s in longest:
        print(f"    {s.clock:4s} {s.kind:8s} tid={s.tid:3d} "
              f"[{s.t0:.4f}, {s.t1:.4f}] {s.duration:.4f}s "
              f"{s.payload}", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", metavar="TRACE_JSON",
                    help="Perfetto trace file(s) from Trace.to_perfetto")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check every file; nonzero exit on any "
                         "violation")
    ap.add_argument("--top", type=int, default=8,
                    help="longest spans to print per file")
    args = ap.parse_args(argv)

    bad = 0
    for path in args.paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            bad += 1
            continue
        problems = validate_perfetto(data)
        if problems:
            print(f"{path}: INVALID", file=sys.stderr)
            for p in problems:
                print(f"  - {p}", file=sys.stderr)
            bad += 1
            continue
        if args.validate:
            n = sum(1 for e in data["traceEvents"]
                    if e.get("ph") in ("X", "i"))
            print(f"{path}: schema OK ({n} events)")
            continue
        print(f"{path}:")
        report(Trace.from_perfetto(data), top=args.top)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
