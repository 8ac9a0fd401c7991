"""Readings that set a cell's limits, and the sizing of ``b_max``.

Run on the card, from the root of a checkout; not part of a run::

    python3 -m bench.control readings --workload <cell> --seeds 1,2,3 --faults 3
    python3 -m bench.control size --workload <cell> --batches 1,2,4

``readings``: for each seed, the cell's set-up (round 1 of the program,
as a run makes it) and the reference, then the numbers the run compares
(``program``); for the first ``--faults`` seeds also the numbers of the
reference put in the program's place in float8 (``fp8``, the control)
and with each fault (``half_batch``, ``no_exchange``, ``decision``,
``one_worker_unchanged``; a step that returns its state unchanged reads
1 by the measure).  One JSON line per seed and side.

``size``: for each seed and micro batch b, in a process of its own, the
cell's trainer at b_max = b through rounds until one that accumulates
(or three) has run; prints the peak of ``torch.cuda.max_memory_allocated``
and each round's plan, probes, requested batch after it and seconds, or
the out-of-memory error.  ``--initial-x`` sets the first requested batch
in multiples of b, so that a sizing run reaches switch mode's
accumulating rounds.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench import spec  # noqa: E402
from bench.kinds.train import Trainer  # noqa: E402
from bench.reference import train as ref  # noqa: E402


def readings(cell: spec.Cell, seeds, faults: int, device="cuda") -> list:
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        tn = Trainer(cell, seed, device)
        prog, inputs = tn.round1()
        tn.free()
        base = ref.reference(inputs, device)
        sides = {"program": prog}
        if i < faults:
            for f in ref.FAULTS:
                if f == "decision" and base.probe is None:
                    continue
                sides[f] = ref.stand_in(inputs, f, device, base)
        for side, rd in sides.items():
            row = {"cell": cell.name, "seed": seed, "side": side,
                   "numbers": ref.compare(rd, base),
                   "losses": rd.losses, "probe": rd.probe,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del tn, inputs, base, sides
        torch.cuda.empty_cache()
    return rows


def size_one(name: str, b: int, seed: int, initial_x=None) -> dict:
    cell = spec.load_cell(name)
    cfg = dict(cell.config, b_max=b)
    traffic = cell.traffic
    if initial_x is not None:
        traffic = dict(traffic, batch=dict(traffic["batch"],
                                           initial_x=initial_x))
    tn = Trainer(replace(cell, config=cfg, traffic=traffic), seed, "cuda")
    torch.cuda.reset_peak_memory_stats()
    out = {"cell": cell.name, "b": b, "rounds": []}
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            r = tn.round()
            torch.cuda.synchronize()
            out["rounds"].append([r.mode, r.samples, r.probes,
                                  tn.tr.requested_batch,
                                  time.perf_counter() - t0])
            if r.mode == "accum":
                break
    except torch.cuda.OutOfMemoryError as e:
        out["oom"] = str(e).splitlines()[0]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("readings", "size"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--batches", default="1,2,4")
    ap.add_argument("--initial-x", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "readings":
        readings(cell, seeds, args.faults)
        return 0
    spawn = multiprocessing.get_context("spawn")
    for seed in seeds:
        for b in args.batches.split(","):
            # a process of its own, so that one size's peak and
            # out-of-memory leave the next untouched
            with ProcessPoolExecutor(1, mp_context=spawn) as ex:
                got = ex.submit(size_one, cell.name, int(b), seed,
                                args.initial_x).result()
            print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
