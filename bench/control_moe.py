"""Readings that set a DeepSeek-V2 cell's limits, and the sizing of
``b_max``: ``bench.control`` for the ``train_moe`` kind.

Run on the card, from the root of a checkout; not part of a run::

    python3 -m bench.control_moe readings --workload <cell> --seeds 1 --faults 1
    python3 -m bench.control_moe size --workload <cell> --batches 8,16

``readings``: for each seed, the cell's set-up (round 1 of the program,
as a run makes it) and the reference, then the numbers the run compares
(``program``); for the first ``--faults`` seeds also the numbers of the
float8 control (``fp8``) and of each fault in the program's place
(``half_batch``, ``no_exchange``, ``one_worker_unchanged``).  One JSON
line per seed and side.

``size``: for each micro batch b, in a process of its own, the cell's
trainer at b_max = b through two rounds; prints the peak of
``torch.cuda.max_memory_allocated``, each round's seconds and the
allocator's retries, and the MoE layers' assignments, or the
out-of-memory error.
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
from bench.kinds.train_moe import Trainer  # noqa: E402
from bench.reference import moe_train as ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402


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
            sides.update((f, ref.stand_in(inputs, f, device, base))
                         for f in ref.FAULTS)
        for side, rd in sides.items():
            row = {"cell": cell.name, "seed": seed, "side": side,
                   "numbers": ref.compare(rd, base), "losses": rd.losses,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del tn, inputs, base, sides
        torch.cuda.empty_cache()
    return rows


def size_one(name: str, b: int, seed: int) -> dict:
    cell = spec.load_cell(name)
    tn = Trainer(replace(cell, config=dict(cell.config, b_max=b)), seed,
                 "cuda")
    torch.cuda.reset_peak_memory_stats()
    layers.reset_moe_counts()
    out = {"cell": cell.name, "b": b, "rounds": []}
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            r = tn.round()
            torch.cuda.synchronize()
            out["rounds"].append([r.mode, r.samples,
                                  time.perf_counter() - t0, r.alloc])
    except torch.cuda.OutOfMemoryError as e:
        out["oom"] = str(e).splitlines()[0]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["moe"] = layers.moe_counts()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("readings", "size"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--batches", default="8,16")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "readings":
        readings(cell, seeds, args.faults)
        return 0
    spawn = multiprocessing.get_context("spawn")
    for b in args.batches.split(","):
        # a process of its own, so that one size's peak and out-of-memory
        # leave the next untouched
        with ProcessPoolExecutor(1, mp_context=spawn) as ex:
            got = ex.submit(size_one, cell.name, int(b), seeds[0]).result()
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
