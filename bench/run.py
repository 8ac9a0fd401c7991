"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (the port is imported from ``src/``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``card`` gives the card's name and power limit, and
``checks``, last, each number compared with its limit.  The checks are
also the last lines of standard error.  Exit 2, with no result, where
CUDA is missing or the card count is short of the cell's; exit 3 where
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded
once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# read when the CUDA allocator starts, as repro_torch.launch.train sets it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench import spec  # noqa: E402
from bench import trace as btrace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark must not
    load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"nvidia_smi": out.stdout.strip().splitlines()[:1]}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = T_START,
             root: Path = ROOT) -> dict:
    """Run ``cell`` once on ``device`` and return the result line's
    object (without ``card``)."""
    kind = importlib.import_module(f"bench.kinds.{cell.traffic['kind']}")
    res = kind.run(cell, seed, seconds, trace, device, t_start)
    run = res["run"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m.name, root)(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    dev = torch.device(device)
    out = {
        "correct": None, "attempted": res["attempted"],
        "failed": res["failed"], "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": res["peak_bytes"]},
    }
    if trace:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = btrace.breakdown(run.trace)
    checks = {k: {"value": res["numbers"][k], "limit": lim}
              for k, lim in cell.limits.items()}
    out["correct"] = all(c["value"] <= c["limit"] and math.isfinite(
        c["value"]) for c in checks.values())
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"[bench] loaded modules it must not load: {bad}",
              file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["card"] = card()
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct = {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
