"""Finding a cell's pieces by name.

``BENCHMARK.json`` (the checkout's root) lists the cells and metrics.
A cell ``<cell>`` is ``bench/workloads/<cell>.json``: its configuration,
its traffic mix, the chips it needs, why it exists, and the limits of
the numbers that decide ``correct``.  The configuration is
``bench/configs/<config>.json`` and the traffic mix
``bench/traffic/<traffic>.json``.  A metric ``<m>`` is read by
``bench/metrics/<m>.py``'s ``read(run)``.  A later cell, configuration,
traffic mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str]          # per-layer metrics only
    workloads: Optional[List[str]]

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict                  # bench/configs/<config>.json
    traffic: dict                 # bench/traffic/<traffic>.json
    chips: int
    why: str
    limits: Dict[str, float]      # number compared -> its limit
    end_to_end: List[Metric]      # the cell's end-to-end metrics
    per_layer: List[Metric]       # the cell's per-layer metrics


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _metrics(entries: List[dict]) -> List[Metric]:
    return [Metric(e["name"], e["unit"], e["better"], e["source"],
                   e.get("moves"), e.get("workloads")) for e in entries]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics.
    Raises ``KeyError`` when ``BENCHMARK.json`` does not list it and
    ``FileNotFoundError`` when one of its files is missing."""
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cell = _load_json(root / "bench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {cell[key]!r} in its file "
                             f"and {entry[key]!r} in BENCHMARK.json")
    e2e = [m for m in _metrics(bench["end_to_end"])
           if m.applies_to(name)]
    reported = {m.name for m in e2e}
    layer = [m for m in _metrics(bench["per_layer"])
             if (m.applies_to(name) if m.workloads is not None
                 else m.moves in reported)]
    return Cell(
        name=name,
        config=_load_json(root / "bench" / "configs" / f"{cell['config']}.json"),
        traffic=_load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json"),
        chips=int(cell["chips"]), why=cell["why"],
        limits={k: float(v) for k, v in cell["limits"].items()},
        end_to_end=e2e, per_layer=layer)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(run) -> float | None`` of ``bench/metrics/<metric>.py``,
    loaded by its path (a metric's name may hold a dot)."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
