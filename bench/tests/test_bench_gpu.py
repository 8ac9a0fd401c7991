"""The control at a cell's own size, on the card (``gpu`` marker; skips
without one).  Runs the cell's set-up for one seed, the reference, and
the reference in float8 in the program's place: the program passes the
cell's limits and the control fails one of them.  Several minutes a
cell::

    PYTHONPATH=src python -m pytest -m gpu bench/tests/test_bench_gpu.py
"""
from __future__ import annotations

import json

import pytest
import torch

from bench import control, spec
from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.load_cell(cell)
    rows = {r["side"]: r["numbers"]
            for r in control.readings(c, [2 ** 31 + 101], 1)}

    def passes(numbers):
        return all(numbers[k] <= v for k, v in c.limits.items())
    assert passes(rows["program"]), rows["program"]
    assert not passes(rows["fp8"]), rows["fp8"]
    assert not any(passes(rows[f]) for f in rows if f != "program")
