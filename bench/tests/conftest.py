"""Shared pieces of the benchmark's tests (run on the CPU with
``PYTHONPATH=src python -m pytest bench/tests``)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import spec  # noqa: E402

TINY = {"name": "tiny-dense", "source": "https://example.org/tiny",
        "arch_type": "dense", "num_layers": 2, "d_model": 64,
        "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "vocab_size": 256,
        "rope_theta": 10000.0, "rms_eps": 1e-5, "dtype": "float32",
        "nodes_per_gpu": 2, "b_max": 2}
# limits of the tiny float32 cell: the reference and the port agree to
# about 1e-6 there (f32 on both sides); each fault reads 1e-2 or more
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
               "outer_gap": 1e-3, "probe_gap": 1e-3, "decision_gap": 0.0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def add_tiny_cell(root: Path, traffic: str = "adloco",
                  name: str = "tiny-dense.adloco") -> spec.Cell:
    """Add a tiny float32 cell to the checkout at ``root`` as new files
    and new ``BENCHMARK.json`` entries: a configuration, a traffic mix
    (the named one at 32 tokens and 16 rows) and the cell."""
    b = root / "bench"
    (b / "configs" / "tiny-dense.json").write_text(json.dumps(TINY))
    mix = json.loads((b / "traffic" / f"{traffic}.json").read_text())
    mix.update(seq_len=32, pool_rows=16)
    (b / "traffic" / f"tiny-{traffic}.json").write_text(json.dumps(mix))
    limits = {k: v for k, v in TINY_LIMITS.items()
              if mix["adloco"]["adaptive"] or k not in ("probe_gap",
                                                        "decision_gap")}
    entry = {"config": "tiny-dense", "traffic": f"tiny-{traffic}",
             "chips": 1, "why": "a tiny CPU cell"}
    (b / "workloads" / f"{name}.json").write_text(
        json.dumps(dict(entry, limits=limits)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense", "source": TINY["source"],
                             "file": "bench/configs/tiny-dense.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append(dict(entry, name=name))
    probe_only = {"probe_ms_per_round", "gradstats_roofline"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] not in probe_only:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.load_cell(name, root)


@pytest.fixture
def checkout(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path
