"""Every piece is found by name; a cell added as new files runs with no
existing file edited; the result line has the driver's keys."""
from __future__ import annotations

import hashlib
import json
import re

import pytest

from bench import spec
from bench import trace as btrace
from bench.record import Trace
from bench.run import run_cell
from conftest import ROOT, add_tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == {w["name"]: w for w in
                                BENCH["workloads"]}[cell]["config"]
    assert {m.name for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer and len(c.end_to_end) >= 2
    assert set(c.limits) >= {"loss_gap", "grad_gap", "change_gap"}
    assert (ROOT / "bench" / "kinds" / f"{c.traffic['kind']}.py").exists()


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    f = json.loads((ROOT / entry["file"]).read_text())
    assert f["name"] == config and f["source"] == entry["source"]
    assert f["reduced"] == entry["reduced"]
    for key in ("assumed", "deployment", "b_max", "changed"):
        assert key in f
    assert set(f["reduced"]) <= set(f["changed"])


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_runs_as_new_files_only(checkout):
    before = _digest(checkout / "bench")
    cell = add_tiny_cell(checkout)
    after = _digest(checkout / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
    out = run_cell(cell, 2 ** 31 + 7, 0.2, False, device="cpu",
                   root=checkout)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_line_has_breakdown(checkout, monkeypatch):
    cell = add_tiny_cell(checkout, "diloco", "tiny-dense.diloco")
    fake = Trace(window_s=2.0, busy_s=1.5, kernels=30,
                 by_name={"k1": (1.0, 10), "k2": (0.5, 20)},
                 idle_by_host={"aten::item": 0.5})
    monkeypatch.setattr(btrace, "record", lambda fn: (None, fn()))
    monkeypatch.setattr(btrace, "summarize", lambda prof, launched: fake)
    out = run_cell(cell, 5, 0.2, True, device="cpu", root=checkout)
    assert list(out)[:5] == KEYS and list(out)[5:] == ["breakdown",
                                                       "checks"]
    assert out["device"]["busy_s"] == 1.5 and out["device"]["window_s"] == 2.0
    assert out["breakdown"]["device_ops"][0] == ["k1", 1.0]
    assert out["breakdown"]["idle_gaps"] == [["aten::item", 0.5]]
    assert out["metrics"]["device_idle_share"]["value"] == pytest.approx(25.0)
    assert "probe_ms_per_round" not in out["metrics"]


def test_metric_without_workloads_follows_its_moves(checkout):
    """A per-layer metric with no ``workloads`` key is reported in every
    cell that reports the end-to-end metric it moves, and nowhere else."""
    add_tiny_cell(checkout)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    for name, moves in (("every_train_cell", "train_tokens_per_s"),
                        ("no_train_cell", "serve_tokens_per_s")):
        bench["per_layer"].append({"name": name, "unit": "ms",
                                   "better": "lower",
                                   "source": "program_span", "layer": "x",
                                   "moves": moves})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    names = {m.name for m in
             spec.load_cell("tiny-dense.adloco", checkout).per_layer}
    assert "every_train_cell" in names and "no_train_cell" not in names
