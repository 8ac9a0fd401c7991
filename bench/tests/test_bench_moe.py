"""The ``train_moe`` kind on a tiny float32 DeepSeek-V2 cell on the CPU
(3 layers with the first dense, d 64, 8 experts top-2 with 4 held and 1
shared), added as new files: a
sound run reads under the limits; each fault planted in the port reads
above them; the control, the
reference in float8 in the program's place, fails a tiny bfloat16
cell's numbers where the program passes them.  The weights are the
port's training dict, the spans ``mla`` and ``moe`` open inside
``forward`` and ``backward``, and the window counts each token's
assignments once.
"""
from __future__ import annotations

import json

import pytest

import repro_torch.core.adloco as adloco
from bench import spec
from bench.kinds import train_moe as kmoe
from bench.reference import moe_train as rmoe
from bench.reference.moe_weights import LatentMoE, make_weights
from bench.run import run_cell
from conftest import ROOT
from repro_torch import models
from repro_torch.models import lm
from test_bench_faults import FAULTS as DENSE_FAULTS

TINY = {"name": "tiny-v2", "hidden_size": 64, "intermediate_size": 96,
        "kv_lora_rank": 32, "moe_intermediate_size": 32,
        "n_routed_experts": 8, "n_shared_experts": 1,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "num_experts_per_tok": 2, "num_hidden_layers": 3,
        "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 16,
        "vocab_size": 256, "experts_held": 4, "dtype": "float32",
        "b_max": 2}
# the tiny float32 cell: reference and port agree to about 1e-5 (f32 on
# both sides); each fault reads 1e-2 or more
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
          "outer_gap": 1e-3}
NAME = "tiny-v2.moe"


def add_tiny_moe_cell(root, dtype="float32") -> spec.Cell:
    """The cell as new files and new ``BENCHMARK.json`` entries; its
    configuration is DeepSeek-V2-Lite's file at tiny sizes."""
    b = root / "bench"
    cfg = json.loads((b / "configs" / "deepseek-v2-lite.json").read_text())
    cfg.update(TINY, dtype=dtype)
    (b / "configs" / "tiny-v2.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "diloco_moe.json").read_text())
    mix.update(seq_len=32, pool_rows=16)
    (b / "traffic" / "tiny-moe.json").write_text(json.dumps(mix))
    entry = {"config": "tiny-v2", "traffic": "tiny-moe", "chips": 1,
             "why": "a tiny CPU cell"}
    (b / "workloads" / f"{NAME}.json").write_text(
        json.dumps(dict(entry, limits=LIMITS)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-v2", "source": "x",
                             "file": "bench/configs/tiny-v2.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append(dict(entry, name=NAME))
    for m in bench["per_layer"]:
        if "deepseek-v2-lite.diloco_moe" in m.get("workloads", ()):
            m["workloads"].append(NAME)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.load_cell(NAME, root)


def test_weights_are_the_ports_training_dict():
    m = LatentMoE.of(dict(json.loads(
        (ROOT / "bench/configs/deepseek-v2-lite.json").read_text()), **TINY))
    cfg = kmoe.model_config(m, "tiny-v2")
    want = lm.param_dict(models.init_params(cfg, 0, device="cpu"))
    got = make_weights(m, 5, "cpu")
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype ==
               want[k].dtype for k in want)
    assert m.param_count() == cfg.param_count()


def test_rope_scaling_runs_only_where_rope_stays_plain():
    """The file keeps the source's YaRN group at factor 1, which is plain
    RoPE; the source's own factor 40 is refused, not run as plain."""
    c = json.loads((ROOT / "bench/configs/deepseek-v2-lite.json").read_text())
    assert c["rope_scaling"] == dict(c["published"]["rope_scaling"], factor=1)
    assert LatentMoE.of(c).rope_theta == 1e4
    assert LatentMoE.of(dict(c, rope_scaling=None)).rope_theta == 1e4
    with pytest.raises(ValueError, match="rope_scaling"):
        LatentMoE.of(dict(c, rope_scaling=c["published"]["rope_scaling"]))


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12])
def test_unbroken_run_is_correct(checkout, seed):
    cell = add_tiny_moe_cell(checkout)
    out = run_cell(cell, seed, 0.2, False, device="cpu", root=checkout)
    assert out["correct"] is True, out["checks"]


FAULTS = {k: DENSE_FAULTS[k] for k in ("unchanged", "no_exchange",
                                       "one_worker_unchanged")}


def _half_batch(monkeypatch, cell):
    build = kmoe.build_loss_fn

    def build_loss_fn(cfg, **kw):
        loss = build(cfg, **kw)

        def broken(params, batch):
            t = batch["tokens"]
            return loss(params, {"tokens": t[:max(1, t.shape[0] // 2)]})
        return broken
    monkeypatch.setattr(kmoe, "build_loss_fn", build_loss_fn)


FAULTS["half_batch"] = _half_batch


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(checkout, monkeypatch, fault):
    cell = add_tiny_moe_cell(checkout)
    FAULTS[fault](monkeypatch, cell)
    out = run_cell(cell, 11, 0.2, False, device="cpu", root=checkout)
    assert out["correct"] is False, out["checks"]


def test_fp8_control_fails_where_the_program_passes(checkout):
    """Tiny bfloat16 cell, limits between the program's readings and
    the control's on these seeds (program: loss gap about 5e-4 to 7e-4,
    gradient gap up to 4e-2 where routing parts; control: about 8e-3 and
    7e-2)."""
    cell = add_tiny_moe_cell(checkout, "bfloat16")
    limits = {"loss_gap": 2e-3, "grad_gap": 5e-2}
    for seed in (3, 4):
        tn = kmoe.Trainer(cell, seed, "cpu")
        prog, inputs = tn.round1()
        tn.free()
        ref = rmoe.reference(inputs, "cpu")
        ctrl = rmoe.stand_in(inputs, "fp8", "cpu", ref)
        p, c = rmoe.compare(prog, ref), rmoe.compare(ctrl, ref)
        assert all(p[k] <= v for k, v in limits.items()), p
        assert any(c[k] > v for k, v in limits.items()), c


def test_spans_nest_and_counts_once_per_token(checkout, monkeypatch):
    """The window's spans: ``mla`` 3 and ``moe`` 2 per forward, as many
    again for the remat recompute, each inside ``forward`` or
    ``backward``; the counters count every token's K choices once."""
    cell = add_tiny_moe_cell(checkout)
    seen = []
    span = adloco.PhaseClock.span

    def recording(self, name, device):
        seen.append((name, self._open[-1] if self._open else None))
        return span(self, name, device)
    monkeypatch.setattr(adloco.PhaseClock, "span", recording)
    res = kmoe.run(cell, 5, 0.2, False, "cpu", 0.0)
    run = res["run"]
    steps = sum(r.phase_ms.counts.get("forward", 0) for r in run.rounds)
    for name, n in (("mla", 3), ("moe", 2)):
        assert {p for s, p in seen if s == name} == {"forward", "backward"}
        got = sum(r.phase_ms.counts.get(name, 0) for r in run.rounds)
        assert got == 2 * n * steps
    tokens = int(cell.config["b_max"]) * cell.traffic["seq_len"]
    assert run.moe["routed"] == steps * 2 * tokens * 2    # layers, top-2
    assert run.moe["kept"] + run.moe["dropped"] == run.moe["held"] > 0


def test_metrics_read_the_window(checkout):
    cell = add_tiny_moe_cell(checkout)
    out = run_cell(cell, 7, 0.2, False, device="cpu", root=checkout)
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    res = kmoe.run(cell, 7, 0.2, False, "cpu", 0.0)
    run = res["run"]
    mfu = spec.reader("mla_moe_train_mfu", checkout)(run)
    assert mfu is not None and mfu > 0
    # on the CPU the spans hold no device time: nothing to read
    assert spec.reader("moe_ms_per_ktok", checkout)(run) is None
