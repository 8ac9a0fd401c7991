"""The dry run's baseline mode (``REPRO_BASELINE=1``), held against the
JAX package's.

The baseline traces the port's programs without their activation
constraints and with full-sequence prefill logits.  On one card
constraints change nothing, so the reduced MicroLlama prefill (B 2,
S 64, f32) counts exactly what JAX's ``hlo_analysis`` counts for
``models.prefill(..., last_only=False)``: 385,875,968 FLOPs, the
last-token program's 319,815,680 plus the head over the other 63
positions of both rows.  The layouts DTensor needs to trace at all (the
scans' and the conv's ``on_shards``, the head merge) do not depend on
the policy, so the SSM, hybrid and encoder-decoder prefills trace under
the baseline on a fake mesh.  ``launch/dryrun.py`` alone reads the
switch.

Nothing here imports ``repro.launch.dryrun``, which sets a 512-device
``XLA_FLAGS`` at import.  Every test leaves no process group behind.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import models as jmodels
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro_torch import sharding
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, op_analysis, roofline
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
BASELINE_PREFILL_FLOPS = 385_875_968
PREFILL_FLOPS = 319_815_680


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


def prefill_count(cfg, shape, mesh_shape=(1, 1)):
    """The dry run's prefill step traced on a fake mesh -> (its
    OpCounter, logits, cache)."""
    with dryrun.fake_world(mesh_shape[0] * mesh_shape[1]):
        mesh = init_device_mesh("cuda", mesh_shape,
                                mesh_dim_names=("data", "model"))
        step, args, policy = dryrun.build_program(cfg, shape, mesh)
        counter = op_analysis.OpCounter()
        logits, cache = dryrun.trace(counter, step, args, policy)
    return counter, logits, cache


def one_card_prefill(monkeypatch, baseline: bool):
    """The reduced MicroLlama's prefill on a (1, 1) mesh (plain meta
    tensors) -> its OpCounter."""
    monkeypatch.setattr(dryrun, "BASELINE", baseline)
    cfg = reduced(get_config("microllama-300m"))
    counter, logits, _ = prefill_count(cfg, InputShape("p", S, B,
                                                       "prefill"))
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    return counter


def test_baseline_prefill_flops_equal_jax_exactly(monkeypatch):
    jcfg = jax_reduced(jax_get_config("microllama-300m"))
    compiled = jax.jit(
        lambda p, t: jmodels.prefill(p, t, jcfg, S, last_only=False)).lower(
            jspecs.abstract_params(jcfg),
            jax.ShapeDtypeStruct((B, S), jnp.int32)).compile()
    jf = hlo_analysis.analyze(compiled.as_text())["flops"]
    base = one_card_prefill(monkeypatch, True)
    assert jf == base.cost.flops == BASELINE_PREFILL_FLOPS
    assert one_card_prefill(monkeypatch, False).cost.flops == PREFILL_FLOPS


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "whisper-small"])
def test_baseline_prefill_traces_on_a_fake_2x2_mesh(arch, monkeypatch):
    """No policy is open, and no constraint acts: the scans' and the
    conv's ``on_shards`` lay their results out from the mesh itself,
    and whisper's head merge gathers the heads DTensor split unevenly.
    Each card counts at least its quarter of the one-card prefill."""
    monkeypatch.setattr(dryrun, "BASELINE", True)
    cfg = reduced(get_config(arch))
    shape = InputShape("p", S, 4, "prefill")
    whole, _, _ = prefill_count(cfg, shape)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        _, _, policy = dryrun.build_program(cfg, shape, mesh)
        with policy() as opened:
            assert opened is None                   # a null context
            assert sharding.policy_model_size() == 0
    counter, logits, _ = prefill_count(cfg, shape, (2, 2))
    assert sharding.is_sharded(logits)
    assert tuple(logits.shape) == (4, cfg.vocab_size)
    assert counter.cost.flops >= whole.cost.flops / 4 > 0


def test_only_the_dry_run_reads_the_switch():
    hits = sorted(str(p.relative_to(ROOT / "src" / "repro_torch"))
                  for p in (ROOT / "src" / "repro_torch").rglob("*.py")
                  if "BASELINE" in p.read_text())
    assert hits == ["launch/dryrun.py"]


def test_artifacts_and_roofline_rows_carry_baseline(tmp_path, monkeypatch,
                                                    capsys):
    for baseline, out in ((False, tmp_path / "policy"),
                          (True, tmp_path / "baseline")):
        monkeypatch.setattr(dryrun, "BASELINE", baseline)
        r = dryrun.run_combo("microllama-300m", "decode_32k",
                             out_dir=str(out))
        assert r["status"] == "ok" and r["baseline"] is baseline
        saved = json.loads((out / "microllama-300m__decode_32k__h100_32x8"
                            ".json").read_text())
        assert saved["baseline"] is baseline
        skip = dryrun.run_combo("qwen3-0.6b", "long_500k", out_dir=str(out))
        assert skip["baseline"] is baseline
        (row,) = roofline.load_rows(str(out))
        assert row.baseline is baseline
        capsys.readouterr()
        roofline.print_csv([row])
        header, line = capsys.readouterr().out.strip().splitlines()
        assert header.endswith(",torch,baseline")
        assert line.endswith(f",{int(baseline)}")
        roofline.print_table([row], markdown=True)
        md = capsys.readouterr().out.strip().splitlines()
        assert md[0].endswith("| torch | baseline |")
        assert md[-1].endswith(f"| {'yes' if baseline else 'no'} |")
    # decode is the same program in both modes
    counts = [json.loads(p.read_text())["flops"]
              for p in sorted(tmp_path.glob("*/*.json"))]
    assert len(counts) == 2 and counts[0] == counts[1]


def test_the_cli_reads_repro_baseline(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_BASELINE="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "microllama-300m", "--shape", "prefill_32k", "--out",
         str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BASELINE OK" in out.stdout
    art = json.loads((tmp_path / "microllama-300m__prefill_32k__h100_32x8"
                      ".json").read_text())
    assert art["baseline"] is True and art["torch"] == torch.__version__
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path), "--csv"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1].endswith(",1")
