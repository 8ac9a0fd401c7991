"""The port's examples (``repro_torch.examples``) on the CPU.

- ``common`` against ``benchmarks.common``: the quadratic streams hand
  out bitwise equal batches for each seed and shard; ``quad_loss`` and
  the E[f] evaluation agree on the same numpy params (f32, 1e-6
  relative); ``lm_setup``'s config equals the JAX package's reduced
  microllama field by field and its token streams are equal.
- ``train_100m.build_config`` equals the JAX example's, field by field.
- Every example's ``main`` runs to its end with ``--device cpu`` at its
  own settings (``train_100m`` as ``--demo --outer-steps 1``).
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jc
from repro_torch.examples import (adloco_vs_diloco, common,
                                  continuous_batching, heterogeneous_cluster,
                                  quickstart, serve_batched, train_100m)
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 3])
def test_quad_streams_are_bitwise_equal(seed):
    jprob, _, jstreams, _ = jc.quad_setup(k=2, M=2, seed=seed)
    tprob, _, tstreams, _ = common.quad_setup(k=2, M=2, seed=seed,
                                              device="cpu")
    assert len(jstreams) == len(tstreams) == 4
    for js, ts in zip(jstreams, tstreams):
        for b in (1, 4, 7):
            jb, tb = js.next_batch(b), ts.next_batch(b)
            for key in ("A", "y"):
                assert tb[key].dtype == torch.float32
                np.testing.assert_array_equal(tb[key].numpy(),
                                              np.asarray(jb[key]))


def test_quad_loss_and_eval_agree():
    jprob, _, jstreams, jeval = jc.quad_setup(k=1, M=1, seed=1)
    _, _, tstreams, teval = common.quad_setup(k=1, M=1, seed=1,
                                              device="cpu")
    x = np.random.default_rng(5).standard_normal(16).astype(np.float32)
    jb, tb = jstreams[0].next_batch(8), tstreams[0].next_batch(8)
    jl, _ = jc.quad_loss({"x": jnp.asarray(x)}, jb)
    tl, _ = common.quad_loss({"x": torch.from_numpy(x)}, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(teval({"x": torch.from_numpy(x)}),
                               jeval({"x": jnp.asarray(x)}), rtol=1e-6)


def test_quad_inits_are_seeded_numpy_draws():
    _, a, _, _ = common.quad_setup(k=3, seed=2, device="cpu")
    _, b, _, _ = common.quad_setup(k=3, seed=2, device="cpu")
    for i, (pa, pb) in enumerate(zip(a, b)):
        assert torch.equal(pa["x"], pb["x"])
        assert torch.equal(pa["x"],
                           torch.from_numpy(common.quad_init(16, 2, i)))
    assert not torch.equal(a[0]["x"], a[1]["x"])


def test_lm_setup_matches_the_jax_setup():
    jcfg, jinits, jstreams, _, _ = jc.lm_setup(k=2, M=2, seq_len=16)
    cfg, inits, streams, loss_fn, eval_fn = common.lm_setup(
        k=2, M=2, seq_len=16, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert len(inits) == 2 and len(streams) == len(jstreams) == 4
    assert sorted(inits[0]) == sorted(inits[1])
    for js, ts in zip(jstreams, streams):
        for b in (2, 5):
            np.testing.assert_array_equal(
                ts.next_batch(b)["tokens"].numpy(),
                np.asarray(js.next_batch(b)["tokens"]))
    assert np.isfinite(eval_fn(inits[0]))


@pytest.mark.parametrize("demo", [False, True])
def test_train_100m_config_matches_the_jax_example(demo):
    want = _jax_example("train_100m").build_config(demo)
    assert dataclasses.asdict(train_100m.build_config(demo)) == \
        dataclasses.asdict(want)


def test_examples_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, adloco_vs_diloco, train_100m,
                heterogeneous_cluster, serve_batched, continuous_batching):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


EXAMPLES = {
    "quickstart": (quickstart, [], "final pool size:"),
    "adloco_vs_diloco": (adloco_vs_diloco, [], "DiLoCo : final E[f]="),
    "train_100m": (train_100m, ["--demo", "--outer-steps", "1"],
                   "[100m] checkpoint + history ->"),
    "heterogeneous_cluster": (heterogeneous_cluster, [],
                              "overlap fraction="),
    "serve_batched": (serve_batched, [], "whisper-small"),
    "continuous_batching": (continuous_batching, [],
                            "flash_crowd x12 on 12 shared blocks"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    mod, argv, marker = EXAMPLES[name]
    if hasattr(mod, "OUT"):
        monkeypatch.setattr(mod, "OUT", str(tmp_path))
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert marker in out
    if name == "train_100m":
        hist = json.loads((tmp_path / "history.json").read_text())
        assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    if name == "heterogeneous_cluster":
        trace = json.loads((tmp_path / "trace.json").read_text())
        assert trace["traceEvents"]
