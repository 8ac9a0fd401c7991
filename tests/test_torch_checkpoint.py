"""Checkpoints cross between the packages, and the port's training CLI
runs to its end on the CPU.

A pool state written by the JAX package's ``save_train_state`` restores
into the port's pool, and the reverse, with every array equal (bf16
stored as f32 and restored to bf16 exactly).  The pool is the reduced
MicroLlama (stacked layers on the JAX side, ``layers.N.*`` names in the
port) with AdamW inner and Nesterov outer states.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_train_state as j_restore
from repro.checkpoint import save_train_state as j_save
from repro.configs.base import AdLoCoConfig as JAdLoCoConfig
from repro.core.adloco import TrainerRound as JTrainerRound
from test_torch_lm import CFG, np_params, one_torch_thread  # noqa: F401
from test_torch_train import _flat, _tree
from repro_torch import convert
from repro_torch.checkpoint import (latest_step, restore_train_state,
                                    save_train_state)
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core.adloco import TrainerRound
from repro_torch.launch import train as launch_train
from repro_torch.models import lm

ACFG = dict(num_init_trainers=2, nodes_per_gpu=2)


def _noise_like(tree, rng):
    return jax.tree.map(lambda a: (rng.standard_normal(np.shape(a)) * 0.1)
                        .astype(np.float32), tree)


def _jax_pool(trees):
    rnd = JTrainerRound(lambda p, b: (0.0, {}), JAdLoCoConfig(**ACFG))
    return rnd.init_pool([jax.tree.map(jnp.asarray, t) for t in trees],
                         [None] * 4)


def _port_pool(trees, cfg=CFG):
    rnd = TrainerRound(lambda p, b: (0.0, {}), AdLoCoConfig(**ACFG))
    flats = [lm.param_dict(convert.params_from_numpy(t, cfg, device="cpu"))
             for t in trees]
    return rnd.init_pool(flats, [None] * 4)


def _port_tree(state):
    """A port optimizer state in the JAX layout (numpy)."""
    return {k: (_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in state.items()}


def test_jax_checkpoint_restores_into_port(tmp_path):
    rng = np.random.default_rng(0)
    trees = [np_params(CFG, s) for s in (1, 2)]
    jpool = _jax_pool(trees)
    for tr in jpool.trainers:
        tr.outer_opt_state = {"m": jax.tree.map(
            jnp.asarray, _noise_like(trees[0], rng))}
        tr.inner_opt_states = [
            {"m": jax.tree.map(jnp.asarray, _noise_like(trees[0], rng)),
             "v": jax.tree.map(jnp.asarray, _noise_like(trees[0], rng)),
             "t": jnp.int32(7 + m)} for m in range(2)]
        tr.requested_batch = 5 + tr.tid
    j_save(str(tmp_path), 3, jpool)

    tpool = _port_pool([np_params(CFG, 9)] * 2)
    tpool, meta = restore_train_state(str(tmp_path), 3, tpool)
    assert latest_step(str(tmp_path)) == 3 and meta["step"] == 3
    for jt, tt in zip(jpool.trainers, tpool.trainers):
        assert tt.requested_batch == jt.requested_batch
        jax.tree.map(np.testing.assert_array_equal, _tree(tt.params),
                     jax.tree.map(np.asarray, jt.params))
        jax.tree.map(np.testing.assert_array_equal,
                     _port_tree(tt.outer_opt_state),
                     jax.tree.map(np.asarray, jt.outer_opt_state))
        for js, ts in zip(jt.inner_opt_states, tt.inner_opt_states):
            assert ts["t"].dtype == torch.int32
            jax.tree.map(np.testing.assert_array_equal, _port_tree(ts),
                         jax.tree.map(np.asarray, js))


def test_port_checkpoint_restores_into_jax_bf16(tmp_path):
    rng = np.random.default_rng(1)
    bf = CFG.with_overrides(dtype="bfloat16")
    trees = [np_params(CFG, s) for s in (3, 4)]
    tpool = _port_pool(trees, bf)
    assert tpool.trainers[0].params["embed"].dtype == torch.bfloat16
    for tr in tpool.trainers:
        tr.outer_opt_state = {"m": _flat(_noise_like(trees[0], rng))}
        tr.requested_batch = 3 + tr.tid
    tpool.global_params = tpool.trainers[1].params
    save_train_state(str(tmp_path), 2, tpool)

    jtrees = [jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
              for t in (np_params(CFG, 8),) * 2]
    rnd = JTrainerRound(lambda p, b: (0.0, {}), JAdLoCoConfig(**ACFG))
    jpool = rnd.init_pool(jtrees, [None] * 4)
    jpool, _ = j_restore(str(tmp_path), 2, jpool)
    for jt, tt in zip(jpool.trainers, tpool.trainers):
        assert jt.requested_batch == tt.requested_batch
        assert jax.tree.leaves(jt.params)[0].dtype == jnp.bfloat16
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  jt.params), _tree(tt.params))
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, jt.outer_opt_state),
                     _port_tree(tt.outer_opt_state))
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(lambda a: np.asarray(a, np.float32),
                              jpool.global_params),
                 _tree(tpool.global_params))


def test_restore_rejects_a_wrong_shape(tmp_path):
    tpool = _port_pool([np_params(CFG, 1)] * 2)
    save_train_state(str(tmp_path), 1, tpool)
    other = _port_pool([np_params(CFG, 1)] * 2)
    other.trainers[0].params["embed"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        restore_train_state(str(tmp_path), 1, other)


def test_cli_runs_to_the_end_and_resumes(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--outer-steps", "2",
            "--inner-steps", "1", "--seq-len", "16", "--stats-probe-size", "4",
            "--ckpt-dir", str(tmp_path / "ckpt"),
            "--history-out", str(tmp_path / "hist.json")]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] arch=microllama-300m-smoke" in out
    assert "[train] final loss=" in out and "[adloco] t=2" in out
    hist = json.loads((tmp_path / "hist.json").read_text())
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert latest_step(str(tmp_path / "ckpt")) == 2
    assert launch_train.main(argv + ["--resume"]) == 0
    assert "resuming from" in capsys.readouterr().out


def test_cli_rejects_other_families():
    with pytest.raises(NotImplementedError, match="frames"):
        launch_train.main(["--arch", "whisper-small", "--reduced",
                           "--device", "cpu", "--outer-steps", "1"])
