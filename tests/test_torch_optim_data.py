"""Optimizers, data streams, SwitchMode planning and comms metering of
the port against the JAX package.

Optimizers run several steps on the same random trees (numpy, seeded;
bf16 trees are cast by both frameworks with round-to-nearest-even).
Updates, states and parameters agree to 1e-6: the same elementwise f32
arithmetic, which XLA may contract into fused multiply-adds (one f32
ulp).  Data batches and plans must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import optim as joptim
from repro.core import comms as jcomms
from repro.core.switch import plan_execution as jplan
from repro_torch import data, optim
from repro_torch.core import comms
from repro_torch.core.switch import plan_execution
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

OPTIMIZERS = [
    ("sgd", dict(lr=0.1), {}),
    ("sgd", dict(lr=0.1, momentum=0.9), {}),
    ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True), {}),
    ("nesterov_outer", dict(lr=0.7, momentum=0.9), {}),
    ("delay_compensated_nesterov", dict(lr=0.5, momentum=0.9),
     dict(delay=1.0)),
    ("adamw", dict(lr=3e-3, weight_decay=0.1), {}),
    ("adagrad", dict(lr=0.05), {}),
]
SHAPES = {"w": (7, 5), "b": (5,), "e": (3, 2, 4)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _leaves(x):
    if isinstance(x, dict):
        return {k: _leaves(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, rtol=1e-6, atol=1e-6), got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw,extra", OPTIMIZERS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_steps_match(name, kw, extra, dtype):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jopt, topt = getattr(joptim, name)(**kw), getattr(optim, name)(**kw)
    jp = {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = _tree(rng, 0.5)
        jg = {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        ju, js = jopt.update(jg, js, jp, **extra)
        tu, ts = topt.update(tg, ts, tp, **extra)
        jp = joptim.apply_updates(jp, ju)
        tp_new = optim.apply_updates(tp, tu)
        assert all(tp_new[k] is not tp[k] for k in tp)
        tp = tp_new
        _assert_close(tu, ju)
        _assert_close(ts, js)
        _assert_close(tp, jp)
        assert all(tp[k].dtype == getattr(torch, dtype) for k in tp)
    if name == "adamw":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 4


def test_get_optimizer_names():
    for name in ("sgd", "adamw", "adagrad", "nesterov", "delay_nesterov"):
        assert isinstance(optim.get_optimizer(name, 0.1), optim.Optimizer)


def test_apply_updates_rounds_like_jax_in_bf16():
    """The update is cast to bf16 before a bf16 add; an f32 add
    followed by a cast would round differently."""
    p = np.array([1.0, 1.0, 256.0], np.float32)
    u = np.array([0.00390625 * 0.51, 0.0029296875, 0.99], np.float32)
    want = joptim.apply_updates({"p": jnp.asarray(p).astype(jnp.bfloat16)},
                                {"p": jnp.asarray(u)})["p"]
    got = optim.apply_updates({"p": torch.from_numpy(p).bfloat16()},
                              {"p": torch.from_numpy(u)})["p"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_markov_stream_batches_are_bit_identical():
    jstreams = jdata.make_shard_streams(1000, 16, 3, seed=5)
    tstreams = data.make_shard_streams(1000, 16, 3, seed=5, device="cpu")
    for b in (3, 1, 7, 2, 4):
        for js, ts in zip(jstreams, tstreams):
            want = np.asarray(js.next_batch(b)["tokens"])
            got = ts.next_batch(b)["tokens"]
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
    assert [s.tokens_served for s in tstreams] == \
        [s.tokens_served for s in jstreams]


def test_quadratic_problem_samples_are_bit_identical():
    jp = jdata.QuadraticProblem(dim=12, noise=2.0, seed=3)
    tp = data.QuadraticProblem(dim=12, noise=2.0, seed=3, device="cpu")
    np.testing.assert_array_equal(tp.x_star, jp.x_star)
    jr = np.random.default_rng(np.random.SeedSequence([0, 1]))
    tr = np.random.default_rng(np.random.SeedSequence([0, 1]))
    for b in (4, 1, 9):
        for shard in (None, "rng"):
            jA, jb = jp.sample(b, jr if shard else None)
            tA, tb = tp.sample(b, tr if shard else None)
            assert tA.dtype == tb.dtype == torch.float32
            np.testing.assert_array_equal(tA.numpy(), np.asarray(jA))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    x = np.random.default_rng(0).standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(
        float(tp.loss(torch.from_numpy(x), tA, tb)),
        float(jp.loss(jnp.asarray(x), jA, jb)), rtol=1e-6)
    np.testing.assert_allclose(
        tp.per_sample_grads(torch.from_numpy(x), tA, tb).numpy(),
        np.asarray(jp.per_sample_grads(jnp.asarray(x), jA, jb)),
        rtol=1e-5, atol=1e-5)


def test_plan_execution_matches_over_a_grid():
    for b_req in range(0, 80):
        for max_batch in (1, 2, 3, 4, 8, 16):
            for n in (1, 2, 3):
                for bucket in (True, False):
                    got = plan_execution(b_req, max_batch, n, bucket=bucket)
                    want = jplan(b_req, max_batch, n, bucket=bucket)
                    assert tuple(got) == tuple(want)
                    assert got.effective_batch == want.effective_batch


def test_comms_meter_and_param_bytes_match():
    tree = {"a": np.zeros((3, 4), np.float32), "b": np.zeros((5,), np.float32)}
    assert comms.param_bytes({k: torch.from_numpy(v).bfloat16()
                              for k, v in tree.items()}) == \
        jcomms.param_bytes({k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in tree.items()})
    jm, tm = jcomms.CommsMeter(), comms.CommsMeter()
    for kind, p, n in (("outer", 2, 100), ("merge", 3, 64), ("x", 1, 8)):
        jm.record(kind, p, n, step=1)
        tm.record(kind, p, n, step=1)
    assert tm.snapshot() == jm.snapshot() and tm.log == jm.log
