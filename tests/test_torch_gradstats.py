"""Gradstats reduction and the batching statistics of the port against
the JAX package.

On the CPU the port's ``gradstats_reduce`` runs its plain version; the
JAX side runs the Pallas kernels in interpret mode
(``repro.kernels.gradstats.ops``), as ``tests/test_kernels.py`` does.
Inputs are made with numpy from a seed (bf16 cast by both frameworks
with round-to-nearest-even).  Tolerances are ``tests/test_kernels.py``'s:
2e-5 in f32, 2e-2 in bf16 for the reduction; the derived GradStats
within 1e-4 (f32) and 5e-2 (bf16) relative, as its drop-in test.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AdLoCoConfig as JAdLoCoConfig
from repro.core import batching as jb
from repro.kernels.gradstats.ops import gradstats_reduce as jax_gradstats
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import batching as tb
from repro_torch.kernels.gradstats import kernel, ops
from repro_torch.kernels.gradstats.ref import gradstats_reduce_ref
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
REL = {"float32": 1e-4, "bfloat16": 5e-2}

# tests/test_kernels.py: GRADSTATS_EDGE_CASES, then test_gradstats_allclose
CASES = [
    (1, 16, "float32"), (1, 513, "float32"), (2, 16, "float32"),
    (5, 193, "float32"), (9, 515, "float32"), (13, 1027, "float32"),
    (3, 130, "bfloat16"), (5, 193, "bfloat16"), (17, 700, "bfloat16"),
    (31, 1000, "bfloat16"),
    (16, 1024, "float32"), (7, 300, "float32"), (64, 4096, "float32"),
    (3, 130, "float32"), (32, 2048, "bfloat16"),
]


def _matrix(B, D, seed, scale=2.0, shift=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)) * scale + shift).astype(np.float32)


def _both(G, dtype):
    return (jnp.asarray(G).astype(jnp.dtype(dtype)),
            torch.from_numpy(G).to(getattr(torch, dtype)))


@pytest.mark.parametrize("B,D,dtype", CASES)
def test_reduction_matches_pallas_kernel(B, D, dtype):
    jG, tG = _both(_matrix(B, D, B * 1000 + D), dtype)
    want = jax_gradstats(jG)
    before = (ops.colsum_launches, ops.moments_launches)
    got = ops.gradstats_reduce(tG)
    assert (ops.colsum_launches, ops.moments_launches) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])
    assert got[0].shape == got[1].shape == (B,) and float(got[3]) == B


def _assert_stats_close(got, want, rel):
    scale = max(abs(float(v)) for v in want) + 1e-6
    for name, x, y in zip(tb.GradStats._fields, got, want):
        x, y = float(x), float(y)
        assert abs(x - y) <= rel * max(abs(x), abs(y)) + rel * scale, \
            (name, x, y)


@pytest.mark.parametrize("B,D,dtype", CASES[:10])
def test_stats_from_matrix_both_routes(B, D, dtype):
    jG, tG = _both(_matrix(B, D, B + 7 * D, scale=3.0, shift=0.0), dtype)
    want = jb.stats_from_matrix(jG, use_kernel=False)
    for use_kernel in (False, True):
        _assert_stats_close(tb.stats_from_matrix(tG, use_kernel=use_kernel),
                            want, REL[dtype])
        _assert_stats_close(tb.stats_from_matrix(tG, use_kernel=use_kernel),
                            jb.stats_from_matrix(jG, use_kernel=True),
                            REL[dtype])


@pytest.mark.parametrize("sizes,micro", [([3, 4, 1], 0), ([1, 1], 8),
                                         ([2, 5], 4)])
def test_distributed_composition_matches(sizes, micro):
    G = _matrix(sum(sizes), 257, len(sizes) + micro, shift=0.1)
    parts = np.split(G, np.cumsum(sizes)[:-1])
    ident = (lambda x: x)
    want = jb.compose_shards([jnp.asarray(p) for p in parts],
                             micro_size=micro)
    got = tb.compose_shards([torch.from_numpy(p) for p in parts],
                            micro_size=micro)
    _assert_stats_close(got, want, 1e-4)
    _assert_stats_close(
        tb.distributed_stats(torch.from_numpy(G), ident, micro_size=micro),
        jb.distributed_stats(jnp.asarray(G), ident, micro_size=micro), 1e-4)
    # composition law: the shards compose to the whole matrix
    whole = tb.stats_from_matrix(torch.from_numpy(G))
    if micro:
        whole = tb.rescale_microbatch(whole, micro)
    _assert_stats_close(got, whole, 1e-4)
    np.testing.assert_allclose(
        tb.stats_phase1(torch.from_numpy(G)).numpy(),
        np.asarray(jb.stats_phase1(jnp.asarray(G))), rtol=1e-5, atol=1e-5)
    assert tb.stats_payload_bytes(1000) == jb.stats_payload_bytes(1000)
    total = sum(tb.shard_moments(torch.from_numpy(p), torch.from_numpy(
        G.mean(0))) for p in parts)
    _assert_stats_close(tb.stats_finish_total(total, micro_size=micro),
                        jb.stats_finish_total(np.asarray(total),
                                              micro_size=micro), 1e-4)


def test_microbatch_stats_and_flatten_match():
    rng = np.random.default_rng(9)
    stack = {"a": rng.standard_normal((3, 4, 5)).astype(np.float32),
             "b": rng.standard_normal((3, 7)).astype(np.float32)}
    G = tb.flatten_grads({k: torch.from_numpy(v) for k, v in stack.items()})
    np.testing.assert_array_equal(
        G.numpy(), np.asarray(jb.flatten_grads(
            {k: jnp.asarray(v) for k, v in stack.items()})))
    _assert_stats_close(
        tb.stats_from_microbatch_grads(
            {k: torch.from_numpy(v) for k, v in stack.items()}, 6),
        jb.stats_from_microbatch_grads(
            {k: jnp.asarray(v) for k, v in stack.items()}, 6), 1e-4)


@pytest.mark.parametrize("test", ["norm", "inner_product", "augmented"])
def test_requested_batch_decisions_match(test):
    rng = np.random.default_rng(4)
    for i in range(20):
        vals = np.abs(rng.standard_normal(4)).astype(np.float32) * \
            np.float32(10.0 ** rng.integers(-2, 3))
        jst = jb.GradStats(*[jnp.float32(v) for v in vals], jnp.float32(8))
        tst = tb.GradStats(*[torch.tensor(float(v)) for v in vals],
                           torch.tensor(8.0))
        kw = dict(batch_test=test, eta=0.8, theta=0.3, nu=0.3,
                  max_global_batch=4096)
        cur = int(rng.integers(1, 6))
        assert tb.requested_batch(tst, AdLoCoConfig(**kw), cur) == \
            jb.requested_batch(jst, JAdLoCoConfig(**kw), cur)
    with pytest.raises(ValueError):
        tb.requested_batch(tst, dataclasses.replace(AdLoCoConfig(),
                                                    batch_test="nope"), 1)


def test_batch_growth_predictor_matches():
    jp, tp = jb.BatchGrowthPredictor(500), tb.BatchGrowthPredictor(500)
    assert tp.predict(1, 2) == jp.predict(1, 2)
    for r, b in [(1, 2), (4, 3), (4, 9), (3, 1), (7, 5), (10, 0), (10, 12)]:
        jp.observe(r, b)
        tp.observe(r, b)
        assert tp.num_observations == jp.num_observations
        for q in range(r, r + 6):
            for cur in (1, 4, 40):
                assert tp.predict(q, cur) == jp.predict(q, cur)


def test_wrapper_raises_for_a_device_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        ops.gradstats_reduce(torch.zeros((2, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.colsum_mean(torch.zeros((2, 3)))


# (B, D, dtype) as chip_smoke.py checks them, without the main shape
GPU_CASES = [(1, 16, "float32"), (5, 193, "float32"), (13, 1027, "float32"),
             (31, 1000, "bfloat16"), (64, 4096, "float32")]


@pytest.mark.gpu
def test_kernels_match_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for B, D, dtype in GPU_CASES:
        G = torch.from_numpy(_matrix(B, D, B + D)).to(
            "cuda", getattr(torch, dtype))
        before = (ops.colsum_launches, ops.moments_launches)
        got = ops.gradstats_reduce(G)
        again = ops.gradstats_reduce(G)
        torch.cuda.synchronize()
        assert (ops.colsum_launches, ops.moments_launches) == \
            (before[0] + 2, before[1] + 2)
        for g, a, w in zip(got, again, gradstats_reduce_ref(G)):
            assert torch.equal(g, a)           # bit-identical repeat
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       **TOL[dtype])
