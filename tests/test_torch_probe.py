"""The per-sample probe in row chunks (``batching.per_sample_probe``)
against the one-pass probe and the JAX package's ``per_sample_stats``,
on ``reduced(get_config("microllama-300m"))`` in f32 on the CPU.

On the card a probe whose (B, D) f32 matrix does not fit runs in row
chunks; on the CPU the ``rows`` argument forces them.  The chunked
statistics are the same statistics: every GradStats field within the
gradstats tests' f32 tolerance for GradStats (``REL``, 1e-4 relative)
of the one-pass ones (the column sums are added in another grouping,
so not bit for bit on the plain path; ``ip_var`` subtracts n2 from each
d_i), and within 1e-4 relative of JAX's, as ``test_torch_train`` holds
the one-pass probe; the two passes' partial results within the
reduction's f32 tolerance (``TOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core import batching as jb
from repro_torch import convert, models
from repro_torch.core import batching as tb
from repro_torch.kernels.gradstats import ops
from repro_torch.kernels.gradstats.ref import gradstats_reduce_ref
from repro_torch.models import lm
from test_torch_gradstats import REL, TOL
from test_torch_lm import CFG, JCFG, np_params, one_torch_thread  # noqa: F401

F32 = TOL["float32"]


def _setup(B, seed=0):
    tree = np_params(CFG, seed)
    flat = lm.param_dict(convert.params_from_numpy(tree, CFG, device="cpu"))
    toks = np.random.default_rng(seed + 1).integers(0, CFG.vocab_size,
                                                    (B, 10))
    return tree, flat, toks


def _tloss(p, b):
    return models.loss_fn(p, b, CFG)


@pytest.mark.parametrize("B,rows", [(7, 3), (7, 1), (6, 4), (5, 2)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_chunked_probe_equals_one_pass(B, rows, use_kernel):
    _, flat, toks = _setup(B)
    batch = {"tokens": torch.from_numpy(toks)}
    whole = tb.per_sample_probe(_tloss, flat, batch, use_kernel=use_kernel)
    assert (whole.rows, whole.chunks) == (B, 1)     # the CPU: one pass
    before = ops.colsum_launches, ops.moments_launches
    names, spans = [], lambda name: names.append(name) or _null()
    part = tb.per_sample_probe(_tloss, flat, batch, use_kernel=use_kernel,
                               rows=rows, span=spans)
    # no kernel launches on CPU tensors: the plain version runs
    assert (ops.colsum_launches, ops.moments_launches) == before
    n = -(-B // rows)
    assert (part.rows, part.chunks) == (rows, n)
    # two sweeps, each chunk's gradients then its reduction
    assert names == ["stats_grads", "stats_reduce"] * (2 * n)
    for f in whole.stats._fields:
        np.testing.assert_allclose(float(getattr(part.stats, f)),
                                   float(getattr(whole.stats, f)),
                                   rtol=REL["float32"], err_msg=f)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_chunked_probe_matches_jax():
    tree, flat, toks = _setup(7, seed=3)
    want = jb.per_sample_stats(
        lambda p, b: jmodels.loss_fn(p, b, JCFG),
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    got = tb.per_sample_probe(_tloss, flat,
                              {"tokens": torch.from_numpy(toks)},
                              use_kernel=True, rows=3).stats
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4,
                                   atol=1e-4 * abs(float(w)))


@pytest.mark.parametrize("B,R,D", [(7, 3, 300), (9, 4, 1027), (4, 4, 16)])
def test_chunk_passes_equal_the_one_pass_reduction(B, R, D):
    """``colsum_chunk`` over row chunks (divided by B on the last), then
    ``moments_chunk`` of each chunk against that mean, give the one-pass
    (s, d, n2)."""
    G = torch.from_numpy((np.random.default_rng(B * D).standard_normal(
        (B, D)) * 2.0 + 0.3).astype(np.float32))
    acc = torch.empty(D)
    for lo in range(0, B, R):
        ops.colsum_chunk(G[lo:lo + R], acc, accumulate=lo > 0,
                         divisor=float(B) if lo + R >= B else None)
    torch.testing.assert_close(acc, G.mean(dim=0), **F32)
    parts = [ops.moments_chunk(G[lo:lo + R], acc) for lo in range(0, B, R)]
    s, d, n2, _ = gradstats_reduce_ref(G)
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), s, **F32)
    torch.testing.assert_close(torch.cat([p[1] for p in parts]), d, **F32)
    torch.testing.assert_close(parts[0][2], n2, **F32)


def test_probe_rows_is_the_batch_off_the_card():
    assert tb.probe_rows(64, 304_636_928, "cpu") == 64
