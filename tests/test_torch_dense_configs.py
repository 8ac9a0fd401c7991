"""The four dense configs the port accepts, held against the JAX package:
qwen3-0.6b (qk-norm, hd 128 reduced to 64, tied head), gemma3-4b (5:1
sliding window, tied head), stablelm-1.6b and phi3-medium-14b, each at
``reduced()`` width (2 layers, d 256, vocab 1024, f32, CPU), plus a
gemma-shaped config at head dim 256 (``reduced()`` sets hd 64).

Parameters are numpy arrays from a seed in the JAX package's pytree
layout (``np_tree``: every leaf of ``repro.models.init_params``'s tree,
filled with the JAX init's scales), carried to the port by
``convert.params_from_numpy``.  Forward, prefill (past the reduced
window of 64), one decode step and paged chunked prefill with a decode
step agree to rtol = atol = 1e-4: f32 sums taken in another order
through two layers and the LM head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import lm
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen3-0.6b", "gemma3-4b", "stablelm-1.6b", "phi3-medium-14b"]
HD256 = "gemma3-4b@hd256"


def configs(name):
    """(JAX config, port config) of ``name`` at reduced width;
    ``gemma3-4b@hd256`` is reduced gemma3-4b at head dim 256."""
    arch, _, hd = name.partition("@hd")
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    if hd:
        jcfg = dataclasses.replace(jcfg, head_dim=int(hd))
        tcfg = dataclasses.replace(tcfg, head_dim=int(hd))
    return jcfg, tcfg


def np_tree(jcfg, seed=0):
    """Every leaf of the JAX init's tree for ``jcfg``, as numpy f32 from
    ``seed``: the embedding at scale 0.02, norm weights at 0.1 (so the
    (1 + w) scale is exercised), every other leaf at 1/sqrt(fan_in)
    (its second-to-last axis), as ``layers.dense_init`` draws them."""
    shapes = jax.eval_shape(lambda: jlm.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "embed":
            scale = 0.02
        elif "norm" in name:
            scale = 0.1
        else:
            scale = 1.0 / np.sqrt(sd.shape[-2])
        return (rng.standard_normal(sd.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def both(name, seed=0):
    jcfg, tcfg = configs(name)
    tree = np_tree(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device="cpu"))


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ARCHS + [HD256])
def test_forward_and_loss(name):
    jcfg, tcfg, jp, tp = both(name)
    toks = tokens(tcfg, 2, 20, 1)
    want, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = lm.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want)
    assert float(aux) == 0.0
    jl, _ = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, _ = lm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ARCHS + [HD256])
def test_prefill_then_decode(name):
    """A 72-token prompt passes the reduced window (64), then one decode
    step at a cache of 80 slots."""
    jcfg, tcfg, jp, tp = both(name)
    toks = tokens(tcfg, 2, 72, 2)
    want, jc = jlm.prefill(jp, jnp.asarray(toks), jcfg, 80)
    got, tc = lm.prefill(tp, torch.from_numpy(toks), tcfg, 80)
    close(got, want)
    # the kernel route (its plain version on the CPU) is the same function
    got_k, _ = lm.prefill(tp, torch.from_numpy(toks), tcfg, 80,
                          use_kernels=True)
    torch.testing.assert_close(got_k, got, rtol=0, atol=0)
    nxt = tokens(tcfg, 2, 1, 3)[:, 0]
    want, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(72), jcfg)
    got, tc = lm.decode_step(tp, tc, torch.from_numpy(nxt), 72, tcfg)
    close(got, want)
    for n in ("k", "v"):
        close(tc[n], jc[n])


@pytest.mark.parametrize("name", ARCHS + [HD256])
def test_paged_chunked_prefill_then_decode(name):
    jcfg, tcfg, jp, tp = both(name)
    bs, nb, num_blocks = 8, 10, 12
    jcache = jlm.init_paged_cache(jcfg, 1, num_blocks, bs)
    tcache = lm.init_paged_cache(tcfg, 1, num_blocks, bs, device="cpu")
    table = np.full((nb,), -1, np.int32)
    table[:9] = [3, 7, 0, 11, 5, 2, 9, 1, 4]
    prompt = tokens(tcfg, 1, 70, 4)
    for lo in range(0, 70, 24):
        chunk = prompt[:, lo:lo + 24]
        want, jcache = jlm.prefill_chunk_paged(
            jp, jcache, jnp.asarray(chunk), jnp.int32(lo), jcfg,
            jnp.asarray(table), 0, block_size=bs)
        got, tcache = lm.prefill_chunk_paged(tp, tcache, chunk, lo, tcfg,
                                             table, 0, block_size=bs)
        close(got, want)
    tok = np.array([int(np.argmax(np.asarray(want)))])
    want, jcache = jlm.decode_step_paged(
        jp, jcache, jnp.asarray(tok), jnp.asarray([70]), jcfg,
        jnp.asarray(table[None]), jnp.asarray([True]), block_size=bs)
    got, tcache = lm.decode_step_paged(tp, tcache, tok, np.array([70]), tcfg,
                                       table[None], np.array([True]),
                                       block_size=bs)
    close(got, want)
    for n in ("kp", "vp"):
        close(tcache[n], jcache[n])
