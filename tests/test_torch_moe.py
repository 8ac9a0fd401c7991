"""The port's MoE block and the ``moe`` family against the JAX package:
deepseek-moe-16b (fine-grained, 2 shared experts) and grok-1-314b (few
big experts) at ``reduced()`` width (2 layers, d 256, 4 experts top-2,
f32, CPU), in both dispatch forms ("flat": all tokens of a call routed
together; "grouped": one routing group per batch row).

Parameters come from ``test_torch_dense_configs.np_tree`` (numpy, seeded,
every leaf of the JAX tree).  Logits, caches and the loss agree to
rtol = atol = 1e-4 (the loss and its aux to 1e-5); the routing of a
capacity-overflow case (which assignments are kept, which dropped)
agrees exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import convert, models
from repro_torch.models import layers as L
from repro_torch.models import lm
from test_torch_dense_configs import close, configs, np_tree, tokens
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

CASES = [(a, d) for a in ("deepseek-moe-16b", "grok-1-314b")
         for d in ("flat", "grouped")]


def both(arch, dispatch, seed=0):
    jcfg, tcfg = configs(arch)
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, dispatch=dispatch))
    tcfg = dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, dispatch=dispatch))
    tree = np_tree(jcfg, seed)
    return (jcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_forward_loss_and_aux(arch, dispatch):
    jcfg, tcfg, _, jp, tp = both(arch, dispatch)
    toks = tokens(tcfg, 3, 16, 1)
    want, jaux = jlm.forward(jp, jnp.asarray(toks), jcfg)
    got, taux = lm.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jl, jm = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tm = models.loss_fn(lm.param_dict(tp),
                            {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    assert float(tm["aux"]) > 0.0


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_prefill_decode_and_paged(arch, dispatch):
    jcfg, tcfg, _, jp, tp = both(arch, dispatch)
    toks = tokens(tcfg, 2, 12, 2)
    want, jc = jlm.prefill(jp, jnp.asarray(toks), jcfg, 16)
    got, tc = lm.prefill(tp, torch.from_numpy(toks), tcfg, 16)
    close(got, want)
    nxt = tokens(tcfg, 2, 2, 3)
    for i in range(2):
        want, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[:, i]),
                                   jnp.int32(12 + i), jcfg)
        got, tc = lm.decode_step(tp, tc, torch.from_numpy(nxt[:, i]),
                                 12 + i, tcfg)
        close(got, want)
    # paged: chunked prefill of one lane (routing follows dispatch), one
    # decode tick
    bs = 4
    jcache = jlm.init_paged_cache(jcfg, 1, 6, bs)
    tcache = lm.init_paged_cache(tcfg, 1, 6, bs, device="cpu")
    table = np.array([4, 1, 5, -1], np.int32)
    for lo in range(0, 10, 5):
        chunk = toks[:1, lo:lo + 5]
        want, jcache = jlm.prefill_chunk_paged(
            jp, jcache, jnp.asarray(chunk), jnp.int32(lo), jcfg,
            jnp.asarray(table), 0, block_size=bs)
        got, tcache = lm.prefill_chunk_paged(tp, tcache, chunk, lo, tcfg,
                                             table, 0, block_size=bs)
        close(got, want)
    want, _ = jlm.decode_step_paged(
        jp, jcache, jnp.asarray(toks[:1, 10]), jnp.asarray([10]), jcfg,
        jnp.asarray(table[None]), jnp.asarray([True]), block_size=bs)
    got, _ = lm.decode_step_paged(tp, tcache, toks[:1, 10], np.array([10]),
                                  tcfg, table[None], np.array([True]),
                                  block_size=bs)
    close(got, want)


def _kept_reference(topi, E, C):
    """The JAX block's capacity rule in numpy, from JAX's top-k: rank
    each assignment within its expert in a stable sort by expert id,
    keep rank < C; returned in assignment order."""
    flat = np.asarray(topi).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    rank = np.arange(flat.size) - np.searchsorted(sorted_e, sorted_e,
                                                  side="left")
    kept = np.empty(flat.size, bool)
    kept[order] = rank < C
    return kept


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_capacity_drops_match(arch):
    """A router that sends every token's first choice to expert 0
    overflows its capacity: the kept and dropped assignments must be
    JAX's exactly, and the block's output and aux within tolerance."""
    jcfg, tcfg, tree, _, _ = both(arch, "flat", seed=5)
    rng = np.random.default_rng(6)
    p = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    d, E = p["router"].shape
    # x's entries are ~ +1, so expert 0's logit is ~ 0.02 d = 5 against
    # the others' ~ N(0, 1): every first choice, no ties in the top-k
    p["router"][:, 0] = 0.02
    x = (rng.standard_normal((24, d)) * 0.3 + 1.0).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, jaux = jL.moe_block(jp, jnp.asarray(x), jcfg)
    got, taux = L.moe_block(tp, torch.from_numpy(x), tcfg)

    route = L.moe_route(tp, torch.from_numpy(x), tcfg)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jtopi = jax.lax.top_k(jprobs, tcfg.moe.top_k)
    np.testing.assert_array_equal(route.topi.numpy(), np.asarray(jtopi))
    kept = _kept_reference(jtopi, E, route.capacity)
    np.testing.assert_array_equal(route.kept.numpy(), kept)
    assert not kept.all() and kept.sum() > 0     # the case drops
    assert (route.slot.numpy()[~kept] == E * route.capacity).all()
    close(got, want)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_router_stays_f32_in_bf16():
    _, tcfg = configs("deepseek-moe-16b")
    bf = tcfg.with_overrides(dtype="bfloat16")
    params = lm.init_params(bf, 0, device="cpu")
    moe = params.layers[0].moe
    assert moe["router"].dtype == torch.float32
    assert moe["gate"].dtype == torch.bfloat16
    back = convert.params_to_numpy(params)
    again = convert.params_from_numpy(back, bf, device="cpu")
    assert again.layers[1].moe["router"].dtype == torch.float32
    assert torch.equal(again.layers[1].moe["s_up"], params.layers[1].moe["s_up"])
