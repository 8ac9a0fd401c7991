"""The port's banded sliding-window attention (``layers.sdpa_banded``)
and the layers that take it, held against the JAX package.

Every input is made with numpy from a seed and handed to both packages.
``sdpa_banded`` and its gradients agree with JAX's to atol = rtol =
2e-5 in f32 (the JAX package's own tolerance for its banded path, in
``tests/test_perf_paths.py``); a card's shard of the query rows
(``policy_sdpa``'s context-parallel path, a shard smaller than a window
included) gives the rows of the one-card result.  ``plan_window``
returns JAX's ``(window, banded)`` for the globality flag JAX's
``_run_layers`` hands each layer.

Reduced gemma3-4b and hymba-1.5b at 5 layers with a global layer every
2 (``reduced()``'s 2 layers form no group, so nothing would be banded):
layers 0, 2 and 4 are local, 4 the tail.  At S = 4w = 256 their
forward, loss with gradients and prefill agree with JAX's to atol 1e-4
(as ``test_torch_lm``), and their dry-run programs on a fake (2, 4)
mesh (hymba's 5 heads also on (1, 8), where a card's 32 query rows are
half a window) count at most JAX's per-card ratio, with the one-card
count within 1% of JAX's.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.core.diloco import value_and_grad
from repro_torch.models import layers as L
from repro_torch.models import lm
import test_torch_dense_configs as dense_tests
import test_torch_dryrun_parity as parity
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
WINDOWS = [(256, 64), (128, 32), (512, 128)]
GROUPED = dict(num_layers=5, global_every=2)


def qkv(S, seed, B=2, H=4, Hk=2, hd=32):
    """f32 q (B,S,H,hd), k, v (B,S,Hk,hd) from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, hd)).astype(np.float32)
                 for h in (H, Hk, Hk))


@pytest.mark.parametrize("S,w", WINDOWS)
def test_sdpa_banded_matches_jax(S, w):
    arrays = qkv(S, seed=S)
    want = jax.jit(JL.sdpa_banded, static_argnames="window")(
        *map(jnp.asarray, arrays), window=w)
    got = L.sdpa_banded(*map(torch.from_numpy, arrays), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    masked = L.sdpa(*map(torch.from_numpy, arrays), causal=True, window=w)
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **TOL)


@pytest.mark.parametrize("S,w", WINDOWS)
def test_sdpa_banded_gradients_match_jax(S, w):
    """q, k and v's gradients of <sdpa_banded, cotangent> against
    ``jax.grad`` of JAX's."""
    arrays = qkv(S, seed=S + 1)
    cot = np.random.default_rng(S).standard_normal(
        arrays[0].shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        JL.sdpa_banded(q, k, v, window=w) * cot), argnums=(0, 1, 2)))(
        *map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    (L.sdpa_banded(*leaves, window=w) * torch.from_numpy(cot)).sum() \
        .backward()
    for t, g in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_banded_first_block_no_left_leak():
    """Queries of block 0 do not see the zero-padded phantom block: they
    equal attention over the first window alone, as JAX's."""
    q, k, v = map(torch.from_numpy, qkv(128, seed=7, B=1, H=2, Hk=1, hd=16))
    ref = L.sdpa(q[:, :64], k[:, :64], v[:, :64], causal=True, window=64)
    got = L.sdpa_banded(q, k, v, window=64)[:, :64]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    want = JL.sdpa_banded(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          window=64)[:, :64]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cards", [2, 4, 8, 16, 3])
def test_row_shards_give_the_one_card_rows(cards):
    """``policy_sdpa``'s banded rows on each card: DTensor's chunks of
    S = 256 query rows over ``cards`` (w 64: whole windows, half and a
    quarter of one, and 86 / 86 / 84 rows), each at its offset in
    blocks of gcd(rows, w) against the whole k and v, give the one-card
    rows and gradients."""
    arrays = qkv(256, seed=cards, H=5, Hk=1)
    cot = torch.from_numpy(np.random.default_rng(cards).standard_normal(
        arrays[0].shape).astype(np.float32))

    def run(split):
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        q, k, v = leaves
        if split:
            n = -(-256 // cards)
            out = torch.cat([L.sdpa_banded(
                q[:, lo:lo + n], k, v, window=64, q_offset=lo,
                block=math.gcd(q[:, lo:lo + n].shape[1], 64))
                for lo in range(0, 256, n)], dim=1)
        else:
            out = L.sdpa_banded(q, k, v, window=64)
        (out * cot).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    (one, g1), (many, gm) = run(False), run(True)
    np.testing.assert_allclose(many.numpy(), one.numpy(), **TOL)
    for a, b in zip(gm, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


PLAN_CONFIGS = {
    "grouped-tail": GROUPED,                        # 2 groups of 2, 1 tail
    "grouped": dict(num_layers=4, global_every=2),
    "all-local": dict(num_layers=3, global_every=None),
    "no-group": dict(num_layers=2, global_every=6),   # ng == 0
}


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_plan_window_matches_jax(name):
    """Each layer's (window, banded) equals JAX's ``plan_window`` given
    the flag its ``_run_layers`` passes: a Python bool where the arch
    forms groups (group and tail layers), a traced one otherwise (then
    JAX's window is GLOBAL_WINDOW on a global layer, where the port's
    None means the same: no window)."""
    over = PLAN_CONFIGS[name]
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma3-4b")),
                               **over)
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b")), **over)
    w = cfg.sliding_window
    assert (L.layer_groups(cfg) is None) == (jlm._grouped(jcfg) is None)
    flags = [bool(f) for f in np.asarray(jlm.layer_is_global(jcfg))]
    assert flags == lm.layer_is_global(cfg)
    for S in (w // 2, w, 2 * w, 3 * w, 4 * w, 2 * w + 3, 8 * w):
        for g in flags:
            static = jlm._grouped(jcfg) is not None
            jwin, jband = JL.plan_window(jcfg, g if static
                                         else jnp.asarray(g), S)
            window, banded = L.plan_window(cfg, g, S)
            assert banded == jband, (name, S, g)
            jwin = None if jwin is None else int(jwin)
            assert window == (None if jwin == JL.GLOBAL_WINDOW else jwin)
            assert banded == (static and not g and S % w == 0
                              and S // w >= 2)


FAMILIES = ["gemma3-4b", "hymba-1.5b"]
_TREES = {}


def family(arch):
    """(JAX config, port config, JAX params, port params) of ``arch``
    reduced with 5 layers in groups of 2 (numpy from seed 5)."""
    if arch not in _TREES:
        jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                   **GROUPED)
        cfg = dataclasses.replace(reduced(get_config(arch)), **GROUPED)
        tree = dense_tests.np_tree(jcfg, seed=5)
        _TREES[arch] = (jcfg, cfg, tree)
    jcfg, cfg, tree = _TREES[arch]
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, cfg, device="cpu"))


@pytest.fixture
def banded_calls(monkeypatch):
    """Counts ``layers.sdpa_banded``'s calls."""
    calls = []
    real = L.sdpa_banded

    def counted(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(L, "sdpa_banded", counted)
    return calls


def tokens(cfg, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_prefill_match_jax(arch, banded_calls):
    """forward and prefill at S = 4w: logits and caches as JAX's, each
    of the three local layers through ``sdpa_banded``."""
    jcfg, cfg, jp, tp = family(arch)
    S = 4 * cfg.sliding_window
    toks = tokens(cfg, S, 1)
    want, _ = jax.jit(lambda p, t: jlm.forward(p, t, jcfg))(
        jp, jnp.asarray(toks))
    got, _ = lm.forward(tp, torch.from_numpy(toks), cfg)
    close(got, want)
    assert banded_calls == [S] * 3
    want, jc = jax.jit(lambda p, t: jlm.prefill(p, t, jcfg, S + 8))(
        jp, jnp.asarray(toks))
    got, tc = lm.prefill(tp, torch.from_numpy(toks), cfg, S + 8)
    close(got, want)
    for name in tc:
        close(tc[name], jc[name])
    assert banded_calls == [S] * 6


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax(arch, banded_calls):
    """``models.loss_fn`` (remat, JAX's default) at S = 4w: the loss to
    1e-5 and every gradient to 1e-4 of its leaf's largest entry, against
    ``jax.value_and_grad`` of JAX's."""
    jcfg, cfg, jp, tp = family(arch)
    toks = tokens(cfg, 4 * cfg.sliding_window, 2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.loss_fn(p, b, jcfg), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, tg = value_and_grad(
        lambda p, b: models.loss_fn(p, b, cfg), lm.param_dict(tp),
        {"tokens": torch.from_numpy(toks)})
    # each local layer in the forward and again in remat's recompute
    assert banded_calls == [4 * cfg.sliding_window] * 6
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    grads = convert.params_to_numpy(lm.from_param_dict(tg, cfg))
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max()),
        grads, jg)


# (arch, heads, kv heads, program, mesh): gemma3's heads split over the
# model axis with the kv heads repeated, hymba's 5 heads split the query
# rows (on (1, 8) 32 rows a card, half a window)
COUNT_CASES = [("gemma3-4b", 4, 2, "train", (2, 4)),
               ("gemma3-4b", 4, 2, "prefill", (2, 4)),
               ("hymba-1.5b", 5, 1, "train", (2, 4)),
               ("hymba-1.5b", 5, 1, "prefill", (2, 4)),
               ("hymba-1.5b", 5, 1, "prefill", (1, 8))]
COUNT_S, COUNT_B, LOGIT_CHUNK = 4 * 64, 8, 512


@pytest.fixture(scope="module", autouse=True)
def jax_counts():
    """JAX's counts of ``COUNT_CASES`` by case, from two subprocesses
    that start with the module's first test and work while the others
    run: hymba's train step compiles about as long as the other cases
    together."""
    slow = [c for c in COUNT_CASES if c[0] == "hymba-1.5b" and c[3] == "train"]
    by_case = {}
    for part in (slow, [c for c in COUNT_CASES if c not in slow]):
        ratios = parity.JaxRatios([[a, h, hk, k, list(s), COUNT_B, None,
                                    COUNT_S, GROUPED]
                                   for a, h, hk, k, s in part])
        by_case.update((c, ratios) for c in part)
    yield by_case
    for ratios in set(by_case.values()):
        if ratios.proc.poll() is None:
            ratios.proc.kill()
            ratios.proc.communicate()


def jax_excess(cfg, kind):
    """What JAX's one-card train program computes beyond the port's,
    in FLOPs: the dry run's loss pads the last 512-row logit chunk
    (B x 257 rows at S = 256, each a head product forward and two
    backward; the port's chunk is ragged), and JAX's remat wraps each
    tail layer in ``jax.checkpoint``, which traces its Python-bool
    globality, so a local tail layer attends masked (S keys a row, not
    2w) in the forward, the recompute and the backward's two products
    each of QK and PV.  Prefill computes the same in both."""
    if kind != "train":
        return 0
    S, w, H = COUNT_S, cfg.sliding_window, cfg.num_heads
    pad = COUNT_B * (-(S - 1) % LOGIT_CHUNK)
    head = 3 * pad * 2 * cfg.d_model * cfg.vocab_size
    ng, g, _ = L.layer_groups(cfg)
    tails = sum((i + 1) % g != 0 for i in range(ng * g, cfg.num_layers))
    masked = 8 * 2 * COUNT_B * H * S * (S - 2 * w) * cfg.resolved_head_dim
    return head + tails * masked


@pytest.mark.parametrize("case", COUNT_CASES, ids=parity.case_id)
def test_per_card_flops_at_most_jax(case, jax_counts):
    """The port's per-card ratio at most JAX's (JAX's own are 1.0), and
    its one-card count JAX's within 1% once ``jax_excess`` is added."""
    arch, h, hk, kind, shape = case
    cfg = dataclasses.replace(parity.cfg_of(arch, h, hk), **GROUPED)
    one, many = (parity.count(cfg, kind, s, batch=COUNT_B, seq=COUNT_S)
                 .cost.flops for s in ((1, 1), shape))
    k = parity.key(*case, seq=COUNT_S, over=GROUPED)
    jax_one = jax_counts[case][k + "/one"]
    assert abs(one + jax_excess(cfg, kind) - jax_one) <= 0.01 * jax_one, \
        (case, one, jax_one)
    ratio = many * math.prod(shape) / one
    jax_ratio = jax_counts[case][k]
    assert ratio <= jax_ratio + 1e-9, (case, ratio, jax_ratio)
