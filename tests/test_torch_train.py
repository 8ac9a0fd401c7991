"""The port's training loss, its gradients and the per-sample statistics
against the JAX package, on ``reduced(get_config("microllama-300m"))``
in f32 (2 layers, d 256, 4/2 heads, vocab 1024) on the CPU.

Parameters come from ``test_torch_lm.np_params`` (numpy, seeded) and
reach the port through ``convert.params_from_numpy`` and
``lm.param_dict``.  Loss within 1e-5; gradients within 1e-4 relative to
each leaf's largest entry (f32 sums taken in another order through two
layers and the LM head, then differentiated); the per-sample GradStats
within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.core import batching as jb
from test_torch_lm import CFG, JCFG, np_params, one_torch_thread  # noqa: F401
from repro_torch import convert, models
from repro_torch.core import batching as tb
from repro_torch.core.diloco import value_and_grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers, lm


def _flat(tree):
    return lm.param_dict(convert.params_from_numpy(tree, CFG, device="cpu"))


def _tree(flat):
    return convert.params_to_numpy(lm.from_param_dict(flat, CFG))


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


def _jloss(chunk):
    return lambda p, b: jmodels.loss_fn(p, b, JCFG, logit_chunk=chunk)


def _tloss(chunk):
    return lambda p, b: models.loss_fn(p, b, CFG, logit_chunk=chunk)


@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_loss_and_grads_match(chunk):
    tree = np_params(CFG, 1)
    toks = _tokens(3, 17, 2)
    (jl, jaux), jg = jax.value_and_grad(_jloss(chunk), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    flat = _flat(tree)
    before = {k: v.clone() for k, v in flat.items()}
    tl, taux, tg = value_and_grad(_tloss(chunk), flat,
                                  {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    got = _tree(tg)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max()), got, jg)
    assert all(torch.equal(flat[k], before[k]) for k in flat)
    assert not any(v.requires_grad for v in tg.values())


def test_module_and_dict_routes_agree():
    """``models.loss_fn`` on the dict (``functional_call`` on a meta
    template) is ``lm.loss_fn`` on the module."""
    tree = np_params(CFG, 2)
    batch = {"tokens": torch.from_numpy(_tokens(2, 9, 3))}
    module = convert.params_from_numpy(tree, CFG, device="cpu")
    a, _ = lm.loss_fn(module, batch, CFG)
    b, _ = models.loss_fn(lm.param_dict(module), batch, CFG)
    assert torch.equal(a, b)


def test_per_sample_stats_match():
    tree = np_params(CFG, 3)
    probe = _tokens(4, 12, 4)
    want = jb.per_sample_stats(_jloss(None), jax.tree.map(jnp.asarray, tree),
                               {"tokens": jnp.asarray(probe)})
    flat = _flat(tree)
    G = tb.per_sample_grads(_tloss(None), flat,
                            {"tokens": torch.from_numpy(probe)})
    assert G.shape == (4, CFG.param_count()) and G.dtype == torch.float32
    got = tb.stats_from_matrix(G, use_kernel=True)
    scale = max(abs(float(v)) for v in want)
    for name, x, y in zip(tb.GradStats._fields, got, want):
        assert abs(float(x) - float(y)) <= 1e-4 * (abs(float(y)) + scale), \
            (name, float(x), float(y))
    # row i is the gradient of sample i as a batch of one
    _, _, g1 = value_and_grad(_tloss(None), flat,
                              {"tokens": torch.from_numpy(probe[1:2])})
    row = torch.cat([g.reshape(-1) for g in g1.values()])
    assert torch.equal(G[1], row)


def test_plain_attention_route_keeps_gradients():
    """On the CPU the flash wrapper runs its plain version, which
    autograd differentiates like ``layers.sdpa``."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, h, 32))
                                .astype(np.float32)).requires_grad_()
               for h in (4, 2, 2))
    out = flash_ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    g_flash = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = layers.sdpa(q, k, v, causal=True)
    g_ref = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(g_flash, g_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
def test_flash_kernel_refuses_inputs_that_need_gradients():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    q, k, v = (torch.randn((1, 64, h, 64), device="cuda") for h in (4, 2, 2))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="plain path"):
        flash_ops.flash_attention(q, k, v)
    with torch.no_grad():
        out = flash_ops.flash_attention(q, k, v)
    assert out.shape == q.shape
