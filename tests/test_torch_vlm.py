"""The port's VLM prefix (phi-3-vision-4.2b: the dense decoder with P
stub patch embeddings in front of the tokens) against
``repro.models.lm``, and the launcher on the VLM and the
encoder-decoder.

Everything runs in f32 on the CPU at
``reduced(get_config("phi-3-vision-4.2b"))``: 2 layers, d 256, 4/4
heads, hd 64, vocab 1024, a prefix of P = 16.  Parameters come from
``test_torch_dense_configs.np_tree`` (numpy, seeded) and reach the port
through ``convert.params_from_numpy``; the prefix is numpy too.  Logits,
hidden states and caches agree to rtol = atol = 1e-4 (f32 sums in
another order through two layers and the LM head, as
``test_torch_lm``); the loss to 1e-5 and the gradients to 1e-4 relative
to each leaf's largest entry, as ``test_torch_train``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm as jlm
from repro_torch import convert, models, serve
from repro_torch.configs import get_config, reduced
from repro_torch.core.diloco import value_and_grad
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from test_torch_dense_configs import np_tree
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "phi-3-vision-4.2b"
JCFG = jax_reduced(jax_get_config(ARCH))
CFG = reduced(get_config(ARCH))
P = CFG.num_prefix_tokens            # 16 at reduced size


def both(seed=0):
    tree = np_tree(JCFG, seed)
    return (tree, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, CFG, device="cpu"))


def prefix(B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, P, CFG.d_model)).astype(np.float32)


def tokens(B, S, seed=0):
    return np.random.default_rng(seed + 100).integers(0, CFG.vocab_size,
                                                      (B, S))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_config_is_accepted_and_whisper_is_not():
    lm.check_arch(CFG)
    with pytest.raises(NotImplementedError, match="models.encdec"):
        lm.check_arch(reduced(get_config("whisper-small")))


def test_forward_and_backbone_with_prefix():
    _, jp, tp = both()
    pre, toks = prefix(2), tokens(2, 9)
    want, _ = jlm.forward(jp, jnp.asarray(toks), JCFG,
                          prefix_emb=jnp.asarray(pre))
    got, aux = lm.forward(tp, torch.from_numpy(toks), CFG,
                          prefix_emb=torch.from_numpy(pre))
    assert got.shape == (2, P + 9, CFG.vocab_size)
    close(got, want)
    assert float(aux) == 0.0
    want_h, _ = jlm.backbone(jp, jnp.asarray(toks), JCFG,
                             prefix_emb=jnp.asarray(pre))
    got_h, _ = lm.backbone(tp, torch.from_numpy(toks), CFG,
                           prefix_emb=torch.from_numpy(pre))
    close(got_h, want_h)


@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_prefix_loss_and_grads_match(chunk):
    tree, jp, _ = both(1)
    pre, toks = prefix(3, seed=1), tokens(3, 11, seed=1)
    (jl, _), jg = jax.value_and_grad(
        lambda p, b: jmodels.loss_fn(p, b, JCFG, logit_chunk=chunk,
                                     remat=False),
        has_aux=True)(jp, {"tokens": jnp.asarray(toks),
                           "prefix_emb": jnp.asarray(pre)})
    flat = lm.param_dict(convert.params_from_numpy(tree, CFG, device="cpu"))
    tl, _, tg = value_and_grad(
        lambda p, b: models.loss_fn(p, b, CFG, logit_chunk=chunk), flat,
        {"tokens": torch.from_numpy(toks), "prefix_emb": torch.from_numpy(pre)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    got = convert.params_to_numpy(lm.from_param_dict(tg, CFG))
    # tree.map needs the same tree on both sides: every leaf is compared
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max()), got, jg)


def test_example_batch_loss_matches():
    """``models.example_batch`` feeds both losses the same prefix."""
    tree, jp, tp = both(2)
    want, _ = jmodels.loss_fn(jp, jmodels.example_batch(JCFG, 2, 7), JCFG)
    got, _ = models.loss_fn(lm.param_dict(tp),
                            models.example_batch(CFG, 2, 7, device="cpu"),
                            CFG)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache_len", [40, 20])
def test_prefill_with_prefix_then_decode(cache_len):
    """P + S = 24 positions, then 5 decode steps; cache_len 20 < 24
    exercises the ring scatter and its wrap."""
    _, jp, tp = both(3)
    pre, toks, nxt = prefix(2, seed=3), tokens(2, 8, seed=3), tokens(2, 5, 4)
    want, jc = jlm.prefill(jp, jnp.asarray(toks), JCFG, cache_len,
                           prefix_emb=jnp.asarray(pre))
    got, tc = lm.prefill(tp, torch.from_numpy(toks), CFG, cache_len,
                         prefix_emb=torch.from_numpy(pre))
    close(got, want)
    for name in ("k", "v"):
        close(tc[name], jc[name])
    got_k, _ = models.prefill(tp, torch.from_numpy(toks), CFG, cache_len,
                              prefix_emb=torch.from_numpy(pre),
                              use_kernels=True)
    torch.testing.assert_close(got_k, got, rtol=0, atol=0)
    jstep = jax.jit(jlm.decode_step, static_argnames="cfg")
    for i in range(nxt.shape[1]):
        pos = P + toks.shape[1] + i
        want, jc = jstep(jp, jc, jnp.asarray(nxt[:, i]), jnp.int32(pos),
                         cfg=JCFG)
        got, tc = models.decode_step(tp, tc, torch.from_numpy(nxt[:, i]),
                                     pos, CFG)
        close(got, want)
    for name in ("k", "v"):
        close(tc[name], jc[name])


def test_generate_with_prefix_matches_jax():
    _, jp, tp = both(4)
    pre, prompts = prefix(2, seed=5), tokens(2, 6, seed=5)
    want = jserve.generate(jp, JCFG, jnp.asarray(prompts, jnp.int32),
                           max_new_tokens=6, prefix_emb=jnp.asarray(pre))
    got = serve.generate(tp, CFG, prompts, max_new_tokens=6,
                         prefix_emb=torch.from_numpy(pre))
    assert got.tokens == want.tokens
    with pytest.raises(ValueError, match="prefix"):
        serve.generate(tp, CFG, prompts, max_new_tokens=6, cache_len=P + 6,
                       prefix_emb=torch.from_numpy(pre))


def test_launcher_trains_the_vlm_text_only(capsys):
    pool, hist, cfg = launch_train.run([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--outer-steps", "2",
        "--inner-steps", "1", "--trainers", "1", "--workers", "1",
        "--seq-len", "16", "--stats-probe-size", "2", "--max-batch", "2"])
    assert cfg.arch_type == "vlm" and len(hist.loss) == 2
    assert all(np.isfinite(hist.loss))
    assert "[train] final loss=" in capsys.readouterr().out


def test_launcher_refuses_the_encoder_decoder():
    with pytest.raises(NotImplementedError, match="frames"):
        launch_train.make_configs(launch_train.parse_args(
            ["--arch", "whisper-small", "--reduced"]))
