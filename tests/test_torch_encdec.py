"""The port's encoder-decoder (``models.encdec``, whisper-small) against
``repro.models.encdec``, plus ``models.example_batch`` and
``layers.gelu_mlp``.

Everything runs in f32 on the CPU at ``reduced(get_config("whisper-small"))``:
2 encoder and 2 decoder layers, d 256, 4/4 heads, hd 64, vocab 1024,
16 frames.  Parameters come from ``np_tree`` (numpy, seeded, every leaf
of the JAX init's tree, the MLP biases drawn too) and reach the port
through ``convert.params_from_numpy``.  Encoder states, logits and
caches agree to rtol = atol = 1e-4 (f32 sums in another order through
the layers and the tied head, as ``test_torch_lm``); the loss to 1e-5
and the gradients to 1e-4 relative to each leaf's largest entry, as
``test_torch_train``.
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
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import convert, models, serve
from repro_torch.configs import get_config, reduced
from repro_torch.core.diloco import value_and_grad
from repro_torch.models import encdec, layers
from repro_torch.serve.scheduler import ContinuousBatcher, DenseBatcher
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-small"
JCFG = jax_reduced(jax_get_config(ARCH))
CFG = reduced(get_config(ARCH))
F = CFG.num_prefix_tokens            # 16 frames at reduced size


def np_tree(jcfg, seed=0):
    """Every leaf of ``repro.models.init_params``'s tree for ``jcfg``, as
    numpy f32 from ``seed``: the embedding at scale 0.02, norm weights
    and the MLP biases (zero in the JAX init) at 0.1 so they are
    exercised, every other leaf at 1/sqrt(fan_in) (its second-to-last
    axis)."""
    shapes = jax.eval_shape(lambda: jmodels.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "embed":
            scale = 0.02
        elif "norm" in name or name in ("up_b", "down_b"):
            scale = 0.1
        else:
            scale = 1.0 / np.sqrt(sd.shape[-2])
        return (rng.standard_normal(sd.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def both(seed=0):
    tree = np_tree(JCFG, seed)
    return (tree, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, CFG, device="cpu"))


def frames(B, n=F, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, n, CFG.d_model)).astype(np.float32)


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("arch", ["whisper-small", "phi-3-vision-4.2b",
                                  "microllama-300m"])
def test_example_batch_same_bits(arch):
    """The full configs (bf16 frames / prefix): the same draws, the
    same rounding."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = jmodels.example_batch(jcfg, 2, 8)
    got = models.example_batch(cfg, 2, 8, device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            g = g.view(torch.int16).numpy().view(np.uint16)
        else:
            g = g.numpy()
        w = _bits(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    up, down = (rng.standard_normal(s).astype(np.float32) * 0.3
                for s in ((32, 64), (64, 32)))
    up_b, down_b = (rng.standard_normal(n).astype(np.float32)
                    for n in (64, 32))
    want = jlayers.gelu_mlp(*map(jnp.asarray, (x, up, up_b, down, down_b)))
    got = layers.gelu_mlp(*map(torch.from_numpy, (x, up, up_b, down,
                                                  down_b)))
    close(got, want, rtol=1e-5, atol=1e-5)


def test_convert_round_trips():
    tree, _, tp = both(3)
    assert isinstance(tp, encdec.EncDecLM)
    back = convert.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_encode_and_decode_forward_match():
    _, jp, tp = both()
    fr, toks = frames(2), tokens(2, 10)
    want_enc = jencdec.encode(jp, jnp.asarray(fr), JCFG)
    got_enc = encdec.encode(tp, torch.from_numpy(fr), CFG)
    close(got_enc, want_enc)
    want = jencdec.decode_forward(jp, jnp.asarray(toks), want_enc, JCFG)
    got = encdec.decode_forward(tp, torch.from_numpy(toks), got_enc, CFG)
    assert got.shape == (2, 10, CFG.vocab_size)
    close(got, want)


def test_encode_kernel_route_at_a_padded_length():
    """``use_kernels=True`` runs the flash wrapper's plain version on the
    CPU; F = 200 is no multiple of a tile.  Held to JAX's ``sdpa`` path:
    its Pallas path leaves padded keys unmasked when not causal."""
    _, jp, tp = both(1)
    fr = frames(2, 200, seed=5)
    want = jencdec.encode(jp, jnp.asarray(fr), JCFG, use_kernels=False)
    got = encdec.encode(tp, torch.from_numpy(fr), CFG, use_kernels=True)
    close(got, want)


def _flat(tree):
    return models.lm.param_dict(convert.params_from_numpy(tree, CFG,
                                                          device="cpu"))


def test_loss_and_grads_match():
    tree, jp, _ = both(2)
    fr, toks = frames(3, seed=2), tokens(3, 9, seed=2)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p, b: jmodels.loss_fn(p, b, JCFG, remat=False), has_aux=True)(
        jp, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)})
    flat = _flat(tree)
    before = {k: v.clone() for k, v in flat.items()}
    tl, taux, tg = value_and_grad(
        lambda p, b: models.loss_fn(p, b, CFG), flat,
        {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    got = convert.params_to_numpy(encdec.from_param_dict(tg, CFG))
    # tree.map needs the same tree on both sides: every leaf is compared
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max()), got, jg)
    assert all(torch.equal(flat[k], before[k]) for k in flat)


def test_decode_chain_matches_jax_through_the_ring():
    """cache_len 6 < 11 positions: slots are reused (ring semantics)."""
    _, jp, tp = both(4)
    fr, toks = frames(2, seed=4), tokens(2, 11, seed=4)
    C = 6
    jc = jencdec.init_cache(JCFG, jp, jnp.asarray(fr), C)
    tc = models.init_cache(CFG, tp, 2, C, frames=torch.from_numpy(fr))
    close(tc["xk"], jc["xk"])
    close(tc["xv"], jc["xv"])
    jstep = jax.jit(jencdec.decode_step, static_argnames="cfg")
    for t in range(toks.shape[1]):
        want, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                         cfg=JCFG)
        got, tc = models.decode_step(tp, tc, torch.from_numpy(toks[:, t]),
                                     t, CFG)
        close(got, want)
    for name in ("k", "v"):
        close(tc[name], jc[name])


def test_decode_steps_equal_teacher_forcing():
    _, _, tp = both(5)
    fr, toks = torch.from_numpy(frames(2, seed=6)), tokens(2, 7, seed=6)
    enc_out = encdec.encode(tp, fr, CFG)
    want = encdec.decode_forward(tp, torch.from_numpy(toks), enc_out, CFG)
    cache = encdec.init_cache(CFG, tp, fr, 8)
    for t in range(toks.shape[1]):
        got, cache = encdec.decode_step(tp, cache, toks[:, t], t, CFG)
        torch.testing.assert_close(got, want[:, t], **TOL)


def test_generate_frames_matches_jax():
    _, jp, tp = both(6)
    fr, prompts = frames(2, seed=7), tokens(2, 3, seed=7)
    want = jserve.generate(jp, JCFG, jnp.asarray(prompts, jnp.int32),
                           max_new_tokens=6, frames=jnp.asarray(fr))
    got = serve.generate(tp, CFG, prompts, max_new_tokens=6,
                         frames=torch.from_numpy(fr))
    assert got.tokens == want.tokens


def test_generate_needs_frames():
    _, _, tp = both()
    with pytest.raises(ValueError, match="frames"):
        serve.generate(tp, CFG, tokens(1, 3), max_new_tokens=2)


def test_decoder_only_entry_points_refuse_encdec():
    _, _, tp = both()
    with pytest.raises(ValueError, match="encoder-decoder"):
        DenseBatcher(tp, CFG, n_slots=2, cache_len=32)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ContinuousBatcher(tp, CFG, n_slots=2, cache_len=32, block_size=8,
                          chunk_size=8)
    with pytest.raises(ValueError, match="encoder-decoder"):
        models.prefill(tp, torch.zeros((1, 4), dtype=torch.long), CFG, 8)
    with pytest.raises(ValueError, match="encoder-decoder"):
        models.init_paged_cache(CFG, 2, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        models.init_cache(CFG, tp, 1, 8)
    cache = models.init_cache(CFG, tp, 1, 8,
                              frames=torch.from_numpy(frames(1)))
    with pytest.raises(ValueError, match="lane"):
        models.decode_step(tp, cache, [1], 0, CFG, active=[True])


def test_init_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_params(CFG, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.example_batch(CFG, 1, 4)
    assert models.init_params(CFG, 0, device="cpu").device.type == "cpu"
