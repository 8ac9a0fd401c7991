"""Dense layers of the port against ``repro.models.layers``.

Inputs and weights are made with numpy from a seed and handed to both
frameworks in f32 at ``reduced(get_config("microllama-300m"))``'s widths;
outputs agree to rtol = atol = 1e-5 (f32 sums taken in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as J
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as T
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
JCFG = jax_reduced(jax_get_config("microllama-300m"))
CFG = reduced(get_config("microllama-300m"))


def _rng(seed):
    return np.random.default_rng(seed)


def _attn_params(rng, cfg):
    d, s = cfg.d_model, 1.0 / np.sqrt(cfg.d_model)
    return {n: (rng.standard_normal(shape) * s).astype(np.float32)
            for n, shape in (("q", (d, cfg.q_dim)), ("k", (d, cfg.kv_dim)),
                             ("v", (d, cfg.kv_dim)), ("o", (cfg.q_dim, d)))}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_config_copies_match_reference():
    from repro.configs import ARCH_REGISTRY as JREG
    from repro_torch.configs import ARCH_REGISTRY
    assert sorted(ARCH_REGISTRY) == sorted(JREG)
    for name, cfg in ARCH_REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JREG[name])
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


def test_rms_norm():
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    w = rng.standard_normal((256,)).astype(np.float32) * 0.1
    _close(T.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           J.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_rope():
    rng = _rng(1)
    pos = np.array([0, 3, 17, 250, 4095])
    cj, sj = J.rope_cos_sin(jnp.asarray(pos), 64, 10_000.0)
    ct, st = T.rope_cos_sin(torch.from_numpy(pos), 64, 10_000.0)
    _close(ct, cj)
    _close(st, sj)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    _close(T.apply_rope(torch.from_numpy(x), ct, st),
           J.apply_rope(jnp.asarray(x), cj, sj))


def test_swiglu():
    rng = _rng(2)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.06
          for s in ((256, 512), (256, 512), (512, 256))]
    _close(T.swiglu(torch.from_numpy(x), *map(torch.from_numpy, ws)),
           J.swiglu(jnp.asarray(x), *map(jnp.asarray, ws)))


def test_qkv_project():
    rng = _rng(3)
    p = _attn_params(rng, CFG)
    x = rng.standard_normal((2, 7, 256)).astype(np.float32)
    pos = np.arange(3, 10)
    want = J.qkv_project(_j(p), jnp.asarray(x), JCFG, jnp.asarray(pos))
    got = T.qkv_project(_t(p), torch.from_numpy(x), CFG, torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (False, None, 0), (True, 5, 0), (True, None, 4)])
def test_sdpa(causal, window, q_offset):
    rng = _rng(4)
    q = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 9 + q_offset, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 9 + q_offset, 2, 64)).astype(np.float32)
    _close(T.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                  window=window, q_offset=q_offset),
           J.sdpa(*map(jnp.asarray, (q, k, v)), causal=causal,
                  window=window, q_offset=q_offset))


@pytest.mark.parametrize("vector_pos,window", [(False, None), (True, None),
                                               (True, 6)])
def test_decode_attention(vector_pos, window):
    rng = _rng(5)
    p = _attn_params(rng, CFG)
    B, C = 3, 12
    x = rng.standard_normal((B, 1, 256)).astype(np.float32)
    kc = rng.standard_normal((B, C, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((B, C, 2, 64)).astype(np.float32)
    pos = np.array([4, 11, 7]) if vector_pos else np.array(9)
    slot = np.arange(C)
    kv_pos = (np.stack([slot, slot - 3, np.where(slot < 8, slot, -1)])
              if vector_pos else None)
    want = J.decode_attention(
        _j(p), jnp.asarray(x), JCFG, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos), window=window,
        kv_pos_of_slot=None if kv_pos is None else jnp.asarray(kv_pos))
    got = T.decode_attention(
        _t(p), torch.from_numpy(x), CFG, torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(pos), window=window,
        kv_pos_of_slot=None if kv_pos is None else torch.from_numpy(kv_pos))
    _close(got, want)


@pytest.mark.parametrize("window", [None, 5])
def test_gathered_attention(window):
    rng = _rng(6)
    B, Sq, C = 2, 4, 16
    q = rng.standard_normal((B, Sq, 4, 64)).astype(np.float32)
    kc = rng.standard_normal((B, C, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((B, C, 2, 64)).astype(np.float32)
    qpos = np.array([[4, 5, 6, 7], [8, 9, 10, 11]])
    kv_pos = np.stack([np.where(np.arange(C) < 8, np.arange(C), -1),
                       np.arange(C)])
    _close(T.gathered_attention(*map(torch.from_numpy, (q, kc, vc, qpos,
                                                        kv_pos)),
                                window=window),
           J.gathered_attention(*map(jnp.asarray, (q, kc, vc, qpos, kv_pos)),
                                window=window))
