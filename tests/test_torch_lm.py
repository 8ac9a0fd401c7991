"""The port's dense LM entry points against ``repro.models.lm``.

Parameters and tokens are made with numpy from a seed, in the JAX
package's pytree layout (``np_params``); the JAX side takes them as
arrays, the port through ``convert.params_from_numpy``.  Everything runs
in f32 on the CPU at ``reduced(get_config("microllama-300m"))``: 2
layers, d 256, 4/2 heads, hd 64, vocab 1024.  Logits and caches agree to
atol 1e-4 (rtol 1e-4): f32 sums taken in another order, through two
layers and the LM head.
"""
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

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test.  The suite runs in several worker
    processes at once, and torch's default of one thread per core in
    each of them oversubscribes the CPU (the port's tests ran about
    three times slower).  Test files of the port import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
JCFG = jax_reduced(jax_get_config("microllama-300m"))
CFG = reduced(get_config("microllama-300m"))


def np_params(cfg, seed=0):
    """JAX-layout parameter tree of numpy f32 arrays (layers stacked on
    a leading L axis), with the JAX init's scales and small random norm
    weights so the (1 + w) scale is exercised."""
    rng = np.random.default_rng(seed)
    L, d, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size

    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {
        "embed": w(V, d, scale=0.02),
        "layers": {
            "attn_norm": w(L, d, scale=0.1),
            "attn": {"q": w(L, d, cfg.q_dim), "k": w(L, d, cfg.kv_dim),
                     "v": w(L, d, cfg.kv_dim), "o": w(L, cfg.q_dim, d)},
            "mlp_norm": w(L, d, scale=0.1),
            "gate": w(L, d, F), "up": w(L, d, F), "down": w(L, F, d),
        },
        "final_norm": w(d, scale=0.1),
        "lm_head": w(d, V),
    }


def both_params(seed=0):
    tree = np_params(CFG, seed)
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, CFG, device="cpu"))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_convert_round_trips():
    tree = np_params(CFG, 3)
    back = convert.params_to_numpy(
        convert.params_from_numpy(tree, CFG, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    bf = convert.params_from_numpy(
        tree, CFG.with_overrides(dtype="bfloat16"), device="cpu")
    assert bf.embed.dtype == torch.bfloat16


def test_forward_logits():
    jp, tp = both_params()
    toks = _tokens(2, 12)
    want, _ = jlm.forward(jp, jnp.asarray(toks), JCFG)
    got, aux = lm.forward(tp, torch.from_numpy(toks), CFG)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("S,cache_len,last_only", [
    (12, 16, False), (12, 8, False), (12, 16, True)])
def test_prefill_logits_and_cache(S, cache_len, last_only):
    """cache_len < S exercises the ring scatter."""
    jp, tp = both_params()
    toks = _tokens(2, S, seed=1)
    want, jc = jlm.prefill(jp, jnp.asarray(toks), JCFG, cache_len,
                           last_only=last_only)
    got, tc = lm.prefill(tp, torch.from_numpy(toks), CFG, cache_len,
                         last_only=last_only)
    _close(got, want)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    # the kernel route (its plain version on the CPU) is the same function
    got_k, tck = lm.prefill(tp, torch.from_numpy(toks), CFG, cache_len,
                            last_only=last_only, use_kernels=True)
    torch.testing.assert_close(got_k, got, rtol=0, atol=0)
    torch.testing.assert_close(tck["k"], tc["k"], rtol=0, atol=0)


def test_decode_steps_scalar_pos():
    jp, tp = both_params()
    toks = _tokens(2, 6, seed=2)
    _, jc = jlm.prefill(jp, jnp.asarray(toks), JCFG, 16)
    _, tc = lm.prefill(tp, torch.from_numpy(toks), CFG, 16)
    nxt = _tokens(2, 8, seed=3)
    for i in range(8):
        want, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[:, i]),
                                   jnp.int32(6 + i), JCFG)
        got, tc = lm.decode_step(tp, tc, torch.from_numpy(nxt[:, i]), 6 + i,
                                 CFG)
        _close(got, want)
    for name in ("k", "v"):
        _close(tc[name], jc[name])


def test_decode_steps_vector_pos_with_active_mask():
    """Per-lane positions; lane 1 is inactive and must keep its rows."""
    jp, tp = both_params()
    B, C = 3, 16
    rng = np.random.default_rng(4)
    cache = {n: rng.standard_normal((CFG.num_layers, B, C, 2, 64))
             .astype(np.float32) for n in ("k", "v")}
    jc = {n: jnp.asarray(a) for n, a in cache.items()}
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    pos = np.array([3, 9, 5])
    active = np.array([True, False, True])
    nxt = _tokens(B, 8, seed=5)
    for i in range(8):
        want, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[:, i]),
                                   jnp.asarray(pos + i), JCFG,
                                   active=jnp.asarray(active))
        got, tc = lm.decode_step(tp, tc, nxt[:, i], pos + i, CFG,
                                 active=active)
        _close(got, want)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
        np.testing.assert_array_equal(tc[name][:, 1].numpy(),
                                      cache[name][:, 1])


def test_paged_chunked_prefill_then_decode():
    jp, tp = both_params()
    bs, nb, num_blocks = 4, 5, 10
    jcache = jlm.init_paged_cache(JCFG, 2, num_blocks, bs)
    tcache = lm.init_paged_cache(CFG, 2, num_blocks, bs, device="cpu")
    tables = np.full((2, nb), -1, np.int32)
    tables[0, :3] = [7, 2, 5]
    tables[1, :2] = [0, 9]
    prompts = [_tokens(1, 10, seed=6)[0], _tokens(1, 6, seed=7)[0]]
    last = []
    for lane, prompt in enumerate(prompts):
        for lo in range(0, len(prompt), 4):
            chunk = prompt[None, lo:lo + 4]
            want, jcache = jlm.prefill_chunk_paged(
                jp, jcache, jnp.asarray(chunk), jnp.int32(lo), JCFG,
                jnp.asarray(tables[lane]), lane, block_size=bs)
            got, tcache = lm.prefill_chunk_paged(
                tp, tcache, chunk, lo, CFG, tables[lane], lane,
                block_size=bs)
            _close(got, want)
        last.append(int(np.argmax(np.asarray(want))))
    pos = np.array([10, 6])
    tok = np.array(last)
    for i in range(2):
        active = np.array([True, i == 0])      # lane 1 idles on step 2
        want, jcache = jlm.decode_step_paged(
            jp, jcache, jnp.asarray(tok), jnp.asarray(pos), JCFG,
            jnp.asarray(tables), jnp.asarray(active), block_size=bs)
        got, tcache = lm.decode_step_paged(
            tp, tcache, tok, pos, CFG, tables, active, block_size=bs)
        _close(got, want)
        tok = np.array(jnp.argmax(want, axis=-1))
        pos = pos + active
    for name in ("kp", "vp"):
        _close(tcache[name], jcache[name])


def test_other_families_raise():
    with pytest.raises(NotImplementedError, match="models.encdec"):
        lm.init_params(reduced(get_config("whisper-small")), device="cpu")
