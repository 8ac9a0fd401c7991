"""The port's SSM and hybrid families against the JAX package.

``reduced(get_config("falcon-mamba-7b"))`` (ssm: 2 Mamba layers, d 256,
di 512, n 8, conv 4, dt rank 16, vocab 1024) and
``reduced(get_config("hymba-1.5b"))`` (hybrid: 2 layers of attention
(4/2 heads, hd 64, window 64) and Mamba heads in parallel, then the
MLP).  Parameters and tokens are made with numpy from a seed in the JAX
package's pytree layout (``np_params``); the JAX side takes them as
arrays, the port through ``convert.params_from_numpy``.  Everything
runs in f32 on the CPU.  The JAX side's ``use_kernels=True`` runs the
Pallas scan in interpret mode, as its own tests do.

Tolerance: atol 1e-4 (rtol 1e-4), as ``test_torch_lm``: f32 sums taken
in another order (the port's log-depth associative scan is not JAX's,
its sequential scan forms a block of steps at once), through two layers
and the LM head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models import lm
from test_torch_lm import np_params as np_dense_params
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]


def cfgs(arch):
    return reduced(get_config(arch)), jax_reduced(jax_get_config(arch))


def np_mamba(cfg, rng, L_=None):
    """A Mamba parameter group of numpy f32 arrays, with the JAX init's
    scales and distributions (small noise on A_log, D and conv_b so
    every term is exercised); a leading L axis when ``L_`` is given."""
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm.state_dim, cfg.dt_rank
    lead = () if L_ is None else (L_,)

    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(lead + shape) * s).astype(np.float32)

    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), lead + (di,)))
    A = np.broadcast_to(np.arange(1, n + 1, dtype=np.float64),
                        lead + (di, n))
    return {
        "in_proj": w(d, 2 * di),
        "conv_w": w(cfg.ssm.conv_dim, di, scale=0.5),
        "conv_b": w(di, scale=0.1),
        "x_proj": w(di, dtr + 2 * n),
        "dt_w": w(dtr, di),
        "dt_b": np.log(np.expm1(dt0)).astype(np.float32),
        "A_log": (np.log(A) + rng.standard_normal(A.shape) * 0.1
                  ).astype(np.float32),
        "D": (1.0 + rng.standard_normal(lead + (di,)) * 0.1
              ).astype(np.float32),
        "out_proj": w(di, d),
    }


def np_params(cfg, seed=0):
    """JAX-layout parameter tree of numpy f32 arrays for an ssm or
    hybrid config (layers stacked on a leading L axis)."""
    rng = np.random.default_rng(seed + 100)
    Ln, d = cfg.num_layers, cfg.d_model
    if cfg.arch_type == "ssm":
        return {
            "embed": (rng.standard_normal((cfg.vocab_size, d)) * 0.02
                      ).astype(np.float32),
            "layers": {"norm": (rng.standard_normal((Ln, d)) * 0.1
                                ).astype(np.float32),
                       "mamba": np_mamba(cfg, rng, Ln)},
            "final_norm": (rng.standard_normal(d) * 0.1).astype(np.float32),
            "lm_head": (rng.standard_normal((d, cfg.vocab_size))
                        / np.sqrt(d)).astype(np.float32),
        }
    tree = np_dense_params(cfg, seed)
    tree["layers"]["mamba"] = np_mamba(cfg, rng, Ln)
    return tree


_PARAMS = {}


def both_params(arch, seed=0):
    key = (arch, seed)
    if key not in _PARAMS:
        cfg, _ = cfgs(arch)
        tree = np_params(cfg, seed)
        _PARAMS[key] = (jax.tree.map(jnp.asarray, tree),
                        convert.params_from_numpy(tree, cfg, device="cpu"))
    return _PARAMS[key]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _mamba_group(arch="falcon-mamba-7b", seed=0):
    """One layer's Mamba group on both sides, and the configs."""
    cfg, jcfg = cfgs(arch)
    p = np_mamba(cfg, np.random.default_rng(seed))
    return (cfg, jcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(cfg, B, S, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
            * scale).astype(np.float32)


def _scan_inputs(B, S, di, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1
          ).astype(np.float32)
    A_log = np.log(np.abs(rng.standard_normal((di, n))) + 0.5
                   ).astype(np.float32)
    Bm = rng.standard_normal((B, S, n)).astype(np.float32)
    Cm = rng.standard_normal((B, S, n)).astype(np.float32)
    h0 = rng.standard_normal((B, di, n)).astype(np.float32)
    return u, dt, A_log, Bm, Cm, h0


# ------------------------------------------------------------------
# layers
# ------------------------------------------------------------------

@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d(with_prev):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    prev = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jp = jnp.asarray(prev) if with_prev else None
    tp = torch.from_numpy(prev) if with_prev else None
    want = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            prev=jp)
    got = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), prev=tp)
    _close(got, want)


@pytest.mark.parametrize("S,with_h0", [(37, True), (16, False), (1, True)])
def test_ssm_scan_seq(S, with_h0):
    u, dt, A_log, Bm, Cm, h0 = _scan_inputs(2, S, 40, 8, seed=S)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    jy, jh = JL.ssm_scan_seq(*map(jnp.asarray, (u, dt, A_log, Bm, Cm)),
                             h0=jh0)
    ty, th = L.ssm_scan_seq(*map(torch.from_numpy, (u, dt, A_log, Bm, Cm)),
                            h0=th0)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("S,chunk", [(70, 32), (256, 256), (5, 256)])
def test_ssm_scan_chunked(S, chunk):
    u, dt, A_log, Bm, Cm, _ = _scan_inputs(1, S, 24, 8, seed=S + 1)
    jy, jh = JL.ssm_scan_chunked(*map(jnp.asarray, (u, dt, A_log, Bm, Cm)),
                                 chunk=chunk)
    ty, th = L.ssm_scan_chunked(*map(torch.from_numpy, (u, dt, A_log, Bm, Cm)),
                                chunk=chunk)
    _close(ty, jy)
    _close(th, jh)


def test_ssm_scan_chunked_gradients_match_jax():
    """The training path: autograd through the log-depth scan gives
    jax.grad's gradients of the same loss, for every input."""
    args = _scan_inputs(2, 19, 16, 8, seed=3)[:5]
    w = np.random.default_rng(4).standard_normal((2, 19, 16)
                                                 ).astype(np.float32)

    def jloss(*a):
        y, h = JL.ssm_scan_chunked(*a, chunk=8)
        return jnp.sum(y * w) + jnp.sum(h)

    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = L.ssm_scan_chunked(*t, chunk=8)
    (torch.sum(y * torch.from_numpy(w)) + torch.sum(h)).backward()
    for g, gw in zip(t, want):
        _close(g.grad, gw)


@pytest.mark.parametrize("impl", ["kernel", "seq", "assoc"])
def test_mamba_forward(impl):
    cfg, jcfg, jp, tp = _mamba_group()
    x = _x(cfg, 2, 11, seed=4)
    kw = (dict(use_kernel=True) if impl == "kernel"
          else dict(scan_impl=impl))
    want, jst = JL.mamba_forward(jp, jnp.asarray(x), jcfg,
                                 return_state=True, **kw)
    got, tst = L.mamba_forward(tp, torch.from_numpy(x), cfg,
                               return_state=True, **kw)
    _close(got, want)
    _close(tst["conv"], jst["conv"])
    _close(tst["ssm"], jst["ssm"])
    with pytest.raises(ValueError, match="scan_impl"):
        L.mamba_forward(tp, torch.from_numpy(x), cfg, scan_impl="nope")


def test_mamba_decode():
    cfg, jcfg, jp, tp = _mamba_group(seed=5)
    rng = np.random.default_rng(6)
    x = _x(cfg, 3, 1, seed=7)
    conv = rng.standard_normal((3, 3, cfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((3, cfg.d_inner, 8)).astype(np.float32)
    want = JL.mamba_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(conv),
                           jnp.asarray(ssm))
    got = L.mamba_decode(tp, torch.from_numpy(x), cfg, torch.from_numpy(conv),
                         torch.from_numpy(ssm))
    for g, w in zip(got, want):
        _close(g, w)


def test_mamba_forward_chunk():
    cfg, jcfg, jp, tp = _mamba_group(seed=8)
    rng = np.random.default_rng(9)
    x = _x(cfg, 1, 6, seed=10)
    conv = rng.standard_normal((1, 3, cfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((1, cfg.d_inner, 8)).astype(np.float32)
    want, jst = JL.mamba_forward_chunk(jp, jnp.asarray(x), jcfg,
                                       jnp.asarray(conv), jnp.asarray(ssm))
    got, tst = L.mamba_forward_chunk(tp, torch.from_numpy(x), cfg,
                                     torch.from_numpy(conv),
                                     torch.from_numpy(ssm))
    _close(got, want)
    _close(tst["conv"], jst["conv"])
    _close(tst["ssm"], jst["ssm"])


@pytest.mark.parametrize("S", [1, 2, 3, 6])
def test_prefill_conv_state_is_left_padded(S):
    """The decode conv state after S tokens: the last cw-1 raw inputs,
    zeros before the sequence (JAX's chunk path; its one-shot slice is
    short for S < cw-1)."""
    cfg, jcfg, jp, tp = _mamba_group(seed=11)
    x = _x(cfg, 1, S, seed=12)
    zero = jnp.zeros((1, 3, cfg.d_inner), jnp.float32)
    _, jst = JL.mamba_forward_chunk(jp, jnp.asarray(x), jcfg, zero,
                                    jnp.zeros((1, cfg.d_inner, 8)))
    _, tst = L.mamba_forward(tp, torch.from_numpy(x), cfg,
                             return_state=True, scan_impl="seq")
    assert tst["conv"].shape == (1, 3, cfg.d_inner)
    _close(tst["conv"], jst["conv"])


# ------------------------------------------------------------------
# the model
# ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    cfg, jcfg = cfgs(arch)
    jp, tp = both_params(arch)
    toks = _tokens(cfg, 2, 12)
    want, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = lm.forward(tp, torch.from_numpy(toks), cfg)
    _close(got, want)
    assert float(aux) == 0.0
    jl, _ = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    from repro_torch import models
    tl, m = models.loss_fn(lm.param_dict(tp), {"tokens":
                                               torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert float(m["ce"]) == pytest.approx(float(tl))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch, use_kernels):
    cfg, jcfg = cfgs(arch)
    jp, tp = both_params(arch)
    toks = _tokens(cfg, 2, 10, seed=1)
    want, jc = jlm.prefill(jp, jnp.asarray(toks), jcfg, 16,
                           use_kernels=use_kernels)
    got, tc = lm.prefill(tp, torch.from_numpy(toks), cfg, 16,
                         use_kernels=use_kernels)
    _close(got, want)
    assert sorted(tc) == sorted(jc)
    assert sorted(tc) == (["conv", "ssm"] if arch == "falcon-mamba-7b"
                          else ["conv", "k", "ssm", "v"])
    for name in tc:
        _close(tc[name], jc[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain(arch):
    """Prefill, then decode steps with a scalar position and, from the
    same state, with per-lane positions and lane 1 inactive: its state
    and cache rows must stay as they were."""
    cfg, jcfg = cfgs(arch)
    jp, tp = both_params(arch)
    toks = _tokens(cfg, 3, 6, seed=2)
    _, jc = jlm.prefill(jp, jnp.asarray(toks), jcfg, 16)
    _, tc = lm.prefill(tp, torch.from_numpy(toks), cfg, 16)
    nxt = _tokens(cfg, 3, 5, seed=3)
    for i in range(3):
        want, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[:, i]),
                                   jnp.int32(6 + i), jcfg)
        got, tc = lm.decode_step(tp, tc, torch.from_numpy(nxt[:, i]), 6 + i,
                                 cfg)
        _close(got, want)
    before = {n: t[:, 1].clone() for n, t in tc.items()}
    active = np.array([True, False, True])
    for i in range(3, 5):
        pos = np.array([9, 9, 9]) + (i - 3)
        want, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[:, i]),
                                   jnp.asarray(pos), jcfg,
                                   active=jnp.asarray(active))
        got, tc = lm.decode_step(tp, tc, nxt[:, i], pos, cfg, active=active)
        _close(got, want)
    for name in tc:
        _close(tc[name], jc[name])
        torch.testing.assert_close(tc[name][:, 1], before[name], rtol=0,
                                   atol=0)


def _paged(arch):
    cfg, jcfg = cfgs(arch)
    bs, num_blocks = 4, 10
    return (cfg, jcfg, bs, jlm.init_paged_cache(jcfg, 2, num_blocks, bs),
            lm.init_paged_cache(cfg, 2, num_blocks, bs, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_chunked_prefill_then_decode(arch):
    """prefill_chunk_paged in chunks of 4, then decode_step_paged with
    lane 1 idle on the second step; logits and every cache entry."""
    jp, tp = both_params(arch)
    cfg, jcfg, bs, jcache, tcache = _paged(arch)
    tables = np.full((2, 5), -1, np.int32)
    tables[0, :3] = [7, 2, 5]
    tables[1, :2] = [0, 9]
    prompts = [_tokens(cfg, 1, 10, seed=6)[0], _tokens(cfg, 1, 6, seed=7)[0]]
    last = []
    for lane, prompt in enumerate(prompts):
        for lo in range(0, len(prompt), 4):
            chunk = prompt[None, lo:lo + 4]
            want, jcache = jlm.prefill_chunk_paged(
                jp, jcache, jnp.asarray(chunk), jnp.int32(lo), jcfg,
                jnp.asarray(tables[lane]), lane, block_size=bs)
            got, tcache = lm.prefill_chunk_paged(
                tp, tcache, chunk, lo, cfg, tables[lane], lane,
                block_size=bs)
            _close(got, want)
        last.append(int(np.argmax(np.asarray(want))))
    for name in tcache:
        _close(tcache[name], jcache[name])
    pos, tok = np.array([10, 6]), np.array(last)
    for i in range(2):
        active = np.array([True, i == 0])
        want, jcache = jlm.decode_step_paged(
            jp, jcache, jnp.asarray(tok), jnp.asarray(pos), jcfg,
            jnp.asarray(tables), jnp.asarray(active), block_size=bs)
        got, tcache = lm.decode_step_paged(
            tp, tcache, tok, pos, cfg, tables, active, block_size=bs)
        _close(got, want)
        tok = np.array(jnp.argmax(want, axis=-1))
        pos = pos + active
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_one_shot(arch):
    """Chunks of 3 through prefill_chunk_paged give one-shot prefill's
    last logits and Mamba state (the port alone)."""
    jp, tp = both_params(arch)
    cfg, _, bs, _, tcache = _paged(arch)
    prompt = _tokens(cfg, 1, 11, seed=8)
    table = np.array([3, 1, 4, -1, -1], np.int32)
    for lo in range(0, 11, 3):
        got, tcache = lm.prefill_chunk_paged(tp, tcache, prompt[:, lo:lo + 3],
                                             lo, cfg, table, 1, block_size=bs)
    want, oc = lm.prefill(tp, torch.from_numpy(prompt), cfg, 16,
                          last_only=True)
    torch.testing.assert_close(got, want[:, -1], **TOL)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(tcache[name][:, 1], oc[name][:, 0], **TOL)
        assert not tcache[name][:, 0].any()          # lane 0 untouched


def test_bf16_keeps_f32_leaves_through_convert():
    cfg, _ = cfgs("hymba-1.5b")
    tree = np_params(cfg, seed=3)
    bf = cfg.with_overrides(dtype="bfloat16")
    params = convert.params_from_numpy(tree, bf, device="cpu")
    m = params.layers[0].mamba
    for name, t in m.items():
        want = (torch.float32 if name in L.MAMBA_F32_LEAVES
                else torch.bfloat16)
        assert t.dtype == want, name
    assert params.layers[1].attn["q"].dtype == torch.bfloat16
    back = convert.params_to_numpy(params)
    for name in L.MAMBA_F32_LEAVES:                  # exact, both ways
        np.testing.assert_array_equal(back["layers"]["mamba"][name],
                                      tree["layers"]["mamba"][name])
    assert not np.array_equal(back["layers"]["mamba"]["in_proj"],
                              tree["layers"]["mamba"]["in_proj"])
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    # and the port's own init keeps them f32 in a bf16 model
    own = lm.init_params(reduced(get_config("falcon-mamba-7b")
                                 ).with_overrides(dtype="bfloat16"),
                         device="cpu")
    assert own.layers[0].mamba["A_log"].dtype == torch.float32
    assert own.layers[0].mamba["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_jax(arch):
    """The port's seeded init has the JAX tree's names, shapes and
    dtypes (bits differ: the streams are not JAX's)."""
    cfg, jcfg = cfgs(arch)
    jtree = jax.eval_shape(lambda: jlm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    ttree = convert.params_to_numpy(lm.init_params(cfg, 0, device="cpu"))
    assert jax.tree.structure(jtree) == jax.tree.structure(ttree)
    for j, t in zip(jax.tree.leaves(jtree), jax.tree.leaves(ttree)):
        assert j.shape == t.shape
    m = lm.init_params(cfg, 0, device="cpu").layers[0].mamba
    np.testing.assert_allclose(torch.exp(m["A_log"])[0].numpy(),
                               np.arange(1, cfg.ssm.state_dim + 1))
    dt = torch.nn.functional.softplus(m["dt_b"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
