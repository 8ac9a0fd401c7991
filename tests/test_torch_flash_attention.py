"""Flash attention: the port's wrapper against the JAX package.

On the CPU the port's wrapper runs its plain version; the JAX side runs
the Pallas kernel in interpret mode (``repro.kernels.flash_attention.ops``),
as ``tests/test_kernels.py`` does.  Inputs are made with numpy from a
seed and cast to bf16 by both frameworks with round-to-nearest-even, so
both sides see the same values.  Tolerances are ``tests/test_kernels.py``'s
``_tol``: 2e-5 in f32, 2e-2 in bf16.

The padded bidirectional case is held against JAX ``layers.sdpa``, not
the Pallas kernel: the Pallas wrapper zero-pads S and its kernel lets
padded keys into a bidirectional softmax (an error of about 0.1).

The training route (``ops.flash_attention_train``, taken by
``layers.policy_sdpa`` where ``ops.takes_train_kernel`` holds) runs on
the card only.  Its dispatch rule is checked here on the CPU with the
device test set aside (``pretend_card``); its kernels by the ``gpu``
tests, whose checks live in ``flash_train_card`` (no JAX, so they also
run alone on a card without it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as jax_layers
import flash_train_card
from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import dryrun
from repro_torch.models import layers as L
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (B, S, H, Hk, hd, window, causal, dtype): tests/test_kernels.py's
# FLASH_CASES, plus a ragged S = 200
CASES = [
    (2, 256, 4, 2, 64, None, True, "float32"),
    (1, 128, 8, 8, 32, None, True, "float32"),
    (2, 256, 4, 1, 64, 100, True, "float32"),
    (1, 384, 6, 3, 128, 64, True, "float32"),
    (1, 256, 2, 2, 64, None, False, "float32"),     # bidirectional
    (2, 192, 4, 2, 64, None, True, "bfloat16"),     # bf16 + pad (192)
    (1, 96, 4, 4, 80, None, True, "float32"),       # odd hd, pad
    (2, 200, 4, 2, 64, None, True, "float32"),      # ragged S
]


def _inputs(B, S, H, Hk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, Hk, hd), np.float32),
            rng.standard_normal((B, S, Hk, hd), np.float32))


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@pytest.mark.parametrize("B,S,H,Hk,hd,window,causal,dtype", CASES)
def test_cpu_wrapper_matches_pallas_kernel(B, S, H, Hk, hd, window, causal,
                                           dtype):
    arrs = _inputs(B, S, H, Hk, hd)
    want = jax_flash(*_jax(arrs, dtype), causal=causal, window=window)
    got = ops.flash_attention(*_torch(arrs, dtype), causal=causal,
                              window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_padded_bidirectional_matches_sdpa():
    arrs = _inputs(1, 192, 4, 2, 64, seed=1)
    want = jax_layers.sdpa(*_jax(arrs, "float32"), causal=False)
    got = ops.flash_attention(*_torch(arrs, "float32"), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_window_forms_agree():
    """None, a Python int and a 0-d integer tensor are all windows; a
    float or shaped tensor is not."""
    q, k, v = _torch(_inputs(1, 64, 2, 1, 32, seed=2), "float32")
    full = ops.flash_attention(q, k, v, window=None)
    torch.testing.assert_close(
        full, ops.flash_attention(q, k, v, window=ops.GLOBAL_WINDOW),
        rtol=0, atol=0)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, window=9),
        ops.flash_attention(q, k, v, window=torch.tensor(9, dtype=torch.int32)),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="0-d integer"):
        ops.flash_attention(q, k, v, window=torch.tensor(9.0))
    with pytest.raises(ValueError, match="0-d integer"):
        ops.flash_attention(q, k, v, window=torch.tensor([9]))


def test_cpu_path_counts_no_launch_and_binding_rejects_cpu():
    """The CPU path is the plain version: no kernel launch is counted on
    any path, and the CUDA binding refuses CPU tensors (before any
    build)."""
    q, k, v = _torch(_inputs(1, 32, 2, 1, 32, seed=3), "float32")
    before = ops.launches, ops.tc_launches, ops.fma_launches
    ops.flash_attention(q, k, v)
    ops.flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)))
    assert (ops.launches, ops.tc_launches, ops.fma_launches) == before
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention_fwd(q, k, v, causal=True, window=8)
    # the training kernels take bf16 of hd 64 or 128 on the card only
    with pytest.raises(ValueError, match="training kernels"):
        kernel.flash_attention_fwd_lse(q, k, v)
    qb, kb, vb = _torch(_inputs(1, 32, 2, 1, 64, seed=3), "bfloat16")
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention_fwd_lse(qb, kb, vb)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention_bwd(qb, kb, vb, qb, None, qb)
    assert kernel.padded_len(1000) == 1024 and kernel.padded_len(64) == 64


@pytest.mark.parametrize("dtype,hd,path", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 80, "tc"), (torch.bfloat16, 96, "tc"),
    (torch.bfloat16, 32, "tc"), (torch.bfloat16, 40, "fma"),
    (torch.bfloat16, 72, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 40, "fma"),
    (torch.bfloat16, 256, "tc"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 136, "fma"),
])
def test_path_choice_by_dtype_and_head_dim(dtype, hd, path):
    """bf16 with hd % 16 == 0 takes the tensor-core kernel; f32 (TF32
    would keep three digits) and other bf16 head dims the FMA kernel."""
    assert kernel.choose_path(dtype, hd) == path


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 264), (torch.float32, 512), (torch.bfloat16, 260),
    (torch.bfloat16, 20), (torch.float16, 64)])
def test_path_choice_rejects_what_no_kernel_takes(dtype, hd):
    with pytest.raises(ValueError):
        kernel.choose_path(dtype, hd)


# (B, S, H, Hk, hd, window, causal, dtype) as chip_smoke.py checks them
GPU_CASES = [
    (4, 512, 16, 4, 64, None, True, "bfloat16"),
    (4, 512, 16, 4, 64, None, True, "float32"),
    (1, 2048, 16, 4, 64, None, True, "bfloat16"),
    (2, 1536, 25, 5, 64, 1024, True, "bfloat16"),
    (2, 1536, 25, 5, 64, None, True, "bfloat16"),
    (2, 200, 4, 2, 64, None, True, "float32"),
    (2, 256, 4, 1, 64, 100, True, "float32"),
    (1, 384, 6, 3, 128, 64, True, "float32"),
    (1, 96, 4, 4, 80, None, True, "float32"),
    (1, 128, 8, 8, 32, None, True, "float32"),
    (1, 192, 4, 2, 64, None, False, "float32"),
    (2, 2048, 8, 4, 256, None, True, "bfloat16"),      # gemma3-4b global
    (2, 2048, 8, 4, 256, 1024, True, "bfloat16"),      # gemma3-4b local
    (1, 300, 8, 4, 256, 100, True, "float32"),
]


# bf16 edge cases of the tensor-core kernel: hd 128, hd 80 and 32 (hd
# past a 64-dim block and short of one), ragged S, a window smaller than
# a tile, bidirectional at a padded S, and a window of 0 (every row
# fully masked: writes 0); hd 256 at a ragged S and hd 192 (a 256-wide
# tile, zero-filled past hd); and bf16 hd 40 and 136 on the FMA kernel
TC_CASES = [
    (1, 384, 6, 3, 128, 64, True, "bfloat16"),
    (1, 96, 4, 4, 80, None, True, "bfloat16"),
    (1, 128, 8, 8, 32, None, True, "bfloat16"),
    (2, 200, 4, 2, 64, None, True, "bfloat16"),
    (2, 256, 4, 1, 64, 17, True, "bfloat16"),
    (1, 192, 4, 2, 64, None, False, "bfloat16"),
    (1, 130, 4, 2, 128, 0, True, "bfloat16"),
    (1, 96, 4, 2, 40, None, True, "bfloat16"),
    (2, 2000, 8, 4, 256, None, True, "bfloat16"),
    (1, 200, 4, 2, 192, 100, True, "bfloat16"),
    (1, 96, 4, 2, 136, None, True, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hk,hd,window,causal,dtype", TC_CASES)
def test_bf16_edge_cases_on_card_take_their_path(B, S, H, Hk, hd, window,
                                                 causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    q, k, v = [t.cuda() for t in _torch(_inputs(B, S, H, Hk, hd), dtype)]
    path = kernel.choose_path(q.dtype, hd)
    before = ops.tc_launches, ops.fma_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (ops.tc_launches - before[0], ops.fma_launches - before[1]) == (
        (1, 0) if path == "tc" else (0, 1))
    w = ops.normalize_window(window)
    want = flash_attention_ref(q, k, v, causal=causal, window=w)
    if w <= 0:   # no visible key: the kernel writes 0, the plain version
        # spreads the softmax evenly over the masked keys
        want = torch.zeros_like(want)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    for B, S, H, Hk, hd, window, causal, dtype in GPU_CASES:
        q, k, v = [t.cuda() for t in _torch(_inputs(B, S, H, Hk, hd), dtype)]
        before = ops.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        want = flash_attention_ref(q, k, v, causal=causal,
                                   window=ops.normalize_window(window))
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **TOL[dtype])


# ---------------------------------------------------------------------
# the training route's dispatch, on the CPU
# ---------------------------------------------------------------------

@pytest.fixture
def pretend_card(monkeypatch):
    """The rule with its device test set aside: a CPU tensor counts as a
    card's, and the kernels' Function is swapped for a recorder that
    returns ``sdpa``'s output.  Yields the list of recorded calls."""
    calls, sdpa = [], L.sdpa

    def train(q, k, v):
        calls.append(tuple(q.shape))
        return sdpa(q, k, v, causal=True)

    monkeypatch.setattr(ops, "records_cuda_grad", lambda q: (
        torch.is_grad_enabled() and q.requires_grad))
    monkeypatch.setattr(ops, "flash_attention_train", train)
    ops.reset_train_counts()
    yield calls
    ops.reset_train_counts()


def _qkv(dtype, hd, S=64, Sk=None, H=4, Hk=2, grad=True):
    g = torch.Generator().manual_seed(hd + S)
    q, k, v = (torch.randn((1, n, h, hd), generator=g).to(dtype)
               for n, h in ((S, H), (Sk or S, Hk), (Sk or S, Hk)))
    return q.requires_grad_(grad), k.requires_grad_(grad), \
        v.requires_grad_(grad)


# (case, dtype, hd, Sk, window, banded, causal, grad, route): "kernel"
# (the Function), "sdpa" or "sdpa_banded"
ROUTE_CASES = [
    ("stablelm", torch.bfloat16, 64, None, None, False, True, True,
     "kernel"),
    ("phi3", torch.bfloat16, 128, None, L.GLOBAL_WINDOW, False, True, True,
     "kernel"),
    ("f32", torch.float32, 64, None, None, False, True, True, "sdpa"),
    ("windowed", torch.bfloat16, 64, None, 16, False, True, True, "sdpa"),
    ("banded", torch.bfloat16, 64, None, 16, True, True, True,
     "sdpa_banded"),
    ("hd96", torch.bfloat16, 96, None, None, False, True, True, "sdpa"),
    ("hd256", torch.bfloat16, 256, None, None, False, True, True, "sdpa"),
    ("no_grad", torch.bfloat16, 64, None, None, False, True, False, "sdpa"),
    ("sq_ne_sk", torch.bfloat16, 64, 128, None, False, True, True, "sdpa"),
    ("bidirectional", torch.bfloat16, 64, None, None, False, False, True,
     "sdpa"),
]


@pytest.mark.parametrize("case,dtype,hd,Sk,window,banded,causal,grad,route",
                         ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_policy_sdpa_routes_training_attention_by_its_input(
        pretend_card, monkeypatch, case, dtype, hd, Sk, window, banded,
        causal, grad, route):
    """Only bf16, hd 64 / 128, causal, unwindowed, Sq == Sk attention
    that autograd records takes the kernels; every other call keeps its
    plain path, and the CUDA training calls among them are counted."""
    seen = []
    for name in ("sdpa", "sdpa_banded"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _f=fn, _n=name, **kw: (
            seen.append(_n), _f(*a, **kw))[1])
    q, k, v = _qkv(dtype, hd, Sk=Sk, grad=grad)
    cfg = reduced(get_config("stablelm-1.6b"))
    with torch.set_grad_enabled(grad):
        out = L.policy_sdpa(q, k, v, cfg, causal=causal, window=window,
                            banded=banded)
    assert out.shape == q.shape
    got = "kernel" if pretend_card else seen[0]
    assert got == route and len(pretend_card) + len(seen) == 1
    plain_training = route != "kernel" and grad
    assert ops.train_plain_calls == int(plain_training)


def test_rule_leaves_the_cpu_dtensors_and_offsets_alone(pretend_card):
    q, k, v = _qkv(torch.bfloat16, 64)
    assert ops.takes_train_kernel(q, k, v, causal=True)
    assert not ops.takes_train_kernel(q, k, v, causal=True, q_offset=8)
    assert not ops.takes_train_kernel(q, k, v.float(), causal=True)
    ops.records_cuda_grad = lambda q: False      # restored by monkeypatch
    assert not ops.takes_train_kernel(q, k, v, causal=True)
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch import sharding
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        qd, kd, vd = (sharding.distribute(
            torch.empty((2, 64, h, 64), dtype=torch.bfloat16,
                        device="meta"), ("data", None, None, None),
            mesh).requires_grad_(True) for h in (4, 2, 2))
        assert sharding.is_sharded(qd)
        assert not ops.takes_train_kernel(qd, kd, vd, causal=True)


def test_cpu_training_calls_neither_launch_nor_count():
    """Without a card the rule never holds: the CPU's attention is the
    plain path's, and no counter moves."""
    ops.reset_train_counts()
    q, k, v = _qkv(torch.bfloat16, 64)
    assert not ops.takes_train_kernel(q, k, v, causal=True)
    cfg = reduced(get_config("stablelm-1.6b"))
    out = L.policy_sdpa(q, k, v, cfg, causal=True)
    out.float().sum().backward()
    assert (ops.train_fwd_launches, ops.train_bwd_launches,
            ops.train_plain_calls) == (0, 0, 0)


def test_cpu_remat_step_gradients_are_the_plain_paths(monkeypatch):
    """A CPU ``loss_fn`` step with remat gives, bit for bit, the gradients
    of the same step with every attention call sent straight to ``sdpa``
    (the route before the training kernels existed)."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = models.lm.param_dict(models.init_params(cfg, 0, device="cpu"))
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=g)}

    def step():
        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in params.items()}
        loss, _ = models.loss_fn(leaves, batch, cfg, remat=True)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    ops.reset_train_counts()
    loss, grads = step()
    assert (ops.train_fwd_launches, ops.train_bwd_launches,
            ops.train_plain_calls) == (0, 0, 0)
    monkeypatch.setattr(L, "policy_sdpa", lambda q, k, v, cfg, *, causal,
                        window=None, banded=False: L.sdpa(
                            q, k, v, causal=causal, window=window))
    loss_plain, grads_plain = step()
    assert torch.equal(loss, loss_plain)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_plain))


# ---------------------------------------------------------------------
# the training route's kernels, on the card
# ---------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", flash_train_card.TRAIN_SHAPES)
def test_train_route_gradients_on_card(shape):
    """q, k, v gradients (and the output) of the kernels against autograd
    through ``layers.sdpa`` in bf16, both held to f32 (the tolerance in
    ``flash_train_card``: at most 1.5x the plain path's error + 2e-3)."""
    _need_card()
    flash_train_card.check_grads(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", flash_train_card.TRAIN_SHAPES)
def test_lse_forward_on_card(shape):
    """The forward that saves the log-sum-exp writes the serving
    forward's output bit for bit, and the log-sum-exp to 1e-4."""
    _need_card()
    flash_train_card.check_lse_forward(shape)


@pytest.mark.gpu
def test_train_counts_for_one_stablelm_remat_step():
    """stablelm-1.6b at full width, one remat step: 24 forwards, 24
    recomputes and 24 backwards on the kernels, no plain call."""
    _need_card()
    flash_train_card.check_step_counts()
