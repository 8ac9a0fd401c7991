"""The port's selective-scan wrapper against the JAX package's.

On the CPU the port's ``ops.mamba_scan`` runs its plain version (the
chunked associative scan); the JAX side runs the Pallas kernel in
interpret mode (``repro.kernels.mamba_scan.ops``) and its oracle
``mamba_scan_ref``, as ``tests/test_kernels.py`` does.  Inputs are made
with numpy from a seed (bf16 cast by both frameworks with
round-to-nearest-even).  Tolerances are ``tests/test_kernels.py``'s
``_tol``: 2e-5 in f32, 2e-2 in bf16; the naive-recurrence test's 1e-4.

The ``gpu`` tests hold the hand-written kernel against the plain
version on the card; they skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import mamba_scan as jax_mamba_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro_torch.kernels.mamba_scan import kernel, ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models import layers as L
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# tests/test_kernels.py: MAMBA_CASES
CASES = [
    (2, 256, 128, 16, "float32"),
    (1, 200, 96, 8, "float32"),       # ragged S and di
    (2, 64, 256, 16, "float32"),
    (1, 128, 128, 16, "bfloat16"),
]


def _inputs(B, S, di, n, seed=0):
    """u, dt, A_log, Bm, Cm as numpy f32, with the JAX test's
    distributions: dt = softplus(normal) * 0.1, A_log = log(|normal| +
    0.5)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1
    A_log = np.log(np.abs(rng.standard_normal((di, n))) + 0.5)
    Bm = rng.standard_normal((B, S, n))
    Cm = rng.standard_normal((B, S, n))
    return [a.astype(np.float32) for a in (u, dt, A_log, Bm, Cm)]


def _both(arrays, dtype):
    """The scan inputs in ``dtype`` on both sides (A_log stays f32)."""
    jx = [jnp.asarray(a) if i == 2 else jnp.asarray(a).astype(dtype)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a) if i == 2
          else torch.from_numpy(a).to(getattr(torch, dtype))
          for i, a in enumerate(arrays)]
    return jx, tx


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,S,di,n,dtype", CASES)
def test_matches_pallas_kernel_and_oracle(B, S, di, n, dtype):
    jx, tx = _both(_inputs(B, S, di, n), dtype)
    before = ops.scan_launches
    y, h = ops.mamba_scan(*tx)
    assert ops.scan_launches == before          # the CPU runs no kernel
    assert y.dtype == h.dtype == tx[0].dtype
    assert y.shape == (B, S, di) and h.shape == (B, di, n)
    for fn in (jax_mamba_scan, jax_mamba_scan_ref):
        jy, jh = fn(*jx)
        _close(y, jy, TOL[dtype])
        _close(h, jh, TOL[dtype])


@pytest.mark.parametrize("B,S,di,n,dtype", CASES)
def test_sequential_scan_matches_plain_version(B, S, di, n, dtype):
    """``ssm_scan_seq`` (prefill's plain path) and the plain version of
    the kernel (``ssm_scan_chunked``) are one function."""
    _, tx = _both(_inputs(B, S, di, n, seed=1), dtype)
    y, h = L.ssm_scan_seq(*tx)
    yr, hr = mamba_scan_ref(*tx)
    _close(y, yr, TOL[dtype])
    _close(h, hr, TOL[dtype])


def test_matches_naive_recurrence():
    """The wrapper against an explicit Python-loop recurrence (ground
    truth), at test_kernels.py's 1e-4."""
    B, S, di, n = 1, 16, 8, 4
    u, dt, A_log, Bm, Cm = _inputs(B, S, di, n, seed=7)
    dt = dt * 2.0
    A = -np.exp(A_log.astype(np.float64))
    h = np.zeros((B, di, n))
    ys = []
    for t in range(S):
        a = np.exp(dt[:, t, :, None] * A[None])
        h = a * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, Cm[:, t]))
    y, h_last = ops.mamba_scan(*map(torch.from_numpy, (u, dt, A_log, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), h, rtol=1e-4, atol=1e-4)


def test_binding_rejects_what_the_kernel_does_not_take():
    """The binding checks its inputs before it builds or launches: a CPU
    tensor raises ValueError (never a plain-version fallback)."""
    u, dt, A_log, Bm, Cm = map(torch.from_numpy, _inputs(1, 8, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mamba_scan_fwd(u, dt, -torch.exp(A_log), Bm, Cm)


@pytest.mark.parametrize("B,di,n,lanes", [
    (4, 8192, 16, 4),     # falcon-mamba-7b prefill: 131,072 threads at 4
    (2, 3200, 16, 4),     # hymba-1.5b prefill: 25,600 threads at 4
    (1, 2048, 16, 8),     # 16,384 threads at 8
    (1, 1024, 16, 16),    # short of the fill at every count: the most
    (1, 96, 8, 8),        # n <= 8: at most 8 lanes
    (1, 4096, 8, 4),
])
def test_lanes_per_channel_fill_the_card(B, di, n, lanes):
    assert kernel.choose_lanes(B, di, n) == lanes
    assert lanes in kernel.LANES and lanes <= (8 if n <= 8 else 16)


def test_binding_rejects_state_and_batch_it_cannot_hold():
    """n > 16 states do not fit the lanes' registers and B > 65535 the
    grid: the binding raises before it builds or launches."""
    u, dt, A_log, Bm, Cm = map(torch.from_numpy, _inputs(1, 4, 8, 17))
    with pytest.raises(ValueError, match="state size"):
        kernel.mamba_scan_fwd(u, dt, -torch.exp(A_log), Bm, Cm)
    B = kernel.MAX_BATCH + 1
    u = torch.zeros((B, 1, 1))
    Bm = torch.zeros((B, 1, 4))
    with pytest.raises(ValueError, match="range"):
        kernel.mamba_scan_fwd(u, u.clone(), torch.zeros((1, 4)), Bm,
                              Bm.clone())


# ------------------------------------------------------------------
# on the card
# ------------------------------------------------------------------

GPU_CASES = CASES + [
    (1, 1, 96, 8, "float32"),              # S = 1
    (2, 300, 3200, 16, "bfloat16"),        # hymba-1.5b's width
    (1, 70, 40, 5, "float32"),             # odd n, di < one block
]


def _cuda_inputs(B, S, di, n, dtype, seed=0):
    """Inputs on the card; Bm and Cm are views split off one (B, S,
    r + 2n) tensor, as the model passes them."""
    u, dt, A_log, Bm, Cm = (torch.from_numpy(a).cuda()
                            for a in _inputs(B, S, di, n, seed))
    dt_ = getattr(torch, dtype)
    BC = torch.cat([torch.zeros_like(Bm[..., :1]).expand(B, S, 3), Bm, Cm],
                   dim=-1).to(dt_)
    return u.to(dt_), dt.to(dt_), A_log, BC[..., 3:3 + n], BC[..., 3 + n:]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,n,dtype", GPU_CASES)
def test_kernel_matches_plain_on_card(B, S, di, n, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    x = _cuda_inputs(B, S, di, n, dtype)
    before = ops.scan_launches
    y, h = ops.mamba_scan(*x)
    y2, h2 = ops.mamba_scan(*x)
    torch.cuda.synchronize()
    assert ops.scan_launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)   # no atomics
    yr, hr = mamba_scan_ref(*x)
    torch.testing.assert_close(y.float(), yr.float(), **TOL[dtype])
    torch.testing.assert_close(h.float(), hr.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,n,dtype", [
    (2, 300, 3200, 16, "bfloat16"),        # ragged tiles at every lane count
    (1, 77, 100, 5, "float32"),            # di past no vector width
    (1, 129, 40, 8, "bfloat16"),
])
def test_every_lane_count_matches_plain_on_card(B, S, di, n, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    u, dt, A_log, Bm, Cm = _cuda_inputs(B, S, di, n, dtype)
    neg_A = -torch.exp(A_log)
    yr, hr = mamba_scan_ref(u, dt, A_log, Bm, Cm)
    for lanes in [lanes for lanes in kernel.LANES
                  if lanes <= (8 if n <= 8 else 16)]:
        y, h = kernel.mamba_scan_fwd(u, dt, neg_A, Bm, Cm, lanes=lanes)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yr.float(), **TOL[dtype])
        torch.testing.assert_close(h.float(), hr.float(), **TOL[dtype])


@pytest.mark.gpu
def test_kernel_refuses_inputs_that_need_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    u, dt, A_log, Bm, Cm = _cuda_inputs(1, 8, 16, 4, "float32")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mamba_scan(u.requires_grad_(), dt, A_log, Bm, Cm)
    with torch.no_grad():
        ops.mamba_scan(u, dt, A_log, Bm, Cm)
