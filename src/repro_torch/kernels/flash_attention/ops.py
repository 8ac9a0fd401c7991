"""Public flash-attention wrapper: window normalization and dispatch by
device, and the training route.

A CUDA tensor goes to the Hopper kernel (``kernel.flash_attention_fwd``)
or the call raises; a CPU tensor goes to the plain version
(``ref.flash_attention_ref``).  Nothing falls back from one to the
other.  This serving call has no backward: on a CUDA tensor with grad
mode on and any of q, k, v requiring grad it raises instead of
returning an output with no gradient.

The training route (``flash_attention_train``) is a
``torch.autograd.Function`` whose forward is the tensor-core kernel
with each row's log-sum-exp saved and whose backward is the library's
backward kernels (``kernel.flash_attention_bwd``): the (B, H, S, S)
scores never reach device memory.  ``layers.policy_sdpa`` sends training
attention there by what the input shows (``takes_train_kernel``): CUDA
bf16 plain tensors with grad recorded, hd 64 or 128, causal with no
window, Sq == Sk.  Everything else stays on ``layers.sdpa`` /
``sdpa_banded``; the JAX package has no such backward and trains on its
plain path.

``launches`` counts kernel launches made through this wrapper's
serving call (a plain integer; set it to 0 to start a count);
``tc_launches`` and ``fma_launches`` count them by the path that ran
(the tensor-core kernel for bf16 with hd % 16 == 0, the f32-FMA kernel
otherwise; see ``kernel.choose_path``), so ``launches == tc_launches +
fma_launches``.  The training route counts apart: ``train_fwd_launches``
(forwards under autograd, a rematerialised layer's recompute included),
``train_bwd_launches`` (backwards) and ``train_plain_calls`` (CUDA
training attention calls that stayed on ``sdpa`` or ``sdpa_banded``);
``reset_train_counts`` sets the three to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    TRAIN_HEAD_DIMS, flash_attention_bwd, flash_attention_fwd,
    flash_attention_fwd_lse)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import GLOBAL_WINDOW
from repro_torch.sharding import is_sharded

launches = 0
tc_launches = 0
fma_launches = 0
train_fwd_launches = 0
train_bwd_launches = 0
train_plain_calls = 0


def reset_train_counts() -> None:
    global train_fwd_launches, train_bwd_launches, train_plain_calls
    train_fwd_launches = train_bwd_launches = train_plain_calls = 0


def normalize_window(window) -> int:
    """None (full attention) -> GLOBAL_WINDOW; a Python int or a 0-d
    integer tensor -> that int."""
    if window is None:
        return GLOBAL_WINDOW
    if isinstance(window, torch.Tensor):
        if window.ndim != 0 or window.dtype.is_floating_point:
            raise ValueError(f"window must be a 0-d integer tensor, got "
                             f"{window.dtype} of shape {tuple(window.shape)}")
        return int(window.item())
    return int(window)


def records_cuda_grad(q) -> bool:
    """Whether ``q`` is a CUDA tensor whose attention autograd records:
    the calls the training counters see."""
    return (torch.is_grad_enabled() and q.requires_grad
            and q.device.type == "cuda")


def takes_train_kernel(q, k, v, *, causal: bool, window=None,
                       q_offset: int = 0) -> bool:
    """The training route's rule, by what the input shows: autograd
    records and q requires grad; q, k, v plain (not DTensor) CUDA bf16;
    hd in ``kernel.TRAIN_HEAD_DIMS``; causal with no window (None or
    GLOBAL_WINDOW); Sq == Sk and q_offset 0."""
    return (records_cuda_grad(q) and causal and q_offset == 0
            and not any(is_sharded(t) for t in (q, k, v))
            and all(t.device == q.device and t.dtype == torch.bfloat16
                    for t in (q, k, v))
            and q.shape[-1] in TRAIN_HEAD_DIMS
            and q.shape[1] == k.shape[1]
            and (window is None or normalize_window(window) == GLOBAL_WINDOW))


def count_plain_train(q) -> None:
    """Count a CUDA training attention call left on the plain path."""
    global train_plain_calls
    if records_cuda_grad(q):
        train_plain_calls += 1


class _TrainAttention(torch.autograd.Function):
    """Causal attention with both passes on the Hopper kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        global train_fwd_launches
        o, lse = flash_attention_fwd_lse(q, k, v)
        train_fwd_launches += 1
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        global train_bwd_launches
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, lse, do.contiguous())
        train_bwd_launches += 1
        return grads


def flash_attention_train(q, k, v):
    """q (B,S,H,hd), k/v (B,S,Hk,hd) -> causal attention (B,S,H,hd) whose
    gradient runs on the backward kernels; the inputs
    ``takes_train_kernel`` accepts, or the kernels' checks raise."""
    return _TrainAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous())


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q (B,S,H,hd), k/v (B,S,Hk,hd) -> (B,S,H,hd)."""
    global launches, tc_launches, fma_launches
    w = normalize_window(window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is the serving call: its output would carry "
            "no gradient.  Train through models.layers.policy_sdpa "
            "(use_kernels=False), which takes the kernels' training route "
            "where it applies and the plain path otherwise, or call it "
            "under torch.no_grad()")
    out, path = flash_attention_fwd(q, k, v, causal=causal, window=w)
    launches += 1
    if path == "tc":
        tc_launches += 1
    else:
        fma_launches += 1
    return out
