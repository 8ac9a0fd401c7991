"""Public flash-attention wrapper: window normalization and dispatch by
device.

A CUDA tensor goes to the Hopper kernel (``kernel.flash_attention_fwd``)
or the call raises; a CPU tensor goes to the plain version
(``ref.flash_attention_ref``).  Nothing falls back from one to the
other.  Forward only, like the JAX wrapper: the kernel has no backward,
so on a CUDA tensor with grad mode on and any of q, k, v requiring
grad the call raises instead of returning an output with no gradient.
Training runs attention on the plain path (``layers.sdpa``).

``launches`` counts kernel launches made through this wrapper (a plain
integer; set it to 0 to start a count); ``tc_launches`` and
``fma_launches`` count them by the path that ran (the tensor-core kernel
for bf16 with hd % 16 == 0, the f32-FMA kernel otherwise; see
``kernel.choose_path``), so ``launches == tc_launches + fma_launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import GLOBAL_WINDOW

launches = 0
tc_launches = 0
fma_launches = 0


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


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q (B,S,H,hd), k/v (B,S,Hk,hd) -> (B,S,H,hd)."""
    global launches, tc_launches, fma_launches
    w = normalize_window(window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward kernel: its output would carry "
            "no gradient.  Run attention on the plain path to train "
            "(use_kernels=False, models.layers.sdpa) or call it under "
            "torch.no_grad()")
    out, path = flash_attention_fwd(q, k, v, causal=causal, window=w)
    launches += 1
    if path == "tc":
        tc_launches += 1
    else:
        fma_launches += 1
    return out
