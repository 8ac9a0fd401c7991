"""ctypes binding of the Hopper flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``).

``flash_attention_fwd`` checks its inputs, allocates the output with
``torch.empty`` and launches the kernel on PyTorch's current stream.  It
takes CUDA tensors only and raises on anything the kernel does not
take; the library is built at the first call (``kernels._build``).

``choose_path`` says which of the library's two kernels an input takes,
by dtype and head dim alone (the C entry point applies the same rule):
both take ``hd <= 256`` with ``hd % 8 == 0``; ``"tc"``, the tensor-core
kernel (``wgmma`` fed by TMA), for bf16 with ``hd % 16 == 0``;
``"fma"``, the f32-FMA kernel, for f32 and for bf16 with
``hd % 8 == 0`` otherwise.  f32 never goes to the tensor cores: TF32
would keep about three digits.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import build

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1
MAX_HEAD_DIM = 256
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build("flash_attention").lib.repro_flash_attention_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def choose_path(dtype, hd: int) -> str:
    """``"tc"`` or ``"fma"`` for a (dtype, head dim) the library takes;
    ValueError otherwise."""
    if dtype not in _DTYPE_TAG:
        raise ValueError(f"dtype {dtype}; the kernel takes one of "
                         "float32/bfloat16 for all of q, k, v")
    if not 0 < hd <= MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"head_dim={hd}: the kernel takes 0 < hd <= "
                         f"{MAX_HEAD_DIM} with hd % 8 == 0")
    return "tc" if dtype == torch.bfloat16 and hd % 16 == 0 else "fma"


def check_inputs(q, k, v) -> str:
    """Raise ValueError on anything the kernel does not take; return
    the path (``choose_path``) the input takes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_TAG:
            raise ValueError(f"{name}: dtype {t.dtype}; the kernel takes "
                             "one of float32/bfloat16 for all of q, k, v")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != hd:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    Hk = k.shape[2]
    if H % Hk:
        raise ValueError(f"H={H} is not a multiple of Hk={Hk}")
    path = choose_path(q.dtype, hd)
    if B * S * H * hd >= 2 ** 31 or B * S >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's int sizes")
    if path == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core path loads q, k, v by TMA, which "
                         "needs 16-byte aligned base addresses")
    return path


def flash_attention_fwd(q, k, v, *, causal: bool, window: int):
    """q (B,S,H,hd), k/v (B,S,Hk,hd) CUDA tensors -> (o (B,S,H,hd), the
    path that ran: ``"tc"`` or ``"fma"``).

    Keys with kpos <= qpos - window are masked (window >= 2**31 - 1 is
    clamped: it masks nothing either way)."""
    path = check_inputs(q, k, v)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    fn = _entry()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, S, H, k.shape[2], hd, int(bool(causal)),
                max(min(int(window), _INT32_MAX), -_INT32_MAX),
                1.0 / math.sqrt(hd), _DTYPE_TAG[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({path} "
                           f"path): CUDA error {rc}")
    return o, path
