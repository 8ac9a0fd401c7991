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

Training (causal, no window, bf16, hd in ``TRAIN_HEAD_DIMS``):
``flash_attention_fwd_lse`` runs the tensor-core forward and also
returns each query row's log-sum-exp; ``flash_attention_bwd`` takes it
and returns dq, dk, dv from the library's backward kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import build

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1
MAX_HEAD_DIM = 256
TRAIN_HEAD_DIMS = (64, 128)
ROW_TILE = 64          # query rows per tile: the log-sum-exp's padding
_fns = {}


def _entry(name: str):
    """The library's ``repro_flash_attention_<name>`` with its argtypes."""
    if name not in _fns:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(build("flash_attention").lib,
                     f"repro_flash_attention_{name}")
        fn.argtypes = {"fwd": [P] * 5 + [I] * 7 + [F, I, P],
                       "bwd": [P] * 10 + [I] * 5 + [F, P]}[name]
        fn.restype = I
        _fns[name] = fn
    return _fns[name]


def padded_len(S: int) -> int:
    """S rounded up to whole query tiles: the last dim of the log-sum-exp
    and of the backward's row sums."""
    return -(-S // ROW_TILE) * ROW_TILE


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


def _fwd(q, k, v, causal: bool, window: int, lse):
    path = check_inputs(q, k, v)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _entry("fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, H, k.shape[2], hd, int(bool(causal)),
            max(min(int(window), _INT32_MAX), -_INT32_MAX),
            1.0 / math.sqrt(hd), _DTYPE_TAG[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({path} "
                           f"path): CUDA error {rc}")
    return o, path


def flash_attention_fwd(q, k, v, *, causal: bool, window: int):
    """q (B,S,H,hd), k/v (B,S,Hk,hd) CUDA tensors -> (o (B,S,H,hd), the
    path that ran: ``"tc"`` or ``"fma"``).

    Keys with kpos <= qpos - window are masked (window >= 2**31 - 1 is
    clamped: it masks nothing either way)."""
    return _fwd(q, k, v, causal, window, None)


def check_train_inputs(q, k, v, *extra):
    """Raise ValueError unless the training kernels take q, k, v (and
    ``extra`` tensors shaped as q): bf16, hd in ``TRAIN_HEAD_DIMS``."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TRAIN_HEAD_DIMS:
        raise ValueError(f"the training kernels take bf16 with head_dim in "
                         f"{TRAIN_HEAD_DIMS}, got {q.dtype}, "
                         f"hd={q.shape[-1]}")
    check_inputs(q, k, v)
    for t in extra:
        if t.shape != q.shape:
            raise ValueError(f"shape {tuple(t.shape)} is not q's "
                             f"{tuple(q.shape)}")
        check_inputs(t, k, v)


def flash_attention_fwd_lse(q, k, v):
    """Causal attention's forward for training: q (B,S,H,hd), k/v
    (B,S,Hk,hd) CUDA bf16 -> (o, lse): lse (B, H, padded_len(S)) f32,
    each query row's natural log-sum-exp of its scaled logits (rows past
    S are the zero-filled padding's, finite).  The tensor-core kernel,
    as ``flash_attention_fwd`` runs it, with the log-sum-exp stored."""
    check_train_inputs(q, k, v)
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, padded_len(S)), dtype=torch.float32,
                      device=q.device)
    o, _ = _fwd(q, k, v, True, _INT32_MAX, lse)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do):
    """Gradients of ``flash_attention_fwd_lse``'s output: (dq, dk, dv) in
    bf16, from the forward's q, k, v, o, lse and the output's gradient
    ``do`` (B,S,H,hd).  dK and dV sum over each kv head's query heads."""
    check_train_inputs(q, k, v, o, do)
    B, S, H, hd = q.shape
    Hk = k.shape[2]
    if lse.shape != (B, H, padded_len(S)) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} is not the "
                         "forward's")
    dsum = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        rc = _entry("bwd")(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, dsum, dq, dk, dv)),
            B, S, H, Hk, hd, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc}")
    return dq, dk, dv
