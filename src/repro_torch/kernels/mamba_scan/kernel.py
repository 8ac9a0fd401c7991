"""ctypes binding of the Hopper selective-scan kernel
(``repro_torch/csrc/mamba_scan.cu``).

``mamba_scan_fwd`` checks its inputs, allocates y and h_last with
``torch.empty`` and launches the kernel on PyTorch's current stream.  It
takes CUDA tensors only and raises on anything the kernel does not
take; the library is built at the first call (``kernels._build``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import build

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16            # the kernel holds h[n] in registers
MAX_BATCH = 65535         # the grid's y dimension
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build("mamba_scan").lib.repro_mamba_scan_fwd
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I64, I64, I64, I, I64, I64, I64,
                       I64, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def check_inputs(u, dt, neg_A, Bm, Cm) -> None:
    """Raise ValueError on anything the kernel does not take."""
    dev = u.device
    for name, t in (("u", u), ("dt", dt), ("neg_A", neg_A), ("Bm", Bm),
                    ("Cm", Cm)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on u's CUDA device, got "
                             f"{t.device}")
    if u.dtype not in _DTYPE_TAG:
        raise ValueError(f"u: dtype {u.dtype}; the kernel takes float32 or "
                         "bfloat16")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != u.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, u is {u.dtype}")
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u/dt must be (B,S,di) of one shape, got "
                         f"{tuple(u.shape)}/{tuple(dt.shape)}")
    if not (u.is_contiguous() and dt.is_contiguous()):
        raise ValueError("u and dt must be contiguous")
    B, S, di = u.shape
    if neg_A.dtype != torch.float32 or neg_A.dim() != 2 \
            or neg_A.shape[0] != di or not neg_A.is_contiguous():
        raise ValueError(f"neg_A must be a contiguous f32 ({di}, n) tensor, "
                         f"got {neg_A.dtype} {tuple(neg_A.shape)}")
    n = neg_A.shape[1]
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.shape != (B, S, n) or t.stride(2) != 1:
            raise ValueError(f"{name} must be ({B}, {S}, {n}) with unit "
                             f"stride along n, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if not (1 <= n <= MAX_STATE):
        raise ValueError(f"state size n={n}: the kernel takes 1..{MAX_STATE}")
    if not (1 <= B <= MAX_BATCH) or S < 1 or di < 1:
        raise ValueError(f"shape (B,S,di)={(B, S, di)} is out of the "
                         f"kernel's range (1 <= B <= {MAX_BATCH})")


def mamba_scan_fwd(u, dt, neg_A, Bm, Cm):
    """u, dt (B,S,di); neg_A (di,n) f32 = -exp(A_log); Bm, Cm (B,S,n), all
    CUDA -> (y (B,S,di), h_last (B,di,n)) in u's dtype."""
    check_inputs(u, dt, neg_A, Bm, Cm)
    B, S, di = u.shape
    n = neg_A.shape[1]
    y = torch.empty_like(u)
    h_last = torch.empty((B, di, n), dtype=u.dtype, device=u.device)
    fn = _entry()
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), dt.data_ptr(), neg_A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), B, S, di, n, Bm.stride(0), Bm.stride(1),
                Cm.stride(0), Cm.stride(1), _DTYPE_TAG[u.dtype],
                torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {rc}")
    return y, h_last
