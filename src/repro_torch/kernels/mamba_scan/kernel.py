"""ctypes binding of the Hopper selective-scan kernel
(``repro_torch/csrc/mamba_scan.cu``).

``mamba_scan_fwd`` checks its inputs, allocates y and h_last with
``torch.empty`` and launches the kernel on PyTorch's current stream.  It
takes CUDA tensors only and raises on anything the kernel does not
take; the library is built at the first call (``kernels._build``).

The kernel splits each channel's n states over ``lanes`` threads (4, 8
or 16); ``choose_lanes`` picks them from the shape (the C entry point
without a ``lanes`` argument applies the same rule).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import build

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16            # the kernel holds h[n] in registers
MAX_BATCH = 65535         # the grid's y dimension
LANES = (4, 8, 16)        # the kernel's instantiations of lanes per channel
FILL_THREADS = 2 ** 14    # about 4 warps on each of an H100's 132 SMs
_fn = None


def choose_lanes(B: int, di: int, n: int) -> int:
    """Lanes per channel: the fewest of ``LANES`` (at most 8 for n <= 8,
    whose states fit 8 lanes) that give B * di * lanes >= FILL_THREADS,
    else the most.  Each lane pays the per-step work (u, dt, the
    shuffles, y) once for its n / lanes states, so fewer lanes cost less
    while the card has warps to spare: on an H100, 4 lanes beat 8 and 16
    at falcon-mamba-7b's (32,768 channels) and hymba-1.5b's (6,400)
    prefill shapes (PERF.md)."""
    allowed = [lanes for lanes in LANES if lanes <= (8 if n <= 8 else 16)]
    for lanes in allowed:
        if B * di * lanes >= FILL_THREADS:
            return lanes
    return allowed[-1]


def _entry():
    global _fn
    if _fn is None:
        fn = build("mamba_scan").lib.repro_mamba_scan_fwd_lanes
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I64, I64, I64, I, I64, I64, I64,
                       I64, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def check_inputs(u, dt, neg_A, Bm, Cm) -> None:
    """Raise ValueError on anything the kernel does not take (shapes
    first, then devices)."""
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
    dev = u.device
    for name, t in (("u", u), ("dt", dt), ("neg_A", neg_A), ("Bm", Bm),
                    ("Cm", Cm)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on u's CUDA device, got "
                             f"{t.device}")


def mamba_scan_fwd(u, dt, neg_A, Bm, Cm, lanes=None):
    """u, dt (B,S,di); neg_A (di,n) f32 = -exp(A_log); Bm, Cm (B,S,n), all
    CUDA -> (y (B,S,di), h_last (B,di,n)) in u's dtype.  ``lanes`` per
    channel defaults to ``choose_lanes``; another allowed value computes
    the same function (for measuring the choice)."""
    check_inputs(u, dt, neg_A, Bm, Cm)
    B, S, di = u.shape
    n = neg_A.shape[1]
    if lanes is None:
        lanes = choose_lanes(B, di, n)
    if lanes not in LANES or (n <= 8 and lanes > 8):
        raise ValueError(f"lanes={lanes}: the kernel takes {LANES} lanes "
                         "per channel (at most 8 for n <= 8)")
    y = torch.empty_like(u)
    h_last = torch.empty((B, di, n), dtype=u.dtype, device=u.device)
    fn = _entry()
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), dt.data_ptr(), neg_A.data_ptr(),
                Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), B, S, di, n, Bm.stride(0), Bm.stride(1),
                Cm.stride(0), Cm.stride(1), lanes, _DTYPE_TAG[u.dtype],
                torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {rc}")
    return y, h_last
