"""ctypes binding of the Hopper gradstats kernels
(``repro_torch/csrc/gradstats.cu``).

``colsum_mean``, ``colsum_into`` and ``moments`` check their inputs,
allocate outputs and scratch with ``torch.empty`` and launch on
PyTorch's current stream.
They take CUDA tensors only and raise on anything the kernels do not
take; the library is built at the first call (``kernels._build``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import build

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build("gradstats").lib
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_gradstats_scratch_floats.argtypes = [I64, I64]
        lib.repro_gradstats_scratch_floats.restype = I64
        lib.repro_gradstats_colsum.argtypes = [P, P, I64, I64, I, I,
                                               ctypes.c_float, P]
        lib.repro_gradstats_colsum.restype = I
        lib.repro_gradstats_moments.argtypes = [P, P, P, P, P, P, I64, I64,
                                                I, P]
        lib.repro_gradstats_moments.restype = I
        _lib = lib
    return _lib


def check_matrix(G) -> None:
    """Raise ValueError on anything the kernels do not take."""
    if G.device.type != "cuda":
        raise ValueError(f"G must be a CUDA tensor, got {G.device}")
    if G.dtype not in _DTYPE_TAG:
        raise ValueError(f"G: dtype {G.dtype}; the kernels take float32 "
                         "or bfloat16")
    if G.dim() != 2 or not G.is_contiguous() or G.numel() == 0:
        raise ValueError(f"G must be a non-empty contiguous 2-d tensor, "
                         f"got shape {tuple(G.shape)}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"gradstats {name} kernel launch failed: CUDA "
                           f"error {rc}")


def _check_vector(v, G, name: str) -> None:
    D = G.shape[1]
    if (v.device != G.device or v.dtype != torch.float32
            or v.shape != (D,) or not v.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous f32 ({D},) tensor "
                         f"on {G.device}")


def colsum_into(G, acc, *, accumulate: bool, divisor: float = 0.0):
    """Write G's column sums (plus ``acc``'s values when ``accumulate``,
    divided by ``divisor`` when it is > 0) into ``acc`` (D,) f32, in
    place, and return it.  Row chunks of one G summed this way, the last
    with divisor B, give ``colsum_mean`` of the whole G bit for bit."""
    check_matrix(G)
    _check_vector(acc, G, "acc")
    if not divisor >= 0.0:
        raise ValueError(f"divisor must be >= 0, got {divisor}")
    B, D = G.shape
    with torch.cuda.device(G.device):
        rc = _library().repro_gradstats_colsum(
            G.data_ptr(), acc.data_ptr(), B, D, _DTYPE_TAG[G.dtype],
            int(bool(accumulate)), float(divisor), _stream(G))
    _raise_on(rc, "colsum")
    return acc


def colsum_mean(G):
    """G (B, D) CUDA -> gbar (D,) f32, the column sum divided by B."""
    check_matrix(G)
    gbar = torch.empty((G.shape[1],), dtype=torch.float32, device=G.device)
    return colsum_into(G, gbar, accumulate=False, divisor=float(G.shape[0]))


def moments(G, gbar):
    """G (B, D), gbar (D,) f32, both CUDA -> (s (B,), d (B,), n2 ())."""
    check_matrix(G)
    B, D = G.shape
    _check_vector(gbar, G, "gbar")
    lib = _library()
    n_scratch = lib.repro_gradstats_scratch_floats(B, D)
    if n_scratch <= 0:
        raise ValueError(f"shape {(B, D)} is out of the kernels' range")
    scratch = torch.empty((n_scratch,), dtype=torch.float32,
                          device=G.device)
    s = torch.empty((B,), dtype=torch.float32, device=G.device)
    d = torch.empty((B,), dtype=torch.float32, device=G.device)
    n2 = torch.empty((), dtype=torch.float32, device=G.device)
    with torch.cuda.device(G.device):
        rc = lib.repro_gradstats_moments(
            G.data_ptr(), gbar.data_ptr(), s.data_ptr(), d.data_ptr(),
            n2.data_ptr(), scratch.data_ptr(), B, D, _DTYPE_TAG[G.dtype],
            _stream(G))
    _raise_on(rc, "moments")
    return s, d, n2
