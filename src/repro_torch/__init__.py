"""PyTorch port of ``repro`` for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``models``, ``kernels``, ``serve``) so each
module's counterpart is easy to find.  It imports ``torch``, numpy and
the standard library only — never ``jax`` and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(as the CPU tests do).  Without a card an entry point called with no
device raises; it never falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device``
    names another.  Raises when CUDA is asked for (or defaulted to) and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev
