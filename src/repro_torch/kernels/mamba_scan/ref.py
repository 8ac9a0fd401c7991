"""Plain PyTorch version of the selective scan: the chunked associative
scan ``models.layers.ssm_scan_chunked``, as the JAX package's oracle
(``repro/kernels/mamba_scan/ref.py``) is.  The CPU path of
``ops.mamba_scan`` and ``chip_smoke.py``'s kernel check use it.
"""
from __future__ import annotations

from repro_torch.models.layers import ssm_scan_chunked


def mamba_scan_ref(u, dt, A_log, Bm, Cm):
    """u, dt (B,S,di); A_log (di,n); Bm, Cm (B,S,n) ->
    (y (B,S,di), h_last (B,di,n))."""
    return ssm_scan_chunked(u, dt, A_log, Bm, Cm)
