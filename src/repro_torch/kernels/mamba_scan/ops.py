"""Public selective-scan wrapper: dispatch by device.

A CUDA tensor goes to the Hopper kernel (``kernel.mamba_scan_fwd``) or
the call raises; a CPU tensor goes to the plain version
(``ref.mamba_scan_ref``).  Nothing falls back from one to the other.
Like the JAX wrapper it computes ``neg_A = -exp(A_log)`` in f32; unlike
it, it makes no padded copies (the kernel masks ragged S and di).
Forward only: on a CUDA tensor with grad mode on and any input
requiring grad the call raises instead of returning an output with no
gradient (training runs ``layers.ssm_scan_chunked``).

``scan_launches`` counts kernel launches made through this wrapper (a
plain integer; set it to 0 to start a count).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fwd
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

scan_launches = 0


def mamba_scan(u, dt, A_log, Bm, Cm):
    """u, dt (B,S,di); A_log (di,n); Bm, Cm (B,S,n) ->
    (y (B,S,di), h_last (B,di,n)), both in u's dtype."""
    global scan_launches
    if u.device.type == "cpu":
        return mamba_scan_ref(u, dt, A_log, Bm, Cm)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, A_log, Bm, Cm)):
        raise RuntimeError(
            "mamba_scan has no backward kernel: its output would carry no "
            "gradient.  Train through the plain scan "
            "(models.layers.ssm_scan_chunked) or call it under "
            "torch.no_grad()")
    neg_A = -torch.exp(A_log.float())
    out = mamba_scan_fwd(u, dt, neg_A, Bm, Cm)
    scan_launches += 1
    return out
