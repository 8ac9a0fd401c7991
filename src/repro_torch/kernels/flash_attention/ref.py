"""Plain PyTorch version of the flash-attention kernel (GQA + causal +
sliding window).

It is the port's ``sdpa`` on the unpadded tensors, so keys at or beyond
the true sequence length never enter the softmax — the semantics the
CUDA kernel keeps by masking ``kpos < S``.  The CPU path of
``ops.flash_attention`` and ``chip_smoke.py``'s kernel check use it.
"""
from __future__ import annotations


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q (B,S,H,hd), k/v (B,S,Hk,hd) -> (B,S,H,hd)."""
    # imported here: ``models`` imports ``lm``, which imports ``ops``,
    # which imports this module, so a top-level import would make a
    # cycle whenever this module is imported first
    from repro_torch.models.layers import sdpa
    return sdpa(q, k, v, causal=causal, window=window)
