"""A dense decoder of the port's equations, in plain float32 PyTorch.

Per layer (pre-norm): h = rmsnorm(x) (f32, scale 1 + w); q, k, v = h
Wq, h Wk, h Wv with half-split rotary on q and k (theta as configured,
every dimension rotated); causal softmax of q k^T / sqrt(hd), query
head j g .. j g + g - 1 on kv head j; x += (P v) Wo; x += (silu(h2 Wg)
* h2 Wu) Wd with h2 = rmsnorm(x).  The token embeddings are scaled by
sqrt(d_model) rounded to the model's dtype; the loss is the mean
cross-entropy of tokens 1 .. S-1 from positions 0 .. S-2 over the
final rmsnorm and the untied head.

``row_loss`` takes one row (1, S) and float32 leaves; each layer runs
under ``torch.utils.checkpoint``, so the backward recomputes it and a
full-size row fits beside an optimizer state.  ``quant="fp8"`` rounds
both operands of every product to float8 e4m3 with one scale per
tensor (straight-through in the backward): the lower precision of the
control.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.weights import Dense

F8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale per tensor, the
    gradient passed straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def _mm(a, b, quant: Optional[str]):
    if quant == "fp8":
        a, b = fp8(a), fp8(b)
    elif quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return a @ b


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x, positions, theta: float):
    """x (S, H, hd): the half-split rotation of the port."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.float()[:, None] * freqs.to(x.device)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(m: Dense, h, wq, wk, wv, wo, quant):
    S, hd, H, Hk = h.shape[0], m.hd, m.num_heads, m.num_kv_heads
    pos = torch.arange(S, device=h.device)
    q = rope(_mm(h, wq, quant).view(S, H, hd), pos, m.rope_theta)
    k = rope(_mm(h, wk, quant).view(S, Hk, hd), pos, m.rope_theta)
    v = _mm(h, wv, quant).view(S, Hk, hd)
    g = H // Hk
    q = q.view(S, Hk, g, hd).permute(1, 2, 0, 3)          # (Hk, g, S, hd)
    kt = k.permute(1, 2, 0)[:, None]                        # (Hk, 1, hd, S)
    logits = _mm(q, kt, quant) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1)
    out = _mm(probs, v.permute(1, 0, 2)[:, None], quant)     # (Hk, g, S, hd)
    return _mm(out.permute(2, 0, 1, 3).reshape(S, H * hd), wo, quant)


def layer(m: Dense, x, w: Dict[str, torch.Tensor], quant):
    h = rms_norm(x, w["attn_norm"], m.rms_eps)
    x = x + attention(m, h, w["attn.q"], w["attn.k"], w["attn.v"],
                      w["attn.o"], quant)
    h2 = rms_norm(x, w["mlp_norm"], m.rms_eps)
    y = F.silu(_mm(h2, w["gate"], quant)) * _mm(h2, w["up"], quant)
    return x + _mm(y, w["down"], quant)


def embed_scale(m: Dense) -> float:
    """sqrt(d_model) rounded to the model's dtype, as the port scales."""
    return float(torch.tensor(math.sqrt(m.d_model), dtype=m.torch_dtype))


def row_loss(m: Dense, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
             quant: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of one row ``tokens`` (S,) under the
    float32 leaves ``w`` (the training dict's names)."""
    x = w["embed"][tokens] * embed_scale(m)
    keys = ("attn_norm", "attn.q", "attn.k", "attn.v", "attn.o",
            "mlp_norm", "gate", "up", "down")
    for i in range(m.num_layers):
        lw = [w[f"layers.{i}.{k}"] for k in keys]

        def run(x, *lw):
            return layer(m, x, dict(zip(keys, lw)), quant)
        x = checkpoint(run, x, *lw, use_reentrant=False)
    x = rms_norm(x, w["final_norm"], m.rms_eps)
    logits = _mm(x[:-1], w["lm_head"], quant)
    gold = torch.gather(logits, 1, tokens[1:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)
