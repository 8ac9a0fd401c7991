"""A DeepSeek-V2 decoder of the port's equations, in plain float32
PyTorch, holding a share of each MoE layer's experts.

Per layer (pre-norm, norms scale by 1 + w): h = rmsnorm(x);

- MLA: q = h Wq, per head [q_nope ; q_rope]; [c ; k_r] = h Wkv_a;
  c = rmsnorm(c); [k_nope ; v] = c Wkv_b per head; k = [k_nope ;
  rope(k_r) on every head], q = [q_nope ; rope(q_rope)], rotary the
  half-split rotation over the rope part; x += (causal softmax(q k^T /
  sqrt(nope + rope)) v) Wo;
- h2 = rmsnorm(x); the first ``first_k_dense`` layers x += SwiGLU(h2);
  the others x += the MoE layer of h2 over all B*S tokens of the batch
  as one group: p = softmax(h2 Wrouter), the top-k of p (weights p,
  renormalised only with ``norm_topk``); each expert takes its
  assignments in (token, choice) order up to C = max(K, ceil(T K / E *
  1.25)); the held experts' kept assignments add their SwiGLU, weighted;
  each shared expert adds its SwiGLU of every token; aux = coef * E *
  sum_e (share of the T K assignments to e) * (mean p of e).

The token embeddings are scaled by sqrt(d_model) rounded to the model's
dtype; the loss is the mean cross-entropy of tokens 1 .. S-1 of every
row over the final rmsnorm and the untied head, plus the layers' aux
summed over the layer count.

``batch_loss`` takes the rows (B, S) of one step and float32 leaves; each
layer, and each row's cross-entropy, runs under
``torch.utils.checkpoint``, so a full-size batch fits beside an
optimizer state.  The reference routes by itself.  ``quant="fp8"``
rounds both operands of every product to float8 e4m3
(``bench.reference.model.fp8``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.model import _mm, embed_scale, rms_norm, rope
from bench.reference.moe_weights import LatentMoE

ATTN = ("attn.q", "attn.kv_a", "attn.kv_norm", "attn.kv_b", "attn.o")
DENSE = ("gate", "up", "down")
MOE = ("moe.router", "moe.gate", "moe.up", "moe.down", "moe.s_gate",
       "moe.s_up", "moe.s_down")


def mla(m: LatentMoE, h, w, quant):
    """One row h (S, d) -> (S, d)."""
    S, H, r = h.shape[0], m.num_heads, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    pos = torch.arange(S, device=h.device)
    q = _mm(h, w["attn.q"], quant).view(S, H, dn + dr)
    a = _mm(h, w["attn.kv_a"], quant)
    c = rms_norm(a[:, :r], w["attn.kv_norm"], m.rms_eps)
    kv = _mm(c, w["attn.kv_b"], quant).view(S, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, m.rope_theta)], -1)
    k_r = rope(a[:, None, r:], pos, m.rope_theta).expand(S, H, dr)
    k = torch.cat([kv[..., :dn], k_r], -1)
    logits = _mm(q.permute(1, 0, 2), k.permute(1, 2, 0), quant) \
        / math.sqrt(dn + dr)                                  # (H, S, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1)
    out = _mm(probs, kv[..., dn:].permute(1, 0, 2), quant)    # (H, S, dv)
    return _mm(out.permute(1, 0, 2).reshape(S, H * dv), w["attn.o"], quant)


def swiglu(x, g, u, d, quant):
    return _mm(F.silu(_mm(x, g, quant)) * _mm(x, u, quant), d, quant)


def moe(m: LatentMoE, x, w, quant):
    """x (T, d) -> (y, aux)."""
    T, E, K = x.shape[0], m.num_experts, m.top_k
    C = max(K, int(math.ceil(T * K / E * m.capacity_factor)))
    probs = torch.softmax(_mm(x, w["moe.router"], quant), -1)
    topw, topi = torch.topk(probs, K, dim=-1)
    if m.norm_topk:
        topw = topw / topw.sum(-1, keepdim=True)
    flat_e, flat_w = topi.reshape(-1), topw.reshape(-1)
    y = torch.zeros_like(x)
    for j, e in enumerate(m.held):
        kept = torch.nonzero(flat_e == e)[:C, 0]       # (token, choice) order
        if not len(kept):
            continue
        tok = kept // K
        out = swiglu(x[tok], w["moe.gate"][j], w["moe.up"][j],
                     w["moe.down"][j], quant)
        y = y.index_add(0, tok, out * flat_w[kept, None])
    for i in range(m.num_shared):
        y = y + swiglu(x, w["moe.s_gate"][i], w["moe.s_up"][i],
                       w["moe.s_down"][i], quant)
    share = torch.bincount(flat_e, minlength=E).float() / (T * K)
    aux = m.aux_coef * E * torch.sum(share * probs.mean(0))
    return y, aux


def layer(m: LatentMoE, i: int, x, w, quant):
    """Layer i on x (B, S, d) -> (x, aux)."""
    h = rms_norm(x, w["attn_norm"], m.rms_eps)
    x = x + torch.stack([mla(m, hb, w, quant) for hb in h])
    h2 = rms_norm(x, w["mlp_norm"], m.rms_eps)
    if m.is_dense(i):
        return (x + swiglu(h2, w["gate"], w["up"], w["down"], quant),
                torch.zeros((), device=x.device))
    y, aux = moe(m, h2.reshape(-1, h2.shape[-1]), w, quant)
    return x + y.view(h2.shape), aux


def _row_ce(x, head, tokens, quant):
    logits = _mm(x[:-1], head, quant)
    gold = torch.gather(logits, 1, tokens[1:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def batch_loss(m: LatentMoE, w: Dict[str, torch.Tensor], rows: torch.Tensor,
               quant: Optional[str] = None) -> torch.Tensor:
    """The loss of the rows (B, S) under the float32 leaves ``w``."""
    x = w["embed"][rows] * embed_scale(m)
    aux = torch.zeros((), device=x.device)
    for i in range(m.num_layers):
        keys = ("attn_norm", "mlp_norm") + ATTN + (
            DENSE if m.is_dense(i) else MOE)

        def run(x, *lw, i=i, keys=keys):
            return layer(m, i, x, dict(zip(keys, lw)), quant)
        x, a = checkpoint(run, x, *[w[f"layers.{i}.{k}"] for k in keys],
                          use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, w["final_norm"], m.rms_eps)
    ce = sum(checkpoint(_row_ce, xb, w["lm_head"], tb, quant,
                        use_reentrant=False) for xb, tb in zip(x, rows))
    return ce / rows.shape[0] + aux / m.num_layers
