"""DeepSeek-V2's decoder (arXiv:2405.04434) in plain float32 PyTorch: the
reference that ``test_torch_deepseek_v2`` holds the port's
``DeepseekV2Config`` models to.  It imports nothing of the port and no
JAX, and turns TF32 off where it runs on a card.  It writes the
equations out whole and returns logits and aux; the benchmark's own
reference (``bench/reference/moe_model.py``), shaped to fit the card at
full size, is held to the port on tiny cells by ``bench/tests``.

Per layer (pre-norm, norms scale by 1 + w): MLA, then a SwiGLU MLP in
the first ``first_k_dense`` layers and a MoE layer in the others.

- MLA, per token x and H heads: q = x Wq, per head [q_nope ; q_rope];
  [c ; k_r] = x Wkv_a; c = rmsnorm(c); [k_nope ; v] = c Wkv_b per head;
  k = [k_nope ; rope(k_r) on every head], q = [q_nope ; rope(q_rope)];
  causal softmax(q k^T / sqrt(nope + rope)) v, then Wo.  Rotary is the
  half-split rotation over the rope part alone.
- MoE over T = B*S tokens as one group: softmax of the f32 router, the
  top-k by probability, weights renormalised only with ``norm_topk``.
  Each expert takes its assignments in the order (token, choice) up to
  C = max(K, ceil(T K / E * 1.25)); later ones are dropped.  Only the
  ``held`` experts' kept assignments add to the result, weighted; every
  shared expert sees every token.  aux = coef * E * sum_e (share of
  the T K assignments to e, dropped ones too) * (mean probability of e).
- Embeddings times sqrt(d_model) rounded to the weights' dtype; the loss
  is the mean cross-entropy of tokens 1 .. S-1 plus the layers' aux
  summed over the layer count.

Leaves are the port's training names (``layers.<i>.attn.q``,
``layers.<i>.moe.gate`` ...); the expert leaves hold the ``held``
experts in order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Sizes:
    num_layers: int
    d_model: int
    num_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense: int
    vocab_size: int
    num_experts: int
    top_k: int
    num_shared: int
    held: range
    norm_topk: bool
    rope_theta: float
    rms_eps: float
    aux_coef: float
    capacity_factor: float = 1.25


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (1 + w)


def rope(x, theta):
    """x (B, S, H, n): the half-split rotation at positions 0 .. S-1."""
    half = x.shape[-1] // 2
    freqs = theta ** -(torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float32)[:, None] * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], -1)


def swiglu(x, g, u, d):
    return (F.silu(x @ g) * (x @ u)) @ d


def mla(s: Sizes, w: Dict[str, torch.Tensor], x):
    """x (B, S, d) -> (B, S, d); ``w``: the layer's attn.* leaves."""
    B, S, _ = x.shape
    H, r = s.num_heads, s.kv_lora_rank
    dn, dr, dv = s.qk_nope_head_dim, s.qk_rope_head_dim, s.v_head_dim
    q = (x @ w["q"]).view(B, S, H, dn + dr)
    a = x @ w["kv_a"]
    c = rms_norm(a[..., :r], w["kv_norm"], s.rms_eps)
    kv = (c @ w["kv_b"]).view(B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], s.rope_theta)], -1)
    k_r = rope(a[..., None, r:], s.rope_theta).expand(B, S, H, dr)
    k = torch.cat([kv[..., :dn], k_r], -1)
    v = kv[..., dn:]
    scores = torch.einsum("bqhn,bkhn->bhqk", q, k) / math.sqrt(dn + dr)
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    out = torch.einsum("bhqk,bkhn->bqhn", p, v).reshape(B, S, H * dv)
    return out @ w["o"]


def moe(s: Sizes, w: Dict[str, torch.Tensor], x):
    """x (T, d) -> (y (T, d), aux); ``w``: the layer's moe.* leaves."""
    T = x.shape[0]
    E, K = s.num_experts, s.top_k
    C = max(K, math.ceil(T * K / E * s.capacity_factor))
    probs = torch.softmax(x @ w["router"], -1)
    topw, topi = torch.topk(probs, K, -1)
    if s.norm_topk:
        topw = topw / topw.sum(-1, keepdim=True)
    flat_e, flat_w = topi.reshape(-1), topw.reshape(-1)
    y = torch.zeros_like(x)
    for j, e in enumerate(s.held):
        kept = torch.nonzero(flat_e == e)[:C, 0]      # (token, choice) order
        tok = kept // K
        out = swiglu(x[tok], w["gate"][j], w["up"][j], w["down"][j])
        y = y.index_add(0, tok, out * flat_w[kept, None])
    for i in range(s.num_shared):
        y = y + swiglu(x, w["s_gate"][i], w["s_up"][i], w["s_down"][i])
    share = torch.bincount(flat_e, minlength=E).float() / (T * K)
    aux = s.aux_coef * E * torch.sum(share * probs.mean(0))
    return y, aux


def layer(s: Sizes, w: Dict[str, torch.Tensor], i: int, x):
    """Layer i on x (B, S, d) -> (x, aux or 0)."""
    sub = {k[len(f"layers.{i}."):]: t for k, t in w.items()
           if k.startswith(f"layers.{i}.")}
    grp = {g: {k.split(".", 1)[1]: t for k, t in sub.items()
               if k.startswith(g + ".")} for g in ("attn", "moe")}
    x = x + mla(s, grp["attn"], rms_norm(x, sub["attn_norm"], s.rms_eps))
    h = rms_norm(x, sub["mlp_norm"], s.rms_eps)
    if i < s.first_k_dense:
        return x + swiglu(h, sub["gate"], sub["up"], sub["down"]), 0.0
    y, aux = moe(s, grp["moe"], h.reshape(-1, h.shape[-1]))
    return x + y.view(h.shape), aux


def forward(s: Sizes, w: Dict[str, torch.Tensor], tokens):
    """tokens (B, S) -> (logits (B, S, V), the layers' aux summed)."""
    scale = float(torch.tensor(math.sqrt(s.d_model), dtype=w["embed"].dtype))
    x = w["embed"][tokens] * scale
    aux = 0.0
    for i in range(s.num_layers):
        x, a = layer(s, w, i, x)
        aux = aux + a
    return rms_norm(x, w["final_norm"], s.rms_eps) @ w["lm_head"], aux


def loss(s: Sizes, w: Dict[str, torch.Tensor], tokens):
    """-> (loss, cross-entropy, aux over the layer count)."""
    logits, aux = forward(s, w, tokens)
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, s.vocab_size),
                         tokens[:, 1:].reshape(-1))
    aux = aux / s.num_layers
    return ce + aux, ce, aux
