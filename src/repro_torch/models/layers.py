"""Building blocks of the dense decoder, in PyTorch.

Port of the dense subset of ``repro/models/layers.py``: plain functions
on tensors, with a parameter group ``p`` passed as a mapping (an
``nn.ParameterDict`` or a dict of tensors).  Weights keep the JAX
package's ``(d_in, d_out)`` orientation, so every projection is
``x @ W``.  Shapes use B=batch, S=sequence, d=d_model, H=query heads,
Hk=kv heads, hd=head_dim.

The port has no banded sliding-window path (``sdpa_banded``): a local
layer takes masked full attention, which computes the same function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# A window value meaning "attend to everything" for global layers.
GLOBAL_WINDOW = (2 ** 31 - 1) // 2

# Score given to masked logits before the softmax, as in the JAX package.
NEG_INF = -1e30


# --------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32):
    """Normal(0, scale) weights drawn in f32 on ``gen``'s device, then
    cast; ``scale`` defaults to 1/sqrt(fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# --------------------------------------------------------------------
# norms / rope / activations
# --------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm in f32 with a ``(1 + w)`` scale, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape positions.shape + (hd/2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd); cos/sin: (S, hd/2) or broadcastable.  Half-split
    rotation (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x, gate_w, up_w, down_w):
    return (F.silu(x @ gate_w) * (x @ up_w)) @ down_w


# --------------------------------------------------------------------
# attention
# --------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "q": dense_init(gen, (d, cfg.q_dim), dtype=dtype),
        "k": dense_init(gen, (d, cfg.kv_dim), dtype=dtype),
        "v": dense_init(gen, (d, cfg.kv_dim), dtype=dtype),
        "o": dense_init(gen, (cfg.q_dim, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return p


def qkv_project(p, x, cfg: ModelConfig, positions):
    """x (B,S,d) -> q (B,S,H,hd), k,v (B,S,Hk,hd), RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["q"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["k"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["v"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def sdpa(q, k, v, *, causal: bool, window=None, q_offset: int = 0):
    """Plain scaled-dot-product attention with GQA.

    q: (B,Sq,H,hd), k/v: (B,Sk,Hk,hd).  ``window`` limits attention to
    the last ``window`` keys; None or GLOBAL_WINDOW = full.  The softmax
    runs in f32 and its probabilities are cast to q's dtype before the
    PV product, as in the JAX package.
    """
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention(p, x, cfg: ModelConfig, *, causal=True, window=None,
              positions=None, use_kernel=False):
    """Full-sequence attention sublayer (no cache): x (B,S,d) -> (B,S,d)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = qkv_project(p, x, cfg, positions)
    if use_kernel:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = sdpa(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, cfg.q_dim) @ p["o"]


def plan_window(cfg: ModelConfig, is_global: bool):
    """The attention window of one layer: None for a global layer (or an
    arch without sliding windows), else ``cfg.sliding_window``.  Layers
    run in a Python loop, so ``is_global`` is always a plain bool."""
    if is_global or cfg.sliding_window is None:
        return None
    return cfg.sliding_window


def _rope_pos_for_decode(pos):
    """Normalize decode ``pos`` (0-d or (B,) tensor) so rope_cos_sin's
    cos/sin broadcast against (B,1,H,hd) queries."""
    if pos.ndim == 0:
        return pos[None]                 # (1,)   -> cos (1, hd/2)
    return pos[:, None]                  # (B,1)  -> cos (B, 1, hd/2)


def decode_attention(p, x, cfg: ModelConfig, k_cache, v_cache, pos, *,
                     cache_len_valid=None, window=None, kv_pos_of_slot=None):
    """One-token attention against a cache.

    x: (B,1,d); k_cache/v_cache: (B,C,Hk,hd) already holding this
    token's k/v.  ``pos``: absolute position of the new token, a 0-d
    tensor (lockstep batch) or a (B,) tensor (every request at its own
    position).  ``kv_pos_of_slot``: (C,) or (B,C) absolute position held
    by each cache slot; None -> slot i holds position i.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = (x @ p["q"]).reshape(B, 1, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
    cos, sin = rope_cos_sin(_rope_pos_for_decode(pos), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    C = k_cache.shape[1]
    slot_pos = (kv_pos_of_slot if kv_pos_of_slot is not None
                else torch.arange(C, device=x.device))
    slot_pos = torch.atleast_2d(slot_pos).expand(B, C)
    pos_b = pos.expand(B)[:, None]                             # (B,1)
    Hk = cfg.num_kv_heads
    qg = q.reshape(B, Hk, cfg.num_heads // Hk, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    mask = (slot_pos <= pos_b) & (slot_pos >= 0)
    if cache_len_valid is not None:
        mask &= slot_pos > pos_b - cache_len_valid
    if window is not None:
        mask &= slot_pos > pos_b - window
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    return out.reshape(B, 1, cfg.q_dim) @ p["o"]


def gathered_attention(q, k_cache, v_cache, qpos, kv_pos, *, window=None):
    """Multi-query attention against a gathered (paged) KV cache.

    q: (B,Sq,H,hd) already RoPE'd; k_cache/v_cache: (B,C,Hk,hd) gathered
    from the block pool and already holding the chunk's own k/v; qpos:
    (B,Sq) absolute query positions; kv_pos: (B,C) absolute position held
    by each gathered slot (-1 = unallocated -> masked out).  Masked slots
    score exactly NEG_INF, so they add exactly 0 to the softmax.
    """
    B, Sq, H, hd = q.shape
    Hk = k_cache.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    kv = kv_pos[:, None, :]                              # (B,1,C)
    qp = qpos[:, :, None]                                # (B,Sq,1)
    mask = (kv <= qp) & (kv >= 0)                        # (B,Sq,C)
    if window is not None:
        mask &= kv > qp - window
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return out.reshape(B, Sq, H, hd)


def project_kv_one(p, x, cfg: ModelConfig, pos):
    """k/v for a single new token: x (B,1,d) -> (B,1,Hk,hd) each.
    ``pos``: 0-d or (B,) tensor."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    k = (x @ p["k"]).reshape(B, 1, cfg.num_kv_heads, hd)
    v = (x @ p["v"]).reshape(B, 1, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = rope_cos_sin(_rope_pos_for_decode(pos), hd, cfg.rope_theta)
    return apply_rope(k, cos, sin), v
