"""Encoder-decoder transformer in PyTorch (whisper-small's backbone).

Port of ``repro/models/encdec.py``.  The audio frontend (mel + conv) is
a stub there and here: the encoder takes precomputed frame embeddings
(B, F, d).  As in the JAX package: RMSNorm instead of LayerNorm, RoPE
self-attention positions (0 .. F-1 in the encoder, 0 .. S-1 in the
decoder) instead of learned ones, no RoPE in cross-attention, a GELU
MLP with biases, and the head tied to the embedding (no ``lm_head``,
whatever the config's ``tie_embeddings`` says).

``EncDecLM`` holds the parameters (``embed``, ``enc_layers``,
``dec_layers``, ``enc_norm``, ``final_norm``; weights in JAX's
``(d_in, d_out)`` orientation); the entry points are plain functions
over it, with a Python loop over the layers where JAX scans.

Cache layout (decode): k, v (L, B, C, Hk, hd), the decoder's self
attention in a ring buffer (position p in slot p % C, as in
``models.lm``); xk, xv (L, B, F, Hk, hd), the encoder states projected
once per decoder layer for cross-attention.  ``decode_step`` writes k
and v IN PLACE and returns the same dict (JAX returns a new cache).

``encode(use_kernels=True)`` runs the encoder's bidirectional
self-attention through ``kernels.flash_attention`` (the hand-written
kernel on a CUDA tensor, its plain version on a CPU tensor), as
serving does (``init_cache``); cross-attention (Sq != F) and the
decoder's self attention stay plain ``sdpa``, as in the JAX package.
Training (``loss_fn``) runs attention through ``layers.policy_sdpa``:
on the card the decoder's causal bf16 self attention (hd 64) takes the
flash kernels' training route, the encoder's bidirectional and the
cross attention stay plain ``sdpa``; the CPU is plain.  Parameters
are created with ``requires_grad=False``; training holds them as the
flat dict of ``param_dict`` and runs ``loss_fn`` through
``torch.func.functional_call`` on ``template``, as ``models.lm`` does.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.lm import _dtype, _embed, param_dict  # noqa: F401
from repro_torch.sharding import constrain, pin, pin_grad

_STACKS = ("enc_layers", "dec_layers")


def check_arch(cfg: ModelConfig) -> None:
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder: "
                         "models.lm runs it")


class EncDecLayer(lm.DecoderLayer):
    """One pre-norm block from the JAX layer tree: self-attention
    (+ cross-attention in the decoder) and the GELU MLP."""

    KEYS = ("attn_norm", "attn", "xattn_norm", "xattn", "mlp_norm", "mlp")


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder.  ``tree`` is the JAX layout
    with the layers as lists instead of a stacked axis: {"embed",
    "enc_layers": [...], "dec_layers": [...], "enc_norm",
    "final_norm"}."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        check_arch(cfg)
        self.cfg = cfg
        self.embed = lm._param(tree["embed"])
        self.enc_layers = nn.ModuleList(EncDecLayer(t)
                                        for t in tree["enc_layers"])
        self.dec_layers = nn.ModuleList(EncDecLayer(t)
                                        for t in tree["dec_layers"])
        self.enc_norm = lm._param(tree["enc_norm"])
        self.final_norm = lm._param(tree["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``, for
        ``torch.func.functional_call`` (see ``lm.DecoderLM.forward``)."""
        return fn(self, *args, **kwargs)


def from_param_dict(flat: Dict[str, torch.Tensor],
                    cfg: ModelConfig) -> EncDecLM:
    """An EncDecLM over the dict's tensors (no copy)."""
    return EncDecLM(cfg, lm._nest({k: t.detach() for k, t in flat.items()},
                                  _STACKS))


def template(flat: Dict[str, torch.Tensor], cfg: ModelConfig) -> EncDecLM:
    """An EncDecLM of the dict's names, shapes and dtypes on the meta
    device, for ``torch.func.functional_call``."""
    return EncDecLM(cfg, lm._nest({
        k: torch.empty(t.shape, dtype=t.dtype, device="meta")
        for k, t in flat.items()}, _STACKS))


# --------------------------------------------------------------------
# init
# --------------------------------------------------------------------

def _init_mlp(gen: torch.Generator, cfg: ModelConfig, dt) -> Dict:
    dev = gen.device
    return {"up": L.dense_init(gen, (cfg.d_model, cfg.d_ff), dtype=dt),
            "up_b": torch.zeros((cfg.d_ff,), dtype=dt, device=dev),
            "down": L.dense_init(gen, (cfg.d_ff, cfg.d_model), dtype=dt),
            "down_b": torch.zeros((cfg.d_model,), dtype=dt, device=dev)}


def _init_layer(gen: torch.Generator, cfg: ModelConfig, cross: bool) -> Dict:
    dt, dev, d = _dtype(cfg), gen.device, cfg.d_model
    p = {"attn_norm": torch.zeros((d,), dtype=dt, device=dev),
         "attn": L.init_attention(gen, cfg, dt)}
    if cross:
        p["xattn_norm"] = torch.zeros((d,), dtype=dt, device=dev)
        p["xattn"] = L.init_attention(gen, cfg, dt)
    p["mlp_norm"] = torch.zeros((d,), dtype=dt, device=dev)
    p["mlp"] = _init_mlp(gen, cfg, dt)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> EncDecLM:
    """Seeded random init with the JAX package's distributions (zero
    biases and norm weights), on ``cuda`` unless ``device`` names
    another."""
    check_arch(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg)
    return EncDecLM(cfg, {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                              scale=0.02, dtype=dt),
        "enc_layers": [_init_layer(gen, cfg, False)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_init_layer(gen, cfg, True)
                       for _ in range(cfg.num_layers)],
        "enc_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    })


# --------------------------------------------------------------------
# encoder / teacher-forced decoder
# --------------------------------------------------------------------

def _mlp(layer: EncDecLayer, x, cfg: ModelConfig):
    h = constrain(L.rms_norm(x, layer.mlp_norm, cfg.rms_eps), "batch", None,
                  None)
    p = layer.mlp
    return x + L.gelu_mlp(h, p["up"], p["up_b"], p["down"], p["down_b"])


def _cross_attention(p, x, enc_kv, cfg: ModelConfig):
    """x (B,Sq,d) queries (no RoPE) against the encoder's k/v
    (B,F,Hk,hd): plain ``sdpa``, as in the JAX package (under a sharding
    policy each card takes its own heads or query rows,
    ``layers.policy_sdpa``)."""
    k, v = enc_kv
    q = L.split_heads(x @ p["q"], cfg.num_heads, cfg.resolved_head_dim)
    out = L.policy_sdpa(q, k, v, cfg, causal=False)
    return L.out_project(out, p["o"])


def encode(params: EncDecLM, frames, cfg: ModelConfig, *,
           use_kernels: bool = False):
    """frames (B,F,d) stub embeddings -> encoder states (B,F,d):
    bidirectional self-attention with RoPE at positions 0 .. F-1."""
    x = frames.to(_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in params.enc_layers:
        # pinned as the decoder's layers pin theirs (``lm.backbone``)
        x = pin(x, "batch", None, None)
        h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
        x = pin(x + L.attention(layer.attn, h, cfg, causal=False,
                                positions=positions,
                                use_kernel=use_kernels),
                "batch", None, None)
        x = _mlp(layer, x, cfg)
    x = pin(x, "batch", None, None)
    return L.rms_norm(x, params.enc_norm, cfg.rms_eps)


def enc_kv(p_xattn, enc_out, cfg: ModelConfig):
    """Encoder states -> cross-attention k, v (B,F,Hk,hd), no RoPE.
    Under a sharding policy each is whole on every model card: the
    projection's partial sums reduced once here, not left in the
    cross-attention einsum of every decoder step (which stalls DTensor
    for minutes on the 2-pod mesh).  Their gradient comes back laid out
    as the projection made them (``pin_grad``): whole on every model
    card, it would have each card compute all of the weight's
    gradient."""
    hd = cfg.resolved_head_dim
    return tuple(constrain(pin_grad(L.split_heads(enc_out @ p_xattn[w],
                                                  cfg.num_kv_heads, hd)),
                           "batch", None, None, None) for w in ("k", "v"))


def _head(params: EncDecLM, x, cfg: ModelConfig):
    return lm._head_product(L.rms_norm(x, params.final_norm, cfg.rms_eps),
                            params.embed.T)


def decode_forward(params: EncDecLM, tokens, enc_out, cfg: ModelConfig, *,
                   remat: bool = True):
    """Teacher-forced decoder pass: tokens (B,S) -> logits (B,S,V), its
    attention through ``layers.policy_sdpa``.  ``remat``: recompute each decoder
    layer in the backward (``lm.run_layers``), JAX's default; the
    encoder keeps its activations, as in JAX."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(layer, i, x):
        # pinned as the encoder's layers are
        x = pin(x, "batch", None, None)
        h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
        x = pin(x + L.attention(layer.attn, h, cfg, causal=True,
                                positions=positions),
                "batch", None, None)
        h = L.rms_norm(x, layer.xattn_norm, cfg.rms_eps)
        x = pin(x + _cross_attention(
            layer.xattn, h, enc_kv(layer.xattn, enc_out, cfg), cfg),
            "batch", None, None)
        return (_mlp(layer, x, cfg),)

    x, = lm.run_layers(params, "dec_layers", body, (x,), remat)
    return _head(params, pin(x, "batch", None, None), cfg)


def loss_fn(params: EncDecLM, batch, cfg: ModelConfig, *,
            remat: bool = True):
    """batch: {"frames": (B,F,d), "tokens": (B,S)} -> (loss, metrics):
    the mean next-token cross-entropy over tokens 1 .. S-1 (aux 0).
    Attention runs through ``layers.policy_sdpa`` (the module's note).
    ``remat``:
    ``decode_forward``'s."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_forward(params, tokens, enc_out, cfg, remat=remat)
    pred = logits[:, :-1].float()
    logz = torch.logsumexp(pred, dim=-1)
    gold = lm.gold_logits(pred, tokens[:, 1:, None].long())
    ce = torch.mean(logz - gold)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# --------------------------------------------------------------------
# decode with cache
# --------------------------------------------------------------------

def cross_cache(cfg: ModelConfig, params: EncDecLM, frames, *,
                use_kernels: bool = False) -> Dict[str, torch.Tensor]:
    """Runs the encoder once (``use_kernels``: through the flash wrapper)
    and projects its states to every decoder layer's cross k/v: {"xk",
    "xv"} (L,B,F,Hk,hd), on ``params``' device."""
    frames = torch.as_tensor(frames, device=params.device)
    enc_out = encode(params, frames, cfg, use_kernels=use_kernels)
    xk, xv = zip(*(enc_kv(layer.xattn, enc_out, cfg)
                   for layer in params.dec_layers))
    return {"xk": torch.stack(xk), "xv": torch.stack(xv)}


def init_cache(cfg: ModelConfig, params: EncDecLM, frames, cache_len: int,
               *, use_kernels: bool = False) -> Dict[str, torch.Tensor]:
    """``cross_cache`` and zeroed self-attention k/v of ``cache_len``
    slots.  On ``params``' device."""
    cross = cross_cache(cfg, params, frames, use_kernels=use_kernels)
    shape = (cfg.num_layers, cross["xk"].shape[1], cache_len,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    dev = params.device
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            **cross}


def decode_step(params: EncDecLM, cache, token, pos, cfg: ModelConfig):
    """One decoder token (B,) at position ``pos`` (scalar) against the
    self-attention ring (slot pos % C, written in place) and the cross
    cache -> (logits (B,V), cache)."""
    dev = params.device
    token = torch.as_tensor(token, dtype=torch.long, device=dev)
    pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
    x = _embed(params, token, cfg)[:, None, :]
    C = cache["k"].shape[2]
    slot = (pos % C).reshape(1)
    kv_pos = pos - (pos - torch.arange(C, device=dev)) % C
    for i, layer in enumerate(params.dec_layers):
        ck, cv = cache["k"][i], cache["v"][i]
        h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
        k_new, v_new = L.project_kv_one(layer.attn, h, cfg, pos)
        rows = torch.arange(ck.shape[0], device=dev)
        lm.write_slot(ck, rows, slot.expand(ck.shape[0]), k_new[:, 0])
        lm.write_slot(cv, rows, slot.expand(ck.shape[0]), v_new[:, 0])
        x = x + L.decode_attention(layer.attn, h, cfg, ck, cv, pos,
                                   kv_pos_of_slot=kv_pos)
        h = L.rms_norm(x, layer.xattn_norm, cfg.rms_eps)
        x = x + _cross_attention(layer.xattn, h,
                                 (cache["xk"][i], cache["xv"][i]), cfg)
        x = _mlp(layer, x, cfg)
    return _head(params, x[:, 0], cfg), cache
