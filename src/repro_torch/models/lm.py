"""Decoder-only language model in PyTorch: dense, MoE, SSM, hybrid, VLM.

Port of ``repro/models/lm.py`` for five families: ``dense`` (attention
+ SwiGLU MLP), ``moe`` (attention + a capacity-dispatched MoE block in
place of the MLP: deepseek-moe-16b, grok-1-314b), ``ssm`` (a Mamba
block per layer, attention-free: falcon-mamba-7b), ``hybrid``
(attention and Mamba heads in parallel on the same normed input,
averaged, then the MLP: hymba-1.5b) and ``vlm`` (the dense decoder
with P stub patch embeddings ``prefix_emb`` (B, P, d) in front of the
token embeddings, at positions 0 .. P-1: phi-3-vision-4.2b).
A ``DeepseekV2Config`` (``moe``, the port's alone) runs latent
attention (``layers.mla_attention``) in every layer, a SwiGLU MLP in
its first ``first_k_dense`` layers and the MoE block, holding its
``experts_held``, in the others; it trains, and its serving entry
points refuse it (no latent cache).
``DecoderLM`` holds the parameters (an ``nn.ModuleList`` of
``DecoderLayer``s, weights in JAX's ``(d_in, d_out)`` orientation); the
entry points below are plain functions over it, as in the JAX package,
with a Python loop over the layers where JAX scans.  Encoder-decoder
models (whisper-small) are ``models.encdec``'s.

The MoE block routes as JAX does per entry point: ``forward`` /
``loss_fn`` and ``prefill_chunk_paged`` follow ``cfg.moe.dispatch``
("grouped": one routing group per batch row), ``prefill`` routes all
B*S tokens as one group, and the decode steps the B tokens of a step
as one group.  Capacity couples the tokens of a group, as in JAX.

Cache layout (decode), as in JAX:
  k, v      : (L, B, C, Hk, hd)      C = cache length (ring buffer)
  conv, ssm : (L, B, cw-1, di), (L, B, di, n)   ssm/hybrid, model dtype
Ring-buffer semantics: position p lives in slot p % C; the absolute
position held by slot i at decode position ``pos`` is
pos - ((pos - i) % C).

Paged layout: kp, vp : (L, num_blocks + 1, block_size, Hk, hd), the last
block a scratch block that masked writes land in, addressed through
per-lane block tables ((n_lanes, nb_max) int, -1 = unallocated).  The
SSM state is per lane and needs no paging: conv, ssm as above with
n_lanes in place of B.

Where the port differs from JAX: ``decode_step``, ``decode_step_paged``
and ``prefill_chunk_paged`` write the cache IN PLACE and return the same
dict (JAX returns a new cache).  ``prefill``'s conv state is left-padded
with zeros for prompts shorter than cw-1 tokens (JAX's one-shot prefill
returns a shorter state there; its chunked path pads, as here).
``prefill`` runs the sequential scan (JAX's default) without JAX's
``REPRO_SSM_SCAN`` switch.  Parameters are created with
``requires_grad=False``: serving holds them as a module.

Training holds the parameters as a flat ``{name: tensor}`` dict keyed as
``DecoderLM.named_parameters()`` (``param_dict``).  ``models.loss_fn``
runs the free functions below on such a dict through
``torch.func.functional_call`` and a parameter-free template
(``template``), so gradients reach the dict's tensors.  Training
attention is the plain ``sdpa``, as in the JAX package's training,
except on the card, where causal bf16 attention of hd 64 or 128 with no
window takes the flash kernels' forward and backward
(``layers.policy_sdpa``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, spans
from repro_torch.configs.base import DeepseekV2Config, ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.sharding import (constrain, is_sharded, pin, replicated,
                                  splittable, splittable_in_grad)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


_ARCHS = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_arch(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config this decoder-only model
    does not run: an encoder-decoder (``models.encdec`` runs those), or
    a prefix frontend outside the ``vlm`` family."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: models.encdec runs it, "
            f"models.lm runs the decoder-only families {_ARCHS}")
    if cfg.arch_type not in _ARCHS or (
            cfg.arch_type != "vlm"
            and (cfg.frontend is not None or cfg.num_prefix_tokens)):
        raise NotImplementedError(
            f"models.lm runs the decoder-only families {_ARCHS} (a prefix "
            f"frontend only in vlm); {cfg.name} is {cfg.arch_type!r}")


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.arch_type != "ssm"


def _has_mamba(cfg: ModelConfig) -> bool:
    return cfg.arch_type == "ssm" or cfg.hybrid


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# A layer's parameter groups in registration (and so named_parameters)
# order: dense {attn_norm, attn, mlp_norm, gate, up, down}; moe {attn_norm,
# attn, mlp_norm, moe}; ssm {norm, mamba}; hybrid the dense groups plus
# mamba.
_LAYER_KEYS = ("norm", "attn_norm", "attn", "mamba", "mlp_norm", "moe",
               "gate", "up", "down")


class DecoderLayer(nn.Module):
    """One pre-norm block, from the JAX layer tree: attention + SwiGLU
    MLP (dense) or MoE block (moe), a Mamba block (ssm), or both heads
    and the MLP (hybrid).  ``KEYS``: the parameter groups it takes, in
    registration order."""

    KEYS = _LAYER_KEYS

    def __init__(self, tree: Dict):
        super().__init__()
        unknown = set(tree) - set(self.KEYS)
        if unknown:
            raise ValueError(f"unknown layer parameters {sorted(unknown)}")
        for key in self.KEYS:
            if key not in tree:
                continue
            leaf = tree[key]
            if isinstance(leaf, dict):
                self.register_module(key, nn.ParameterDict(
                    {k: _param(v) for k, v in leaf.items()}))
            else:
                self.register_parameter(key, _param(leaf))


class DecoderLM(nn.Module):
    """Parameters of a decoder (dense, moe, ssm or hybrid).  ``tree`` is the
    JAX parameter layout with the layers as a list instead of a stacked
    axis: {"embed", "layers": [layer trees], "final_norm"[, "lm_head"]}."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        check_arch(cfg)
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.layers = nn.ModuleList(DecoderLayer(t) for t in tree["layers"])
        self.final_norm = _param(tree["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(tree["lm_head"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``: lets ``torch.func.functional_call``
        run one of this module's free functions (``loss_fn``, ``forward``)
        with other tensors in place of the parameters."""
        return fn(self, *args, **kwargs)


def param_dict(params: DecoderLM) -> Dict[str, torch.Tensor]:
    """The training form of the parameters: ``{name: tensor}`` in
    ``named_parameters()`` order, sharing storage with the module."""
    return {k: p.detach() for k, p in params.named_parameters()}


def _nest(flat: Dict[str, torch.Tensor], stacks=("layers",)) -> Dict:
    """{"layers.0.attn.q": t, ...} -> the tree ``DecoderLM`` takes (each
    of ``stacks`` a list of layer trees)."""
    tree: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    for key in stacks:
        tree[key] = [tree[key][str(i)] for i in range(len(tree[key]))]
    return tree


def from_param_dict(flat: Dict[str, torch.Tensor],
                    cfg: ModelConfig) -> DecoderLM:
    """A DecoderLM over the dict's tensors (no copy), e.g. to serve a
    trained model."""
    return DecoderLM(cfg, _nest({k: t.detach() for k, t in flat.items()}))


def template(flat: Dict[str, torch.Tensor], cfg: ModelConfig) -> DecoderLM:
    """A DecoderLM of the dict's names, shapes and dtypes on the meta
    device (no storage), for ``torch.func.functional_call``."""
    return DecoderLM(cfg, _nest({
        k: torch.empty(t.shape, dtype=t.dtype, device="meta")
        for k, t in flat.items()}))


# --------------------------------------------------------------------
# init
# --------------------------------------------------------------------

def _latent(cfg: ModelConfig) -> bool:
    """DeepSeek-V2's decoder: MLA attention, leading dense layers."""
    return isinstance(cfg, DeepseekV2Config)


def init_layer(gen: torch.Generator, cfg: ModelConfig, i: int = 0) -> Dict:
    """Layer ``i``'s parameter tree."""
    dt, dev, d = _dtype(cfg), gen.device, cfg.d_model
    if cfg.arch_type == "ssm":
        return {"norm": torch.zeros((d,), dtype=dt, device=dev),
                "mamba": L.init_mamba(gen, cfg, dt)}
    p = {"attn_norm": torch.zeros((d,), dtype=dt, device=dev),
         "attn": (L.init_mla if _latent(cfg) else L.init_attention)(
             gen, cfg, dt)}
    if cfg.hybrid:
        p["mamba"] = L.init_mamba(gen, cfg, dt)
    p["mlp_norm"] = torch.zeros((d,), dtype=dt, device=dev)
    dense = _latent(cfg) and i < cfg.first_k_dense
    if cfg.moe is not None and not dense:
        p["moe"] = L.init_moe(gen, cfg, dt)
        return p
    d_ff = cfg.dense_d_ff if dense else cfg.d_ff
    p.update({
        "gate": L.dense_init(gen, (d, d_ff), dtype=dt),
        "up": L.dense_init(gen, (d, d_ff), dtype=dt),
        "down": L.dense_init(gen, (d_ff, d), dtype=dt),
    })
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> DecoderLM:
    """Seeded random init with the JAX package's distributions (its
    bits cannot be matched: parity tests carry JAX params over with
    ``repro_torch.convert``).  Runs on ``cuda`` unless ``device`` names
    another."""
    check_arch(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg)
    tree = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                              scale=0.02, dtype=dt),
        "layers": [init_layer(gen, cfg, i) for i in range(cfg.num_layers)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=dt)
    return DecoderLM(cfg, tree)


def layer_is_global(cfg: ModelConfig) -> List[bool]:
    """Which layers use full (global) attention."""
    if cfg.sliding_window is None:
        return [True] * cfg.num_layers
    if cfg.global_every is None:
        return [False] * cfg.num_layers
    return [(i + 1) % cfg.global_every == 0 for i in range(cfg.num_layers)]


def _decode_window(cfg: ModelConfig, is_global: bool):
    if cfg.sliding_window is None:
        return None
    return L.GLOBAL_WINDOW if is_global else cfg.sliding_window


def _embed(params: DecoderLM, tokens, cfg: ModelConfig, prefix_emb=None):
    """Token embeddings (B, S, d) times sqrt(d), with ``prefix_emb``
    (B, P, d), cast to the model dtype, in front when given."""
    # the sqrt(d) scale is rounded to the model dtype first, as in JAX
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=params.embed.dtype)
    if is_sharded(params.embed):
        # a sharded table is gathered and looked up by ``embedding``:
        # DTensor cannot place the backward of an indexed lookup
        x = F.embedding(tokens, replicated(params.embed)) * scale
    else:
        x = params.embed[tokens] * scale
    if prefix_emb is None:
        return x
    return torch.cat([prefix_emb.to(x.dtype), x], dim=1)


def _head_weight(params: DecoderLM, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _head(params: DecoderLM, x, cfg: ModelConfig):
    return _head_product(L.rms_norm(x, params.final_norm, cfg.rms_eps),
                         _head_weight(params, cfg))


def _head_product(x, head):
    """x @ head (d, V).  Where the vocab does not divide the model axis
    the head splits d over it instead (``sharding._fix_divisibility``),
    and x is laid out to match (``layers.rows_input``)."""
    return L.rows_input(x, head) @ head


def _ffn(layer: DecoderLayer, x, cfg: ModelConfig, grouped: bool,
         decode: bool = False):
    """The layer's MLP (SwiGLU, or the MoE block) of the normed x (B,S,d)
    -> (y (B,S,d), MoE aux or None).  ``grouped``: follow
    ``cfg.moe.dispatch`` (JAX's forward and chunked prefill); otherwise
    every token of the call is one routing group.  ``decode``: the
    tokens of one decode step (``layers.moe_block``'s layout)."""
    # pinned to batch-over-data like the layer input: left free, DTensor
    # may keep the attention's partial sums sharded over the sequence and
    # then gather the weights and the activations both
    h2 = constrain(L.rms_norm(x, layer.mlp_norm, cfg.rms_eps),
                   "batch", None, None)
    if cfg.moe is None or not hasattr(layer, "moe"):
        # a dense model, or a leading dense layer (``first_k_dense``)
        return L.swiglu(h2, layer.gate, layer.up, layer.down), None
    with spans.span("moe"):
        return _moe(layer, h2, cfg, grouped, decode)


def _moe(layer: DecoderLayer, h2, cfg: ModelConfig, grouped: bool,
         decode: bool):
    if grouped and cfg.moe.dispatch == "grouped":
        return L.moe_block(layer.moe, h2, cfg)
    # the tokens as rows, batch-over-data both ways: the dispatch's
    # gradient would otherwise come back split in a way the view back to
    # (B, S, d) cannot unflatten
    rows = constrain(splittable_in_grad(h2.reshape(-1, h2.shape[-1]), 0,
                                        h2.shape[0]), "batch", None)
    y, aux = L.moe_block(layer.moe, rows, cfg, decode=decode)
    # tokens back to batch-over-data before they are rows again (and,
    # with no policy, rows whose split the batch cannot take gathered)
    y = splittable(constrain(y, "batch", None), 0, h2.shape[0])
    return y.reshape(h2.shape), aux


def _mlp(layer: DecoderLayer, x, cfg: ModelConfig, grouped: bool = False,
         decode: bool = False):
    return x + _ffn(layer, x, cfg, grouped, decode)[0]


def _tensor(x, device, dtype=torch.long):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _layer_apply(layer: DecoderLayer, x, cfg: ModelConfig, is_global: bool,
                 positions, use_kernels: bool):
    """One layer, full sequence (training / ``forward``) -> (x, MoE aux
    or None).  The Mamba blocks run the associative scan, JAX's
    ``mamba_forward`` default."""
    if cfg.arch_type == "ssm":
        h = L.rms_norm(x, layer.norm, cfg.rms_eps)
        return x + L.mamba_forward(layer.mamba, h, cfg,
                                   use_kernel=use_kernels), None
    window, banded = L.plan_window(cfg, is_global, x.shape[1])
    h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
    if _latent(cfg):
        a = L.mla_attention(layer.attn, h, cfg, positions)
    else:
        a = L.attention(layer.attn, h, cfg, causal=True, window=window,
                        positions=positions, use_kernel=use_kernels,
                        banded=banded)
    if cfg.hybrid:
        m = L.mamba_forward(layer.mamba, h, cfg, use_kernel=use_kernels)
        a = 0.5 * (a + m)          # Hymba's parallel-head mean fusion
    # the attention's partial sums reduced here: left free, the residual
    # stays a partial sum, and so does its gradient, which makes the
    # backward of the o projection gather its input
    x = pin(x + a, "batch", None, None)
    y, aux = _ffn(layer, x, cfg, grouped=True)
    return x + y, aux


# --------------------------------------------------------------------
# forward / prefill
# --------------------------------------------------------------------

def remat_spans(cfg: ModelConfig) -> List[range]:
    """The layers that each checkpoint of ``run_layers`` covers, where
    JAX's ``_run_layers`` puts ``jax.checkpoint``: one layer each, or
    for an interleaved arch one group of ``global_every`` layers each,
    then one per tail layer."""
    grp = L.layer_groups(cfg)
    if grp is None:
        return [range(i, i + 1) for i in range(cfg.num_layers)]
    ng, g, _ = grp
    return ([range(i * g, (i + 1) * g) for i in range(ng)]
            + [range(i, i + 1) for i in range(ng * g, cfg.num_layers)])


def run_layers(params: nn.Module, stack: str, body, carry: tuple,
               remat: bool, spans=None) -> tuple:
    """``carry = body(layer, i, *carry)`` over the layers of
    ``params.<stack>`` in order.  With ``remat``, and where autograd
    records, each span of ``spans`` (default: one per layer) runs in one
    non-reentrant ``torch.utils.checkpoint``: the backward recomputes
    its activations instead of keeping them, as ``jax.checkpoint`` does.
    The recompute
    stops at the span's last tensor that the backward needs (PyTorch's
    default early stop), so a layer's last product, whose output the
    backward never reads, is not recomputed, as XLA removes it from
    JAX's.  The span's parameters are inputs of the checkpoint, bound to
    the module again for the recompute (``functional_call``): the
    backward runs after ``models.loss_fn``'s own ``functional_call`` has
    put the template's meta tensors back."""
    layers = getattr(params, stack)
    if spans is None:
        spans = [range(i, i + 1) for i in range(len(layers))]
    if not (remat and torch.is_grad_enabled()):
        for i, layer in enumerate(layers):
            carry = body(layer, i, *carry)
        return carry

    def span_fn(module, span, *carry):
        for i in span:
            carry = body(getattr(module, stack)[i], i, *carry)
        return carry

    def run(span, tensors, *carry):
        return torch.func.functional_call(params, tensors,
                                          (span_fn, span, *carry))

    for span in spans:
        tensors = {n: t for i in span for n, t in
                   layers[i].named_parameters(prefix=f"{stack}.{i}")}
        carry = checkpoint(run, span, tensors, *carry, use_reentrant=False,
                           preserve_rng_state=False)
    return carry


def backbone(params: DecoderLM, tokens, cfg: ModelConfig, *,
             prefix_emb=None, use_kernels: bool = False, remat: bool = True):
    """tokens (B,S) -> (final hidden states (B, P+S, d) after the final
    norm, aux): aux is the MoE layers' load-balance losses summed (0
    without MoE).  ``prefix_emb``: (B, P, d) stub embeddings (VLM
    patches) in front of the tokens; P = 0 without it.  ``remat``:
    recompute each layer (each group of an interleaved arch) in the
    backward (``run_layers``), JAX's default."""
    x = constrain(_embed(params, tokens, cfg, prefix_emb), "batch", None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    is_global = layer_is_global(cfg)

    def body(layer, i, x, aux_sum):
        x = pin(x, "batch", None, None)
        x, aux = _layer_apply(layer, x, cfg, is_global[i], positions,
                              use_kernels)
        return x, (aux_sum if aux is None else aux_sum + aux)

    x, aux_sum = run_layers(
        params, "layers", body,
        (x, torch.zeros((), dtype=torch.float32, device=x.device)),
        remat, remat_spans(cfg))
    # so that the head's gradient reaches the last layer reduced
    x = pin(x, "batch", None, None)
    return L.rms_norm(x, params.final_norm, cfg.rms_eps), aux_sum


def forward(params: DecoderLM, tokens, cfg: ModelConfig, *,
            prefix_emb=None, use_kernels: bool = False, remat: bool = True):
    """tokens (B,S) -> (logits (B, P+S, V), aux); ``remat``:
    ``backbone``'s."""
    x, aux = backbone(params, tokens, cfg, prefix_emb=prefix_emb,
                      use_kernels=use_kernels, remat=remat)
    return _head_product(x, _head_weight(params, cfg)), aux


def gold_logits(logits, t):
    """logits (..., V) at the targets t (..., 1) -> (...).  On a sharded
    (DTensor) logits tensor the target is picked by a one-hot product
    and a sum over V, which holds one nonzero term and so gives the same
    value: DTensor's vocab-parallel gather fails on the meta device."""
    if not is_sharded(logits):
        return torch.gather(logits, -1, t)[..., 0]
    vocab = torch.arange(logits.shape[-1], device=t.device)
    return torch.sum(logits * (vocab == t), dim=-1)


def _vocab_split(logits):
    """Logits pinned, the gradient too: their vocab over the model axis
    where it divides the vocab, else whole on every card, the head's
    partial sums over its split d reduced (hymba's 32,001, whisper's
    51,865).  Constrained under a sharding policy, and laid out so in
    every mode, as GSPMD lays out JAX's logits from the head's sharded
    weight.  Left free, the head's weight gradient may be computed over
    the whole vocab on every card, or split as the torch version
    pleases."""
    m = L.model_axis_size(logits)
    if not m:
        return logits
    dims = ("batch", None, "model" if logits.shape[-1] % m == 0 else None)
    return pin(logits, *dims)


def chunked_ce(x, head, tokens, P: int, chunk: int):
    """Sequence-chunked cross-entropy: each step computes a (B, chunk, V)
    slab of logits, never the full (B, S, V).  ``head``: (d, V).
    Predicts tokens[:, 1:] from hidden states at positions P .. P+S-2.
    The last chunk is ragged instead of padded and masked (the same
    sum)."""
    B, S = tokens.shape
    n = S - 1
    hs = x[:, P:P + n]
    tgt = tokens[:, 1:]
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, n, chunk):
        logits = _vocab_split(_head_product(hs[:, lo:lo + chunk],
                                            head).float())
        logz = torch.logsumexp(logits, dim=-1)
        t = tgt[:, lo:lo + chunk, None].long()
        gold = gold_logits(logits, t)
        tot = tot + torch.sum(logz - gold)
    return tot / (B * n)


def loss_fn(params: DecoderLM, batch, cfg: ModelConfig, *,
            remat: bool = True, logit_chunk: Optional[int] = None):
    """Next-token cross-entropy.  batch: {"tokens": (B,S) int} and, for
    the VLM, "prefix_emb" (B, P, d).

    Returns (loss, metrics): the mean over predicted positions (tokens
    1 .. S-1, from positions P .. P+S-2) plus the MoE aux term (the
    layers' load-balance losses summed, over the layer count; zero
    without MoE).
    ``logit_chunk``: compute the CE in sequence chunks of this size.
    ``remat``: recompute each layer in the backward (``backbone``).
    Attention runs through ``layers.policy_sdpa``, as JAX training
    builds its loss with ``use_kernels=False``: plain ``sdpa`` on the CPU
    and wherever the flash kernels' training route does not apply, that
    route on the card (causal bf16 attention of hd 64 or 128 with no
    window, ``flash_attention.ops.takes_train_kernel``)."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_emb")
    P = 0 if prefix is None else prefix.shape[1]
    head = _head_weight(params, cfg)
    if logit_chunk is not None:
        x, aux = backbone(params, tokens, cfg, prefix_emb=prefix,
                          remat=remat)
        ce = chunked_ce(x, head, tokens, P, logit_chunk)
    else:
        logits, aux = forward(params, tokens, cfg, prefix_emb=prefix,
                              remat=remat)
        pred = logits[:, P:-1].float()                 # predicts tokens[1:]
        logz = torch.logsumexp(pred, dim=-1)
        gold = gold_logits(pred, tokens[:, 1:, None].long())
        ce = torch.mean(logz - gold)
    aux = aux / max(cfg.num_layers, 1)
    return ce + aux, {"ce": ce, "aux": aux}


def _no_latent_serving(cfg: ModelConfig, what: str) -> None:
    """MLA serves from a latent cache that the port does not have yet:
    its prefill and its caches refuse the config (so decoding, which
    needs a cache, cannot start)."""
    if _latent(cfg):
        raise NotImplementedError(
            f"{what}: {cfg.name} has latent attention (MLA), which the "
            "port trains but does not serve: there is no latent KV cache")


def _ring_scatter(kv, S_total: int, C: int):
    """Place the last min(C, S_total) positions of kv (B,S,Hk,hd) into a
    (B,C,Hk,hd) ring buffer at slot p % C (position p's canonical slot).
    Built from a pad or a rotation rather than an indexed write, which a
    sharded (DTensor) cache cannot take."""
    take = min(C, S_total)
    last = kv[:, S_total - take:]
    if take < C:           # positions 0 .. S-1 in slots 0 .. S-1
        return F.pad(last, (0, 0, 0, 0, 0, C - take))
    r = (S_total - take) % C           # the slot of the first kept position
    return torch.cat([last[:, C - r:], last[:, :C - r]], dim=1)


def prefill(params: DecoderLM, tokens, cfg: ModelConfig, cache_len: int, *,
            prefix_emb=None, use_kernels: bool = False,
            last_only: bool = False):
    """Forward pass that also fills the KV cache with the P + S
    positions of ``prefix_emb`` (B, P, d; P = 0 without it) and the
    tokens (B, S).  Returns (logits (B, P+S, V), cache);
    ``last_only=True`` computes the final position's logits only (shape
    (B, 1, V)).

    ``use_kernels=True`` runs attention through
    ``kernels.flash_attention.ops.flash_attention`` and the Mamba scan
    through ``kernels.mamba_scan.ops.mamba_scan``: the hand-written
    kernels on a CUDA tensor, their plain versions on a CPU tensor.
    Without it the Mamba blocks run the sequential scan
    (``layers.ssm_scan_seq``), JAX prefill's default.  The Mamba blocks
    also return their decode state from the same scan."""
    _no_latent_serving(cfg, "prefill")
    x = constrain(_embed(params, tokens, cfg, prefix_emb), "batch", None, None)
    B, S_total = x.shape[:2]
    positions = torch.arange(S_total, device=x.device)
    cache: Dict[str, list] = {}

    def mamba(layer, h):
        y, state = L.mamba_forward(layer.mamba, h, cfg,
                                   use_kernel=use_kernels,
                                   return_state=True, scan_impl="seq")
        for name, t in state.items():
            cache.setdefault(name, []).append(t)
        return y

    for layer, g in zip(params.layers, layer_is_global(cfg)):
        x = constrain(x, "batch", None, None)
        if cfg.arch_type == "ssm":
            x = x + mamba(layer, L.rms_norm(x, layer.norm, cfg.rms_eps))
            continue
        window, banded = L.plan_window(cfg, g, S_total)
        h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q, k, v = L.qkv_project(layer.attn, h, cfg, positions)
        if use_kernels:
            a = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        else:
            a = L.policy_sdpa(q, k, v, cfg, causal=True, window=window,
                              banded=banded)
        a = L.out_project(a, layer.attn["o"])
        cache.setdefault("k", []).append(_ring_scatter(k, S_total, cache_len))
        cache.setdefault("v", []).append(_ring_scatter(v, S_total, cache_len))
        if cfg.hybrid:
            a = 0.5 * (a + mamba(layer, h))
        x = _mlp(layer, x + a, cfg)
    if last_only:
        x = x[:, -1:]
    return (_head(params, x, cfg),
            {name: torch.stack(ts) for name, ts in cache.items()})


# --------------------------------------------------------------------
# KV cache + decode
# --------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    check_arch(cfg)
    _no_latent_serving(cfg, "init_cache")
    dev = resolve_device(device)
    cache = {}
    if _has_attn(cfg):
        shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=_dtype(cfg), device=dev)
        cache["v"] = torch.zeros(shape, dtype=_dtype(cfg), device=dev)
    cache.update(_ssm_state(cfg, batch, dev))
    return cache


def _ssm_state(cfg: ModelConfig, lanes: int, dev) -> Dict[str, torch.Tensor]:
    """Zeroed per-lane Mamba decode state (none for dense decoders)."""
    if not _has_mamba(cfg):
        return {}
    Ln, ssm, di = cfg.num_layers, cfg.ssm, cfg.d_inner
    return {"conv": torch.zeros((Ln, lanes, ssm.conv_dim - 1, di),
                                dtype=_dtype(cfg), device=dev),
            "ssm": torch.zeros((Ln, lanes, di, ssm.state_dim),
                               dtype=_dtype(cfg), device=dev)}


def _mamba_decode_into(layer: DecoderLayer, h, cfg: ModelConfig,
                       conv_cache, ssm_cache, active=None):
    """One-token Mamba step on this layer's (B, cw-1, di) / (B, di, n)
    state views, written in place (inactive lanes keep theirs).
    Returns the block's output (B, 1, d)."""
    y, conv, ssm = L.mamba_decode(layer.mamba, h, cfg, conv_cache, ssm_cache)
    conv_cache.copy_(_mask_state(conv, conv_cache, active))
    ssm_cache.copy_(_mask_state(ssm, ssm_cache, active))
    return y


def _mask_state(new, old, active):
    """Keep ``old`` rows for inactive lanes (retired slots must not
    accumulate garbage).  active: (B,) bool; leading axis is B."""
    if active is None:
        return new
    keep = active.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(keep, new, old)


def _decode_layer(layer: DecoderLayer, x, cfg: ModelConfig, is_global: bool,
                  cs: Dict[str, torch.Tensor], pos, C: int, active=None):
    """One layer, one token.  ``cs``: this layer's cache views ((B,C,Hk,hd)
    k/v, (B,cw-1,di) conv, (B,di,n) ssm), written in place: k/v at the
    token's slot.  ``active``: optional (B,) bool lane mask — inactive
    lanes keep their cache rows and state."""
    if cfg.arch_type == "ssm":
        h = L.rms_norm(x, layer.norm, cfg.rms_eps)
        return x + _mamba_decode_into(layer, h, cfg, cs["conv"], cs["ssm"],
                                      active)
    k_cache, v_cache = cs["k"], cs["v"]
    h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
    k_new, v_new = L.project_kv_one(layer.attn, h, cfg, pos)
    slot = pos % C
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    slot_b = slot.expand(B)                      # lockstep: one slot
    k_w, v_w = k_new[:, 0], v_new[:, 0]
    if active is not None:
        k_w = _mask_state(k_w, k_cache[rows, slot_b], active)
        v_w = _mask_state(v_w, v_cache[rows, slot_b], active)
    write_slot(k_cache, rows, slot_b, k_w)
    write_slot(v_cache, rows, slot_b, v_w)
    pos_c = pos[..., None]                                   # (1,) or (B,1)
    kv_pos = pos_c - (pos_c - torch.arange(C, device=x.device)) % C
    a = L.decode_attention(layer.attn, h, cfg, k_cache, v_cache, pos,
                           window=_decode_window(cfg, is_global),
                           kv_pos_of_slot=kv_pos)
    if cfg.hybrid:
        a = 0.5 * (a + _mamba_decode_into(layer, h, cfg, cs["conv"],
                                          cs["ssm"], active))
    return _mlp(layer, x + a, cfg, decode=True)


def write_slot(cache, rows, slot_b, new):
    """cache[rows, slot_b] = new, in place: row b's slot slot_b[b] of a
    (B, C, ...) cache.  A cache sharded along C (a DTensor) takes no
    indexed write there; it selects the new row over its whole shard
    instead, as a partitioned dynamic-update-slice does."""
    if is_sharded(cache):
        C = cache.shape[1]
        hit = torch.arange(C, device=slot_b.device)[None, :] == slot_b[:, None]
        hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
        cache.copy_(torch.where(hit, new[:, None], cache))
    else:
        cache[rows, slot_b] = new


def decode_step(params: DecoderLM, cache, token, pos, cfg: ModelConfig, *,
                active=None):
    """token (B,) int, pos scalar or (B,) int -> (logits (B,V), cache).
    The cache is updated in place and returned.  ``active``: optional
    (B,) bool lane mask — inactive lanes compute but never write."""
    dev = params.device
    token = _tensor(token, dev)
    pos = _tensor(pos, dev)
    if active is not None:
        active = _tensor(active, dev, torch.bool)
    x = _embed(params, token, cfg)[:, None, :]
    C = cache["k"].shape[2] if "k" in cache else 0
    # an embedding split on d (the vocab does not divide the model axis)
    # has GSPMD carry the residual so, and a step whose rows lie whole
    # on every data card then splits the layers' products over the data
    # axes (``layers.decode_product``); its head it does not
    with L.decode_over_data(L.splits_over_model(params.embed, 1)):
        for i, (layer, g) in enumerate(zip(params.layers,
                                           layer_is_global(cfg))):
            x = _decode_layer(layer, x, cfg, g,
                              {name: t[i] for name, t in cache.items()},
                              pos, C, active=active)
    return _head(params, x[:, 0], cfg), cache


# --------------------------------------------------------------------
# paged KV cache (block pool + block tables) — serving
# --------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_lanes: int, num_blocks: int,
                     block_size: int, *, device=None):
    """Block pools (L, num_blocks + 1, block_size, Hk, hd), the last
    block scratch, for families with attention; per-lane Mamba state
    (L, n_lanes, ...) for families with a Mamba block."""
    _no_latent_serving(cfg, "init_paged_cache")
    check_arch(cfg)
    dev = resolve_device(device)
    cache = {}
    if _has_attn(cfg):
        shape = (cfg.num_layers, num_blocks + 1, block_size,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["kp"] = torch.zeros(shape, dtype=_dtype(cfg), device=dev)
        cache["vp"] = torch.zeros(shape, dtype=_dtype(cfg), device=dev)
    cache.update(_ssm_state(cfg, n_lanes, dev))
    return cache


def _slot_positions(table, bs: int):
    """kv_pos of every gathered slot: its position, or -1 where the
    table has no block."""
    nb = table.shape[-1]
    slot_idx = torch.arange(nb * bs, device=table.device)
    valid = (table >= 0).repeat_interleave(bs, dim=-1)
    return torch.where(valid, slot_idx, -1)


def decode_step_paged(params: DecoderLM, cache, token, pos, cfg: ModelConfig,
                      tables, active, *, block_size: int):
    """One decode tick over the paged cache, written in place.

    token, pos, active : (B,) — B lanes in lockstep, each at its own
        position; inactive (or unallocated) lanes write zeros into the
        scratch block.
    tables : (B, nb_max) physical-block table per lane (-1 = none).
    Returns (logits (B, V), cache).  Slots beyond a lane's allocation
    carry kv_pos = -1 and drop out of the softmax exactly.
    """
    dev = params.device
    token, pos, tables = (_tensor(token, dev), _tensor(pos, dev),
                          _tensor(tables, dev))
    active = _tensor(active, dev, torch.bool)
    B, bs = token.shape[0], block_size
    if _has_attn(cfg):
        nb = tables.shape[1]
        scratch = cache["kp"].shape[1] - 1
        blk = torch.clamp(pos // bs, 0, nb - 1)
        off = pos % bs
        phys = tables.gather(1, blk[:, None])[:, 0]
        ok = active & (phys >= 0)
        phys_w = torch.where(ok, phys, scratch)
        tab_c = torch.where(tables >= 0, tables, scratch)
        kv_pos = _slot_positions(tables, bs)
        Hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    x = _embed(params, token, cfg)[:, None, :]
    for i, (layer, g) in enumerate(zip(params.layers, layer_is_global(cfg))):
        if cfg.arch_type == "ssm":
            h = L.rms_norm(x, layer.norm, cfg.rms_eps)
            x = x + _mamba_decode_into(layer, h, cfg, cache["conv"][i],
                                       cache["ssm"][i], active)
            continue
        h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
        k_new, v_new = L.project_kv_one(layer.attn, h, cfg, pos)
        kp, vp = cache["kp"][i], cache["vp"][i]
        # colliding scratch writes all carry zeros: deterministic
        kp[phys_w, off] = torch.where(ok[:, None, None], k_new[:, 0], 0)
        vp[phys_w, off] = torch.where(ok[:, None, None], v_new[:, 0], 0)
        k_cache = kp[tab_c].reshape(B, nb * bs, Hk, hd)
        v_cache = vp[tab_c].reshape(B, nb * bs, Hk, hd)
        a = L.decode_attention(layer.attn, h, cfg, k_cache, v_cache, pos,
                               window=_decode_window(cfg, g),
                               kv_pos_of_slot=kv_pos)
        if cfg.hybrid:
            a = 0.5 * (a + _mamba_decode_into(layer, h, cfg, cache["conv"][i],
                                              cache["ssm"][i], active))
        x = _mlp(layer, x + a, cfg)
    return _head(params, x[:, 0], cfg), cache


def prefill_chunk_paged(params: DecoderLM, cache, tokens, pos0: int,
                        cfg: ModelConfig, table_row, lane: int, *,
                        block_size: int):
    """Prefill one chunk of one lane's prompt into the paged cache, in
    place.

    tokens : (1, Sc) chunk covering positions [pos0, pos0 + Sc); the
        blocks spanning that range must already be in ``table_row``
        ((nb_max,), -1 = unallocated).
    lane : the lane whose Mamba state (conv, ssm) carries across
        chunks; dense decoders have none.
    Attention sees every earlier position through the gathered cache,
    and the Mamba blocks continue the lane's carried state with the same
    f32 recurrence as one-shot prefill (``layers.mamba_forward_chunk``),
    so chunked prefill equals one-shot prefill.  Returns (last-position
    logits (1, V), cache).
    """
    dev = params.device
    tokens, table_row = _tensor(tokens, dev), _tensor(table_row, dev)
    B, Sc = tokens.shape
    positions = int(pos0) + torch.arange(Sc, device=dev)
    if _has_attn(cfg):
        bs = block_size
        nb = table_row.shape[0]
        scratch = cache["kp"].shape[1] - 1
        phys = table_row[torch.clamp(positions // bs, 0, nb - 1)]
        phys_w = torch.where(phys >= 0, phys, scratch)
        off = positions % bs
        tab_c = torch.where(table_row >= 0, table_row, scratch)
        kv_pos = _slot_positions(table_row, bs)[None]      # (1, nb*bs)
        qpos = positions[None]                             # (1, Sc)
        Hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def mamba(i, layer, h):
        conv, ssm = cache["conv"][i], cache["ssm"][i]
        y, st = L.mamba_forward_chunk(layer.mamba, h, cfg, conv[lane][None],
                                      ssm[lane][None])
        conv[lane] = st["conv"][0]
        ssm[lane] = st["ssm"][0]
        return y

    x = _embed(params, tokens, cfg)
    for i, (layer, g) in enumerate(zip(params.layers, layer_is_global(cfg))):
        if cfg.arch_type == "ssm":
            x = x + mamba(i, layer, L.rms_norm(x, layer.norm, cfg.rms_eps))
            continue
        h = L.rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q, k, v = L.qkv_project(layer.attn, h, cfg, positions)
        kp, vp = cache["kp"][i], cache["vp"][i]
        kp[phys_w, off] = k[0]
        vp[phys_w, off] = v[0]
        k_cache = kp[tab_c].reshape(1, nb * bs, Hk, hd)
        v_cache = vp[tab_c].reshape(1, nb * bs, Hk, hd)
        a = L.gathered_attention(q, k_cache, v_cache, qpos, kv_pos,
                                 window=_decode_window(cfg, g))
        a = a.reshape(B, Sc, cfg.q_dim) @ layer.attn["o"]
        if cfg.hybrid:
            a = 0.5 * (a + mamba(i, layer, h))
        x = _mlp(layer, x + a, cfg, grouped=True)
    return _head(params, x[:, -1], cfg), cache
