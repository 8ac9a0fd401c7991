"""Meta-device input stand-ins and sharding plans for the dry run.

Port of ``repro/launch/specs.py``.  ``abstract_params`` and the
``*_inputs`` functions return meta tensors (shapes and dtypes, no
storage) of every model input; the ``*_specs`` functions return the
matching specs (``repro_torch.sharding``) for a mesh, and the
``*_shardings`` functions distribute meta tensors by them.  A spec
function takes a ``DeviceMesh`` or an {axis: size} dict, so a plan can
be checked for a mesh that no process group backs.

Sharding plan summary:
  train    batch (accum, mb, S):    (None, data-axes, None)
  prefill  tokens (GB, S):          (data-axes, None)
  decode   token (GB,):             (data-axes,)
           kv cache (L,B,C,Hk,hd):  sequence-parallel cache: C sharded
             over "model" (B over the data axes); when B < |data|
             (long_500k: B = 1) the cache and state dims take the
             combined (data, model) axes instead.
  mamba state (L,B,di,n):           di sharded (model or data+model)
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import sharding
from repro_torch.configs import LONG_CONTEXT_ARCHS
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.sharding import data_axes, mesh_shape

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def data_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in data_axes(mesh))


# ------------------------------------------------------------------
# abstract inputs
# ------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{name: meta tensor} with the names, shapes and dtypes of
    ``lm.param_dict(models.init_params(cfg))``.  The init runs under a
    ``FakeTensorMode``, so no random number is drawn and nothing is
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import models
    with FakeTensorMode():
        flat = models.lm.param_dict(models.init_params(cfg, 0, device="cpu"))
    return {k: _meta(t.shape, t.dtype) for k, t in flat.items()}


def train_inputs(cfg: ModelConfig, shape: InputShape,
                 accum: int = 1) -> Dict[str, torch.Tensor]:
    GB, S = shape.global_batch, shape.seq_len
    if GB % accum:
        raise ValueError(f"accum {accum} does not divide batch {GB}")
    mb = GB // accum
    batch = {"tokens": _meta((accum, mb, S), torch.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = _meta((accum, mb, cfg.num_prefix_tokens,
                                 cfg.d_model), _dt(cfg))
    elif cfg.frontend is not None:
        batch["prefix_emb"] = _meta((accum, mb, cfg.num_prefix_tokens,
                                     cfg.d_model), _dt(cfg))
    return batch


def prefill_inputs(cfg: ModelConfig,
                   shape: InputShape) -> Dict[str, torch.Tensor]:
    GB, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((GB, S), torch.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = _meta((GB, cfg.num_prefix_tokens, cfg.d_model),
                                _dt(cfg))
    elif cfg.frontend is not None:
        batch["prefix_emb"] = _meta((GB, cfg.num_prefix_tokens,
                                     cfg.d_model), _dt(cfg))
    return batch


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k takes the sub-quadratic path: a ring buffer of the
    window (sliding-window archs) or the state alone (SSM)."""
    if shape.name == "long_500k":
        if cfg.name not in LONG_CONTEXT_ARCHS and cfg.arch_type != "ssm":
            raise ValueError(f"{cfg.name} has no sub-quadratic path for "
                             "long_500k")
        if cfg.sliding_window is not None:
            return cfg.sliding_window
        return 1  # attention-free: k/v cache unused
    return shape.seq_len


def decode_inputs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """Meta (token, pos, cache) for ``models.decode_step``."""
    GB = shape.global_batch
    C = cache_len_for(cfg, shape)
    Ln, hd, dt = cfg.num_layers, cfg.resolved_head_dim, _dt(cfg)
    cache = {}
    if cfg.arch_type != "ssm":
        cache["k"] = _meta((Ln, GB, C, cfg.num_kv_heads, hd), dt)
        cache["v"] = _meta((Ln, GB, C, cfg.num_kv_heads, hd), dt)
    if cfg.arch_type == "ssm" or cfg.hybrid:
        cache["conv"] = _meta((Ln, GB, cfg.ssm.conv_dim - 1, cfg.d_inner), dt)
        cache["ssm"] = _meta((Ln, GB, cfg.d_inner, cfg.ssm.state_dim), dt)
    if cfg.is_encoder_decoder:
        cache["xk"] = _meta((Ln, GB, cfg.num_prefix_tokens,
                             cfg.num_kv_heads, hd), dt)
        cache["xv"] = _meta((Ln, GB, cfg.num_prefix_tokens,
                             cfg.num_kv_heads, hd), dt)
    return {"token": _meta((GB,), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": cache}


# ------------------------------------------------------------------
# sharding plans
# ------------------------------------------------------------------

def train_batch_specs(batch, mesh) -> Dict:
    da = data_axes(mesh)
    return {k: (None, da) + (None,) * (t.dim() - 2) for k, t in batch.items()}


def prefill_batch_specs(batch, mesh) -> Dict:
    return sharding.batch_specs(batch, mesh)


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """(token spec, pos spec, {cache name: spec}): see the module
    docstring."""
    da = data_axes(mesh)
    sizes = mesh_shape(mesh)
    GB, n_data = shape.global_batch, data_size(mesh)
    if GB % n_data == 0 and GB >= n_data:
        b_ax, feat_ax, tok = da, ("model",), (da,)
    else:
        # tiny batch (long_500k): replicate B, spread the cache and
        # state over every axis
        b_ax, feat_ax, tok = None, da + ("model",), ()

    def axsize(ax) -> int:
        if ax is None:
            return 1
        return math.prod(sizes[a] for a in ((ax,) if isinstance(ax, str)
                                            else ax))

    def pick(dim: int, ax):
        """``ax`` if it divides ``dim``, else smaller fallbacks."""
        for cand in (ax, ("model",), None):
            if dim % axsize(cand) == 0:
                return cand
        return None

    C = cache_len_for(cfg, shape)
    cache = {}
    if cfg.arch_type != "ssm":
        cache["k"] = (None, b_ax, pick(C, feat_ax), None, None)
        cache["v"] = (None, b_ax, pick(C, feat_ax), None, None)
    if cfg.arch_type == "ssm" or cfg.hybrid:
        di = cfg.d_inner
        cache["conv"] = (None, b_ax, None, pick(di, feat_ax))
        cache["ssm"] = (None, b_ax, pick(di, feat_ax), None)
    if cfg.is_encoder_decoder:
        # the frame count (1500) rarely divides the mesh: shard head_dim
        hd_ax = ("model" if cfg.resolved_head_dim % sizes.get("model", 1)
                 == 0 else None)
        cache["xk"] = (None, b_ax, None, None, hd_ax)
        cache["xv"] = (None, b_ax, None, None, hd_ax)
    return tok, (), cache


def prefill_cache_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """{"k", "v": spec} of the self-attention cache the encoder-decoder's
    prefill hands to decode, as the decode plan lays it out for a batch
    the data axes divide: B over them, C over "model" (where it divides
    C)."""
    b_ax = data_axes(mesh)
    C = cache_len_for(cfg, shape)
    c_ax = "model" if C % mesh_shape(mesh).get("model", 1) == 0 else None
    spec = (None, b_ax, c_ax, None, None)
    return {"k": spec, "v": spec}


def train_batch_shardings(batch, mesh) -> Dict:
    return sharding.shard_tree(batch, train_batch_specs(batch, mesh), mesh)


def prefill_batch_shardings(batch, mesh) -> Dict:
    return sharding.shard_tree(batch, prefill_batch_specs(batch, mesh), mesh)


def decode_shardings(cfg: ModelConfig, shape: InputShape, mesh, dec: Dict):
    """``decode_inputs``' (token, pos, cache) distributed by
    ``decode_specs``."""
    tok, pos, cache = decode_specs(cfg, shape, mesh)
    return (sharding.distribute(dec["token"], tok, mesh),
            sharding.distribute(dec["pos"], pos, mesh),
            sharding.shard_tree(dec["cache"], cache, mesh))
