"""Model API of the port, with the JAX package's dispatch names.

  init_params(cfg, seed, device=None)             -> DecoderLM
  loss_fn(params, batch, cfg, **kw)               -> (loss, metrics)
  init_cache(cfg, params, batch_size, cache_len)  -> cache
  decode_step(params, cache, token, pos, cfg)     -> (logits, cache)
  prefill(params, tokens, cfg, cache_len, **kw)   -> (logits, cache)
  init_paged_cache / decode_step_paged / prefill_chunk_paged

``params`` is a ``lm.DecoderLM``; caches live on its device.  Training
passes ``loss_fn`` the flat ``{name: tensor}`` dict of ``lm.param_dict``
instead.  Dense, MoE (deepseek-moe-16b, grok-1-314b), SSM
(falcon-mamba-7b) and hybrid (hymba-1.5b) decoders; VLM/audio prefixes
and encoder-decoder models raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.lm import DecoderLM


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> DecoderLM:
    return lm.init_params(cfg, seed, device=device)


def loss_fn(params, batch, cfg: ModelConfig, *, logit_chunk=None):
    """Next-token cross-entropy (``lm.loss_fn``) -> (loss, metrics).

    ``params``: the training dict ``{name: tensor}`` (``lm.param_dict``).
    It runs through ``torch.func.functional_call`` on a meta-device
    template, so gradients reach its tensors."""
    return torch.func.functional_call(
        lm.template(params, cfg), params, (lm.loss_fn, batch, cfg),
        {"logit_chunk": logit_chunk})


def init_cache(cfg: ModelConfig, params: DecoderLM, batch_size: int,
               cache_len: int):
    return lm.init_cache(cfg, batch_size, cache_len, device=params.device)


def decode_step(params: DecoderLM, cache, token, pos, cfg: ModelConfig, *,
                active=None):
    return lm.decode_step(params, cache, token, pos, cfg, active=active)


def prefill(params: DecoderLM, tokens, cfg: ModelConfig, cache_len: int, *,
            use_kernels: bool = False, last_only: bool = False):
    return lm.prefill(params, tokens, cfg, cache_len,
                      use_kernels=use_kernels, last_only=last_only)


def init_paged_cache(cfg: ModelConfig, n_lanes: int, num_blocks: int,
                     block_size: int, *, device=None):
    """Block-pool KV cache for paged serving (``cuda`` unless ``device``
    names another)."""
    return lm.init_paged_cache(cfg, n_lanes, num_blocks, block_size,
                               device=device)


def decode_step_paged(params: DecoderLM, cache, token, pos, cfg: ModelConfig,
                      tables, active, *, block_size: int):
    return lm.decode_step_paged(params, cache, token, pos, cfg, tables,
                                active, block_size=block_size)


def prefill_chunk_paged(params: DecoderLM, cache, tokens, pos0,
                        cfg: ModelConfig, table_row, lane: int, *,
                        block_size: int):
    return lm.prefill_chunk_paged(params, cache, tokens, pos0, cfg,
                                  table_row, lane, block_size=block_size)


__all__ = ["DecoderLM", "init_params", "loss_fn", "init_cache",
           "decode_step", "prefill", "init_paged_cache", "decode_step_paged",
           "prefill_chunk_paged", "lm"]
