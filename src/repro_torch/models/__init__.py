"""Model API of the port, with the JAX package's dispatch names.

  init_params(cfg, seed, device=None)             -> DecoderLM | EncDecLM
  loss_fn(params, batch, cfg, **kw)               -> (loss, metrics)
  init_cache(cfg, params, batch_size, cache_len, frames=None) -> cache
  decode_step(params, cache, token, pos, cfg)     -> (logits, cache)
  prefill(params, tokens, cfg, cache_len, **kw)   -> (logits, cache)
  init_paged_cache / decode_step_paged / prefill_chunk_paged
  example_batch(cfg, batch, seq)                  -> {"tokens", ...}

Each dispatches on ``cfg.is_encoder_decoder``: ``encdec`` (whisper-small)
or ``lm`` (dense, MoE, SSM, hybrid and VLM decoders).  ``params`` is
the family's module; caches live on its device.  Training passes
``loss_fn`` the flat ``{name: tensor}`` dict of ``lm.param_dict``
instead.  Prefill and the paged entry points are decoder-only: they
raise ``ValueError`` on an encoder-decoder config, as ``decode_step``
does on a lane mask for one (JAX asserts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM


def _family(cfg: ModelConfig):
    return encdec if cfg.is_encoder_decoder else lm


def _decoder_only(cfg: ModelConfig, what: str) -> None:
    if cfg.is_encoder_decoder:
        raise ValueError(f"{what} is for decoder-only models; {cfg.name} "
                         "is an encoder-decoder")


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    return _family(cfg).init_params(cfg, seed, device=device)


def loss_fn(params, batch, cfg: ModelConfig, *, remat=True,
            logit_chunk=None):
    """Next-token cross-entropy (``lm.loss_fn`` or ``encdec.loss_fn``)
    -> (loss, metrics).

    ``params``: the training dict ``{name: tensor}`` (``lm.param_dict``).
    It runs through ``torch.func.functional_call`` on a meta-device
    template, so gradients reach its tensors.  ``remat``: the backward
    recomputes each layer's forward instead of keeping its activations
    (``lm.run_layers``), as the JAX loss does by default.
    ``logit_chunk`` is the decoder-only loss's (the JAX encoder-decoder
    loss takes none)."""
    fam = _family(cfg)
    kw = {"remat": remat}
    if not cfg.is_encoder_decoder:
        kw["logit_chunk"] = logit_chunk
    return torch.func.functional_call(
        fam.template(params, cfg), params, (fam.loss_fn, batch, cfg), kw)


def init_cache(cfg: ModelConfig, params, batch_size: int, cache_len: int,
               *, frames=None, use_kernels: bool = False):
    """The decode cache.  An encoder-decoder needs ``frames`` (B, F, d):
    its cache runs the encoder (``use_kernels``: through the flash
    wrapper) and holds every decoder layer's cross k/v."""
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError("an encoder-decoder cache needs encoder frames")
        return encdec.init_cache(cfg, params, frames, cache_len,
                                 use_kernels=use_kernels)
    return lm.init_cache(cfg, batch_size, cache_len, device=params.device)


def decode_step(params, cache, token, pos, cfg: ModelConfig, *,
                active=None):
    if cfg.is_encoder_decoder:
        if active is not None:
            raise ValueError("lane masking is decoder-only serving")
        return encdec.decode_step(params, cache, token, pos, cfg)
    return lm.decode_step(params, cache, token, pos, cfg, active=active)


def prefill(params: DecoderLM, tokens, cfg: ModelConfig, cache_len: int, *,
            prefix_emb=None, use_kernels: bool = False,
            last_only: bool = False):
    _decoder_only(cfg, "prefill")
    return lm.prefill(params, tokens, cfg, cache_len, prefix_emb=prefix_emb,
                      use_kernels=use_kernels, last_only=last_only)


def init_paged_cache(cfg: ModelConfig, n_lanes: int, num_blocks: int,
                     block_size: int, *, device=None):
    """Block-pool KV cache for paged serving (``cuda`` unless ``device``
    names another)."""
    _decoder_only(cfg, "the paged cache")
    return lm.init_paged_cache(cfg, n_lanes, num_blocks, block_size,
                               device=device)


def decode_step_paged(params: DecoderLM, cache, token, pos, cfg: ModelConfig,
                      tables, active, *, block_size: int):
    _decoder_only(cfg, "paged decode")
    return lm.decode_step_paged(params, cache, token, pos, cfg, tables,
                                active, block_size=block_size)


def prefill_chunk_paged(params: DecoderLM, cache, tokens, pos0,
                        cfg: ModelConfig, table_row, lane: int, *,
                        block_size: int):
    _decoder_only(cfg, "paged prefill")
    return lm.prefill_chunk_paged(params, cache, tokens, pos0, cfg,
                                  table_row, lane, block_size=block_size)


def example_batch(cfg: ModelConfig, batch: int, seq: int, *, device=None):
    """A small deterministic batch, drawn from ``np.random.default_rng(0)``
    in the JAX package's order (tokens, then the encoder frames or the
    VLM prefix), so both packages give the same values.  On ``cuda``
    unless ``device`` names another."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    out = {"tokens": torch.from_numpy(tokens).to(dev)}
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        emb = rng.standard_normal((batch, cfg.num_prefix_tokens,
                                   cfg.d_model))
        out["frames" if cfg.is_encoder_decoder else "prefix_emb"] = (
            torch.from_numpy(emb).to(device=dev, dtype=lm._dtype(cfg)))
    return out


__all__ = ["DecoderLM", "EncDecLM", "init_params", "loss_fn", "init_cache",
           "decode_step", "prefill", "init_paged_cache", "decode_step_paged",
           "prefill_chunk_paged", "example_batch", "lm", "encdec"]
