"""Serving entry points of the port.

Two tiers, as in the JAX package:

* ``generate`` — static-batch decode: one prefill, then lockstep
  autoregressive decode for every prompt in the batch, greedy or
  temperature sampling.  ``cache_len`` shorter than prompt + generation
  is an error unless ``ring=True`` opts into ring-buffer semantics: the
  cache keeps only the last ``cache_len`` positions and attention is
  truncated to that sliding window.
* ``scheduler.ContinuousBatcher`` (paged, chunked prefill) and
  ``scheduler.DenseBatcher`` (fixed slots).

Where the port differs from the JAX package, on purpose:

* Prefill runs with ``use_kernels=True``, so on the card attention goes
  through the hand-written flash kernel and the Mamba scan (SSM and
  hybrid models) through the hand-written selective-scan kernel; an
  encoder-decoder's encoder (``models.init_cache``) runs flash too.  The
  JAX serving entry points leave ``use_kernels`` off and run ``sdpa``
  and the sequential scan; both compute the same function.
* Sampling streams.  JAX's ``fold_in`` bits cannot be matched.  Every
  sampled token draws from its own counter-based ``torch.Generator`` on
  the logits' device (Philox on the card), seeded from
  ``(seed, rid, n_generated)`` — ``generate`` uses the batch row as
  ``rid`` — so sampled output does not depend on scheduling, batching
  or preemption.  A draw is Gumbel-max: ``argmax(logits / T - log E)``
  with E ~ Exp(1), a categorical sample.  The same seed gives other
  draws on the card than on the CPU.
* On the card ``generate`` also reports its prefill and decode times,
  read from CUDA events on the stream (no extra synchronisation).

``sample_batched`` is the shared per-lane sampler: greedy where
``temperature == 0``, temperature softmax otherwise, optional top-k.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig


@dataclass
class GenerationResult:
    tokens: List[List[int]]          # per-request generated ids
    steps: int
    # device timeline, CUDA only: prefill up to the first token, then
    # the decode steps up to the last token
    prefill_ms: Optional[float] = None
    decode_ms: Optional[float] = None


def stream(seed: int, rid: int, n: int, device) -> torch.Generator:
    """The generator, on ``device``, of request ``rid``'s ``n``-th
    sampled token."""
    hi, lo = np.random.SeedSequence([seed, rid, n]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(hi) << 32) | int(lo))


def sample_batched(logits, gens: Sequence[Optional[torch.Generator]],
                   temperature: Sequence[float], top_k: Sequence[int]):
    """Per-lane sampling: logits (B, V); ``gens`` one generator per lane
    on logits' device (None for greedy lanes); temperature (B,)
    (0 = greedy); top_k (B,) (0 = no top-k).  Greedy lanes draw nothing,
    so mixed batches stay reproducible lane by lane.  Returns (B,) int64
    on logits' device."""
    greedy = torch.argmax(logits, dim=-1)
    temps = [float(t) for t in temperature]
    if not any(t > 0.0 for t in temps):
        return greedy
    B, V = logits.shape
    dev = logits.device
    noise = torch.ones((B, V), dtype=torch.float32, device=dev)
    for i, t in enumerate(temps):
        if t > 0.0:
            noise[i].exponential_(generator=gens[i])
    x = logits.float()
    tk = torch.as_tensor(list(top_k), dtype=torch.long, device=dev)
    kth = torch.sort(x, dim=-1, descending=True).values.gather(
        1, (torch.clamp(tk, 1, V) - 1)[:, None])
    x = torch.where((tk[:, None] > 0) & (x < kth), -torch.inf, x)
    t = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    sampled = torch.argmax(x / torch.clamp(t, min=1e-6)[:, None]
                           - torch.log(noise), dim=-1)
    return torch.where(t > 0.0, sampled, greedy)


def sample(logits, gens: Sequence[Optional[torch.Generator]],
           temperature: float):
    """All lanes at one temperature, no top-k."""
    B = logits.shape[0]
    return sample_batched(logits, gens, [temperature] * B, [0] * B)


@torch.inference_mode()
def generate(params, cfg: ModelConfig, prompts, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             cache_len: Optional[int] = None, seed: int = 0,
             frames=None, prefix_emb=None,
             ring: bool = False) -> GenerationResult:
    """prompts: (B, S_prompt) ints.  Greedy/temperature batched decode on
    ``params``' device.

    ``frames`` (B, F, d): an encoder-decoder's encoder input; its cache
    runs the encoder once (flash kernel on), then the prompt is
    teacher-forced through decode steps at positions 0 .. S-1.
    ``prefix_emb`` (B, P, d): a VLM's stub patch embeddings, prefilled in
    front of the prompt (positions 0 .. P-1); decoding starts at P + S.

    The decode chain needs ``prefix + prompt + max_new_tokens`` cache
    positions; a smaller ``cache_len`` raises ``ValueError`` unless
    ``ring=True``, which opts into the ring-buffer semantics the cache
    implements (position p lives in slot p % cache_len): attention then
    sees only the most recent ``cache_len`` positions.  On the card
    ``prefill_ms`` covers everything up to the first token: the prefill,
    or the encoder and the teacher-forced prompt."""
    dev = params.device
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    B, S = prompts.shape
    if prefix_emb is not None:
        prefix_emb = torch.as_tensor(prefix_emb, device=dev)
    P = 0 if prefix_emb is None else prefix_emb.shape[1]
    need = P + S + max_new_tokens
    C = cache_len or need
    if C < need and not ring:
        raise ValueError(
            f"cache_len={C} < prefix+prompt+max_new_tokens={need}: the "
            "cache would silently wrap; pass ring=True to opt into "
            f"sliding-window (last {C} positions) attention")
    if cfg.is_encoder_decoder and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: generate "
                         "needs its encoder frames")
    marks = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
             if prompts.is_cuda else [])
    if marks:
        marks[0].record()
    if cfg.is_encoder_decoder:
        cache = models.init_cache(cfg, params, B, C, frames=frames,
                                  use_kernels=True)
        for t in range(S):           # teacher-force the prompt
            logits, cache = models.decode_step(params, cache, prompts[:, t],
                                               t, cfg)
    else:
        logits_all, cache = models.prefill(params, prompts, cfg, C,
                                           prefix_emb=prefix_emb,
                                           use_kernels=True, last_only=True)
        logits = logits_all[:, -1]

    def draw(logits, n):
        gens = ([stream(seed, b, n, dev) for b in range(B)]
                if temperature > 0 else [None] * B)
        return sample(logits, gens, temperature)

    tok = draw(logits, 0)
    if marks:
        marks[1].record()
    out = []
    pos0 = P + S
    for i in range(max_new_tokens):
        out.append(tok)
        if i + 1 == max_new_tokens:      # the last token needs no decode
            break
        logits, cache = models.decode_step(params, cache, tok, pos0 + i, cfg)
        tok = draw(logits, i + 1)
    if marks:
        marks[2].record()
    res = GenerationResult(tokens=torch.stack(out, dim=1).cpu().tolist(),
                           steps=max_new_tokens)
    if marks:
        marks[2].synchronize()
        res.prefill_ms = marks[0].elapsed_time(marks[1])
        res.decode_ms = marks[1].elapsed_time(marks[2])
    return res
