"""Seeded weights of a dense decoder, made on the device by the benchmark.

The benchmark makes the weights itself and hands the same tensors to
the program and to the reference.  ``leaf_specs`` lists the leaves of
the training dict the port's ``models.loss_fn`` takes, in its order
and under its names (``layers.<i>.attn.q`` ...); ``make_weights`` draws
them from one ``torch.Generator`` on the device in a few large calls:
one ``randn`` into a flat buffer of the model's dtype whose segments are
grouped by scale, one in-place scale per group, one fill of the norms'
zeros.  The leaves are views of that buffer.  Distributions are the
port's: normal with std 1/sqrt(fan_in), the embedding 0.02, norm
weights 0 (the norms scale by 1 + w).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Dense:
    """The sizes of a dense decoder (a configuration file's ``model``)."""
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, model: dict) -> "Dense":
        if model.get("arch_type", "dense") != "dense":
            raise ValueError(f"not a dense decoder: {model.get('arch_type')}")
        if model.get("tie_embeddings", False):
            raise ValueError("tied embeddings are not drawn here")
        keys = cls.__dataclass_fields__
        return cls(**{k: v for k, v in model.items() if k in keys})

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def param_count(self) -> int:
        return sum(math.prod(s) for _, s, _ in leaf_specs(self))


Spec = Tuple[str, Tuple[int, ...], Optional[float]]


def leaf_specs(m: Dense) -> List[Spec]:
    """(name, shape, std) of every leaf in the training dict's order
    (``DecoderLM.named_parameters()``: the model's own leaves, then each
    layer's, its attention's last and in sorted order); std None for a
    norm weight (zeros)."""
    d, q, kv = m.d_model, m.num_heads * m.hd, m.num_kv_heads * m.hd
    specs: List[Spec] = [("embed", (m.vocab_size, d), 0.02),
                         ("final_norm", (d,), None),
                         ("lm_head", (d, m.vocab_size), d ** -0.5)]
    for i in range(m.num_layers):
        p = f"layers.{i}."
        specs += [(p + "attn_norm", (d,), None),
                  (p + "mlp_norm", (d,), None),
                  (p + "gate", (d, m.d_ff), d ** -0.5),
                  (p + "up", (d, m.d_ff), d ** -0.5),
                  (p + "down", (m.d_ff, d), m.d_ff ** -0.5),
                  (p + "attn.k", (d, kv), d ** -0.5),
                  (p + "attn.o", (q, d), q ** -0.5),
                  (p + "attn.q", (d, q), d ** -0.5),
                  (p + "attn.v", (d, kv), d ** -0.5)]
    return specs


def make_weights(m: Dense, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves of ``leaf_specs(m)`` as views of one flat buffer in
    ``m.dtype`` on ``device``, drawn from ``seed``."""
    specs = leaf_specs(m)
    # segments grouped by std (zeros last), so each group is one range
    order = sorted(range(len(specs)),
                   key=lambda i: (specs[i][2] is None, -(specs[i][2] or 0)))
    offsets, total = {}, 0
    for i in order:
        offsets[i] = total
        total += math.prod(specs[i][1])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=m.torch_dtype)
    lo = 0
    while lo < len(order):
        std = specs[order[lo]][2]
        hi = lo
        while hi < len(order) and specs[order[hi]][2] == std:
            hi += 1
        a = offsets[order[lo]]
        b = offsets[order[hi - 1]] + math.prod(specs[order[hi - 1]][1])
        if std is None:
            flat[a:b].zero_()
        else:
            flat[a:b].mul_(std)
        lo = hi
    return {name: flat[offsets[i]:offsets[i] + math.prod(shape)].view(shape)
            for i, (name, shape, _) in enumerate(specs)}
