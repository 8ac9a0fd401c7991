"""Operations and bytes the metrics divide by, and the card's peaks.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit):
989 TFLOP/s in bfloat16 on the tensor cores, 3.35 TB/s of HBM3.

``dense_forward_flops(m, S)``: the model FLOPs of one forward pass of
one sequence of S tokens through a dense decoder.  Every product counts
2 FLOPs per multiply-add:

- per layer, the projections: q (d x H hd), k and v (d x Hk hd each),
  o (H hd x d): 2 S (d H hd + 2 d Hk hd + H hd d);
- per layer, the SwiGLU MLP: gate, up (d x d_ff) and down (d_ff x d):
  2 S 3 d d_ff;
- per layer, causal attention at S^2/2: q k^T and P v each take
  S^2/2 x hd multiply-adds per head, 2 S^2 H hd FLOPs for both;
- the output head d x V for each of the S positions: 2 S d V.

The embedding lookup, norms, rotary, softmax and the loss are not
products and are not counted.  ``train_flops`` is forward plus backward,
3 x forward (the backward takes two products per forward product), per
sequence trained; the per-sample probe's gradients count once per probe
row.  Remat's recompute, the second sweep of a chunked probe and the
optimizer are not model FLOPs and are not counted.

``gradstats_bytes(probe, D)``: the bytes the two gradstats kernels
must move for one per-sample probe ``[B, rows, chunks]`` over D f32
gradient columns, each input byte read once per sweep and each output
written once.  One pass (chunks 1): colsum reads B D 4 and writes the
mean D 4; moments reads B D 4 and the mean D 4 and writes s, d (B 4
each) and n2 (4).  In row chunks each chunk of r rows: colsum reads
r D 4 (and the accumulator D 4 after the first chunk) and writes D 4;
moments reads r D 4 and the mean D 4 and writes 2 r 4 + 4.
"""
from __future__ import annotations

from typing import Sequence

from bench.weights import Dense

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def dense_forward_flops(m: Dense, S: int) -> float:
    d, H, Hk, hd = m.d_model, m.num_heads, m.num_kv_heads, m.hd
    proj = 2 * S * (d * H * hd + 2 * d * Hk * hd + H * hd * d)
    mlp = 2 * S * 3 * d * m.d_ff
    attn = 2 * S * S * H * hd
    head = 2 * S * d * m.vocab_size
    return float(m.num_layers * (proj + mlp + attn) + head)


def train_flops(m: Dense, S: int, sequences: int) -> float:
    """Forward and backward of ``sequences`` sequences of S tokens."""
    return 3.0 * dense_forward_flops(m, S) * sequences


def gradstats_bytes(probe: Sequence[int], D: int) -> float:
    B, rows, chunks = probe
    if chunks == 1:
        return float(4 * (B * D + D) + 4 * (B * D + D + 2 * B + 1))
    total = 0
    for c in range(chunks):
        r = min(rows, B - c * rows)
        total += 4 * (r * D + (D if c else 0) + D)      # colsum
        total += 4 * (r * D + D + 2 * r + 1)            # moments
    return float(total)
