"""Model FLOPs of a DeepSeek-V2 training window (``mla_moe_train_mfu``).

``dense_part_flops(m, S)``: one forward pass of one sequence of S tokens
through the decoder ``m`` (``bench.reference.moe_weights.LatentMoE``)
outside the routed experts.  Every product counts 2 FLOPs per
multiply-add:

- per layer, MLA's projections: q (d x H (nope + rope)), kv_a (d x
  (rank + rope)), kv_b (rank x H (nope + v)) and o (H v x d);
- per layer, causal attention at S^2/2 scores per head: q k^T at nope +
  rope wide and P v at v wide, S^2 H (nope + rope + v) FLOPs for both;
- per dense layer, the SwiGLU MLP: 2 S 3 d dense_d_ff;
- per MoE layer, the router (d x E) and the shared experts: 2 S d E +
  2 S 3 d d_expert n_shared;
- the output head d x V: 2 S d V.

The routed experts' products count per kept assignment to an expert held
here, ``layers.moe_counts()['kept']`` over the window:
``expert_flops_per_assignment(m)`` = 2 x 3 d d_expert.  Norms, rotary,
softmax, the dispatch's gathers and the loss are not products and are
not counted.  ``train_flops`` is forward plus backward, 3 x forward, as
``bench.flops.train_flops``; remat's recompute is not counted.
"""
from __future__ import annotations

from bench.reference.moe_weights import LatentMoE


def dense_part_flops(m: LatentMoE, S: int) -> float:
    d, H, r = m.d_model, m.num_heads, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    proj = 2 * S * (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv)
                    + H * dv * d)
    attn = S * S * H * (dn + dr + dv)
    n_dense = min(m.first_k_dense, m.num_layers)
    dense = 2 * S * 3 * d * m.dense_d_ff
    moe = 2 * S * d * m.num_experts + 2 * S * 3 * d * m.d_expert * m.num_shared
    head = 2 * S * d * m.vocab_size
    return float(m.num_layers * (proj + attn) + n_dense * dense
                 + (m.num_layers - n_dense) * moe + head)


def expert_flops_per_assignment(m: LatentMoE) -> float:
    return float(2 * 3 * m.d_model * m.d_expert)


def train_flops(m: LatentMoE, S: int, sequences: int, kept: int) -> float:
    """Forward and backward of ``sequences`` sequences of S tokens whose
    forward passes kept ``kept`` assignments to held experts."""
    return 3.0 * (dense_part_flops(m, S) * sequences
                  + expert_flops_per_assignment(m) * kept)
