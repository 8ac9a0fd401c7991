"""Seeded weights of a DeepSeek-V2 decoder, made on the device by the
benchmark, and its sizes as a configuration file states them.

``LatentMoE.of(config)`` reads the file's keys (those of the model's
published ``config.json``, plus the experts held here); ``leaf_specs``
lists the leaves of the training dict the port's ``models.loss_fn``
takes, in its order and under its names (``layers.<i>.attn.q``,
``layers.<i>.moe.gate`` ...); ``make_weights`` draws them from one
``torch.Generator`` on the device: one ``randn`` into a flat buffer of
the model's dtype for every leaf but the router, one into a float32
buffer for the routers (the port keeps them in float32), then one scale
per group of equal std and one fill of the norms' zeros.  The leaves
are views of the buffers.  Distributions are the port's: normal with
std 1/sqrt(fan_in), the embedding 0.02, norm weights 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the configuration's settings the model supports, and their values
FIXED = {"model_type": "deepseek_v2", "hidden_act": "silu",
         "attention_bias": False, "q_lora_rank": None,
         "scoring_func": "softmax", "topk_method": "greedy",
         "routed_scaling_factor": 1, "moe_layer_freq": 1, "n_group": 1,
         "topk_group": 1, "tie_word_embeddings": False, "seq_aux": False}


def plain_rope(c: dict) -> bool:
    """Whether the file's ``rope_scaling`` leaves RoPE plain: none, or
    YaRN at factor 1, whose frequencies are RoPE's and whose mscale terms
    (and so the softmax scale's) are 1."""
    rs = c.get("rope_scaling")
    return rs is None or (rs.get("type") == "yarn" and rs.get("factor") == 1)


@dataclass(frozen=True)
class LatentMoE:
    """The sizes of a DeepSeek-V2 decoder: MLA attention, the first
    ``first_k_dense`` layers a SwiGLU MLP of ``dense_d_ff``, the others
    MoE layers of ``num_experts`` routed experts (``held`` of them held
    here) and ``num_shared`` shared ones, all of width ``d_expert``."""
    num_layers: int
    d_model: int
    num_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense: int
    dense_d_ff: int
    num_experts: int
    top_k: int
    num_shared: int
    d_expert: int
    experts_held: int
    norm_topk: bool
    aux_coef: float
    vocab_size: int
    rope_theta: float
    rms_eps: float
    dtype: str = "bfloat16"
    capacity_factor: float = 1.25

    @classmethod
    def of(cls, c: dict) -> "LatentMoE":
        """From a configuration file; raises ``ValueError`` on a setting
        the model does not run (``FIXED``)."""
        bad = {k: c.get(k) for k, v in FIXED.items() if c.get(k) != v}
        if not plain_rope(c):
            bad["rope_scaling"] = c.get("rope_scaling")
        if bad:
            raise ValueError(f"{c.get('name')}: settings not supported: {bad}")
        return cls(
            num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            num_heads=c["num_attention_heads"],
            kv_lora_rank=c["kv_lora_rank"],
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"],
            first_k_dense=c["first_k_dense_replace"],
            dense_d_ff=c["intermediate_size"],
            num_experts=c["n_routed_experts"],
            top_k=c["num_experts_per_tok"],
            num_shared=c["n_shared_experts"],
            d_expert=c["moe_intermediate_size"],
            experts_held=c["experts_held"],
            norm_topk=c["norm_topk_prob"], aux_coef=c["aux_loss_alpha"],
            vocab_size=c["vocab_size"], rope_theta=float(c["rope_theta"]),
            rms_eps=c["rms_norm_eps"], dtype=c["dtype"])

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held(self) -> range:
        """The experts held here: the first ``experts_held`` ids."""
        return range(self.experts_held)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def is_dense(self, i: int) -> bool:
        return i < self.first_k_dense

    def param_count(self) -> int:
        return sum(math.prod(s) for _, s, _, _ in leaf_specs(self))


# (name, shape, std or None for a norm's zeros, float32 leaf)
Spec = Tuple[str, Tuple[int, ...], Optional[float], bool]


def leaf_specs(m: LatentMoE) -> List[Spec]:
    """Every leaf in the training dict's order (``DecoderLM.
    named_parameters()``: the model's own leaves, then each layer's:
    its norms and a dense layer's MLP, then attention's and the MoE
    group's leaves in sorted order)."""
    d, H, r = m.d_model, m.num_heads, m.kv_lora_rank
    dr, de, Eh = m.qk_rope_head_dim, m.d_expert, m.experts_held
    qk, kvb = H * m.qk_head_dim, H * (m.qk_nope_head_dim + m.v_head_dim)
    specs: List[Spec] = [("embed", (m.vocab_size, d), 0.02, False),
                         ("final_norm", (d,), None, False),
                         ("lm_head", (d, m.vocab_size), d ** -0.5, False)]
    for i in range(m.num_layers):
        p = f"layers.{i}."
        specs += [(p + "attn_norm", (d,), None, False),
                  (p + "mlp_norm", (d,), None, False)]
        if m.is_dense(i):
            f = m.dense_d_ff
            specs += [(p + "gate", (d, f), d ** -0.5, False),
                      (p + "up", (d, f), d ** -0.5, False),
                      (p + "down", (f, d), f ** -0.5, False)]
        specs += [(p + "attn.kv_a", (d, r + dr), d ** -0.5, False),
                  (p + "attn.kv_b", (r, kvb), r ** -0.5, False),
                  (p + "attn.kv_norm", (r,), None, False),
                  (p + "attn.o", (H * m.v_head_dim, d),
                   (H * m.v_head_dim) ** -0.5, False),
                  (p + "attn.q", (d, qk), d ** -0.5, False)]
        if not m.is_dense(i):
            ns = m.num_shared
            specs += [(p + "moe.down", (Eh, de, d), de ** -0.5, False),
                      (p + "moe.gate", (Eh, d, de), d ** -0.5, False),
                      (p + "moe.router", (d, m.num_experts), d ** -0.5, True),
                      (p + "moe.s_down", (ns, de, d), de ** -0.5, False),
                      (p + "moe.s_gate", (ns, d, de), d ** -0.5, False),
                      (p + "moe.s_up", (ns, d, de), d ** -0.5, False),
                      (p + "moe.up", (Eh, d, de), d ** -0.5, False)]
    return specs


def _fill(specs: List[Spec], gen, device, dtype) -> Dict[str, torch.Tensor]:
    # segments grouped by std (zeros last), so each group is one range
    order = sorted(range(len(specs)),
                   key=lambda i: (specs[i][2] is None, -(specs[i][2] or 0)))
    offsets, total = {}, 0
    for i in order:
        offsets[i] = total
        total += math.prod(specs[i][1])
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
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
    return {specs[i][0]: flat[offsets[i]:offsets[i] + math.prod(
        specs[i][1])].view(specs[i][1]) for i in range(len(specs))}


def make_weights(m: LatentMoE, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves of ``leaf_specs(m)`` in its order on ``device``, drawn
    from ``seed``: the routers in float32, the rest in ``m.dtype``."""
    specs = leaf_specs(m)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    low = _fill([s for s in specs if not s[3]], gen, device, m.torch_dtype)
    f32 = _fill([s for s in specs if s[3]], gen, device, torch.float32)
    return {name: (f32 if is32 else low)[name]
            for name, _, _, is32 in specs}
