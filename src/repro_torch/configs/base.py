"""Config system: frozen dataclasses describing model architectures and
input shapes.

The PyTorch port keeps its own copy of the JAX package's config records
(``repro/configs``) so that it imports nothing of ``repro``; the two
copies describe the same architectures field for field.

Every assigned architecture gets one module in this package exporting a
``CONFIG: ModelConfig``; the registry in ``__init__`` maps ``--arch`` ids
to them.  Configs are pure data — no framework imports here, so importing a
config never touches device state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int              # routed experts
    top_k: int                    # experts per token
    num_shared: int = 0           # always-on shared experts (DeepSeekMoE)
    d_expert: Optional[int] = None  # per-expert FFN hidden dim (None -> d_ff)
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # "flat": one global dispatch over all T tokens; "grouped": per-batch-
    # row dispatch (Switch-style per-device capacity) — keeps the (E,C,d)
    # dispatch buffer data-sharded.  Right choice is arch-dependent: wins
    # on fine-grained many-expert MoE (deepseek: the flat buffer is 2x the
    # activations and gets all-gathered), loses on few-big-expert MoE
    # (grok: §Perf pair-3 it.2).
    dispatch: str = "flat"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective-state-space configuration."""

    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # None -> ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``arch_type`` is one of: dense | moe | ssm | hybrid | vlm | audio.
    """

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: Optional[int] = None          # None -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # Sliding-window attention (gemma3): window size and "every Nth layer
    # is global" pattern (5 local : 1 global => global_every=6).
    sliding_window: Optional[int] = None
    global_every: Optional[int] = None

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid: parallel attention + SSM heads within each layer (hymba)
    hybrid: bool = False

    # encoder-decoder (whisper): encoder depth; decoder depth = num_layers
    encoder_layers: int = 0
    is_encoder_decoder: bool = False

    # modality frontend STUB: 'vision' | 'audio' | None.  input_specs()
    # provides precomputed embeddings of shape (batch, num_prefix_tokens,
    # d_model) — per assignment, the frontend itself is not implemented.
    frontend: Optional[str] = None
    num_prefix_tokens: int = 0

    dtype: str = "bfloat16"

    # ----- derived ---------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        assert self.ssm is not None
        if self.ssm.dt_rank is not None:
            return self.ssm.dt_rank
        return -(-self.d_model // 16)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (for roofline MODEL_FLOPS = 6*N*D).
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        # embeddings (+ output head unless tied)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.arch_type == "ssm":
            # mamba block only
            per_layer += self._mamba_params()
            per_layer += d  # norm
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qk_norm:
                attn += 2 * hd
            per_layer += attn + d  # + attn norm
            if self.hybrid:
                per_layer += self._mamba_params()
            if self.moe is not None:
                de = self.moe.d_expert or self.d_ff
                routed = self.moe.num_experts * 3 * d * de
                shared = self.moe.num_shared * 3 * d * de
                router = d * self.moe.num_experts
                per_layer += (routed if not active_only else self.moe.top_k * 3 * d * de) + shared + router
            else:
                per_layer += 3 * d * self.d_ff  # SwiGLU: gate, up, down
            per_layer += d  # mlp norm
        n += self.num_layers * per_layer
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, decoder cross-attn
            enc = self.encoder_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            xattn = self.num_layers * (4 * d * d + d)
            n += enc + xattn
        n += d  # final norm
        return n

    def _mamba_params(self) -> int:
        d = self.d_model
        ssm = self.ssm or SSMConfig()
        di = ssm.expand * d
        dtr = self.dt_rank if self.ssm is not None else -(-d // 16)
        n = 0
        n += d * 2 * di                     # in_proj (x and z)
        n += di * ssm.conv_dim              # depthwise conv
        n += di * (dtr + 2 * ssm.state_dim)  # x -> (dt, B, C)
        n += dtr * di                       # dt_proj
        n += di * ssm.state_dim             # A_log
        n += di                             # D
        n += di * d                         # out_proj
        return n


@dataclass(frozen=True)
class DeepseekV2Config(ModelConfig):
    """DeepSeek-V2's decoder (arXiv:2405.04434), a record of the port
    alone (the JAX package has no such architecture, and the shared
    records stay field for field as its own): multi-head latent
    attention (MLA), ``first_k_dense`` leading SwiGLU layers of width
    ``dense_d_ff`` and MoE layers after them.

    MLA per token x, H heads: q = x Wq split per head into a no-rope
    part (``qk_nope_head_dim``) and a rope part (``qk_rope_head_dim``);
    [c ; k_r] = x Wkv_a with c of ``kv_lora_rank``; c = RMSNorm(c);
    [k_nope ; v] = c Wkv_b per head (v of ``v_head_dim``); k = [k_nope ;
    RoPE(k_r) on every head], q = [q_nope ; RoPE(q_rope)]; causal
    softmax of q k^T / sqrt(nope + rope) over v, then Wo.

    ``norm_topk``: renormalise the top-k router weights (False: the raw
    softmax probabilities weight the experts).  ``experts_held``: the
    expert ids whose weights this layer holds (None: all), as one chip
    of an expert-parallel group holds its share: the router keeps all
    ``moe.num_experts`` outputs and its top-k, and the layer adds only
    its held experts' part of the result (``layers.moe_block``)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 0
    dense_d_ff: int = 0
    norm_topk: bool = True
    experts_held: Optional[range] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held(self) -> range:
        return (range(self.moe.num_experts) if self.experts_held is None
                else self.experts_held)

    def mla_params(self) -> int:
        d, H, r = self.d_model, self.num_heads, self.kv_lora_rank
        return (d * H * self.qk_head_dim + d * (r + self.qk_rope_head_dim)
                + r + r * H * (self.qk_nope_head_dim + self.v_head_dim)
                + H * self.v_head_dim * d)

    def param_count(self, active_only: bool = False) -> int:
        """Parameters held here (``active_only``: each token's share, its
        top-k experts in place of the held ones)."""
        d, mc = self.d_model, self.moe
        de = mc.d_expert or self.d_ff
        experts = mc.top_k if active_only else len(self.held)
        moe = (experts + mc.num_shared) * 3 * d * de + d * mc.num_experts
        n_dense = min(self.first_k_dense, self.num_layers)
        layer = self.mla_params() + 2 * d
        return (self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
                + self.num_layers * layer + n_dense * 3 * d * self.dense_d_ff
                + (self.num_layers - n_dense) * moe)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class AdLoCoConfig:
    """Paper Table 1 hyperparameters + switch/merge policy knobs."""

    num_outer_steps: int = 20
    num_inner_steps: int = 200          # H
    lr_inner: float = 2e-5
    lr_outer: float = 0.5
    outer_momentum: float = 0.9         # DiLoCo uses Nesterov outer
    num_init_trainers: int = 4          # k
    nodes_per_gpu: int = 4              # M workers per trainer
    initial_batch_size: int = 1
    merge_frequency: int = 3
    merge_w: int = 1                    # merge w worst trainers
    eta: float = 0.8                    # norm-test η
    theta: float = 0.01                 # inner-product-test ϑ
    nu: float = 0.3                     # augmented-test ν
    max_batch: int = 64                 # b_max per device
    switch_multiplier: int = 2          # n: accumulate when b_req > n*b_max
    batch_test: str = "norm"            # norm | inner_product | augmented
    max_global_batch: int = 4096        # hard cap (safety)
    weight_decay: float = 0.1
    seed: int = 0

    # ablation switches (paper Fig. 2): turning these off yields the
    # "-adaptive", "-merge", "-switch" variants; all three off + k=1
    # recovers vanilla DiLoCo.
    adaptive: bool = True
    enable_merge: bool = True
    enable_switch: bool = True
    stats_probe_size: int = 64          # samples used for batching stats
    # "per_sample": exact vmap-of-grad probe (the paper's estimator).
    # "microbatch": free distributed estimator — variance of the M
    #   workers' microbatch-mean gradients that data parallelism already
    #   materializes (sigma^2 = m * Var(G_j)); zero extra forward/backward
    #   cost, requires M >= 2 (falls back to per_sample otherwise).
    stats_estimator: str = "per_sample"
    # route the (B, D) stats reduction through the fused gradstats
    # kernel instead of its plain version (same numbers to float
    # tolerance)
    stats_use_kernel: bool = False
    inner_optimizer: str = "adamw"
    outer_optimizer: str = "nesterov"
    # staleness-aware delay compensation for delayed (async) outer
    # application: scale the Nesterov momentum contribution by
    # 1/(1 + measured delay in rounds).  Off by default so every
    # synchronous trajectory stays bit-identical; turn on to run
    # outer_momentum=0.9 under the async policy's one-round staleness
    # (underdamped without it — see repro.cluster docs).
    delay_compensation: bool = False
    # merge drift window (rounds): maybe_merge skips trainers whose
    # round counter lags the merge round by more than this instead of
    # stalling the whole merge until the slowest trainer catches up
    merge_drift_window: int = 1
    # PadaDamp-style predicted batch growth (Lau et al., arXiv
    # 2406.13936): run the exact gradient-order stats reduction only
    # every k_correct rounds and, in between, set the requested batch
    # from a fitted exponential growth trajectory — zero collectives on
    # the skipped rounds, with the exact protocol as the periodic
    # correction.  1 (default) = exact every round, the legacy behavior.
    k_correct: int = 1
