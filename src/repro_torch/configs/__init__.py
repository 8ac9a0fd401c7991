"""Architecture registry.  ``get_config("qwen3-0.6b")`` or ``--arch`` ids."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    INPUT_SHAPES,
    AdLoCoConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

from repro_torch.configs import (  # noqa: E402
    qwen3_0_6b,
    phi3_medium_14b,
    deepseek_moe_16b,
    stablelm_1_6b,
    hymba_1_5b,
    grok_1_314b,
    gemma3_4b,
    phi3_vision_4_2b,
    whisper_small,
    falcon_mamba_7b,
    microllama_300m,
)

ARCH_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_0_6b,
        phi3_medium_14b,
        deepseek_moe_16b,
        stablelm_1_6b,
        hymba_1_5b,
        grok_1_314b,
        gemma3_4b,
        phi3_vision_4_2b,
        whisper_small,
        falcon_mamba_7b,
        microllama_300m,
    )
}

# The ten assigned architectures (microllama is the paper's own extra).
ASSIGNED_ARCHS = [
    "qwen3-0.6b",
    "phi3-medium-14b",
    "deepseek-moe-16b",
    "stablelm-1.6b",
    "hymba-1.5b",
    "grok-1-314b",
    "gemma3-4b",
    "phi-3-vision-4.2b",
    "whisper-small",
    "falcon-mamba-7b",
]

# Archs allowed to lower the long_500k decode shape (sub-quadratic path:
# SSM / hybrid / sliding-window).  Skips are documented in DESIGN.md §5.
LONG_CONTEXT_ARCHS = {"gemma3-4b", "hymba-1.5b", "falcon-mamba-7b"}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCH_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}"
        ) from None


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, small vocab.  Used by per-arch CPU smoke tests."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    # keep the GQA ratio representative when possible
    if cfg.num_kv_heads < cfg.num_heads:
        kv = max(1, heads // 2)
    head_dim = 64 if cfg.head_dim is not None else None
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            d_expert=128,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_dim=8, conv_dim=4, expand=2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2,
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=0 if cfg.arch_type == "ssm" else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 16),
        moe=moe,
        ssm=ssm,
        dtype="float32",
    )


__all__ = [
    "ARCH_REGISTRY",
    "ASSIGNED_ARCHS",
    "LONG_CONTEXT_ARCHS",
    "INPUT_SHAPES",
    "AdLoCoConfig",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "reduced",
]
