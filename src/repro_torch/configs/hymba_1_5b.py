"""hymba-1.5b [hybrid] — parallel attn + mamba heads.  [arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    hybrid=True,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    # Hymba uses sliding-window attention in all but a few global layers
    # (arXiv:2411.13676 §2): modeled as a 15:1 local:global pattern.
    sliding_window=1024,
    global_every=16,
    citation="arXiv:2411.13676 (Hymba 1.5B)",
)
