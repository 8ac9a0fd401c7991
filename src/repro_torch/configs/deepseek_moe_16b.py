"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained.
[arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                     # per fine-grained expert
    vocab_size=102_400,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    citation="arXiv:2401.06066 (DeepSeekMoE 16B)",
)
