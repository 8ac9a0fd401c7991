"""microllama-300m — the paper's own experiment model.  [Wang 2024,
hf:keeeeenw/MicroLlama]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="microllama-300m",
    arch_type="dense",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    citation="hf:keeeeenw/MicroLlama (paper's experiment model)",
)
