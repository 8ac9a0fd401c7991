"""gemma3-4b [dense] — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    vocab_size=262_144,
    sliding_window=1024,
    global_every=6,        # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt (gemma-3 family, 4B config)",
)
