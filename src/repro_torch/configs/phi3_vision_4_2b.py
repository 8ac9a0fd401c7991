"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct]

The vision encoder + projector is a STUB per assignment: input_specs()
provides precomputed patch embeddings (batch, 576, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    frontend="vision",
    num_prefix_tokens=576,   # 24x24 CLIP-L/14 patch grid at 336px
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)
