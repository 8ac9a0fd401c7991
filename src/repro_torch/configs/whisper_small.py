"""whisper-small [audio] — enc-dec, conv frontend (stub).  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a STUB per assignment:
input_specs() provides precomputed frame embeddings (batch, 1500, d_model)
which the 12-layer encoder consumes; the 12-layer decoder cross-attends."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    frontend="audio",
    num_prefix_tokens=1500,   # 30 s audio -> 1500 frames after conv stride 2
    rope_theta=10_000.0,      # (whisper uses learned pos; we use RoPE — noted in DESIGN)
    citation="arXiv:2212.04356 (Whisper, small)",
)
