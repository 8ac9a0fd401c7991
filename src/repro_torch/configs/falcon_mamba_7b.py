"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free.  [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    citation="arXiv:2410.05355 (Falcon Mamba 7B)",
)
