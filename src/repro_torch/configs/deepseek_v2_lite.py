"""deepseek-v2-lite [moe] — MLA, 1 dense layer, then 2 shared + 64 routed
top-6 experts (softmax, top-k weights not renormalised).  A record of the
port alone (``configs.PORT_ARCHS``).
[hf:deepseek-ai/DeepSeek-V2-Lite, arXiv:2405.04434]"""
from repro_torch.configs.base import DeepseekV2Config, MoEConfig

CONFIG = DeepseekV2Config(
    name="deepseek-v2-lite",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                     # per fine-grained expert
    vocab_size=102_400,
    rope_theta=10_000.0,
    rms_eps=1e-6,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=10_944,
    norm_topk=False,
    citation="hf:deepseek-ai/DeepSeek-V2-Lite (arXiv:2405.04434)",
)
