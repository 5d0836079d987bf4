"""kimi-k2-1t-a32b [moe] — trillion-param MoE 384e top-8.
[arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112, d_ff=2048, vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048, num_shared_experts=1),
    rope_theta=5e4,
))
