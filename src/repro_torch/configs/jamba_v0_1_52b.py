"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    attn_every=8, mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336), moe_every=2,
))
