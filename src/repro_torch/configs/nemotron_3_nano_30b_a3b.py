"""nemotron-3-nano-30b-a3b [hybrid] — Nemotron-H: 52 single-mixer blocks
(23 Mamba-2, 23 MoE, 6 GQA) from `hybrid_override_pattern`; MoE of 128
relu² experts, top-6 by sigmoid scores plus a correction bias, one wider
shared expert; attention without RoPE.
[huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, config.json]

Registered, but not in `ALL_ARCHS`, which mirrors the JAX package's archs.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, register

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = register(ModelConfig(
    name="nemotron-3-nano-30b-a3b", family="hybrid",
    num_layers=len(PATTERN), d_model=2688, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=1856, vocab_size=131072, layer_pattern=PATTERN,
    use_rope=False,
    mamba=MambaConfig(d_state=128, d_conv=4, n_heads=64, head_dim=64,
                      n_groups=8, chunk=128),
    moe=MoEConfig(num_experts=128, top_k=6, d_ff=1856, num_shared_experts=1,
                  shared_d_ff=3712, router="sigmoid_bias",
                  activation="relu2", routed_scaling=2.5,
                  dispatch="scatter"),
))
