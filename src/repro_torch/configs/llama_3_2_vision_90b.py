"""llama-3.2-vision-90b [vlm] — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=128256,
    cross_attn_every=5, num_image_tokens=1601,  # 1 tile of 560px @ 14px
    rope_theta=5e5,
))
