"""Architecture configs (copied from `repro.configs`, same names), and the
port's own: nemotron-3-nano-30b-a3b, which the JAX package lacks and
`ALL_ARCHS` therefore leaves out.

Importing this package registers all archs."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, MoEConfig, MambaConfig, ShapeConfig,
    get_config, list_configs, register, smoke_variant, supports_shape,
)
from repro_torch.configs import (  # noqa: F401
    qwen3_32b, llama3_405b, deepseek_coder_33b, h2o_danube_1_8b,
    llama4_scout_17b_a16e, kimi_k2_1t_a32b, llama_3_2_vision_90b,
    jamba_v0_1_52b, rwkv6_7b, whisper_large_v3, glam,
    lovelock_ref, nemotron_3_nano_30b_a3b,
)

ALL_ARCHS = [
    "qwen3-32b", "llama3-405b", "deepseek-coder-33b", "h2o-danube-1.8b",
    "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "llama-3.2-vision-90b",
    "jamba-v0.1-52b", "rwkv6-7b", "whisper-large-v3",
]
