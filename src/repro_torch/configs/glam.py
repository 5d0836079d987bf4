"""GLaM-style dense configs (paper Table 2 reproduction, §5.3).

The paper trains dense models sized per GLaM [14]: 1B/4B/17B/39B params.
Used by benchmarks/bench_table2.py to measure coordinator-side resources.
"""
from repro_torch.configs.base import ModelConfig, register

GLAM_SIZES = {
    "glam-1b":  dict(num_layers=16, d_model=2048, num_heads=16, d_ff=8192),
    "glam-4b":  dict(num_layers=24, d_model=3072, num_heads=24, d_ff=12288),
    "glam-17b": dict(num_layers=36, d_model=6144, num_heads=48, d_ff=24576),
    "glam-39b": dict(num_layers=48, d_model=8192, num_heads=64, d_ff=32768),
}

for _name, _kw in GLAM_SIZES.items():
    register(ModelConfig(
        name=_name, family="dense", vocab_size=32000,
        num_kv_heads=_kw["num_heads"], head_dim=128, **_kw))
