"""Reference models for end-to-end CPU-runnable examples (examples/)."""
from repro_torch.configs.base import ModelConfig, register

# ~134M params — deliverable (b)'s "~100M model" end-to-end train target
register(ModelConfig(
    name="lovelock-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
    head_dim=64, d_ff=2048, vocab_size=32000))

# ~20M — fast CPU loss-curve runs in CI-sized time budgets
register(ModelConfig(
    name="lovelock-20m", family="dense",
    num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
    head_dim=64, d_ff=1024, vocab_size=8192))
