"""AdamW and the learning-rate schedule (port of `repro.optim`)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig, TrainState, adamw_init, adamw_update,
)
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
