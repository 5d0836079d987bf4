"""Train and serve steps (port of `repro.train.steps`)."""
from repro_torch.train.steps import (  # noqa: F401
    cross_entropy, make_grad_fn, make_prefill, make_serve_step,
    make_train_step,
)
