"""Optimizers, schedules, gossip data-parallelism and its DP wire
(counterpart of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd_momentum,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_schedule,
    linear_warmup,
)
