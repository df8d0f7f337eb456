"""Learning-rate schedules: pure functions of the step counter (an int or
a device tensor), returning a 0-d fp32 tensor (counterpart of
``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup: int, peak: float) -> torch.Tensor:
    s = _step(step)
    return peak * torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)


def cosine_schedule(step, warmup: int, total: int, peak: float,
                    floor: float = 0.0) -> torch.Tensor:
    s = _step(step)
    warm = linear_warmup(step, warmup, peak)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, cos)
