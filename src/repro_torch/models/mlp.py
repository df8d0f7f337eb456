"""Feed-forward layers: SwiGLU MLP (counterpart of ``repro.models.mlp``).

Mixture-of-Experts is not ported yet (ROADMAP queue 1 item 17, MoE).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense_init

MOE_TODO = ("MoE layers (repro.models.mlp.moe_*) are not ported yet: "
            "ROADMAP queue 1 item 17 (MoE)")


class MLP(nn.Module):
    """SwiGLU: (silu(x W_gate) * (x W_up)) W_down, weights stored (in, out)
    as the reference stores them. ``generator=None`` leaves the weights
    uninitialised (for loading)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        shapes = {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                  "w_down": (d_ff, d_model)}
        for name, shape in shapes.items():
            t = (dense_init(generator, shape, dtype, device)
                 if generator is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def mlp_init(generator, d_model: int, d_ff: int, dtype, device) -> MLP:
    return MLP(d_model, d_ff, dtype, device, generator)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def moe_init(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)


def moe_apply(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)
