"""Shared neural building blocks: norms, rotary embeddings, initializers.

Counterpart of ``repro.models.common``. ``softmax_cross_entropy`` comes with
the training path (ROADMAP queue 1 item 17).
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, in fp32 inside, with a ``(1 + scale)``
    gain; returns x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the head dim (Qwen3-style qk-norm).

    x: (..., heads, head_dim); scale: (head_dim,).
    """
    return rms_norm(x, scale, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python-float base: a 0-d tensor made on the card would be a blocking
    # host-to-device copy on every call
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding, half-split: the first and second halves of
    the head dim are the rotated pairs (not interleaved lanes).

    x: (B, S, heads, head_dim); positions: (B, S) int32.
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _truncated_normal(generator, shape, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, shape: tuple[int, ...], dtype,
               device, fan_in: int | None = None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], scaled by 1/sqrt(fan_in)
    (fan_in = shape[0] by default); drawn in fp32, returned in ``dtype``."""
    fi = fan_in if fan_in is not None else shape[0]
    t = _truncated_normal(generator, shape, device)
    return t.mul_(fi ** -0.5).to(dtype)


def embed_init(generator: torch.Generator, shape: tuple[int, ...], dtype,
               device) -> torch.Tensor:
    return _truncated_normal(generator, shape, device).to(dtype)
