"""Gossip mixing operators on stacked node state: v_k <- sum_l W_kl v_l
(Algorithm 1, step 4), over the fp32 wire.

``mix_power`` applies B gossip steps (App. E.2) by folding W first:
B-1 (K, K) products and one (K, d) mix, O(B K^3 + K^2 d) instead of the
sequential O(B K^2 d).
"""
from __future__ import annotations

import torch


def dense_mix(w: torch.Tensor, v_stack: torch.Tensor) -> torch.Tensor:
    """v'_k = sum_l W_kl v_l for stacked node state.

    Args:
      w: (K, K) mixing matrix.
      v_stack: (K, ...) per-node state stacked on axis 0.
    """
    flat = v_stack.reshape(v_stack.shape[0], -1)
    return (w.to(flat.dtype) @ flat).reshape(v_stack.shape)


def mix_power(w: torch.Tensor, v_stack: torch.Tensor, steps: int) -> torch.Tensor:
    """Apply B consecutive gossip steps, (W^B) v."""
    if steps <= 0:
        return v_stack
    w_pow = w
    for _ in range(steps - 1):
        w_pow = w @ w_pow
    return dense_mix(w_pow, v_stack)


def mix_power_wire(w: torch.Tensor, v_send: torch.Tensor,
                   v_self: torch.Tensor | None, steps: int) -> torch.Tensor:
    """B gossip steps where the FIRST step mixes on-the-wire payloads.

    ``v_send`` is what each node emitted; ``v_self`` is the stacked honest
    state, or None when nothing was corrupted (then exactly ``mix_power``).
    A node's own contribution W_kk v_k uses its honest state, so the first
    step is ``W v_send + diag(W) (v_self - v_send)``."""
    if v_self is None or steps <= 0:
        return mix_power(w, v_send, steps)
    first = dense_mix(w, v_send)
    diag = torch.diagonal(w).to(first.dtype)
    first = first + diag[:, None] * (v_self - v_send)
    return mix_power(w, first, steps - 1)
