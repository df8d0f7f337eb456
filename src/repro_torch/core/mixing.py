"""Gossip mixing operators on stacked node state: v_k <- sum_l W_kl v_l
(Algorithm 1, step 4).

``mix_power`` applies B gossip steps (App. E.2) on the fp32 wire by
folding W first: B-1 (K, K) products and one (K, d) mix, O(B K^3 + K^2 d)
instead of the sequential O(B K^2 d). ``qmix_steps`` runs the B steps
over a quantized wire (``repro_torch.core.quant``), one encode per step.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant


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


def qmix_steps(w: torch.Tensor, v_stack: torch.Tensor, ef, steps: int,
               wire: str, draws=None, payload=None):
    """B gossip steps over a QUANTIZED wire.

    Every step, each node encodes its current value once (EF-compensated
    when ``ef`` is not None; stochastic rounding with the uniforms
    ``draws(step)``, (K, d), or round-to-nearest when ``draws`` is None),
    and the mix runs on the dequantized stack: ``W @ deq``. Every
    contribution goes through the codec, the node's own diagonal term
    included. ``payload``: an optional pre-encoded ``(q, scale)`` for the
    first step (the pipelined driver's double buffer).

    Returns ``(mixed, ef_new)``.
    """
    out = v_stack
    for s in range(steps):
        if s == 0 and payload is not None:
            deq = quant.dequantize(*payload)
        else:
            u = None if draws is None else draws(s)
            _, _, deq, ef = quant.encode(out, wire, u, ef)
        out = dense_mix(w, deq)
    return out, ef
