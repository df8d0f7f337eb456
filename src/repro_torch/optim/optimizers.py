"""AdamW and SGD with momentum over flat parameter dicts (counterpart of
``repro.optim.optimizers``).

A parameter tree here is a flat dict of tensors
(``transformer.param_paths``: layer leaves stacked). Each optimizer is an
``(init, update)`` pair. Unlike the reference's, ``update`` works IN
PLACE: it writes the new parameters and moments into the tensors it is
given (views write through to the stacks they view) and returns them, so
a step holds one leaf's temporaries at a time instead of a second copy of
the whole state. ``commit`` (a 0-d bool
tensor, or None for always) keeps a leaf's old values where it is False,
with no host sync: a frozen gossip node runs its step and keeps its state.
The arithmetic is the reference's, in fp32, with the step counter a device
tensor (bias correction on the device).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, step, lr, commit=None) -> (params, state),
    # in place
    update: Callable


def leaves(tree: dict) -> list:
    """The tensors of a parameter tree, in order."""
    return list(tree.values())


def _zeros_like(tree: dict, dtype) -> dict:
    return {name: torch.zeros(t.shape, dtype=dtype, device=t.device)
            for name, t in tree.items()}


def _write(dst: torch.Tensor, new: torch.Tensor, commit) -> None:
    new = new.to(dst.dtype)
    dst.copy_(new if commit is None else torch.where(commit, new, dst))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with moments ``m``, ``v`` in ``state_dtype`` (bf16 halves
    their memory; the update itself runs in fp32)."""
    def init(params):
        return {"m": _zeros_like(params, state_dtype),
                "v": _zeros_like(params, state_dtype)}

    def update(grads, state, params, step, lr, commit=None):
        step_f = step.to(torch.float32) + 1.0
        c1 = 1.0 - torch.pow(b1, step_f)
        c2 = 1.0 - torch.pow(b2, step_f)
        with torch.no_grad():
            for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                                  leaves(state["v"]), leaves(params)):
                g32 = g.float()
                m_new = b1 * m.float() + (1 - b1) * g32
                v_new = b2 * v.float() + (1 - b2) * g32 * g32
                delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) \
                    + weight_decay * p.float()
                _write(p, p.float() - lr * delta, commit)
                del delta
                _write(m, m_new, commit)
                _write(v, v_new, commit)
        return params, state

    return Optimizer(init, update)


def sgd_momentum(momentum: float = 0.9) -> Optimizer:
    """SGD with heavy-ball momentum ``mu`` (fp32)."""
    def init(params):
        return {"mu": _zeros_like(params, torch.float32)}

    def update(grads, state, params, step, lr, commit=None):
        with torch.no_grad():
            for g, mu, p in zip(leaves(grads), leaves(state["mu"]),
                                leaves(params)):
                mu_new = momentum * mu + g.float()
                _write(p, p.float() - lr * mu_new, commit)
                _write(mu, mu_new, commit)
        return params, state

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """0-d fp32 L2 norm over every leaf (on the device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, the norm before)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    scaled = {name: g * scale.to(g.dtype) for name, g in grads.items()}
    return scaled, norm
