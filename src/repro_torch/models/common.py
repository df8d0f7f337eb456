"""Shared neural building blocks: norms, rotary embeddings, initializers.

Counterpart of ``repro.models.common``.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

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


class Leaf(NamedTuple):
    """A parameter's shape and initializer, as the reference's ``*_init``
    draws it: ``"dense"`` (``dense_init`` with ``fan_in``), ``"embed"``
    (``embed_init``), ``"zeros"``, or ``"fill"``: constant runs along the
    last axis, ``fill`` = ((count, value), ...) (the SSM biases)."""

    shape: tuple
    init: str = "zeros"
    fan_in: int = 0
    fill: tuple = ()


def dense_leaf(shape: tuple, fan_in: int | None = None) -> Leaf:
    return Leaf(tuple(shape), "dense", fan_in or shape[0])


def new_leaf(generator: torch.Generator | None, leaf: Leaf, dtype,
             device) -> torch.Tensor:
    """``leaf`` as a tensor in ``dtype``, drawn by ``draw_``;
    ``generator=None`` leaves a drawn leaf uninitialised, for loading."""
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "fill":
        row = torch.cat([torch.full((n,), v, dtype=dtype, device=device)
                         for n, v in leaf.fill])
        return row.expand(leaf.shape).clone()
    out = torch.empty(leaf.shape, dtype=dtype, device=device)
    if generator is not None:
        draw_(generator, out, leaf)
    return out


def draw_(generator: torch.Generator, out: torch.Tensor, leaf: Leaf) -> None:
    """Fill ``out`` (``leaf``'s shape, or one group's slice of a stack) from
    ``leaf``'s initializer, one matrix at a time (the trailing two axes: one
    expert), so the fp32 draw never exceeds one matrix; it is rounded into
    ``out`` in place, without a second temporary in ``out``'s dtype. A
    constant leaf is set when it is made (``new_leaf``)."""
    if leaf.init in ("zeros", "fill"):
        return
    shape = out.shape[-2:]
    for idx in itertools.product(*map(range, out.shape[:-2])):
        if leaf.init == "embed":
            t = embed_init(generator, shape, torch.float32, out.device)
        else:
            t = dense_init(generator, shape, torch.float32, out.device,
                           fan_in=leaf.fan_in)
        out[idx].copy_(t)


def init_tree(generator, leaves: dict, dtype, device) -> dict:
    """A nested dict of new tensors from a nested dict of ``Leaf``s."""
    return {name: (init_tree(generator, sub, dtype, device)
                   if isinstance(sub, dict)
                   else new_leaf(generator, sub, dtype, device))
            for name, sub in leaves.items()}


def flatten(tree: dict, prefix: str = "", *, sort: bool = True) -> dict:
    """A nested dict -> {dotted name: leaf} in the reference's flatten
    order (sorted keys at every level; integer keys, a group's list of
    layers, in numeric order), or with ``sort=False`` in the dicts' own
    order."""
    out = {}
    keys = sorted(tree, key=lambda k: (isinstance(k, int), k)) if sort \
        else tree
    for key in keys:
        sub, name = tree[key], f"{prefix}{key}"
        if isinstance(sub, dict):
            out.update(flatten(sub, name + ".", sort=sort))
        else:
            out[name] = sub
    return out


def nest(flat: dict) -> dict:
    """{dotted name: leaf} -> a nested dict; a numeric segment is an int
    key (``"dense.0.ln1"`` -> ``tree["dense"][0]["ln1"]``)."""
    tree: dict = {}
    for name, leaf in flat.items():
        keys = [int(k) if k.isdigit() else k for k in name.split(".")]
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy. logits (B, S, V), cast to fp32; labels
    (B, S) int; ``mask`` (B, S) weights the positions, with
    ``max(sum(mask), 1)`` in the denominator."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
