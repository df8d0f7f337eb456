"""Transformer blocks of the dense family: the GQA attention block with its
ring-buffer KV cache and the dense decoder layer (counterpart of
``repro.models.blocks``).

Every block shares the signature
    apply(cfg, params, x, positions, cache, ctx) -> (y, new_cache, aux)
where ``cache=None`` selects the cache-free path (full-sequence forward)
and ``positions`` are absolute token positions (B, S) int32. Parameters are
``nn.Module``s whose tensors carry the reference's names and layouts.

Not ported yet (ROADMAP queue 1 item 17): MoE layers and groups, xLSTM
pairs, the Zamba2 hybrid group, encoder and cross-attention layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (apply_rope, dense_init, head_rms_norm,
                                       rms_norm)
from repro_torch.models.mlp import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Runtime context, kept for signature parity with the reference. Its
    fields serve expert parallelism and activation sharding, which the
    dense single-card path does not use."""

    mesh: Any = None
    model_axis: str | None = None
    moe_mode: str = "scatter"
    act_spec: Any = None
    dispatch_groups: int = 0


DEFAULT_CTX = ModelCtx()


def _attn_mode(cfg: ModelConfig) -> str:
    return {"full": "causal", "sliding": "sliding",
            "chunked_local": "chunked_local"}[cfg.attention]


def _attention(cfg: ModelConfig, q, k, v, q_pos, kv_pos, *, mode: str,
               **fresh):
    """Attention dispatch. A CUDA tensor goes to the Hopper flash kernels
    and a CPU tensor to their plain version, whatever ``cfg.attn_backend``
    says: in the reference that field picks between two implementations of
    the same function (the jnp scan and the Pallas kernel); the port has
    one. ``fresh`` may pass a second K/V source (``k2, v2, kv_pos2``)."""
    return flash_attention(q, k, v, q_pos, kv_pos, mode=mode,
                           window=cfg.window,
                           compute_dtype=cfg.attn_compute_dtype, **fresh)


def _param(generator, shape, dtype, device, *, zeros: bool = False):
    if zeros:
        t = torch.zeros(shape, dtype=dtype, device=device)
    elif generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = dense_init(generator, shape, dtype, device)
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# GQA attention block with KV cache
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq (d, H hd), wk / wv (d, KV hd), wo (H hd, d); q_scale / k_scale
    (hd,) with qk-norm. ``generator=None`` leaves the projections
    uninitialised (for loading)."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.wq = _param(generator, (d, cfg.num_heads * hd), dtype, device)
        self.wk = _param(generator, (d, cfg.num_kv_heads * hd), dtype, device)
        self.wv = _param(generator, (d, cfg.num_kv_heads * hd), dtype, device)
        self.wo = _param(generator, (cfg.num_heads * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_scale = _param(None, (hd,), dtype, device, zeros=True)
            self.k_scale = _param(None, (hd,), dtype, device, zeros=True)


def attn_init(generator, cfg: ModelConfig, dtype, device) -> Attention:
    return Attention(cfg, dtype, device, generator)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, num_layers: int | None = None) -> dict:
    """k, v (B, L, KV, hd) in ``dtype`` and pos (B, L) int32 at -1 (empty),
    with a leading (num_layers,) axis when ``num_layers`` is given — the
    layout of the reference's layer-stacked cache."""
    hd = cfg.resolved_head_dim
    lead = () if num_layers is None else (num_layers,)
    return {
        "k": torch.zeros(lead + (batch, max_len, cfg.num_kv_heads, hd),
                         dtype=dtype, device=device),
        "v": torch.zeros(lead + (batch, max_len, cfg.num_kv_heads, hd),
                         dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def attn_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               positions: torch.Tensor, cache: dict | None = None, *,
               mode: str | None = None):
    """Self attention. x: (B, S, d); positions: (B, S) int32 absolute.

    With a cache, attention runs over (old cache) ++ (fresh chunk), both
    read in place by the kernel (no concatenation), which is exact for
    one-token decode, chunked prefill and prompts longer than a
    ring buffer. The new K/V are then written at slot ``position %
    cache_len`` (a ring buffer: the identity layout for a cache sized >=
    the sequence; O(window) memory for sliding-window caches), keeping the
    last ``cache_len`` tokens of a prefill longer than the buffer.

    The write is IN PLACE: the tensors of ``cache`` are updated and the same
    dict is returned (the reference returns new arrays).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    mode = mode or _attn_mode(cfg)
    q = (x @ p.wq).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p.wk).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p.wv).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p.q_scale)
        k = head_rms_norm(k, p.k_scale)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _attention(cfg, q, k, v, positions, positions, mode=mode)
    else:
        cache_len = cache["k"].shape[1]
        k_c, v_c = cache["k"], cache["v"]
        if k_c.dtype != q.dtype:
            k_c, v_c = k_c.to(q.dtype), v_c.to(q.dtype)
        # the cache and the fresh chunk are read in place, in that order
        out = _attention(cfg, q, k_c, v_c, positions, cache["pos"],
                         mode=mode, k2=k, v2=v, kv_pos2=positions)
        if s >= cache_len:
            k_w, v_w = k[:, -cache_len:], v[:, -cache_len:]
            pos_w = positions[:, -cache_len:]
        else:
            k_w, v_w, pos_w = k, v, positions
        slots = (pos_w % cache_len).long()                 # (B, S')
        bidx = torch.arange(b, device=x.device)[:, None]
        cache["k"][bidx, slots] = k_w.to(cache["k"].dtype)
        cache["v"][bidx, slots] = v_w.to(cache["v"].dtype)
        cache["pos"][bidx, slots] = pos_w
    y = out.reshape(b, s, cfg.num_heads * hd) @ p.wo
    return y, cache


# ---------------------------------------------------------------------------
# Dense decoder layer
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    """Pre-norm attention + SwiGLU MLP with RMSNorm gains ln1 / ln2."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ln1 = _param(None, (cfg.d_model,), dtype, device, zeros=True)
        self.ln2 = _param(None, (cfg.d_model,), dtype, device, zeros=True)
        self.attn = attn_init(generator, cfg, dtype, device)
        self.mlp = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device)


def dense_layer_init(generator, cfg: ModelConfig, dtype, device) -> DenseLayer:
    return DenseLayer(cfg, dtype, device, generator)


def dense_layer_apply(cfg: ModelConfig, p: DenseLayer, x, positions, cache,
                      ctx: ModelCtx = DEFAULT_CTX):
    h, new_cache = attn_apply(cfg, p.attn, rms_norm(x, p.ln1), positions,
                              cache)
    x = x + h
    x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2))
    return x, new_cache, 0.0
