"""Model assembly for the dense family and the entry points every
architecture exposes (counterpart of ``repro.models.transformer``):

  * ``forward``      — full-sequence logits
  * ``init_cache``   — decode state (KV caches / ring buffers)
  * ``prefill``      — a prompt against a cache: fills it, returns the last
    position's logits
  * ``decode_step``  — one token in, one token's logits out, cache updated

The layers are an ``nn.ModuleList`` walked in a Python loop, where the
reference scans stacked params under ``lax.scan``. The other families (moe,
xlstm, hybrid, encdec, vlm) raise ``NotImplementedError`` naming their
ROADMAP item.

Weights are kept in ONE copy, in ``cfg.dtype``, cast once at build
(``compute_cast``). The reference keeps fp32 masters and casts them on every
call; the numbers are the same.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.blocks import DEFAULT_CTX, ModelCtx
from repro_torch.models.common import dense_init, embed_init, rms_norm

FAMILY_TODO = {
    "moe": "ROADMAP queue 1 item 17 (MoE: repro.models.mlp.moe_*)",
    "xlstm": "ROADMAP queue 1 item 17 (ssm: xLSTM)",
    "hybrid": "ROADMAP queue 1 item 17 (ssm: Mamba2 and the hybrid family)",
    "encdec": "ROADMAP queue 1 item 17 (encdec: cross attention)",
    "vlm": "ROADMAP queue 1 item 17 (vlm)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        todo = FAMILY_TODO.get(cfg.family)
        if todo is None:
            raise ValueError(f"unknown family {cfg.family}")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: {todo}")


class Transformer(nn.Module):
    """Parameters of a dense-family model: embed (V, d), ln_f (d,),
    unembed (d, V) and ``layers``, a ModuleList of DenseLayer."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        _require_dense(cfg)
        dtype = getattr(torch, cfg.dtype)
        shape_e, shape_u = (cfg.vocab_size, cfg.d_model), (cfg.d_model,
                                                            cfg.vocab_size)
        if generator is None:
            embed = torch.empty(shape_e, dtype=dtype, device=device)
            unembed = torch.empty(shape_u, dtype=dtype, device=device)
        else:
            embed = embed_init(generator, shape_e, dtype, device)
            unembed = dense_init(generator, shape_u, dtype, device)
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dtype,
                                             device=device),
                                 requires_grad=False)
        self.unembed = nn.Parameter(unembed, requires_grad=False)
        self.layers = nn.ModuleList(
            blocks.dense_layer_init(generator, cfg, dtype, device)
            for _ in range(cfg.num_layers))


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device) -> Transformer:
    """Random weights from ``generator`` (truncated normal, as the
    reference draws them), in ``cfg.dtype``. ``generator=None`` allocates
    them uninitialised, for loading (``convert.model_params_from_numpy``)."""
    return Transformer(cfg, device, generator)


def compute_cast(cfg: ModelConfig, params: Transformer) -> Transformer:
    """Cast every floating parameter to the activation dtype ``cfg.dtype``,
    in place (once, at build or load: serving keeps no fp32 masters)."""
    return params.to(getattr(torch, cfg.dtype))


def embed_tokens(cfg: ModelConfig, params: Transformer,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens].to(getattr(torch, cfg.dtype))


def _positions(b: int, start, s: int, device) -> torch.Tensor:
    pos = (torch.arange(s, dtype=torch.int32, device=device)
           + start).to(torch.int32)
    return pos.repeat(b, 1)                              # (B, S) contiguous


def _run_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor,
               positions: torch.Tensor, caches: dict | None,
               ctx: ModelCtx):
    """Walk the layers; ``caches`` (the layer-stacked cache dict) may be
    None (cache-free forward). Layer i reads and writes views of the
    stacked tensors."""
    aux = 0.0
    for i, layer in enumerate(params.layers):
        c = None if caches is None else {key: t[i] for key, t in
                                         caches.items()}
        x, _, aux_l = blocks.dense_layer_apply(cfg, layer, x, positions, c,
                                               ctx)
        aux = aux + aux_l
    return x, caches, aux


def _logits(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    return (rms_norm(x, params.ln_f) @ params.unembed).float()


def forward(cfg: ModelConfig, params: Transformer, batch: dict,
            ctx: ModelCtx = DEFAULT_CTX):
    """Full-sequence logits. batch: {"tokens": (B, S)}.

    Returns (logits (B, S, V) float32, aux_loss scalar).
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, 0, s, tokens.device)
    x, _, aux = _run_stack(cfg, params, x, positions, None, ctx)
    return _logits(params, x), torch.full((), float(aux),
                                          dtype=torch.float32,
                                          device=x.device)


def init_cache(cfg: ModelConfig, params: Transformer, batch: int,
               max_len: int) -> dict:
    """Decode state of the whole stack: k, v (layers, B, L, KV, hd) and pos
    (layers, B, L), on the parameters' device. Sliding and chunked-local
    attention keep a ring buffer of L = min(max_len, window) slots: both
    attend only to keys within the last ``window`` positions."""
    _require_dense(cfg)
    cache_len = max_len
    if cfg.attention in ("sliding", "chunked_local"):
        cache_len = min(max_len, cfg.window)
    return blocks.init_kv_cache(cfg, batch, cache_len,
                                getattr(torch, cfg.dtype),
                                params.embed.device,
                                num_layers=len(params.layers))


def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                t, cache: dict, *, ctx: ModelCtx = DEFAULT_CTX):
    """One decode step. tokens: (B, 1); t: the position (int or 0-d int32
    tensor). Updates ``cache`` in place and returns (logits (B, 1, V) f32,
    cache)."""
    _require_dense(cfg)
    b = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, t, 1, tokens.device)
    x, cache, _ = _run_stack(cfg, params, x, positions, cache, ctx)
    return _logits(params, x), cache


def prefill(cfg: ModelConfig, params: Transformer, batch: dict, cache: dict,
            ctx: ModelCtx = DEFAULT_CTX):
    """Process a full prompt against a cache (updated in place); returns
    (last-position logits (B, 1, V) f32, cache)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, 0, s, tokens.device)
    x, cache, _ = _run_stack(cfg, params, x, positions, cache, ctx)
    return _logits(params, x[:, -1:]), cache


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
