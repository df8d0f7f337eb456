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

Serving keeps the weights in ONE copy, in ``cfg.dtype``, cast once at
build (``compute_cast``). Training keeps fp32 masters (``cfg.param_dtype``)
in the reference's layout (``param_paths``: the reference's leaf names and
order, layer leaves stacked on a leading (num_layers,) axis) and casts them
to ``cfg.dtype`` on every forward, differentiably (``cast_masters``), as
the reference's ``compute_cast`` does. ``bind`` gives such a flat dict the
attribute layout the forward reads. With a gradient, each layer runs under
``torch.utils.checkpoint`` as ``cfg.remat_policy`` says: ``full`` keeps
the layer's input only, ``dots`` also the outputs of its matrix products,
``none`` (or ``remat=False``) everything.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
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
                 generator: torch.Generator | None = None, dtype=None):
        super().__init__()
        _require_dense(cfg)
        dtype = dtype or getattr(torch, cfg.dtype)
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
                device, dtype=None) -> Transformer:
    """Random weights from ``generator`` (truncated normal, as the
    reference draws them), in ``dtype`` (default ``cfg.dtype``).
    ``generator=None`` allocates them uninitialised, for loading
    (``convert.model_params_from_numpy``)."""
    return Transformer(cfg, device, generator, dtype)


# ---------------------------------------------------------------------------
# the training layout: flat dicts of the reference's leaves
# ---------------------------------------------------------------------------

class ParamTree(dict):
    """A dict read by attribute: ``bind``'s stand-in for the module tree
    the forward reads (``params.layers[i].attn.wq``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def param_paths(cfg: ModelConfig) -> list:
    """Dotted names of the reference's parameter leaves in its flatten
    order (sorted keys): ``embed``, ``layers.attn.k_scale``, ...,
    ``unembed``. Names under ``layers.`` are stacked over the layers."""
    _require_dense(cfg)
    attn = ["wk", "wo", "wq", "wv"]
    if cfg.qk_norm:
        attn = ["k_scale", "q_scale"] + attn
    return (["embed"] + [f"layers.attn.{n}" for n in attn]
            + ["layers.ln1", "layers.ln2"]
            + [f"layers.mlp.{n}" for n in ("w_down", "w_gate", "w_up")]
            + ["ln_f", "unembed"])


def _module_name(path: str, layer: int | None) -> str:
    return path if layer is None else path.replace("layers.",
                                                   f"layers.{layer}.", 1)


def stack_params(cfg: ModelConfig, module: Transformer) -> dict:
    """A module's weights as the flat training dict (``param_paths``),
    layer leaves stacked: copies, in the module's dtype."""
    named = dict(module.named_parameters())
    out = {}
    for path in param_paths(cfg):
        if path.startswith("layers."):
            out[path] = torch.stack([named[_module_name(path, i)].detach()
                                     for i in range(len(module.layers))])
        else:
            out[path] = named[path].detach().clone()
    return out


def explode(params: dict) -> dict:
    """The flat training dict with each stacked layer leaf split into its
    per-layer views (``"layers.attn.wq"`` -> a list of (d, H hd) views
    sharing the stack's storage); other leaves pass through."""
    return {name: (list(p.unbind(0)) if name.startswith("layers.") else p)
            for name, p in params.items()}


def bind(leaves: dict) -> ParamTree:
    """Attribute layout of the forward (``params.layers[i].attn.wq``) over
    an exploded dict (``explode``), or over stacked leaves, which are
    indexed per layer."""
    root = ParamTree()
    layers = None
    for name, val in leaves.items():
        parts = name.split(".")
        if parts[0] != "layers":
            root[name] = val
            continue
        if layers is None:
            layers = [ParamTree() for _ in range(len(val))]
        for i, t in enumerate(val):
            node = layers[i]
            for key in parts[1:-1]:
                node = node.setdefault(key, ParamTree())
            node[parts[-1]] = t
    root["layers"] = layers or []
    return root


def cast_masters(cfg: ModelConfig, leaves: dict) -> dict:
    """Exploded masters cast to ``cfg.dtype`` (differentiable; the same
    tensors where the dtypes agree)."""
    dtype = getattr(torch, cfg.dtype)
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    return {name: ([cast(t) for t in val] if isinstance(val, list)
                   else cast(val)) for name, val in leaves.items()}


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
    remat = caches is None and torch.is_grad_enabled() and _remat_on(cfg)
    for i, layer in enumerate(params.layers):
        c = None if caches is None else {key: t[i] for key, t in
                                         caches.items()}
        if remat:
            # the layer's weights are closed over: the recompute in the
            # backward reads the same tensors
            x, aux_l = torch.utils.checkpoint.checkpoint(
                functools.partial(_layer_out, cfg, layer, positions, ctx),
                x, use_reentrant=False, context_fn=_remat_context(cfg))
        else:
            x, _, aux_l = blocks.dense_layer_apply(cfg, layer, x, positions,
                                                   c, ctx)
        aux = aux + aux_l
    return x, caches, aux


def _layer_out(cfg, layer, positions, ctx, x):
    """A layer's output and its aux term, without a cache."""
    y, _, aux_l = blocks.dense_layer_apply(cfg, layer, x, positions, None,
                                           ctx)
    return y, aux_l


def _remat_on(cfg: ModelConfig) -> bool:
    if cfg.remat_policy not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return cfg.remat and cfg.remat_policy != "none"


# the products whose outputs "dots" keeps: matrix products without batch
# dims (the projections; the reference's dots_with_no_batch_dims_saveable)
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: ModelConfig):
    if cfg.remat_policy != "dots":
        return torch.utils.checkpoint.noop_context_fn
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(create_selective_checkpoint_contexts,
                             _save_matmuls)


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
    if not isinstance(aux, torch.Tensor):   # a Python float: no host sync
        aux = torch.full((), float(aux), dtype=torch.float32,
                         device=x.device)
    return _logits(params, x), aux


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


def param_count(params) -> int:
    """Parameters of a module or of a flat training dict."""
    tensors = (params.values() if isinstance(params, dict)
               else params.parameters())
    return sum(p.numel() for p in tensors)
