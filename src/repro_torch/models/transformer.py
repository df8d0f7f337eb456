"""Model assembly for the dense, MoE, xlstm and hybrid families and the
entry points every architecture exposes (counterpart of
``repro.models.transformer``):

  * ``forward``      — full-sequence logits
  * ``init_cache``   — decode state (KV caches / ring buffers / recurrent
    states)
  * ``prefill``      — a prompt against a cache: fills it, returns the last
    position's logits
  * ``decode_step``  — one token in, one token's logits out, cache updated

A model's parameters are ONE flat dict ``{dotted name: tensor}``, named and
ordered as ``param_paths`` says: the reference's leaves in its
``jax.tree`` flatten order, the layer leaves stacked over the groups on a
leading axis, as the reference's ``_stack_init`` stacks them (the hybrid
family's ``shared`` attention + MLP block is not stacked: every group
reads it). Serving, training, checkpoints and gossip all read it. Serving
holds it in ``cfg.dtype`` (the reference's ``compute_cast``, once, at
build or load); training holds fp32 masters (``cfg.param_dtype``) and
casts them on every forward, differentiably (``train.steps``).

The groups run in a Python loop where the reference scans them under
``lax.scan``; each group reads views ``t[i]`` of the stacked leaves
(``_group_trees``). With a gradient, each group runs under
``torch.utils.checkpoint`` as ``cfg.remat_policy`` says: ``full`` keeps
the group's input only, ``dots`` also the outputs of its matrix products,
``none`` (or ``remat=False``) everything. The encdec and vlm families
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.blocks import DEFAULT_CTX, ModelCtx
from repro_torch.models.common import (Leaf, dense_leaf, draw_, flatten,
                                       nest, new_leaf, rms_norm)

# the families whose groups carry a recurrent state
RECURRENT = ("xlstm", "hybrid")

FAMILY_TODO = {
    "encdec": "ROADMAP queue 1 item 17.4 (encdec: cross attention)",
    "vlm": "ROADMAP queue 1 item 17.5 (vlm)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in RECURRENT + ("dense", "moe"):
        todo = FAMILY_TODO.get(cfg.family)
        if todo is None:
            raise ValueError(f"unknown family {cfg.family}")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: {todo}")


def _num_groups(cfg: ModelConfig) -> int:
    if cfg.family == "xlstm":
        return max(1, cfg.num_layers // 2)      # one group = mLSTM + sLSTM
    if cfg.family == "hybrid":
        return max(1, cfg.num_layers // (cfg.blocks_per_attn + 1))
    if cfg.family == "moe" and cfg.moe_every > 1:
        return max(1, cfg.num_layers // cfg.moe_every)
    return cfg.num_layers


def _layers_per_group(cfg: ModelConfig) -> int:
    return cfg.moe_every if cfg.family == "moe" and cfg.moe_every > 1 else 1


def num_attn_layers(cfg: ModelConfig) -> int:
    """Attention layers of the stack: the leading axis of the KV cache
    (one shared-block call per hybrid group, none in an xLSTM)."""
    if cfg.family == "xlstm":
        return 0
    return _num_groups(cfg) * _layers_per_group(cfg)


def _group_leaves(cfg: ModelConfig) -> dict:
    if cfg.family == "xlstm":
        return blocks.xlstm_pair_leaves(cfg)
    if cfg.family == "hybrid":
        return blocks.hybrid_group_leaves(cfg)
    if cfg.family == "dense":
        return blocks.dense_layer_leaves(cfg)
    if cfg.moe_every > 1:
        return blocks.moe_group_leaves(cfg)
    return blocks.moe_layer_leaves(cfg)


def param_leaves(cfg: ModelConfig) -> dict:
    """{dotted name: Leaf} in ``param_paths`` order; layer leaves carry the
    leading (groups,) axis, the hybrid's ``shared`` leaves do not."""
    _require_ported(cfg)
    lead = (_num_groups(cfg),)
    layers = {name: leaf._replace(shape=lead + leaf.shape)
              for name, leaf in flatten(_group_leaves(cfg)).items()}
    tree = {"embed": Leaf((cfg.vocab_size, cfg.d_model), "embed"),
            "ln_f": Leaf((cfg.d_model,)),
            "unembed": dense_leaf((cfg.d_model, cfg.vocab_size)),
            "layers": nest(layers)}
    if cfg.family == "hybrid":
        tree["shared"] = blocks.hybrid_shared_leaves(cfg)
    return flatten(tree)


def param_paths(cfg: ModelConfig) -> list:
    """Dotted names of the reference's parameter leaves in its flatten
    order (sorted keys, a group's dense layers by index): ``embed``,
    ``layers.attn.k_scale``, ..., ``unembed``. Names under ``layers.`` are
    stacked over the groups."""
    return list(param_leaves(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device, dtype=None) -> dict:
    """The flat parameter dict, drawn from ``generator`` (truncated normal,
    as the reference draws it, one matrix at a time: an expert of a group
    is the largest fp32 temporary) in ``dtype`` (default ``cfg.dtype``).
    ``generator=None`` leaves the drawn leaves uninitialised, for loading.
    Built under ``no_grad``.

    The draws go embed, unembed, then group by group in the order the
    blocks' ``*_leaves`` list their leaves, then the hybrid's shared
    block: for the dense family the stream of the per-layer modules this
    layout replaced, so a seed gives the weights it gave before."""
    dtype = dtype or getattr(torch, cfg.dtype)
    leaves = param_leaves(cfg)
    with torch.no_grad():
        params = {name: new_leaf(None, leaf, dtype, device)
                  for name, leaf in leaves.items()}
        if generator is None:
            return params
        for name in ("embed", "unembed"):
            draw_(generator, params[name], leaves[name])
        group = flatten(_group_leaves(cfg), sort=False)
        for g in range(_num_groups(cfg)):
            for name, leaf in group.items():
                draw_(generator, params["layers." + name][g], leaf)
        for name, leaf in leaves.items():
            if name.startswith("shared."):
                draw_(generator, params[name], leaf)
    return params


def _group_trees(params: dict, n: int) -> list:
    """One nested tree per group of views ``t[i]`` of the stacked layer
    leaves (``unbind``: views, and one stacked gradient per leaf)."""
    views = {name[len("layers."):]: t.unbind(0)
             for name, t in params.items() if name.startswith("layers.")}
    return [nest({name: v[i] for name, v in views.items()})
            for i in range(n)]


def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


def _positions(b: int, start, s: int, device) -> torch.Tensor:
    pos = (torch.arange(s, dtype=torch.int32, device=device)
           + start).to(torch.int32)
    return pos.repeat(b, 1)                              # (B, S) contiguous


def _shared_tree(params: dict) -> dict:
    """The hybrid's shared block as a nested tree (the same tensors)."""
    return nest({name[len("shared."):]: t for name, t in params.items()
                 if name.startswith("shared.")})


def _hybrid_apply(shared, cfg, p, x, positions, cache, ctx):
    return blocks.hybrid_group_apply(cfg, p, shared, x, positions, cache,
                                     ctx)


def _group_fn(cfg: ModelConfig, params: dict):
    """The per-group apply fn (looked up per call: tests patch blocks);
    the hybrid's closes over the shared block."""
    if cfg.family == "xlstm":
        return blocks.xlstm_pair_apply
    if cfg.family == "hybrid":
        return functools.partial(_hybrid_apply, _shared_tree(params))
    if cfg.family == "dense":
        return blocks.dense_layer_apply
    if cfg.moe_every > 1:
        return blocks.moe_group_apply
    return blocks.moe_layer_apply


def _run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor, caches: dict | None,
               ctx: ModelCtx):
    """Walk the groups, summing their aux terms; ``caches`` (the per-layer
    stacked cache dict, or the recurrent families' tree stacked over
    groups) may be None (cache-free forward). Group i reads views of the
    stacked parameters and of its caches; a recurrent group's new states
    are copied into its views."""
    fn = _group_fn(cfg, params)
    per = _layers_per_group(cfg)
    groups = _group_trees(params, _num_groups(cfg))
    aux = 0.0
    remat = caches is None and torch.is_grad_enabled() and _remat_on(cfg)
    for i, group in enumerate(groups):
        c = None
        if caches is not None and cfg.family in RECURRENT:
            c = _tree_map(lambda t: t[i], caches)
            x, new, _ = fn(cfg, group, x, positions, c, ctx)
            _copy_into(c, new)
            continue
        if caches is not None:
            c = [{key: t[i * per + j] for key, t in caches.items()}
                 for j in range(per)]
            c = c[0] if per == 1 else c
        if remat:
            # the group's weights are closed over: the recompute in the
            # backward reads the same tensors
            x, aux_l = torch.utils.checkpoint.checkpoint(
                functools.partial(_group_out, fn, cfg, group, positions,
                                  ctx),
                x, use_reentrant=False, context_fn=_remat_context(cfg))
        else:
            x, _, aux_l = fn(cfg, group, x, positions, c, ctx)
        aux = aux + aux_l
    return x, caches, aux


def _tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict / list."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, sub) for sub in tree]
    return fn(tree)


def _copy_into(dst, src) -> None:
    """Copy each tensor of ``src`` into the one of ``dst`` at its path
    (skipping those updated in place already: the same tensor)."""
    if isinstance(dst, dict):
        for key in dst:
            _copy_into(dst[key], src[key])
    elif isinstance(dst, list):
        for d, s_ in zip(dst, src):
            _copy_into(d, s_)
    elif src is not dst:
        dst.copy_(src)


def _group_out(fn, cfg, group, positions, ctx, x):
    """A group's output and its aux term, without a cache."""
    y, _, aux_l = fn(cfg, group, x, positions, None, ctx)
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


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (rms_norm(x, params["ln_f"]) @ params["unembed"]).float()


def forward(cfg: ModelConfig, params: dict, batch: dict,
            ctx: ModelCtx = DEFAULT_CTX):
    """Full-sequence logits. batch: {"tokens": (B, S)}.

    Returns (logits (B, S, V) float32, aux_loss scalar: the sum of the MoE
    layers' load-balance terms, 0 for the other families).
    """
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, 0, s, tokens.device)
    x, _, aux = _run_stack(cfg, params, x, positions, None, ctx)
    if not isinstance(aux, torch.Tensor):   # a Python float: no host sync
        aux = torch.full((), float(aux), dtype=torch.float32,
                         device=x.device)
    return _logits(params, x), aux


def init_cache(cfg: ModelConfig, params: dict, batch: int,
               max_len: int) -> dict:
    """Decode state of the whole stack, on the parameters' device.

    Dense and MoE: k, v (layers, B, L, KV, hd) and pos (layers, B, L), one
    entry per attention layer (a MoE group's dense layers, then its MoE
    layer). Sliding and chunked-local attention keep a ring buffer of
    L = min(max_len, window) slots: both attend only to keys within the
    last ``window`` positions.

    xlstm and hybrid: the reference's tree, each tensor stacked over the
    groups: {"mlstm": {c, n, m}, "slstm": {c, n, h, m}} (O(1) in the
    sequence), or {"mamba": [{conv, ssm} per block], "attn": {k, v, pos}}
    with the shared attention's ring of min(max_len, window) slots under
    sliding attention."""
    _require_ported(cfg)
    if cfg.family in RECURRENT:
        g0 = _group_trees(params, 1)[0]
        if cfg.family == "xlstm":
            one = blocks.xlstm_init_cache(cfg, g0, batch)
        else:
            attn_len = min(max_len, cfg.window) \
                if cfg.attention == "sliding" else max_len
            one = blocks.hybrid_init_cache(cfg, g0, batch, attn_len,
                                           getattr(torch, cfg.dtype))
        n = _num_groups(cfg)
        return _tree_map(lambda t: t.expand(n, *t.shape).clone(), one)
    cache_len = max_len
    if cfg.attention in ("sliding", "chunked_local"):
        cache_len = min(max_len, cfg.window)
    return blocks.init_kv_cache(cfg, batch, cache_len,
                                getattr(torch, cfg.dtype),
                                params["embed"].device,
                                num_layers=num_attn_layers(cfg))


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                t, cache: dict, *, ctx: ModelCtx = DEFAULT_CTX):
    """One decode step. tokens: (B, 1); t: the position (int or 0-d int32
    tensor). Updates ``cache`` in place and returns (logits (B, 1, V) f32,
    cache)."""
    _require_ported(cfg)
    b = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, t, 1, tokens.device)
    x, cache, _ = _run_stack(cfg, params, x, positions, cache, ctx)
    return _logits(params, x), cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: dict,
            ctx: ModelCtx = DEFAULT_CTX):
    """Process a full prompt against a cache (updated in place); returns
    (last-position logits (B, 1, V) f32, cache)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, 0, s, tokens.device)
    x, cache, _ = _run_stack(cfg, params, x, positions, cache, ctx)
    return _logits(params, x[:, -1:]), cache


def param_count(params: dict) -> int:
    return sum(p.numel() for p in params.values())
