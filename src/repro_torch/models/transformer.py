"""Model assembly for the dense, MoE, xlstm, hybrid, encdec and vlm
families and the entry points every architecture exposes (counterpart of
``repro.models.transformer``):

  * ``forward``      — full-sequence logits
  * ``init_cache``   — decode state (KV caches / ring buffers / recurrent
    states)
  * ``prefill``      — a prompt against a cache: fills it, returns the last
    position's logits
  * ``decode_step``  — one token in, one token's logits out, cache updated
  * ``encode``       — encdec only: the encoder's output and positions

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
``none`` (or ``remat=False``) everything.

encdec: the encoder's layers are stacked over ``cfg.encoder_layers``
(``enc_layers.*``) and run under the same remat; each decoder layer reads
its own cross K/V of the encoder's output (``_enc_kv_all_layers``, one
stack computed before the decoder), passed into its checkpointed layer as
inputs. vlm: the projected patches (``patch_proj``) precede the text;
positions, logits and the KV cache cover both.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.blocks import DEFAULT_CTX, ModelCtx
from repro_torch.models.common import (Leaf, dense_leaf, draw_, flatten,
                                       nest, new_leaf, rms_norm)

# the families whose groups carry a recurrent state
RECURRENT = ("xlstm", "hybrid")

FAMILIES = RECURRENT + ("dense", "moe", "encdec", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


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
    if cfg.family in ("dense", "vlm"):
        return blocks.dense_layer_leaves(cfg)
    if cfg.family == "encdec":
        return blocks.decoder_xattn_layer_leaves(cfg)
    if cfg.moe_every > 1:
        return blocks.moe_group_leaves(cfg)
    return blocks.moe_layer_leaves(cfg)


def _stacked(leaves: dict, n: int) -> dict:
    """A block's nested leaves with a leading (n,) axis."""
    return nest({name: leaf._replace(shape=(n,) + leaf.shape)
                 for name, leaf in flatten(leaves).items()})


class Frontend(NamedTuple):
    """A family's input beside its tokens, the stubbed modality frontend's
    output (B, n, frontend_dim)."""

    key: str        # its batch key
    proj: str       # its projection leaf (frontend_dim, d)
    prefix: bool    # projected before the text (vlm), or encoded (encdec)


FRONTENDS = {"encdec": Frontend("enc_embeds", "enc_in_proj", False),
             "vlm": Frontend("patches", "patch_proj", True)}


def prefix_len(cfg: ModelConfig, batch: dict) -> int:
    """Positions before the text: vlm's patches, 0 otherwise."""
    front = FRONTENDS.get(cfg.family)
    return batch[front.key].shape[1] if front and front.prefix else 0


def param_leaves(cfg: ModelConfig) -> dict:
    """{dotted name: Leaf} in ``param_paths`` order; layer leaves carry the
    leading (groups,) axis and the encoder's ``enc_layers`` leaves a
    leading (encoder_layers,) axis; the hybrid's ``shared`` leaves and
    the frontend projections are not stacked."""
    _require_ported(cfg)
    tree = {"embed": Leaf((cfg.vocab_size, cfg.d_model), "embed"),
            "ln_f": Leaf((cfg.d_model,)),
            "unembed": dense_leaf((cfg.d_model, cfg.vocab_size)),
            "layers": _stacked(_group_leaves(cfg), _num_groups(cfg))}
    if cfg.family == "hybrid":
        tree["shared"] = blocks.hybrid_shared_leaves(cfg)
    if cfg.family in FRONTENDS:
        tree[FRONTENDS[cfg.family].proj] = dense_leaf((cfg.frontend_dim,
                                                       cfg.d_model))
    if cfg.family == "encdec":
        tree["enc_layers"] = _stacked(blocks.encoder_layer_leaves(cfg),
                                      cfg.encoder_layers)
        tree["enc_ln_f"] = Leaf((cfg.d_model,))
    return flatten(tree)


def param_paths(cfg: ModelConfig) -> list:
    """Dotted names of the reference's parameter leaves in its flatten
    order (sorted keys, a group's dense layers by index): ``embed``,
    ``layers.attn.k_scale``, ..., ``unembed`` (encdec: ``embed,
    enc_in_proj, enc_layers.*, enc_ln_f, layers.*, ln_f, unembed``; vlm:
    ``embed, layers.*, ln_f, patch_proj, unembed``). Names under
    ``layers.`` are stacked over the groups, under ``enc_layers.`` over
    the encoder's layers."""
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
    block, then the encoder layer by layer and the frontend projection:
    for the dense family the stream of the per-layer modules this layout
    replaced, so a seed gives the weights it gave before."""
    dtype = dtype or getattr(torch, cfg.dtype)
    leaves = param_leaves(cfg)
    with torch.no_grad():
        params = {name: new_leaf(None, leaf, dtype, device)
                  for name, leaf in leaves.items()}
        if generator is None:
            return params
        for name in ("embed", "unembed"):
            draw_(generator, params[name], leaves[name])
        _draw_stack(generator, params, "layers.", _group_leaves(cfg),
                    _num_groups(cfg))
        for name, leaf in leaves.items():
            if name.startswith("shared."):
                draw_(generator, params[name], leaf)
        if cfg.family == "encdec":
            _draw_stack(generator, params, "enc_layers.",
                        blocks.encoder_layer_leaves(cfg), cfg.encoder_layers)
        if cfg.family in FRONTENDS:
            name = FRONTENDS[cfg.family].proj
            draw_(generator, params[name], leaves[name])
    return params


def _draw_stack(generator, params: dict, prefix: str, one: dict,
                n: int) -> None:
    """Draw the leaves stacked under ``prefix`` layer by layer, each layer
    in the order ``one`` (a block's ``*_leaves``) lists them."""
    group = flatten(one, sort=False)
    for g in range(n):
        for name, leaf in group.items():
            draw_(generator, params[prefix + name][g], leaf)


def _group_trees(params: dict, n: int, prefix: str = "layers.") -> list:
    """One nested tree per group of views ``t[i]`` of the leaves stacked
    under ``prefix`` (``unbind``: views, and one stacked gradient per
    leaf)."""
    views = {name[len(prefix):]: t.unbind(0)
             for name, t in params.items() if name.startswith(prefix)}
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
    if cfg.family in ("dense", "vlm"):
        return blocks.dense_layer_apply
    if cfg.moe_every > 1:
        return blocks.moe_group_apply
    return blocks.moe_layer_apply


def _checkpointed(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` as
    ``cfg.remat_policy`` says."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=_remat_context(cfg))


def _constrain(x: torch.Tensor, ctx: ModelCtx) -> torch.Tensor:
    """The reference's layer-boundary activation constraint
    (``ctx.act_spec`` on ``ctx.mesh``): it pins the layout a partitioner
    would choose and changes no value, so here it checks that the spec
    fits the (B, S, D) hidden state and returns ``x`` itself."""
    if ctx.act_spec is None or ctx.mesh is None:
        return x
    spec = tuple(ctx.act_spec)
    sizes = dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.shape))
    if len(spec) > x.dim():
        raise ValueError(f"act_spec {ctx.act_spec} has more entries than "
                         f"the hidden state's {x.dim()} dims")
    for dim, axes in zip(x.shape, spec):
        n = 1
        for a in (() if axes is None else
                  axes if isinstance(axes, tuple) else (axes,)):
            if a not in sizes:
                raise ValueError(f"act_spec {ctx.act_spec}: the mesh has "
                                 f"no axis {a!r}")
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"act_spec {ctx.act_spec}: dim {dim} of "
                             f"{tuple(x.shape)} does not split over {n}")
    return x


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
        x = _constrain(x, ctx)
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
            x, aux_l = _checkpointed(cfg, functools.partial(
                _group_out, fn, cfg, group, positions, ctx), x)
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


# ---------------------------------------------------------------------------
# encoder and cross attention (encdec family)
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: dict, enc_embeds: torch.Tensor,
           ctx: ModelCtx = DEFAULT_CTX):
    """The encoder over ``enc_embeds`` (B, S_enc, frontend_dim), the
    stubbed modality frontend's output: the input projection, the
    bidirectional layers (each checkpointed with a gradient, as
    ``_run_stack``'s groups), the final norm. Returns (enc_out (B, S_enc,
    d) in ``cfg.dtype``, enc_pos (B, S_enc) int32 = 0 .. S_enc - 1)."""
    x = enc_embeds.to(getattr(torch, cfg.dtype)) @ params["enc_in_proj"]
    b, s, _ = x.shape
    positions = _positions(b, 0, s, x.device)
    remat = torch.is_grad_enabled() and _remat_on(cfg)
    for layer in _group_trees(params, cfg.encoder_layers, "enc_layers."):
        x = _constrain(x, ctx)
        fn = functools.partial(blocks.encoder_layer_apply, cfg, layer)
        x = (_checkpointed(cfg, fn, x, positions) if remat
             else fn(x, positions))
    return rms_norm(x, params["enc_ln_f"]), positions


def _enc_kv_all_layers(cfg: ModelConfig, params: dict,
                       enc_out: torch.Tensor) -> tuple:
    """Every decoder layer's cross K/V of ``enc_out``: (k, v), each
    (layers, B, S_enc, KV, hd), stacked on the leading layer axis."""
    kv = [blocks.cross_kv(cfg, layer["xattn"], enc_out)
          for layer in _group_trees(params, cfg.num_layers)]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def _xattn_out(cfg, layer, positions, enc_pos, ctx, x, k, v):
    """A decoder layer's output without a cache."""
    return blocks.decoder_xattn_layer_apply(cfg, layer, x, positions, None,
                                            (k, v), enc_pos, ctx)[0]


def _run_decoder_xattn(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       positions: torch.Tensor, caches: dict | None,
                       enc_kv: tuple, enc_pos: torch.Tensor,
                       ctx: ModelCtx):
    """Walk the decoder layers, layer i attending to its slice of
    ``enc_kv``; ``caches`` (the stacked KV cache, updated in place) may be
    None. With a gradient each layer is checkpointed with its K/V slice
    passed in as inputs, so their gradients reach ``xattn.wk / wv`` and
    the encoder."""
    k_all, v_all = enc_kv
    remat = caches is None and torch.is_grad_enabled() and _remat_on(cfg)
    for i, layer in enumerate(_group_trees(params, cfg.num_layers)):
        x = _constrain(x, ctx)
        if remat:
            x = _checkpointed(cfg, functools.partial(
                _xattn_out, cfg, layer, positions, enc_pos, ctx), x,
                k_all[i], v_all[i])
            continue
        c = None if caches is None else {key: t[i]
                                         for key, t in caches.items()}
        x, _, _ = blocks.decoder_xattn_layer_apply(
            cfg, layer, x, positions, c, (k_all[i], v_all[i]), enc_pos, ctx)
    return x, caches


def _run_body(cfg: ModelConfig, params: dict, batch: dict, cache,
              ctx: ModelCtx):
    """The stack over a full sequence (``batch``'s tokens, behind vlm's
    projected patches, and encdec's encoder input), with or without a
    cache: (hidden states, cache, aux)."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    front = FRONTENDS.get(cfg.family)
    if front and front.prefix:
        x = torch.cat([batch[front.key].to(x.dtype) @ params[front.proj], x],
                      dim=1)
    positions = _positions(x.shape[0], 0, x.shape[1], tokens.device)
    if not front or front.prefix:
        return _run_stack(cfg, params, x, positions, cache, ctx)
    enc_out, enc_pos = encode(cfg, params, batch[front.key], ctx)
    enc_kv = _enc_kv_all_layers(cfg, params, enc_out)
    x, cache = _run_decoder_xattn(cfg, params, x, positions, cache, enc_kv,
                                  enc_pos, ctx)
    return x, cache, 0.0


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (rms_norm(x, params["ln_f"]) @ params["unembed"]).float()


def forward(cfg: ModelConfig, params: dict, batch: dict,
            ctx: ModelCtx = DEFAULT_CTX):
    """Full-sequence logits. batch keys per family:

      dense/moe/xlstm/hybrid: tokens (B, S)
      vlm:    tokens (B, S_text) + patches (B, P, frontend_dim)
      encdec: tokens (B, S_dec) + enc_embeds (B, S_enc, frontend_dim)

    Returns (logits (B, S*, V) float32 — for vlm over the P patches and
    the text, S* = P + S_text — and the aux loss, a scalar: the sum of the
    MoE layers' load-balance terms, 0 for the other families).
    """
    _require_ported(cfg)
    x, _, aux = _run_body(cfg, params, batch, None, ctx)
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
    sliding attention.

    encdec: the decoder's self-attention layers (the cross K/V are not
    cached here: ``decode_step`` takes them); vlm: the dense layout, its
    slots holding the patches and the text."""
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
                t, cache: dict, *, enc_kv: tuple | None = None,
                enc_pos: torch.Tensor | None = None,
                ctx: ModelCtx = DEFAULT_CTX):
    """One decode step. tokens: (B, 1); t: the position (int or 0-d int32
    tensor; vlm: counting the patches). Updates ``cache`` in place and
    returns (logits (B, 1, V) f32, cache). encdec takes ``enc_kv`` and
    ``enc_pos`` from ``encode`` + ``_enc_kv_all_layers``."""
    _require_ported(cfg)
    b = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(b, t, 1, tokens.device)
    if cfg.family == "encdec":
        if enc_kv is None or enc_pos is None:
            raise ValueError("decode_step: the encdec family needs enc_kv "
                             "and enc_pos")
        x, cache = _run_decoder_xattn(cfg, params, x, positions, cache,
                                      enc_kv, enc_pos, ctx)
    else:
        x, cache, _ = _run_stack(cfg, params, x, positions, cache, ctx)
    return _logits(params, x), cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache: dict,
            ctx: ModelCtx = DEFAULT_CTX):
    """Process a full prompt against a cache (updated in place); returns
    (last-position logits (B, 1, V) f32, cache). ``batch`` as ``forward``
    takes it: vlm's patches fill the first P slots, and encdec encodes
    ``enc_embeds`` here."""
    _require_ported(cfg)
    x, cache, _ = _run_body(cfg, params, batch, cache, ctx)
    return _logits(params, x[:, -1:]), cache


def param_count(params: dict) -> int:
    return sum(p.numel() for p in params.values())
