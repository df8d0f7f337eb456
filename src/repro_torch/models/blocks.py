"""Per-family blocks: the GQA attention block with its ring-buffer KV
cache, the dense and MoE decoder layers, the interleaved MoE group, the
xLSTM pair, the Zamba2 hybrid group, the bidirectional encoder layer and
the decoder layer with cross attention (counterpart of
``repro.models.blocks``).

Every block shares the signature
    apply(cfg, params, x, positions, cache, ctx) -> (y, new_cache, aux)
where ``cache=None`` selects the cache-free path (full-sequence forward)
and ``positions`` are absolute token positions (B, S) int32. Parameters are
nested dicts of tensors with the reference's names and layouts
(``p["attn"]["wq"]``, ``p["moe"]["router"]``; a group's dense layers under
``p["dense"][i]``): in a model, views of one group of the layer-stacked
leaves (``transformer._group_trees``). ``*_leaves`` give each block's
shapes and initializers.

A recurrent block's cache is its state dict (``ssm.*_init_state``); the
block returns new state tensors, which ``transformer._run_stack`` copies
into the stacked cache. The encoder layer (``encoder_layer_apply``) takes
no cache; the decoder layer with cross attention
(``decoder_xattn_layer_apply``) also takes its layer's encoder K/V
(``cross_kv``) and the encoder positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import mlp, ssm
from repro_torch.models.common import (Leaf, apply_rope, dense_leaf,
                                       head_rms_norm, init_tree, rms_norm)

@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Runtime context. ``moe_mode`` ("scatter" | "dense") and
    ``dispatch_groups`` (token-grouped scatter dispatch) pick the MoE
    dispatch (``mlp.moe_apply``). ``mesh`` (a ``DeviceMesh``, from
    ``launch.mesh.make_host_mesh``) with ``model_axis`` makes scatter
    dispatch expert-parallel over that axis's ranks. ``act_spec`` (a
    ``dist.sharding.P`` over the mesh's axes) is the reference's
    layer-boundary activation constraint (``transformer._constrain``): in
    one process it changes no value, and each group's input is checked
    against it."""

    mesh: Any = None
    model_axis: str | None = None
    moe_mode: str = "scatter"   # "scatter" | "dense"
    act_spec: Any = None        # dist.sharding.P | None
    dispatch_groups: int = 0    # token-grouped MoE dispatch (see mlp.py)

    def __post_init__(self):
        if self.model_axis is not None and self.mesh is not None and \
                self.model_axis not in (self.mesh.mesh_dim_names or ()):
            raise ValueError(f"ModelCtx: the mesh has no axis "
                             f"{self.model_axis!r}")


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
                           compute_dtype=cfg.attn_compute_dtype,
                           grad_chunk=cfg.scan_chunk, **fresh)


# ---------------------------------------------------------------------------
# GQA attention block with KV cache
# ---------------------------------------------------------------------------

def attn_leaves(cfg: ModelConfig) -> dict:
    """wq (d, H hd), wk / wv (d, KV hd), wo (H hd, d); q_scale / k_scale
    (hd,) with qk-norm."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": dense_leaf((d, cfg.num_heads * hd)),
         "wk": dense_leaf((d, cfg.num_kv_heads * hd)),
         "wv": dense_leaf((d, cfg.num_kv_heads * hd)),
         "wo": dense_leaf((cfg.num_heads * hd, d))}
    if cfg.qk_norm:
        p["q_scale"] = Leaf((hd,))
        p["k_scale"] = Leaf((hd,))
    return p


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


def attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
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
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_scale"])
        k = head_rms_norm(k, p["k_scale"])
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
    y = out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]
    return y, cache


def cross_attn_leaves(cfg: ModelConfig) -> dict:
    """The cross attention's projections: ``attn_leaves``' (wk / wv read
    the encoder's output through ``cross_kv``)."""
    return attn_leaves(cfg)


def cross_attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     enc_kv: tuple, enc_pos: torch.Tensor) -> torch.Tensor:
    """Cross attention of x (B, S, d) against precomputed encoder K/V
    (``cross_kv``), mode ``cross``: every valid encoder slot is admitted.
    The queries take no rotary embedding and position 0, as the
    reference's."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k, v = enc_kv
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    out = _attention(cfg, q, k, v, q_pos, enc_pos, mode="cross")
    return out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]


def cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor) -> tuple:
    """The cross attention's K, V (B, S_enc, KV, hd) from the encoder's
    output (B, S_enc, d)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# Decoder layers (dense & MoE)
# ---------------------------------------------------------------------------

def dense_layer_leaves(cfg: ModelConfig) -> dict:
    """Pre-norm attention + SwiGLU MLP with RMSNorm gains ln1 / ln2."""
    return {"ln1": Leaf((cfg.d_model,)), "ln2": Leaf((cfg.d_model,)),
            "attn": attn_leaves(cfg),
            "mlp": mlp.mlp_leaves(cfg.d_model, cfg.d_ff)}


def dense_layer_apply(cfg: ModelConfig, p: dict, x, positions, cache,
                      ctx: ModelCtx = DEFAULT_CTX):
    h, new_cache = attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]),
                              positions, cache)
    x = x + h
    x = x + mlp.mlp_apply(p["mlp"], rms_norm(x, p["ln2"]))
    return x, new_cache, 0.0


def moe_layer_leaves(cfg: ModelConfig) -> dict:
    """Pre-norm attention + MoE (``mlp.moe_leaves``)."""
    return {"ln1": Leaf((cfg.d_model,)), "ln2": Leaf((cfg.d_model,)),
            "attn": attn_leaves(cfg),
            "moe": mlp.moe_leaves(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                  cfg.moe_shared_expert)}


def moe_layer_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return init_tree(generator, moe_layer_leaves(cfg), dtype, device)


def moe_layer_apply(cfg: ModelConfig, p: dict, x, positions, cache,
                    ctx: ModelCtx = DEFAULT_CTX):
    h, new_cache = attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]),
                              positions, cache)
    x = x + h
    y, aux = mlp.moe_apply(p["moe"], rms_norm(x, p["ln2"]),
                           experts_per_token=cfg.experts_per_token,
                           capacity_factor=cfg.moe_capacity_factor,
                           mode=ctx.moe_mode, mesh=ctx.mesh,
                           model_axis=ctx.model_axis,
                           dispatch_groups=ctx.dispatch_groups,
                           group_axes=(tuple(ctx.act_spec)[0]
                                       if ctx.act_spec is not None
                                       else None))
    return x + y, new_cache, aux


def moe_group_leaves(cfg: ModelConfig) -> dict:
    """Interleaved group (cfg.moe_every > 1): (moe_every - 1) dense layers
    followed by one MoE layer — llama4-style alternation."""
    return {"dense": {i: dense_layer_leaves(cfg)
                      for i in range(cfg.moe_every - 1)},
            "moe": moe_layer_leaves(cfg)}


def moe_group_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return init_tree(generator, moe_group_leaves(cfg), dtype, device)


def moe_group_apply(cfg: ModelConfig, p: dict, x, positions, cache,
                    ctx: ModelCtx = DEFAULT_CTX):
    """``cache``: None, or the group's ``moe_every`` per-layer caches in
    order (its dense layers, then the MoE layer), updated in place. The
    reference nests them as ``{"dense": [...], "moe": ...}``."""
    n = cfg.moe_every - 1
    layer_caches = cache or [None] * (n + 1)
    for i in range(n):
        x, _, _ = dense_layer_apply(cfg, p["dense"][i], x, positions,
                                    layer_caches[i], ctx)
    x, _, aux = moe_layer_apply(cfg, p["moe"], x, positions,
                                layer_caches[n], ctx)
    return x, cache, aux


# ---------------------------------------------------------------------------
# xLSTM pair (mLSTM block + sLSTM block), each pre-norm residual
# ---------------------------------------------------------------------------

def xlstm_pair_leaves(cfg: ModelConfig) -> dict:
    return {"ln_m": Leaf((cfg.d_model,)), "ln_s": Leaf((cfg.d_model,)),
            "mlstm": ssm.mlstm_leaves(cfg.d_model, cfg.num_heads),
            "slstm": ssm.slstm_leaves(cfg.d_model, cfg.num_heads)}


def xlstm_pair_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return init_tree(generator, xlstm_pair_leaves(cfg), dtype, device)


def xlstm_pair_apply(cfg: ModelConfig, p: dict, x, positions, cache,
                     ctx: ModelCtx = DEFAULT_CTX):
    cache = cache or {"mlstm": None, "slstm": None}
    h, m_state = ssm.mlstm_apply(p["mlstm"], rms_norm(x, p["ln_m"]),
                                 num_heads=cfg.num_heads,
                                 chunk=cfg.scan_chunk, state=cache["mlstm"])
    x = x + h
    h, s_state = ssm.slstm_apply(p["slstm"], rms_norm(x, p["ln_s"]),
                                 num_heads=cfg.num_heads,
                                 state=cache["slstm"])
    x = x + h
    return x, {"mlstm": m_state, "slstm": s_state}, 0.0


def xlstm_init_cache(cfg: ModelConfig, p: dict, batch: int) -> dict:
    return {"mlstm": ssm.mlstm_init_state(p["mlstm"], batch, cfg.num_heads),
            "slstm": ssm.slstm_init_state(p["slstm"], batch, cfg.num_heads)}


# ---------------------------------------------------------------------------
# Zamba2 hybrid group: N mamba2 blocks + one SHARED attention block
# ---------------------------------------------------------------------------

def mamba_block_leaves(cfg: ModelConfig) -> dict:
    return {"ln": Leaf((cfg.d_model,)),
            "mamba": ssm.mamba2_leaves(cfg.d_model, cfg.ssm_state,
                                       expand=cfg.ssm_expand,
                                       head_dim=cfg.ssm_head_dim)}


def mamba_block_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return init_tree(generator, mamba_block_leaves(cfg), dtype, device)


def hybrid_group_leaves(cfg: ModelConfig) -> dict:
    """One group: ``blocks_per_attn`` mamba blocks (the reference's list,
    int keys here) and the norms feeding the SHARED attention + MLP block,
    whose leaves live outside the groups (Zamba2's parameter sharing)."""
    return {"mamba_blocks": {i: mamba_block_leaves(cfg)
                             for i in range(cfg.blocks_per_attn)},
            "ln_attn": Leaf((cfg.d_model,)), "ln_mlp": Leaf((cfg.d_model,))}


def hybrid_group_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return init_tree(generator, hybrid_group_leaves(cfg), dtype, device)


def hybrid_shared_leaves(cfg: ModelConfig) -> dict:
    return {"attn": attn_leaves(cfg),
            "mlp": mlp.mlp_leaves(cfg.d_model, cfg.d_ff)}


def hybrid_shared_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return init_tree(generator, hybrid_shared_leaves(cfg), dtype, device)


def hybrid_group_apply(cfg: ModelConfig, p: dict, shared: dict, x,
                       positions, cache, ctx: ModelCtx = DEFAULT_CTX):
    """``cache``: None, or {"mamba": [state per block], "attn": KV cache}
    (the attention cache updated in place)."""
    n = cfg.blocks_per_attn
    cache = cache or {"mamba": [None] * n, "attn": None}
    new_mamba = []
    for i in range(n):
        blk = p["mamba_blocks"][i]
        h, st = ssm.mamba2_apply(blk["mamba"], rms_norm(x, blk["ln"]),
                                 ssm_state=cfg.ssm_state,
                                 chunk=cfg.scan_chunk,
                                 state=cache["mamba"][i])
        x = x + h
        new_mamba.append(st)
    h, attn_cache = attn_apply(cfg, shared["attn"],
                               rms_norm(x, p["ln_attn"]), positions,
                               cache["attn"])
    x = x + h
    x = x + mlp.mlp_apply(shared["mlp"], rms_norm(x, p["ln_mlp"]))
    return x, {"mamba": new_mamba, "attn": attn_cache}, 0.0


def hybrid_init_cache(cfg: ModelConfig, p: dict, batch: int, max_len: int,
                      dtype) -> dict:
    return {"mamba": [ssm.mamba2_init_state(p["mamba_blocks"][i]["mamba"],
                                            batch, cfg.ssm_state)
                      for i in range(cfg.blocks_per_attn)],
            "attn": init_kv_cache(cfg, batch, max_len, dtype,
                                  p["ln_attn"].device)}


# ---------------------------------------------------------------------------
# Encoder layer (bidirectional) and decoder layer with cross attention
# ---------------------------------------------------------------------------

def encoder_layer_leaves(cfg: ModelConfig) -> dict:
    """The dense layer's leaves: pre-norm attention + SwiGLU MLP."""
    return dense_layer_leaves(cfg)


def encoder_layer_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional self attention (mode ``cross`` over the layer's own
    keys, rotary embedding at ``positions``) + MLP; no cache."""
    h, _ = attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]), positions,
                      None, mode="cross")
    x = x + h
    return x + mlp.mlp_apply(p["mlp"], rms_norm(x, p["ln2"]))


def decoder_xattn_layer_leaves(cfg: ModelConfig) -> dict:
    """Self attention, cross attention and MLP, each pre-norm (ln1, ln_x,
    ln2)."""
    return {"ln1": Leaf((cfg.d_model,)), "ln_x": Leaf((cfg.d_model,)),
            "ln2": Leaf((cfg.d_model,)), "attn": attn_leaves(cfg),
            "xattn": cross_attn_leaves(cfg),
            "mlp": mlp.mlp_leaves(cfg.d_model, cfg.d_ff)}


def decoder_xattn_layer_apply(cfg: ModelConfig, p: dict, x, positions, cache,
                              enc_kv: tuple, enc_pos: torch.Tensor,
                              ctx: ModelCtx = DEFAULT_CTX):
    """Causal self attention (its KV cache updated in place), cross
    attention into ``enc_kv`` at ``enc_pos``, MLP."""
    h, new_cache = attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]),
                              positions, cache)
    x = x + h
    x = x + cross_attn_apply(cfg, p["xattn"], rms_norm(x, p["ln_x"]),
                             enc_kv, enc_pos)
    x = x + mlp.mlp_apply(p["mlp"], rms_norm(x, p["ln2"]))
    return x, new_cache, 0.0
