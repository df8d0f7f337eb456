"""Stand-ins for every model input, state and cache on the ``meta``
device (counterpart of ``repro.launch.specs``, whose
``ShapeDtypeStruct``s come from ``jax.eval_shape``).

A ``meta`` tensor has a shape and a dtype and no storage: nothing is
allocated and nothing is drawn, so Llama-4-Maverick's 400 B parameters are
described at once. The dtypes are the reference's: int32 tokens and
labels, bf16 ``patches`` / ``enc_embeds``; parameters in
``cfg.param_dtype`` except the leaves the reference keeps in fp32 (norm
gains, biases and other vectors it builds with ``jnp.zeros`` / ``ones``,
and the MoE router).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.train.steps import TrainHParams, TrainState, _optimizer

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The input batch of one step of this (arch, shape) pair."""
    b = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    s = shape.seq_len
    if cfg.family == "vlm":
        # patches occupy part of the context; text fills the rest
        s = max(1, s - cfg.num_prefix_tokens)
        batch = {"tokens": _meta((b, s), torch.int32),
                 "patches": _meta((b, cfg.num_prefix_tokens,
                                   cfg.frontend_dim), torch.bfloat16)}
    elif cfg.family == "encdec":
        # frames of the stubbed audio frontend, same length budget
        batch = {"tokens": _meta((b, s), torch.int32),
                 "enc_embeds": _meta((b, s, cfg.frontend_dim),
                                     torch.bfloat16)}
    else:
        batch = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta(tuple(batch["tokens"].shape), torch.int32)
    return batch


def _keeps_fp32(name: str, leaf) -> bool:
    return leaf.init not in ("dense", "embed") or name.endswith(".router")


def params_specs(cfg: ModelConfig) -> dict:
    """The flat parameter dict on ``meta`` (``transformer.param_paths``
    order) in the reference's dtypes."""
    dtype = getattr(torch, cfg.param_dtype)
    params = transformer.init_params(cfg, None, META, dtype=dtype)
    leaves = transformer.param_leaves(cfg)
    return {name: (t.to(torch.float32) if _keeps_fp32(name, leaves[name])
                   else t) for name, t in params.items()}


def state_specs(cfg: ModelConfig, hp: TrainHParams = TrainHParams()
                ) -> TrainState:
    """The train state on ``meta``: masters, AdamW moments in
    ``hp.state_dtype``, the int32 step."""
    params = params_specs(cfg)
    return TrainState(params=params, opt_state=_optimizer(hp).init(params),
                      step=_meta((), torch.int32))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache on ``meta`` (``transformer.init_cache``)."""
    return transformer.init_cache(cfg, params_specs(cfg), batch, max_len)


def param_bytes(tree) -> int:
    from repro_torch.dist.sharding import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
