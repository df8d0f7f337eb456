"""Public model API: ``build_model(cfg) -> ModelApi`` with
init/forward/prefill/decode (counterpart of ``repro.models.model``)."""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable             # (generator=None) -> params {name: tensor}
    forward: Callable          # (params, batch, ctx=) -> (logits, aux)
    init_cache: Callable       # (params, batch_size, max_len) -> cache
    prefill: Callable          # (params, batch, cache, ctx=) -> (logits, cache)
    decode_step: Callable      # (params, tokens, t, cache, ...) -> (logits, cache)
    encode: Callable | None    # encdec only: (params, enc_embeds) -> (out, pos)
    param_count: Callable


def build_model(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None) -> ModelApi:
    """The model API on ``device`` (default ``"cuda"``; raises without a
    card unless ``device="cpu"`` is asked for). ``api.init()`` draws the
    weights, the flat dict of ``transformer.param_paths`` in ``cfg.dtype``,
    from ``generator`` (default: a generator on ``device`` seeded with 0);
    ``api.init(g)`` from another one."""
    dev = resolve(device)
    transformer._require_ported(cfg)

    def init(gen: torch.Generator | None = None):
        gen = gen or generator
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        return transformer.init_params(cfg, gen, dev)

    return ModelApi(
        cfg=cfg,
        device=dev,
        init=init,
        forward=partial(transformer.forward, cfg),
        init_cache=partial(transformer.init_cache, cfg),
        prefill=partial(transformer.prefill, cfg),
        decode_step=partial(transformer.decode_step, cfg),
        encode=(partial(transformer.encode, cfg)
                if cfg.family == "encdec" else None),
        param_count=transformer.param_count,
    )
