"""Training and serving steps of every family: dense, MoE, xlstm, hybrid,
encdec and vlm (counterpart of ``repro.train.steps``).

``make_train_step`` builds the canonical data-parallel step: forward (+ the
MoE load-balance aux loss), backward, global-norm clip, AdamW. The state is a ``TrainState`` of flat
dicts in the reference's layout (``transformer.param_paths``: fp32
masters, layer leaves stacked) and a 0-d int32 step counter on the device.
The step updates the state IN PLACE and returns it, and it never reads a
value back to the host: the loss, the norm and the bias correction stay on
the device.

``make_prefill_step`` / ``make_decode_step`` / ``greedy_generate`` are
thin wrappers over the serve path; they take a serving dict or the masters
of a ``TrainState``. ``greedy_generate`` feeds tokens only, as the
reference's does (``launch.serve.serve`` takes the frontend inputs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.models.blocks import DEFAULT_CTX, ModelCtx
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.optim.optimizers import (Optimizer, adamw, clip_scale,
                                          global_norm)


class TrainState(NamedTuple):
    params: Any        # {name: tensor}, ``transformer.param_paths`` order
    opt_state: Any     # {"m": {...}, "v": {...}} (AdamW)
    step: torch.Tensor  # 0-d int32 on the device; (K,) stacked


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    grad_clip: float = 1.0
    aux_weight: float = 0.01     # MoE load-balance loss weight
    weight_decay: float = 0.01
    state_dtype: str = "float32"  # optimizer moment dtype
    microbatches: int = 1        # gradient-accumulation chunks per step


def _optimizer(hp: TrainHParams) -> Optimizer:
    return adamw(weight_decay=hp.weight_decay,
                 state_dtype=getattr(torch, hp.state_dtype))


def init_train_state(cfg: ModelConfig, generator: torch.Generator | None,
                     hp: TrainHParams = TrainHParams(), *,
                     device=None) -> TrainState:
    """Masters drawn from ``generator`` in ``cfg.param_dtype`` on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``), zero moments, step 0."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, generator, dev,
                                     dtype=getattr(torch, cfg.param_dtype))
    return TrainState(params=params, opt_state=_optimizer(hp).init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _model(cfg: ModelConfig, params: dict) -> dict:
    """The parameter dict cast to ``cfg.dtype`` (differentiable; the same
    tensors where the dtypes agree, as for a serving dict). Every float
    leaf is cast, the MoE router too, as the reference's ``compute_cast``:
    in a bf16 run the router's gradient reaches its fp32 master through a
    bf16 round."""
    dtype = getattr(torch, cfg.dtype)
    return {name: (t.to(dtype) if t.is_floating_point() else t)
            for name, t in params.items()}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, ctx: ModelCtx,
            aux_weight: float):
    """Next-token cross entropy + ``aux_weight`` x the MoE layers' summed
    load-balance terms, over the dict of masters cast to ``cfg.dtype``
    differentiably. Only the text is scored: the last S_text positions of
    the logits (vlm's patch positions precede it). Without ``labels`` in
    ``batch`` the labels are the tokens shifted by one and the last
    position is masked out. Returns (loss, (ce, aux))."""
    logits, aux = transformer.forward(cfg, _model(cfg, params), batch, ctx)
    tokens = batch["tokens"]
    logits = logits[:, -tokens.shape[1]:]
    labels = batch.get("labels")
    mask = None
    if labels is None:
        labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
    ce = softmax_cross_entropy(logits, labels, mask)
    return ce + aux_weight * aux, (ce, aux)


def _chunk(batch: dict, m: int, j: int) -> dict:
    return {key: torch.chunk(val, m, dim=0)[j] for key, val in batch.items()}


def make_train_step(cfg: ModelConfig, hp: TrainHParams = TrainHParams(),
                    ctx: ModelCtx = DEFAULT_CTX) -> Callable:
    """``train_step(state, batch, commit=None) -> (state, metrics)``: the
    canonical all-reduce DP step, in place. ``batch``: {"tokens" (B, S)
    int, optional "labels", and vlm's "patches" (B, P, frontend_dim) or
    encdec's "enc_embeds" (B, S_enc, frontend_dim)} tensors on the
    state's device; a microbatch takes the same rows of each. With
    ``microbatches`` m > 1 the gradients of m equal row chunks are summed
    in fp32 and divided by m, and so are loss, ce and aux; each chunk's
    MoE layers size their capacity from the chunk's own tokens, as the
    reference's chunks do. ``commit`` (0-d bool tensor) keeps the state
    unchanged where False (the step still runs; its metrics are
    returned). Metrics: loss, ce, aux, grad_norm (0-d device tensors)."""
    opt = _optimizer(hp)

    def train_step(state: TrainState, batch: dict, commit=None):
        # leaves that require grad, sharing the masters' storage
        req = {name: t.detach().requires_grad_()
               for name, t in state.params.items()}
        flat = list(req.values())
        m = hp.microbatches
        grads = loss = ce = aux = None
        for j in range(m):
            mb = batch if m == 1 else _chunk(batch, m, j)
            l_j, (ce_j, aux_j) = loss_fn(cfg, req, mb, ctx, hp.aux_weight)
            g_j = torch.autograd.grad(l_j, flat)
            if grads is None:
                grads, loss, ce, aux = (list(g_j), l_j.detach(),
                                        ce_j.detach(), aux_j.detach())
            else:
                for acc, g in zip(grads, g_j):
                    acc += g
                loss, ce, aux = (loss + l_j.detach(), ce + ce_j.detach(),
                                 aux + aux_j.detach())
        if m > 1:
            grads = [g / m for g in grads]
            loss, ce, aux = loss / m, ce / m, aux / m
        grads = dict(zip(req, grads))
        del req, flat
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, hp.grad_clip)
        for g in grads.values():
            g.mul_(scale.to(g.dtype))
        opt.update(grads, state.opt_state, state.params, state.step, hp.lr,
                   commit)
        state.step.add_(1 if commit is None else commit.to(torch.int32))
        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm}
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig,
                      ctx: ModelCtx = DEFAULT_CTX) -> Callable:
    """(params, batch, cache) -> (last_logits, cache)."""
    def prefill_step(params, batch, cache):
        with torch.no_grad():
            return transformer.prefill(cfg, _model(cfg, params), batch,
                                       cache, ctx)
    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     ctx: ModelCtx = DEFAULT_CTX) -> Callable:
    """(params, tokens (B, 1), t, cache, **kw) -> (logits, cache): one
    token against the cache (encdec: ``enc_kv=``, ``enc_pos=``)."""
    def decode_step(params, tokens, t, cache, **kw):
        with torch.no_grad():
            return transformer.decode_step(cfg, _model(cfg, params), tokens,
                                           t, cache, ctx=ctx, **kw)
    return decode_step


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    num_steps: int, max_len: int,
                    ctx: ModelCtx = DEFAULT_CTX) -> torch.Tensor:
    """Greedy tokens (B, num_steps) after ``prompt`` (B, S)."""
    model = _model(cfg, params)
    b, s = prompt.shape
    with torch.no_grad():
        cache = transformer.init_cache(cfg, model, b, max_len)
        logits, cache = transformer.prefill(cfg, model, {"tokens": prompt},
                                            cache, ctx)
        out = [torch.argmax(logits[:, -1], dim=-1)]
        for i in range(num_steps - 1):
            logits, cache = transformer.decode_step(
                cfg, model, out[-1][:, None], s + i, cache, ctx=ctx)
            out.append(torch.argmax(logits[:, -1], dim=-1))
    return torch.stack(out, dim=1)
