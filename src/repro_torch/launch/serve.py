"""Batched serving driver: prefill a batch of prompts, then greedy decode
through the decode cache (counterpart of ``repro.launch.serve``): the KV
cache of the dense and MoE families; for xlstm and hybrid an O(1)
recurrent state per group, and the hybrid's shared attention's ring of
min(max_len, window) slots. vlm prefills its image patches before the
prompt (P more cache slots, decode positions from S + P); encdec encodes
its frame embeddings once for the decode steps' cross K/V (and, as in the
reference, once more inside ``prefill``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4_maverick_400b --layers 2 --batch 4 --prompt-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \\
      --batch 2 --prompt-len 4096 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless_m4t_medium --batch 8 --prompt-len 32 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2_26b \\
      --batch 4 --prompt-len 1024 --gen 16

``--device`` defaults to ``cuda`` and the run raises without a card.
``--layers`` cuts the depth (Llama-4-Maverick: one group of a dense and an
MoE layer, 18.6 B parameters, fits one 80 GB card). ``--ckpt`` serves the
weights of an npz written by the reference's
``repro.train.checkpoint.save``. The frontend inputs are drawn from the
run's generator as the reference's CLI shapes them: vlm patches
(B, num_prefix_tokens, frontend_dim), encdec frame embeddings
(B, prompt_len, frontend_dim).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.models.model import ModelApi, build_model


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, gen) greedy tokens, int64
    logits: torch.Tensor        # (B, gen, V) f32: prefill's, then each step's
    prefill_ms: float
    decode_ms: list             # one entry per decode step (gen - 1)
    cache: dict                 # the decode cache after the last step
    encode_ms: float | None = None   # encdec: encode + cross K/V, once
    decode_kw: dict = dataclasses.field(default_factory=dict)
    # what each decode step took besides the token (encdec: enc_kv, enc_pos)


class _Clock:
    """Per-interval milliseconds: CUDA events on the card (recorded on the
    stream, read once at the end, so the loop never waits for the host),
    the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def frontend_inputs(cfg, batch: int, enc_len: int, generator,
                    device) -> dict:
    """The family's frontend input, standard normal from ``generator``:
    vlm ``patches`` (B, num_prefix_tokens, frontend_dim), encdec
    ``enc_embeds`` (B, enc_len, frontend_dim) (the reference's CLI takes
    enc_len = the prompt's length); {} for the token-only families."""
    front = transformer.FRONTENDS.get(cfg.family)
    if front is None:
        return {}
    n = cfg.num_prefix_tokens if front.prefix else enc_len
    return {front.key: torch.randn((batch, n, cfg.frontend_dim),
                                   generator=generator, device=device)}


def serve(api: ModelApi, params, prompt: torch.Tensor, gen: int, *,
          device=None, feed: torch.Tensor | None = None,
          frontend: dict | None = None) -> ServeResult:
    """Prefill ``prompt`` (B, S) into a cache of P + S + gen slots, then
    run gen - 1 greedy decode steps from position P + S.

    ``device`` defaults to ``"cuda"`` (raises without a card unless
    ``device="cpu"``) and must be where ``params`` live. ``feed`` (B, >=
    gen - 1), when given, is the token fed at each decode step in place of
    the greedy one (teacher forcing); the greedy tokens are still returned.
    ``frontend`` holds the family's input beside the tokens: vlm
    ``{"patches": (B, P, frontend_dim)}`` (P = its length), encdec
    ``{"enc_embeds": (B, S_enc, frontend_dim)}``, which is encoded once
    (``encode_ms``) for the decode steps' cross K/V before the prefill.
    """
    dev = resolve(device)
    if params["embed"].device != dev:
        raise ValueError(f"serve: params are on {params['embed'].device}, "
                         f"want {dev}")
    if gen < 1:
        raise ValueError(f"serve: gen must be >= 1, got {gen}")
    frontend = {key: t.to(dev) for key, t in (frontend or {}).items()}
    want = transformer.FRONTENDS.get(api.cfg.family)
    if set(frontend) != ({want.key} if want else set()):
        raise ValueError(f"serve: family {api.cfg.family!r} takes frontend "
                         f"input {want.key if want else 'none'}, got "
                         f"{sorted(frontend)}")
    prompt = prompt.to(dev)
    b, s = prompt.shape
    # the first decode position
    s0 = transformer.prefix_len(api.cfg, frontend) + s
    cache = api.init_cache(params, b, s0 + gen)
    clock = _Clock(dev)
    decode_kw = {}
    with torch.no_grad():
        clock.mark()
        if api.encode is not None:
            enc_out, enc_pos = api.encode(params, frontend[want.key])
            decode_kw = {"enc_kv": transformer._enc_kv_all_layers(
                api.cfg, params, enc_out), "enc_pos": enc_pos}
            del enc_out
            clock.mark()
        logits, cache = api.prefill(params, {"tokens": prompt, **frontend},
                                    cache)
        clock.mark()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks, step_logits = [tok], [logits[:, -1]]
        for i in range(gen - 1):
            fed = tok if feed is None else feed[:, i:i + 1].to(dev)
            logits, cache = api.decode_step(params, fed, s0 + i, cache,
                                            **decode_kw)
            clock.mark()
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok)
            step_logits.append(logits[:, -1])
        times = clock.intervals_ms()
    encode_ms = times.pop(0) if api.encode is not None else None
    return ServeResult(tokens=torch.cat(toks, dim=1),
                       logits=torch.stack(step_logits, dim=1),
                       prefill_ms=times[0], decode_ms=times[1:],
                       cache=cache, encode_ms=encode_ms,
                       decode_kw=decode_kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    api = build_model(cfg, device=args.device)
    gen = torch.Generator(device=api.device).manual_seed(args.seed)
    if args.ckpt:
        params = convert.model_params_from_numpy(
            cfg, convert.load_checkpoint(args.ckpt), device=api.device)
    else:
        params = api.init(gen)
    b, s = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=api.device)
    frontend = frontend_inputs(cfg, b, s, gen, api.device)
    res = serve(api, params, prompt, args.gen, device=api.device,
                frontend=frontend)
    steps = max(args.gen - 1, 1)
    t_decode = sum(res.decode_ms)
    print(f"arch={cfg.name} batch={b} prompt={s} gen={args.gen} "
          f"device={api.device} layers={cfg.num_layers}")
    for key, t in frontend.items():
        print(f"{key}: {tuple(t.shape)}")
    if res.encode_ms is not None:
        print(f"encode:  {res.encode_ms:.1f} ms")
    print(f"prefill: {res.prefill_ms:.1f} ms "
          f"({b * s / res.prefill_ms * 1e3:.0f} tok/s)")
    print(f"decode:  {t_decode / steps:.2f} ms/step "
          f"({b * (args.gen - 1) / max(t_decode, 1e-9) * 1e3:.0f} tok/s)")
    print("sample tokens:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
