"""Batched serving driver: prefill a batch of prompts, then greedy decode
through the KV cache (counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --smoke --device cpu

``--device`` defaults to ``cuda`` and the run raises without a card.
``--ckpt`` serves the weights of an npz written by the reference's
``repro.train.checkpoint.save``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.device import resolve
from repro_torch.models.model import ModelApi, build_model


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, gen) greedy tokens, int64
    logits: torch.Tensor        # (B, gen, V) f32: prefill's, then each step's
    prefill_ms: float
    decode_ms: list             # one entry per decode step (gen - 1)
    cache: dict                 # the KV cache after the last step


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


def serve(api: ModelApi, params, prompt: torch.Tensor, gen: int, *,
          device=None, feed: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``prompt`` (B, S) into a cache of S + gen slots, then run
    gen - 1 greedy decode steps.

    ``device`` defaults to ``"cuda"`` (raises without a card unless
    ``device="cpu"``) and must be where ``params`` live. ``feed`` (B, >=
    gen - 1), when given, is the token fed at each decode step in place of
    the greedy one (teacher forcing); the greedy tokens are still returned.
    """
    dev = resolve(device)
    if params.embed.device != dev:
        raise ValueError(f"serve: params are on {params.embed.device}, "
                         f"want {dev}")
    if gen < 1:
        raise ValueError(f"serve: gen must be >= 1, got {gen}")
    prompt = prompt.to(dev)
    b, s = prompt.shape
    cache = api.init_cache(params, b, s + gen)
    clock = _Clock(dev)
    with torch.no_grad():
        clock.mark()
        logits, cache = api.prefill(params, {"tokens": prompt}, cache)
        clock.mark()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks, step_logits = [tok], [logits[:, -1]]
        for i in range(gen - 1):
            fed = tok if feed is None else feed[:, i:i + 1].to(dev)
            logits, cache = api.decode_step(params, fed, s + i, cache)
            clock.mark()
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok)
            step_logits.append(logits[:, -1])
        times = clock.intervals_ms()
    return ServeResult(tokens=torch.cat(toks, dim=1),
                       logits=torch.stack(step_logits, dim=1),
                       prefill_ms=times[0], decode_ms=times[1:],
                       cache=cache)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
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
    res = serve(api, params, prompt, args.gen, device=api.device)
    steps = max(args.gen - 1, 1)
    t_decode = sum(res.decode_ms)
    print(f"arch={cfg.name} batch={b} prompt={s} gen={args.gen} "
          f"device={api.device}")
    print(f"prefill: {res.prefill_ms:.1f} ms "
          f"({b * s / res.prefill_ms * 1e3:.0f} tok/s)")
    print(f"decode:  {t_decode / steps:.2f} ms/step "
          f"({b * (args.gen - 1) / max(t_decode, 1e-9) * 1e3:.0f} tok/s)")
    print("sample tokens:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
