"""Batched serving across architecture families on the port (the twin of
``examples/serve_batched.py``): prefill a batch of prompts and stream
greedy decode steps for a dense sliding-window model (H2O-Danube3), an
xLSTM and a hybrid (Zamba2), smoke variants, showing the ring-buffer KV
cache and the O(1) recurrent decode state.

  PYTHONPATH=src python examples/torch_serve_batched.py
  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Runs on the card unless ``--device cpu`` is given (without a card it
raises). Prints, per architecture, the prefill ms, the decode ms per token
(CUDA events on the card) and the decode state's MB.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.device import resolve
from repro_torch.dist.sharding import tree_leaves
from repro_torch.launch.serve import serve
from repro_torch.models.model import build_model

ARCHS = ("h2o_danube3_4b", "xlstm_125m", "zamba2_7b")


def serve_arch(arch: str, *, batch: int = 4, prompt_len: int = 32,
               gen: int = 16, device=None, params=None, prompt=None,
               seed: int = 0) -> dict:
    """Serve ``arch``'s smoke variant once: weights and prompt drawn from
    ``seed`` unless given. Returns the greedy tokens (B, gen), the logits
    (B, gen, V), prefill ms, decode ms per token and the decode state's
    bytes."""
    dev = resolve(device)
    cfg = smoke_variant(get_config(arch))
    api = build_model(cfg, device=dev)
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = api.init(gen_)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen_, device=dev)
    res = serve(api, params, prompt.to(dev), gen, device=dev)
    return {"arch": arch, "family": cfg.family, "tokens": res.tokens,
            "logits": res.logits, "prefill_ms": res.prefill_ms,
            "decode_ms_per_token": (sum(res.decode_ms)
                                    / max(len(res.decode_ms), 1)),
            "decode_state_bytes": sum(t.numel() * t.element_size()
                                      for t in tree_leaves(res.cache))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", action="append", default=None,
                    help="an architecture (repeatable; default the three)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    for arch in args.arch or ARCHS:
        r = serve_arch(arch, batch=args.batch, prompt_len=args.prompt_len,
                       gen=args.gen, device=args.device)
        print(f"{arch:18s} [{r['family']:6s}] prefill "
              f"{r['prefill_ms']:7.1f} ms | decode "
              f"{r['decode_ms_per_token']:6.1f} ms/tok | decode-state "
              f"{r['decode_state_bytes'] / 1e6:6.2f} MB", flush=True)


if __name__ == "__main__":
    main()
