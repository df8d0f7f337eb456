"""Training driver of every family (counterpart of
``repro.launch.train``). Two modes:

  * all-reduce data-parallel training (one replica here: ``train``);
  * ``--gossip K``: gossip data-parallelism, K replicas taking local AdamW
    steps and mixing parameters over a graph instead of an all-reduce of
    gradients, with node dropout (``--drop-p``) and local steps between
    mixes (``--mix-every``) (``gossip_train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --device cpu --gossip 4 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m \\
      --smoke --device cpu --steps 5

``--device`` defaults to ``cuda`` and the run raises without a card.
The token pipeline (``train.data.TokenBatches``) makes no frontend input,
so ``train`` and ``gossip_train`` raise a ``ValueError`` naming the input
an encdec or vlm model needs (``enc_embeds``, ``patches``) when a batch
lacks it: those train on a pipe whose batches carry it.
``--ckpt`` writes the parameters (gossip: their node average) as an npz
keyed like the reference's checkpoints. Step times are CUDA events on the
card (the loop never waits for the device except to log), the host clock
on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.device import resolve
from repro_torch.launch.serve import _Clock
from repro_torch.models.transformer import FRONTENDS
from repro_torch.optim import gossip as gsp
from repro_torch.optim.privacy import DPConfig
from repro_torch.train import checkpoint
from repro_torch.train.data import TokenBatches
from repro_torch.train.steps import (TrainHParams, init_train_state,
                                     make_train_step)


@dataclasses.dataclass
class TrainResult:
    state: object
    metrics: list       # per step: {name: 0-d device tensor}
    step_ms: list       # per step


@dataclasses.dataclass
class GossipResult:
    states: object      # the (K, ...)-stacked TrainState
    metrics: list       # per round: {name: (K,) device tensor}
    local_ms: list      # per round: every node's local step
    mix_ms: list        # per round: the mix (0 work on a round not mixed)
    consensus: list     # per round: 0-d device tensor
    active: list        # per round: (K,) bool numpy


def to_device(batch: dict, dev: torch.device) -> dict:
    """Host arrays as tensors on ``dev``; on the card through pinned
    memory and an asynchronous copy, so the host does not wait for the
    work already queued."""
    if dev.type != "cuda":
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .to(dev, non_blocking=True) for k, v in batch.items()}


def _check_frontend(cfg, batch: dict) -> None:
    """An encdec or vlm batch carries its frontend input beside the
    tokens; the token pipeline makes none."""
    front = FRONTENDS.get(cfg.family)
    if front is not None and front.key not in batch:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family needs {front.key!r} "
            "beside the tokens, which the token pipeline does not make; "
            f"train it on a pipe whose batches hold {front.key!r}")


def train(cfg, hp: TrainHParams, pipe: TokenBatches, steps: int, *,
          device=None, seed: int = 0, log_every: int = 0,
          state=None) -> TrainResult:
    """``steps`` all-reduce train steps on ``pipe``'s batches from a state
    drawn with ``seed`` (or ``state``); logs every ``log_every`` steps
    (0: never, and the host never waits for the device)."""
    dev = resolve(device)
    if state is None:
        state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(seed), hp,
            device=dev)
    step_fn = make_train_step(cfg, hp)
    clock = _Clock(dev)
    clock.mark()
    metrics = []
    for i in range(steps):
        batch = pipe(i)
        _check_frontend(cfg, batch)
        state, m = step_fn(state, to_device(batch, dev))
        clock.mark()
        metrics.append(m)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"ce {float(m['ce']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)
    return TrainResult(state=state, metrics=metrics,
                       step_ms=clock.intervals_ms())


def gossip_train(cfg, hp: TrainHParams, pipe: TokenBatches,
                 gcfg: gsp.GossipConfig, rounds: int, *, device=None,
                 seed: int = 0, drop_p: float = 0.0,
                 dp: DPConfig | None = None, log_every: int = 0,
                 states=None) -> GossipResult:
    """``rounds`` gossip rounds (the reference's ``run_gossip``): node j
    trains on shard j of the stream; with ``drop_p`` each node sits out a
    round with that probability (W re-weighted over the rest, from
    ``seed``); the mix runs when ``round % mix_every == 0``."""
    dev = resolve(device)
    k = gcfg.num_nodes
    if states is None:
        state0 = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(seed), hp,
            device=dev)
        states = gsp.replicate_state(state0, k)
        del state0
    step_fn = gsp.make_gossip_step(make_train_step(cfg, hp), gcfg, dp=dp)
    rng = np.random.default_rng(seed)
    w_full = torch.tensor(gcfg.weights(), dtype=torch.float32, device=dev)
    ones = torch.ones((k,), dtype=torch.float32, device=dev)
    clock = _Clock(dev)
    res = GossipResult(states, [], [], [], [], [])
    for i in range(rounds):
        if drop_p > 0:
            active_np = rng.random(k) >= drop_p
            if not active_np.any():
                active_np[:] = True
            w = torch.tensor(gcfg.weights(active_np), dtype=torch.float32,
                             device=dev)
            act = torch.tensor(active_np, dtype=torch.float32, device=dev)
        else:
            active_np, w, act = np.ones(k, bool), w_full, ones
        shards = [pipe(i, shard=j) for j in range(k)]
        _check_frontend(cfg, shards[0])
        batches = to_device({key: np.stack([b[key] for b in shards])
                             for key in shards[0]}, dev)
        do_mix = i % gcfg.mix_every == 0
        clock.mark()
        metrics = gsp._local_steps(step_fn.local_step, states, batches, act,
                                   None)
        clock.mark()
        if do_mix:
            step_fn.mix_(w, states.params, i)
        clock.mark()
        res.metrics.append(metrics)
        res.active.append(active_np)
        res.consensus.append(gsp.consensus_distance(states.params))
        if log_every and (i % log_every == 0 or i == rounds - 1):
            print(f"round {i:5d}  mean-loss "
                  f"{float(metrics['loss'].mean()):.4f}  consensus-dist "
                  f"{float(res.consensus[-1]):.3e}  active "
                  f"{int(active_np.sum())}/{k}", flush=True)
    ms = clock.intervals_ms()
    res.local_ms, res.mix_ms = ms[0::3], ms[1::3]
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gossip", type=int, default=0,
                    help="number of gossip-DP nodes (0 = all-reduce DP)")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--drop-p", type=float, default=0.0,
                    help="per-round node dropout probability (gossip mode)")
    ap.add_argument("--mix-every", type=int, default=1,
                    help="local steps between gossip rounds (gossip mode)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    hp = TrainHParams(lr=args.lr)
    pipe = TokenBatches(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    if args.gossip:
        gcfg = gsp.GossipConfig(num_nodes=args.gossip,
                                topology=args.topology,
                                mix_every=args.mix_every)
        res = gossip_train(cfg, hp, pipe, gcfg, args.steps, device=dev,
                           seed=args.seed, drop_p=args.drop_p,
                           log_every=args.log_every)
        ms = [a + b for a, b in zip(res.local_ms, res.mix_ms)]
        print(f"{sum(ms) / len(ms):.1f} ms/round on {dev}")
        if args.ckpt:
            checkpoint.save(args.ckpt,
                            gsp.average_params(res.states.params))
            print(f"saved consensus-averaged params -> {args.ckpt}")
        return
    res = train(cfg, hp, pipe, args.steps, device=dev, seed=args.seed,
                log_every=args.log_every)
    print(f"{sum(res.step_ms) / len(res.step_ms):.1f} ms/step on {dev}")
    if args.ckpt:
        checkpoint.save(args.ckpt, res.state.params)
        print(f"saved params -> {args.ckpt}")


if __name__ == "__main__":
    main()
