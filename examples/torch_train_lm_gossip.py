"""End-to-end driver of the PyTorch port: train the ~125M-parameter xLSTM
on synthetic tokens — once with canonical all-reduce data parallelism,
once with CoLA-style gossip data parallelism (4 node replicas on a ring,
Metropolis parameter mixing, no global collective) — and compare the loss
and consensus trajectories (twin of ``examples/train_lm_gossip.py``).

Full size, on the card:
  PYTHONPATH=src python examples/torch_train_lm_gossip.py --steps 300
Quick demo (the reduced config), on the CPU:
  PYTHONPATH=src python examples/torch_train_lm_gossip.py --smoke \\
      --steps 30 --device cpu
"""
import argparse

from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.launch.train import gossip_train, train
from repro_torch.optim import gossip as gsp
from repro_torch.train.data import TokenBatches
from repro_torch.train.steps import TrainHParams


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("xlstm_125m")
    if args.smoke:
        cfg = smoke_variant(cfg)
    hp = TrainHParams(lr=1e-3)
    pipe = TokenBatches(cfg.vocab_size, args.batch, args.seq, seed=0)
    print(f"model: {cfg.name} ({'smoke' if args.smoke else 'full ~125M'}) "
          f"on {args.device}")
    log_every = max(args.steps // 10, 1)

    # baseline: one replica (the all-reduce data-parallel semantics)
    print("[all-reduce]")
    res = train(cfg, hp, pipe, args.steps, device=args.device,
                log_every=log_every)
    base_loss = float(res.metrics[-1]["loss"])
    print(f"[all-reduce] {sum(res.step_ms) / len(res.step_ms):.1f} ms/step")

    # CoLA gossip-DP: K replicas, ring mixing, node-local data
    k = args.nodes
    print(f"[gossip-DP ] {k} replicas on a ring")
    gres = gossip_train(cfg, hp, pipe,
                        gsp.GossipConfig(num_nodes=k, topology="ring"),
                        args.steps, device=args.device, log_every=log_every)
    ms = [a + b for a, b in zip(gres.local_ms, gres.mix_ms)]
    print(f"[gossip-DP ] {sum(ms) / len(ms):.1f} ms/round")
    print(f"\nfinal: all-reduce loss {base_loss:.4f} | gossip mean loss "
          f"{float(gres.metrics[-1]['loss'].mean()):.4f} (each gossip node "
          f"saw {k}x the data at 1/{k} the per-round collective cost)")


if __name__ == "__main__":
    main()
