"""Elastic decentralized LASSO on the PyTorch port: nodes drop out and
re-join mid-training, and the run stops itself by Prop.-1 certification.

The Fig.-4 fault-tolerance setting in miniature: every round each node
stays in the network with probability ``--p-stay``; the surviving nodes
re-normalize the Metropolis weights over the active subgraph. A leaver
freezes its block (``--leave-mode freeze``, Theta_k = 1) or resets it
(``--leave-mode reset``, App. D Fig. 6: x_[k] zeroed and every estimate
adjusted so the Lemma-1 mean invariant still holds). Instead of a fixed
round count, ``--eps`` arms the local certificates, judged on each round's
reweighted exchange: the run terminates at the first record round where
every node certifies the global duality gap from its own neighborhood,
churn and all. Recording runs on the adaptive cadence: geometric back-off
while far from eps, every round near certification. The local solves run
through the port's CUDA CD kernels on the card (``--device cuda``, the
default) and through their plain PyTorch version with ``--device cpu``.

The reference example's other flags come with later parts of the port
(ROADMAP queue 1): ``--byzantine`` and ``--robust`` with item 11 (attacks
and robust mixing), ``--wire`` and ``--no-error-feedback`` with item 9 (the
quantized wire), ``--telemetry`` and ``--report`` with item 15
(observability).

  PYTHONPATH=src python examples/torch_elastic_lasso.py [--device cpu]
      [--topo torus] [--p-stay 0.8] [--eps 3.0] [--rounds 1500]
      [--leave-mode freeze]
"""
import argparse

import numpy as np

from repro_torch import PROBLEMS, ColaConfig, run_cola, solve_reference
from repro_torch.core import metrics as metrics_lib, topology as topo
from repro_torch.data import synthetic

NODES = 16
# the reference registry's names, built at K = 16 (4 x 4 for the grids)
TOPOLOGIES = {
    "ring": lambda: topo.ring(NODES),
    "cycle2": lambda: topo.connected_cycle(NODES, 2),
    "cycle3": lambda: topo.connected_cycle(NODES, 3),
    "grid": lambda: topo.grid_2d(4, 4),
    "torus": lambda: topo.torus_2d(4, 4),
    "complete": lambda: topo.complete(NODES),
    "star": lambda: topo.star(NODES),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p-stay", type=float, default=0.8)
    ap.add_argument("--eps", type=float, default=3.0,
                    help="certified duality-gap target (stops the run)")
    ap.add_argument("--rounds", type=int, default=1500,
                    help="round budget: max rounds if certification "
                         "never fires")
    ap.add_argument("--leave-mode", default="freeze",
                    choices=["freeze", "reset"],
                    help="what a leaving node does with its block")
    ap.add_argument("--topo", default="torus", choices=sorted(TOPOLOGIES),
                    help="gossip graph over the 16 nodes")
    ap.add_argument("--device", default="cuda",
                    help="where the run happens (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args()

    x, y, _ = synthetic.regression(1500, 300, seed=1, sparsity_solution=0.1)
    prob = PROBLEMS["lasso"](x, y, 1e-3, device=args.device)
    opt = solve_reference(prob, rounds=500, kappa=8)
    graph = TOPOLOGIES[args.topo]()

    def churn(t, rng):
        return rng.random(NODES) < args.p_stay

    cadence = metrics_lib.AdaptiveCadence(base=1, max_every=64, grow=2,
                                          near=2.0)
    res = run_cola(prob, graph, ColaConfig(kappa=2.0), rounds=args.rounds,
                   record_every=cadence, recorder="gap+certificate",
                   eps=args.eps, active_schedule=churn,
                   leave_mode=args.leave_mode, device=args.device)
    h = res.history
    print(f"p_stay={args.p_stay} topo={graph.name} "
          f"leave_mode={args.leave_mode}: suboptimality trajectory "
          "(adaptive record cadence)")
    for t, p in zip(h["round"][::5], h["primal"][::5]):
        print(f"  round {t:4d}  F_A - F* = {p - opt:10.6f}")
    print(f"recorded {len(h['round'])} rows over {h['round'][-1] + 1} rounds"
          f" (fixed record_every=20 would have recorded "
          f"{(h['round'][-1] // 20) + 1})")
    if h["stop_round"] is not None:
        print(f"certified eps={args.eps} at round {h['stop_round']} "
              f"(true gap {h['gap'][-1]:.4f}) — stopped "
              f"{args.rounds - h['stop_round'] - 1} rounds early")
    else:
        print(f"budget exhausted before certifying eps={args.eps} "
              f"(gap {h['gap'][-1]:.4f})")

    x_final = res.state.x_parts.reshape(-1)[: prob.n].cpu().numpy()
    nnz = int(np.sum(np.abs(x_final) > 1e-6))
    print(f"solution sparsity: {nnz}/{prob.n} nonzeros")


if __name__ == "__main__":
    main()
