"""Quickstart on the PyTorch port: decentralized ridge regression with CoLA
(Algorithm 1), then a lasso that stops itself by certificate.

16 nodes on a ring, no central coordinator, parameter-free defaults
(gamma = 1, sigma' = K). Prints the decentralized duality gap + consensus
violation per round, then runs a lasso with CERTIFICATE-DRIVEN stopping:
``eps=`` arms the Prop.-1 local certificates — each node certifies the
GLOBAL duality gap from its own neighborhood only, and the run stops at
the first record round where every node passes, instead of burning a
fixed round budget. The local solves run through the port's CUDA CD
kernels on the card (``--device cuda``, the default) and through their
plain PyTorch version with ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch import PROBLEMS, ColaConfig, run_cola
from repro_torch.core import topology as topo
from repro_torch.data import synthetic


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the runs happen (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args()

    # data: dense synthetic regression, columns (features) spread over nodes
    x, y, _ = synthetic.regression(2000, 400, seed=0)
    prob = PROBLEMS["ridge_primal"](x, y, 1e-4, device=args.device)

    graph = topo.ring(16)
    w = topo.metropolis_weights(graph)
    print(f"ring of {graph.num_nodes}: beta={topo.beta(w):.4f} "
          f"(spectral gap {topo.spectral_gap(w):.4f})")

    res = run_cola(prob, graph, ColaConfig(kappa=2.0), rounds=200,
                   record_every=25, device=args.device)
    for t, p, g, cv in zip(res.history["round"], res.history["primal"],
                           res.history["gap"],
                           res.history["consensus_violation"]):
        print(f"round {t:4d}  F_A={p:10.4f}  gap={g:10.4f}  "
              f"consensus-violation={cv:.3e}")

    # Prop. 1 requires L-bounded support of g_i (lasso-type); certify a
    # lasso run — each node checks the GLOBAL gap from local quantities
    # (one gossip exchange of neighbor gradients), and the driver stops at
    # certification. Condition 10 is conservative by the worst-case factor
    # sqrt(K sum n_k^2 sigma_k)/(1-beta), so it fires once the run is well
    # past the target accuracy.
    lx, ly, _ = synthetic.regression(800, 96, seed=3, sparsity_solution=0.2)
    lprob = PROBLEMS["lasso"](lx, ly, 5e-2, box=5.0, device=args.device)
    eps = 0.1
    budget = 4000
    lres = run_cola(lprob, graph, ColaConfig(kappa=8.0), rounds=budget,
                    record_every=50, recorder="gap+certificate", eps=eps,
                    device=args.device)
    h = lres.history
    stopped = h["stop_round"]
    if stopped is None:
        print(f"\nlasso, eps={eps}: budget of {budget} rounds exhausted "
              f"without certification (gap {h['gap'][-1]:.6f}, condition 9 "
              f"on {int(h['cond9_nodes'][-1])}/16 nodes, condition 10 on "
              f"{int(h['cond10_nodes'][-1])}/16)")
        return
    print(f"\nlasso, eps={eps}: certified at round {stopped} "
          f"(budget {budget}; {len(h['round'])} record rounds kept)")
    print(f"  true gap at certification: {h['gap'][-1]:.6f} <= eps"
          f"  (condition 9 on {int(h['cond9_nodes'][-1])}/16 nodes, "
          f"condition 10 on {int(h['cond10_nodes'][-1])}/16)")


if __name__ == "__main__":
    main()
