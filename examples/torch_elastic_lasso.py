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

``--wire int8|fp8|fp8_e5m2`` quantizes every gossip payload to one byte
per element plus a 4-byte fp32 scale per node (stochastic rounding, error
feedback unless ``--no-error-feedback``), and the run prints the bytes one
node sends per round on that wire beside the fp32 wire's.

With ``--telemetry`` the run carries the ``repro_torch.obs`` counters
(wire bytes and exchanges against the compiled plan's contract, the
codec's saturation and EF residual on a quantized wire) and prints the
totals; ``--report`` also appends a ``RunReport`` to the run registry
(``.repro_runs/`` or ``$REPRO_RUNS_DIR``) for ``python -m repro_torch.obs
show/diff/timeline``.

The reference example's ``--byzantine`` / ``--robust`` flags and its
comm-plan rendering are not in this example
(``examples/torch_attack_smoke.py`` runs the attacks and defenses).

  PYTHONPATH=src python examples/torch_elastic_lasso.py [--device cpu]
      [--topo torus] [--p-stay 0.8] [--eps 3.0] [--rounds 1500]
      [--leave-mode freeze] [--wire int8] [--no-error-feedback]
      [--telemetry] [--report]
"""
import argparse
import os

import numpy as np

from repro_torch import PROBLEMS, ColaConfig, run_cola, solve_reference
from repro_torch.core import metrics as metrics_lib, quant, \
    topology as topo
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
    ap.add_argument("--wire", default="fp32", choices=list(quant.WIRES),
                    help="gossip wire codec: 1-byte payloads + fp32 absmax "
                         "scales (default fp32)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the EF residual carry: shows the raw "
                         "quantization noise floor")
    ap.add_argument("--device", default="cuda",
                    help="where the run happens (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry the obs counters and print their totals")
    ap.add_argument("--report", action="store_true",
                    help="also append a RunReport to the run registry "
                         "(implies --telemetry)")
    args = ap.parse_args()
    telemetry = args.telemetry or args.report
    if telemetry and not args.report:
        # counters only: keep the registry untouched unless the user
        # already pointed REPRO_RUNS_DIR somewhere
        os.environ.setdefault("REPRO_RUNS_DIR", "off")

    x, y, _ = synthetic.regression(1500, 300, seed=1, sparsity_solution=0.1)
    prob = PROBLEMS["lasso"](x, y, 1e-3, device=args.device)
    opt = solve_reference(prob, rounds=500, kappa=8)
    graph = TOPOLOGIES[args.topo]()
    ef = not args.no_error_feedback
    # one gossip step per round (ColaConfig.gossip_steps = 1)
    print(f"wire={args.wire}: {quant.payload_bytes(prob.d, args.wire):,} B "
          f"per node per round ({quant.payload_bytes(prob.d, 'fp32'):,} B "
          "on fp32)" + (f", error feedback {'on' if ef else 'OFF'}"
                        if quant.is_quantized(args.wire) else ""))

    def churn(t, rng):
        return rng.random(NODES) < args.p_stay

    cadence = metrics_lib.AdaptiveCadence(base=1, max_every=64, grow=2,
                                          near=2.0)
    res = run_cola(prob, graph,
                   ColaConfig(kappa=2.0, wire=args.wire, error_feedback=ef,
                              telemetry=telemetry),
                   rounds=args.rounds,
                   record_every=cadence, recorder="gap+certificate",
                   eps=args.eps, active_schedule=churn,
                   leave_mode=args.leave_mode, device=args.device)
    h = res.history
    print(f"p_stay={args.p_stay} topo={graph.name} wire={args.wire} "
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

    if telemetry:
        tel = h["telemetry"]
        print(f"telemetry: {tel['rounds']} rounds moved "
              f"{tel['wire_bytes']:,} wire bytes "
              f"({tel['permutes']} exchanges) — contract: {tel['contract']}")
        if quant.is_quantized(args.wire):
            print(f"  codec: mean saturation {tel['saturation_mean']:.4f}, "
                  f"final EF residual norm {tel['ef_norm']:.4f}")
        if args.report:
            from repro_torch.obs import report as obs_report
            print(f"report appended to {obs_report.runs_file()} — inspect "
                  "with: python -m repro_torch.obs show -1 (or "
                  "diff/timeline)")


if __name__ == "__main__":
    main()
