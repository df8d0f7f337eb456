"""COLA over torch.distributed ranks: K nodes laid over M processes, each
talking only to its graph neighbours, with no coordinator.

Each rank runs Algorithm 1 on its K/M nodes (the CUDA CD kernels on the
card); the gossip step goes over the compiled topology plan, one exchange
of a (K/M, d) block per color (``comm="plan"``), or over an all-gather
(``comm="dense"``). Rank 0 then runs the stacked ``run_cola`` on the same
inputs and prints the parity, the plan, and the bytes each rank sent per
round.

  python -m torch.distributed.run --nproc_per_node=M \\
      examples/torch_dist_cola.py [--device cpu] [--graph torus2d] \\
      [--nodes 16] [--comm plan] [--rounds 100]

with ``PYTHONPATH=src``. ``--device cpu`` runs on gloo (the kernels' plain
versions); the default, the card, runs on NCCL with one card per rank
(``LOCAL_RANK``). Without the launcher it runs one rank.
"""
import argparse
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import PROBLEMS, ColaConfig, run_cola
from repro_torch.data import synthetic
from repro_torch.dist import NodeAxis, run_dist_cola
from repro_torch.topo import build, compile_block_plan, compile_plan


def _init(device: str) -> str:
    """Initialise the default group from the launcher's environment (one
    rank without it); returns this rank's device."""
    backend = "gloo" if device == "cpu" else "nccl"
    if device != "cpu":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=300))
    if backend == "nccl":
        kw["device_id"] = torch.device(device)
    if "RANK" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group(init_method=f"file://{store}", rank=0,
                                world_size=1, **kw)
    return device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--graph", default="torus2d",
                    help="a repro_torch.topo.GRAPHS name")
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--comm", default="plan",
                    choices=("plan", "ring", "dense"))
    ap.add_argument("--rounds", type=int, default=100)
    args = ap.parse_args()
    device = _init(args.device)
    axis = NodeAxis()
    graph = build(args.graph, args.nodes)
    x, y, _ = synthetic.regression(1600, 400, seed=0, sparsity_solution=0.2)
    prob = PROBLEMS["lasso"](x, y, 5e-2, box=5.0, device=device)
    cfg = ColaConfig(kappa=4.0)
    kw = dict(record_every=10, recorder="gap+certificate", eps=0.05)
    res = run_dist_cola(prob, graph, cfg, axis, args.rounds, comm=args.comm,
                        device=device, **kw)
    sent = dict(axis.sent_bytes)
    # everything the run sent: the mix's exchanges, the recorders' and
    # the final gather of the result
    sent_all = torch.tensor([float(sum(sent.values()))], device=device)
    dist.all_reduce(sent_all, op=dist.ReduceOp.MAX)
    if axis.index == 0:
        h = res.history
        rounds = (args.rounds if h["stop_round"] is None
                  else h["stop_round"] + 1)
        ln = args.nodes // axis.size
        plan = (compile_plan(graph) if ln == 1
                else compile_block_plan(graph, axis.size))
        sim = run_cola(prob, graph, cfg, args.rounds, device=device, **kw)
        diff = float((res.state.v_stack - sim.state.v_stack).abs().max())
        if args.comm != "dense":
            print(plan.render(d=prob.d))
        print(f"ranks={axis.size} nodes/rank={ln} comm={args.comm} "
              f"({axis.backend}): stop round {h['stop_round']} "
              f"(run_cola: {sim.history['stop_round']}), gap "
              f"{h['gap'][-1]:.6f}, max |v - v_run_cola| {diff:.3e}")
        print(f"bytes sent per rank per round: exchanges "
              f"{sent.get('permute', 0) / rounds:,.0f}, all-gathers "
              f"{sent.get('all-gather', 0) / rounds:,.0f}, all-reduces "
              f"{sent.get('all-reduce', 0) / rounds:,.0f} (gossip budget "
              f"{plan.bytes_per_device_per_step(prob.d):,} a step); all "
              f"traffic, most on one rank: {sent_all.item():,.0f} B")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
