"""``repro_torch.topo`` — the topology-program compiler.

A gossip round on any sparse doubly-stochastic W (time-varying and
churn-reweighted included) as a compiled program:

  support graph --edge-color--> matchings --lower--> point-to-point
                                                  exchanges + per-round
                                                  coefficients

``compile_plan`` builds a ``CommPlan`` (one node per rank; at most
Delta + 1 colors, ``coloring.edge_coloring``); ``compile_block_plan``
lowers K nodes onto M < K ranks (``BlockPlan``); ``PlanSchedule`` /
``BlockPlanSchedule`` materialize per-round weights into schedule arrays;
``lowering`` holds the bodies ``repro_torch.dist.runtime`` runs under
``comm="plan"`` (fp32, attacked, quantized and robust forms);
``graphs.GRAPHS`` registers the graph families by name.
"""
from repro_torch.topo import coloring, graphs, lowering, plan  # noqa: F401
from repro_torch.topo.coloring import (check_coloring, edge_coloring,
                                       greedy_edge_coloring,
                                       misra_gries_edge_coloring,
                                       undirected_edges)
from repro_torch.topo.graphs import (GRAPHS, build, expander, hypercube,
                                     random_geometric)
from repro_torch.topo.lowering import (block_gather_neighbors,
                                       block_gather_neighbors_q,
                                       block_mix_step, block_mix_steps,
                                       block_mix_steps_wire,
                                       block_neighborhood_stats,
                                       block_qmix_steps,
                                       block_robust_mix_step,
                                       block_robust_mix_steps,
                                       block_robust_qmix_step, comm_budget,
                                       plan_mix_step, plan_mix_steps,
                                       plan_mix_steps_wire,
                                       plan_neighborhood_stats)
from repro_torch.topo.plan import (BlockPlan, BlockPlanSchedule, CommContract,
                                   CommPlan, PlanSchedule, block_mix_dense,
                                   block_robust_mix_dense,
                                   check_plan_covers, compile_block_plan,
                                   compile_plan, mix_with_block_plan,
                                   mix_with_plan, plan_coefficients,
                                   plan_mix_dense, w_from_coefficients,
                                   w_from_coefficients_device)

__all__ = [
    "BlockPlan", "BlockPlanSchedule", "CommContract", "CommPlan",
    "PlanSchedule", "GRAPHS", "block_gather_neighbors",
    "block_gather_neighbors_q", "block_mix_dense", "block_mix_step",
    "block_mix_steps", "block_mix_steps_wire", "block_neighborhood_stats",
    "block_qmix_steps", "block_robust_mix_dense", "block_robust_mix_step",
    "block_robust_mix_steps", "block_robust_qmix_step", "build",
    "check_coloring", "check_plan_covers", "comm_budget",
    "compile_block_plan", "compile_plan", "edge_coloring", "expander",
    "greedy_edge_coloring", "hypercube", "misra_gries_edge_coloring",
    "mix_with_block_plan", "mix_with_plan", "plan_coefficients",
    "plan_mix_dense", "plan_mix_step", "plan_mix_steps",
    "plan_mix_steps_wire", "plan_neighborhood_stats", "random_geometric",
    "undirected_edges",
    "w_from_coefficients", "w_from_coefficients_device",
]
