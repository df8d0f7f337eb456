"""``repro_torch.dist`` — COLA over ``torch.distributed`` ranks.

The paper's setting (K machines, any communication graph, no coordinator;
He et al., NeurIPS 2018, Algorithm 1) on a process group: the node axis
spreads over the ranks (``sharding``), the ranks reach each other through a
``NodeAxis`` (``axis``: point-to-point exchanges, all-reduces, gathers),
and ``run_dist_cola`` (``runtime``) runs ``run_cola``'s round body on each
rank's block, its gossip lowered to exchanges along the graph's edges
(``repro_torch.topo``). NCCL on cards, gloo on the CPU.
"""
from repro_torch.dist.axis import NodeAxis
from repro_torch.dist.runtime import run_dist_cola
from repro_torch.dist.sharding import (cola_env_block, cola_state_block,
                                       gather_state, node_block,
                                       schedule_block)

__all__ = ["NodeAxis", "cola_env_block", "cola_state_block", "gather_state",
           "node_block", "run_dist_cola", "schedule_block"]
