"""A ``CommPlan`` / ``BlockPlan`` as point-to-point exchanges over ranks.

The bodies the distributed runtime (``repro_torch.dist.runtime``) runs
under ``comm="plan"``, on a ``repro_torch.dist.axis.NodeAxis``:

* **one node per rank** (``CommPlan``, K == ranks): one ``permute`` per
  node-level color, per-node coefficients from the ``PlanSchedule``;
* **node blocks** (``BlockPlan``, K/M nodes per rank): one ``permute`` of
  the whole (K/M, d) block per rank-level color, written into a (K, d)
  buffer that is zero where nothing arrived, and contracted against this
  rank's (K/M, K) rows of W (``block_mix_step``). Intra-block edges ride
  the product as local terms.

Nothing here gathers a (K, ...) stack: the exchanges are the only traffic
(``comm_budget``). ``plan_mix_step`` equals ``dense_mix``'s rows within
float summation order (the self term, then the colors, as
``plan.plan_mix_dense``); ``block_mix_step`` equals them bitwise (the
product runs at the dense shape, ``plan.rows_product``).
"""
from __future__ import annotations

import torch

from repro_torch.topo.plan import (BlockPlan, CommPlan, _permutes_per_step,
                                   rows_product)


def plan_mix_step(v_local: torch.Tensor, axis, plan: CommPlan, diag,
                  coefs) -> torch.Tensor:
    """One gossip step for this rank's node. ``diag``: its W_kk (0-d);
    ``coefs``: (C,) its coefficient per color (0 where unmatched or where
    churn dropped the edge this round)."""
    out = diag * v_local
    for c, perm in enumerate(plan.perms):
        out = out + coefs[c] * axis.permute(v_local, perm)
    return out


def plan_mix_steps(v_local: torch.Tensor, axis, plan: CommPlan, diag, coefs,
                   steps: int) -> torch.Tensor:
    """B gossip steps one after the other (App. E.2): on the wire there is
    no W^B fold, so B * num_colors exchanges."""
    out = v_local
    for _ in range(steps):
        out = plan_mix_step(out, axis, plan, diag, coefs)
    return out


def block_gather_neighbors(x_block: torch.Tensor, axis,
                           plan: BlockPlan) -> torch.Tensor:
    """The (K, width) stack this rank can see: its own block, and one
    received block per rank-level color at the partner's node rows; the
    blocks of ranks it never exchanges with stay zero. A rank unmatched in
    a color receives nothing there. One ``permute`` per color, shared by
    the mix and the certificate's Eq.-10 exchange. At M = 1 the buffer is
    the block itself."""
    ln = plan.local_nodes
    flat = x_block.reshape(ln, -1)
    if ln == plan.num_nodes:
        return flat
    i = axis.index
    partners = plan.block.partner_arrays()
    buf = flat.new_zeros((plan.num_nodes, flat.shape[1]))
    buf[i * ln:(i + 1) * ln] = flat
    for c, perm in enumerate(plan.block.perms):
        recv = axis.permute(flat, perm)
        src = int(partners[c, i])
        if src != i:
            buf[src * ln:(src + 1) * ln] = recv
    return buf


def block_mix_step(v_block: torch.Tensor, axis, plan: BlockPlan,
                   w_rows: torch.Tensor) -> torch.Tensor:
    """One gossip step for this rank's (K/M, ...) block; ``w_rows``: its
    (K/M, K) rows of the round's W (the ``BlockPlanSchedule`` entry)."""
    flat = v_block.reshape(v_block.shape[0], -1)
    buf = block_gather_neighbors(flat, axis, plan)
    out = rows_product(w_rows, buf, axis.index * plan.local_nodes)
    return out.reshape(v_block.shape)


def block_mix_steps(v_block: torch.Tensor, axis, plan: BlockPlan,
                    w_rows: torch.Tensor, steps: int) -> torch.Tensor:
    """B block-mode gossip steps, one after the other: B * num_colors
    exchanges."""
    out = v_block
    for _ in range(steps):
        out = block_mix_step(out, axis, plan, w_rows)
    return out


def block_neighborhood_stats(g_block: torch.Tensor, axis, plan: BlockPlan,
                             mask_rows: torch.Tensor):
    """(masked neighbor sums (K/M, d), neighborhood sizes (K/M,)) for the
    Prop.-1 certificate in block mode: the (K/M, d) local gradients go over
    the rank-level colors and ``mask_rows``, this rank's (K/M, K) rows of
    the self-inclusive 0/1 neighborhood mask (static, or the churn round's
    reweighted support), selects per node. The select and sum are
    ``duality.neighborhood_mean``'s."""
    buf = block_gather_neighbors(g_block, axis, plan)
    sel = torch.where(mask_rows[:, :, None] > 0, buf[None, :, :],
                      torch.zeros((), dtype=buf.dtype, device=buf.device))
    return torch.sum(sel, dim=1), torch.sum(mask_rows, dim=1)


def plan_neighborhood_stats(g_local: torch.Tensor, axis, plan: CommPlan,
                            mask_row: torch.Tensor):
    """(masked neighbor sum (d,), neighborhood size) for the certificate,
    one node per rank: this node's gradient goes over the plan's colors,
    ``mask_row`` (its row of the neighborhood mask) selects what arrives.
    O(num_colors * d) bytes per rank."""
    i = axis.index
    partners = plan.partner_arrays()
    nsum = mask_row[i] * g_local
    for c, perm in enumerate(plan.perms):
        nsum = nsum + mask_row[int(partners[c, i])] * axis.permute(g_local,
                                                                   perm)
    return nsum, torch.sum(mask_row)


def comm_budget(plan, d: int, itemsize: int = 4, *,
                gossip_steps: int = 1, wire: str | None = None) -> dict:
    """The exchanges this module makes for ``plan`` in one round's mix:
    ``num_colors`` a gossip step (two on a quantized wire: payload and
    scale sidecar), each a (d,) vector or a (K/M, d) block. The source of
    ``CommPlan.contract`` / ``BlockPlan.contract``."""
    return {
        "collective_permutes":
            gossip_steps * _permutes_per_step(plan.num_colors, wire),
        "bytes_per_device":
            gossip_steps * plan.bytes_per_device_per_step(d, itemsize,
                                                          wire=wire),
    }
