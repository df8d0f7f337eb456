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

The same exchanges carry the other forms of the mix:

* **attacked** (``*_wire``): the first step sends the lie ``v_send`` while
  each node's own term uses its honest ``v_self``;
* **quantized** (``block_qmix_steps``): each rank-level color sends the
  narrow payload (as its bits, ``NodeAxis``) and its fp32 scale sidecar,
  two exchanges; receivers dequantize into the buffer. The
  rounding uniforms are the rank's rows of the round's (K, d) draw
  (``quant.wire_uniforms(rows=)``), so the wire's bits do not depend on M;
* **robust** (``block_robust_*``): the assembled buffer goes into
  ``mixing.robust_neighborhood_mix`` instead of the product, bitwise
  ``mixing.robust_mix_dense``'s rows for trim / median (clip: rtol, its
  square-root chain).
"""
from __future__ import annotations

import torch

from repro_torch.core import mixing, quant
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


def _row_ids(axis, plan: BlockPlan, device) -> torch.Tensor:
    """(K/M,) the global node ids of this rank's block."""
    ln = plan.local_nodes
    return torch.arange(axis.index * ln, (axis.index + 1) * ln,
                        device=device)


def plan_mix_steps_wire(v_send: torch.Tensor, v_self, axis, plan: CommPlan,
                        diag, coefs, steps: int) -> torch.Tensor:
    """``plan_mix_steps`` whose FIRST step sends an attacked payload
    ``v_send`` (``repro_torch.attack``) while the node's own term uses its
    honest ``v_self`` (None: the honest path). Later steps mix received
    values, which are honest."""
    if v_self is None or steps <= 0:
        return plan_mix_steps(v_send, axis, plan, diag, coefs, steps)
    first = plan_mix_step(v_send, axis, plan, diag, coefs)
    first = first + diag * (v_self - v_send)
    return plan_mix_steps(first, axis, plan, diag, coefs, steps - 1)


def block_mix_steps_wire(v_send: torch.Tensor, v_self, axis,
                         plan: BlockPlan, w_rows: torch.Tensor,
                         steps: int) -> torch.Tensor:
    """``block_mix_steps`` whose FIRST step sends the block's attacked
    payloads ``v_send`` while each node's own term uses its honest
    ``v_self`` (None: the honest path): ``W v_send + diag(W) (v_self -
    v_send)`` on the block's rows, bitwise ``mixing.mix_power_wire``'s
    first step."""
    if v_self is None or steps <= 0:
        return block_mix_steps(v_send, axis, plan, w_rows, steps)
    first = block_mix_step(v_send, axis, plan, w_rows)
    ids = _row_ids(axis, plan, w_rows.device)
    diag = w_rows.gather(1, ids[:, None]).to(first.dtype)        # (K/M, 1)
    delta = (v_self - v_send).reshape(plan.local_nodes, -1)
    first = first + (diag * delta).reshape(v_send.shape)
    return block_mix_steps(first, axis, plan, w_rows, steps - 1)


# ---------------------------------------------------------------------------
# the quantized wire: narrow payloads and their scale sidecars
# ---------------------------------------------------------------------------

def block_gather_neighbors_q(q: torch.Tensor, scale: torch.Tensor,
                             deq: torch.Tensor, axis,
                             plan: BlockPlan) -> torch.Tensor:
    """The quantized ``block_gather_neighbors``: per rank-level color, one
    exchange of the (K/M, d) payload and one of its (K/M, 1) scales,
    dequantized into the (K, d) buffer. The rank's own rows hold its own
    DEQUANTIZED payload ``deq``: every contribution, local or received,
    goes through the codec, so the product against the W rows is bitwise
    ``dense_mix`` on the dequantized stack at any M."""
    ln = plan.local_nodes
    if ln == plan.num_nodes:
        return deq
    i = axis.index
    partners = plan.block.partner_arrays()
    buf = deq.new_zeros((plan.num_nodes, deq.shape[1]))
    buf[i * ln:(i + 1) * ln] = deq
    for c, perm in enumerate(plan.block.perms):
        rq = axis.permute(q, perm)
        rs = axis.permute(scale, perm)
        src = int(partners[c, i])
        if src != i:
            buf[src * ln:(src + 1) * ln] = quant.dequantize(rq, rs)
    return buf


def _encode_block(v_block, ef_block, wire: str, u):
    """The block's EF-compensated encode by rows: ``(q, scale, deq,
    ef_new)``, ``ef_new`` shaped like ``ef_block`` (None without EF)."""
    ln = v_block.shape[0]
    q, sc, deq, ef_new = quant.encode(
        v_block.reshape(ln, -1), wire, u,
        None if ef_block is None else ef_block.reshape(ln, -1))
    return q, sc, deq, (None if ef_new is None
                        else ef_new.reshape(ef_block.shape))


def block_qmix_steps(v_block: torch.Tensor, ef_block, axis,
                     plan: BlockPlan, w_rows: torch.Tensor, steps: int,
                     wire: str, draws=None, payload=None,
                     sig: dict | None = None):
    """B quantized block-mode gossip steps: each step encodes the rank's
    (K/M, d) block once (per-row scales, the rank's rows of the round's
    draws ``draws(step)``, EF folded when ``ef_block`` is not None), sends
    payload and sidecar per rank-level color into the dequantized buffer
    and contracts it against the W rows (``rows_product``): bitwise the
    rank's rows of ``mixing.qmix_steps``. ``payload``: the pipelined
    ``(q, scale)`` of the first step. ``sig`` receives the first step's
    payload as ``sig["q"]``. Returns ``(mixed, ef_new)``."""
    out, ef = v_block, ef_block
    row0 = axis.index * plan.local_nodes
    for s in range(steps):
        if s == 0 and payload is not None:
            q, sc = payload
            deq = quant.dequantize(q, sc)
        else:
            q, sc, deq, ef = _encode_block(
                out, ef, wire, None if draws is None else draws(s))
        if s == 0 and sig is not None:
            sig["q"] = q
        buf = block_gather_neighbors_q(q, sc, deq, axis, plan)
        out = rows_product(w_rows, buf, row0).reshape(out.shape)
    return out, ef


def block_robust_qmix_step(v_block: torch.Tensor, ef_block, axis,
                           plan: BlockPlan, w_rows: torch.Tensor, wire: str,
                           draws, mode: str, *, trim: int = 1,
                           clip: float | None = None,
                           sig: dict | None = None):
    """ONE robust gossip step on a quantized wire, the composed
    ``cfg.robust`` x ``cfg.wire`` lowering: the block is encoded as in
    ``block_qmix_steps``, the narrow payload and its sidecar cross per
    color into the dequantized buffer, and each row is aggregated by
    ``mixing.robust_neighborhood_mix``: the gate judges the values the
    receivers consume, bitwise the stacked composed branch of
    ``cola._round_body`` for trim / median. One step by construction
    (``cola._check_wire_config``). ``sig`` receives the payload
    (``sig["q"]``) and the rejection mask of the rank's rows
    (``sig["gate"]``). Returns ``(mixed, ef_new)``."""
    q, sc, deq, ef_new = _encode_block(
        v_block, ef_block, wire, None if draws is None else draws(0))
    if sig is not None:
        sig["q"] = q
    buf = block_gather_neighbors_q(q, sc, deq, axis, plan)
    out = mixing.robust_neighborhood_mix(
        w_rows, buf, _row_ids(axis, plan, buf.device), mode, trim=trim,
        clip=clip, sig=sig)
    return out.reshape(v_block.shape).to(v_block.dtype), ef_new


def block_robust_mix_step(v_block: torch.Tensor, axis, plan: BlockPlan,
                          w_rows: torch.Tensor, mode: str, *, trim: int = 1,
                          clip: float | None = None,
                          v_self=None, sig: dict | None = None
                          ) -> torch.Tensor:
    """One ROBUST gossip step for this rank's (K/M, ...) block: the
    ``block_mix_step`` buffer, aggregated per row by
    ``mixing.robust_neighborhood_mix`` instead of the product. The rule
    reads only the slots in each row's W support, which the coverage
    contract guarantees were exchanged, so trim and median are bitwise
    ``mixing.robust_mix_dense``'s rows on every M (its products run at the
    stacked shape, ``_Neighborhood.rows_matmul``); clip's square-root and
    division chain holds at rtol over a run. ``v_self``: the block's
    honest states when ``v_block`` holds attacked payloads (a liar's lie
    reaches its neighbors, never its own aggregate). ``sig`` receives the
    (K/M, K) rejection mask of the block's rows (``sig["gate"]``)."""
    ln = plan.local_nodes
    buf = block_gather_neighbors(v_block.reshape(ln, -1), axis, plan)
    out = mixing.robust_neighborhood_mix(
        w_rows, buf, _row_ids(axis, plan, buf.device), mode, trim=trim,
        clip=clip,
        self_override=None if v_self is None else v_self.reshape(ln, -1),
        sig=sig)
    return out.reshape(v_block.shape).to(v_block.dtype)


def block_robust_mix_steps(v_block: torch.Tensor, axis, plan: BlockPlan,
                           w_rows: torch.Tensor, mode: str, *,
                           trim: int = 1, clip: float | None = None,
                           steps: int = 1, v_self=None,
                           sig: dict | None = None) -> torch.Tensor:
    """B robust block-mode steps one after the other (no W^B fold), as
    ``mixing.robust_mix_steps``; ``v_self`` applies to the first step
    only, and ``sig`` receives the first step's mask."""
    out = v_block
    for s in range(steps):
        out = block_robust_mix_step(out, axis, plan, w_rows, mode, trim=trim,
                                    clip=clip,
                                    v_self=v_self if s == 0 else None,
                                    sig=sig if s == 0 else None)
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
