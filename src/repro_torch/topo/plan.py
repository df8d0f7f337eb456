"""Topology-program IR: compiled communication plans for any sparse W.

``compile_plan`` turns the support graph of a (possibly time-varying)
doubly-stochastic mixing matrix into a ``CommPlan``: an edge coloring of
the support into matchings, each matching one point-to-point exchange that
carries both directions of its edges. One gossip step is then

    v'_k = W_kk v_k + sum_c W[k, partner_c(k)] recv_c(k)

with the per-node coefficients read off the round's W, so one static plan
runs any reweighting of its support: a churn round's dropped edge carries
coefficient 0 (the exchange still runs).

``PlanSchedule`` stacks the per-round (diag, coefs) into the executor's
``(T, ...)`` schedule arrays. ``plan_mix_dense`` is the executor without
ranks, held to ``mixing.dense_mix`` within float summation order.

**Block mode** (``compile_block_plan``): K nodes over M < K ranks, K/M
contiguous nodes per rank. Intra-block edges are local terms (no
communication); inter-block edges project onto a rank-level graph whose
parallel edges collapse into one exchange of the whole (K/M, d) block, and
that graph is edge-colored. Each rank contracts its (K/M, K) rows of the
round's W (``BlockPlanSchedule``) against its assembled (K, d)
neighborhood buffer, a buffer with exact zeros where nothing was exchanged
and W is zero anyway: ``block_mix_dense`` equals ``dense_mix`` bitwise
(``rows_product`` says why).

Numpy for the host-side plan objects, torch for the executors; the colors,
partner tables and schedules equal the JAX reference's ``repro.topo.plan``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import CommContract
from repro_torch.core import quant, topology as topo
from repro_torch.topo import coloring

Edge = coloring.Edge

def _payload_bytes(d: int, itemsize: int, wire: str | None,
                   rows: int = 1) -> int:
    """Bytes of one ``rows x d`` payload: ``rows * d * itemsize`` without a
    wire, else the codec's elements plus one fp32 scale per row."""
    if wire is None:
        return rows * d * itemsize
    return quant.payload_bytes(d, wire, rows)


def _permutes_per_step(num_colors: int, wire: str | None) -> int:
    """Exchanges per gossip step: one per color, two on a quantized wire
    (the payload and its scale sidecar)."""
    if wire is None:
        return num_colors
    return num_colors * (2 if quant.is_quantized(wire) else 1)


def _render_wire_line(plan, d: int, itemsize: int,
                      wire: str | None) -> list:
    """The quantized wire's bytes line beside the fp32 figure."""
    if wire is None or not quant.is_quantized(wire):
        return []
    dev = plan.bytes_per_device_per_step(d, wire=wire)
    dev32 = plan.bytes_per_device_per_step(d, itemsize)
    return [
        f"  wire={wire} (payload {quant.wire_itemsize(wire)} B/elem + "
        f"{quant.SCALE_BYTES} B scale/row): "
        f"per-device<={dev:,} "
        f"per-link={plan.bytes_per_link_per_step(d, wire=wire):,} "
        f"total={plan.total_bytes_per_step(d, wire=wire):,}  "
        f"({dev / dev32:.2f}x fp32)"]


def _contract(plan, name: str, d: int, itemsize: int, gossip_steps: int,
              wire: str | None) -> CommContract:
    from repro_torch.topo.lowering import comm_budget
    budget = comm_budget(plan, d, itemsize, gossip_steps=gossip_steps,
                         wire=wire)
    tag = f"-{wire}" if wire else ""
    return CommContract(
        name=f"{name}-d{d}{tag}",
        max_collective_permute_count=budget["collective_permutes"],
        max_collective_permute_bytes=budget["bytes_per_device"],
        require_collective_permute=True)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A compiled topology program, one node per rank.

    Attributes:
      num_nodes: K.
      colors: per color class, its undirected edges (i < j).
      perms: per color, the (src, dst) pairs of its exchange: both
        directions of each edge (unmatched nodes send nothing and receive
        zeros).
      partners: per color, p[k] = k's partner in that color, or k itself
        when unmatched (its coefficient is then 0).
    """

    num_nodes: int
    colors: Tuple[Tuple[Edge, ...], ...]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    partners: Tuple[Tuple[int, ...], ...]

    @property
    def num_colors(self) -> int:
        return len(self.colors)

    @property
    def num_edges(self) -> int:
        return sum(len(c) for c in self.colors)

    def support(self) -> np.ndarray:
        """(K, K) bool: the off-diagonal exchange pattern of the plan."""
        s = np.zeros((self.num_nodes, self.num_nodes), dtype=bool)
        for cls in self.colors:
            for i, j in cls:
                s[i, j] = s[j, i] = True
        return s

    def coverage(self) -> np.ndarray:
        """(K, K) bool: the off-diagonal W entries the plan can execute
        (for a per-node plan, its support)."""
        return self.support()

    def partner_arrays(self) -> np.ndarray:
        """(C, K) int32 partner table (the own index where unmatched)."""
        return np.asarray(self.partners, dtype=np.int32).reshape(
            self.num_colors, self.num_nodes)

    def max_degree(self) -> int:
        return int(self.support().sum(axis=1).max(initial=0))

    def cache_token(self):
        return ("CommPlan", self.num_nodes, self.colors)

    def bytes_per_device_per_step(self, d: int, itemsize: int = 4,
                                  wire: str | None = None) -> int:
        """Worst-case bytes a rank sends in one gossip step: one (d,)
        vector per color."""
        return self.num_colors * _payload_bytes(d, itemsize, wire)

    def bytes_per_link_per_step(self, d: int, itemsize: int = 4,
                                wire: str | None = None) -> int:
        """Bytes crossing one graph edge (both directions) per step."""
        return 2 * _payload_bytes(d, itemsize, wire)

    def total_bytes_per_step(self, d: int, itemsize: int = 4,
                             wire: str | None = None) -> int:
        """Bytes of one gossip step over every edge, both ways."""
        return self.num_edges * self.bytes_per_link_per_step(d, itemsize,
                                                             wire)

    def contract(self, d: int, itemsize: int = 4, *, gossip_steps: int = 1,
                 wire: str | None = None) -> CommContract:
        """The round's budget: at most ``gossip_steps * num_colors``
        exchanges (twice that on a quantized wire) of at most
        ``bytes_per_device_per_step`` a step, no gathers or reductions."""
        return _contract(self, f"plan-K{self.num_nodes}-c{self.num_colors}",
                         d, itemsize, gossip_steps, wire)

    def render(self, d: int | None = None, itemsize: int = 4,
               max_edges: int = 8, wire: str | None = None) -> str:
        """Human-readable plan: colors, edges and bytes per round."""
        lines = [f"[comm plan] K={self.num_nodes} edges={self.num_edges} "
                 f"colors={self.num_colors} max_degree={self.max_degree()}"]
        for c, cls in enumerate(self.colors):
            shown = ", ".join(f"{i}<->{j}" for i, j in cls[:max_edges])
            more = f", ... +{len(cls) - max_edges}" if len(cls) > max_edges \
                else ""
            lines.append(f"  color {c}: {len(cls)} edge(s)  {shown}{more}")
        if d is not None:
            lines.append(
                f"  bytes/round (1 gossip step, d={d}, itemsize={itemsize}): "
                f"per-device<={self.bytes_per_device_per_step(d, itemsize):,} "
                f"per-link={self.bytes_per_link_per_step(d, itemsize):,} "
                f"total={self.total_bytes_per_step(d, itemsize):,}  "
                f"(dense all-gather per-device="
                f"{self.num_nodes * d * itemsize:,})")
            lines.extend(_render_wire_line(self, d, itemsize, wire))
        return "\n".join(lines)


def _support_adjacency(support) -> np.ndarray:
    """(K, K) pattern of a Topology or of any square matrix."""
    if isinstance(support, topo.Topology):
        adj = support.adjacency
    else:
        adj = np.asarray(support)
    k = adj.shape[0]
    if adj.ndim != 2 or adj.shape != (k, k):
        raise ValueError(f"support must be square, got {adj.shape}")
    return adj


def _plan_from_classes(classes, k: int, edges) -> CommPlan:
    """Validated color classes as exchange pairs and partner tables."""
    coloring.check_coloring(classes, edges, k)
    perms, partners = [], []
    for cls in classes:
        perm = []
        partner = list(range(k))
        for i, j in cls:
            perm.append((i, j))
            perm.append((j, i))
            partner[i], partner[j] = j, i
        perms.append(tuple(sorted(perm)))
        partners.append(tuple(partner))
    return CommPlan(num_nodes=k,
                    colors=tuple(tuple(cls) for cls in classes),
                    perms=tuple(perms), partners=tuple(partners))


def compile_plan(support, *, method: str = "auto") -> CommPlan:
    """A ``CommPlan`` (one node per rank) for the off-diagonal pattern of
    ``support`` (a Topology or a (K, K) matrix; a mixing matrix works
    as-is). ``method``: the coloring pass (``coloring.edge_coloring``)."""
    adj = _support_adjacency(support)
    k = adj.shape[0]
    edges = coloring.undirected_edges(adj)
    classes = coloring.edge_coloring(edges, k, method=method)
    return _plan_from_classes(classes, k, edges)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A K-node graph lowered onto M < K ranks (node k on rank k // (K/M)).

    ``intra_edges`` have both ends on one rank (local terms);
    ``inter_edges`` cross ranks and project onto the rank-level graph whose
    coloring is ``block`` (a ``CommPlan`` over the M ranks, each color one
    exchange of the (K/M, d) block)."""

    num_nodes: int            # K nodes
    num_devices: int          # M ranks
    block: CommPlan           # rank-level plan (block.num_nodes == M)
    intra_edges: Tuple[Edge, ...]
    inter_edges: Tuple[Edge, ...]

    @property
    def local_nodes(self) -> int:
        return self.num_nodes // self.num_devices

    @property
    def num_colors(self) -> int:
        """Rank-level colors = exchanges per gossip step."""
        return self.block.num_colors

    @property
    def num_edges(self) -> int:
        return len(self.intra_edges) + len(self.inter_edges)

    def support(self) -> np.ndarray:
        """(K, K) bool: the node-level exchange pattern."""
        s = np.zeros((self.num_nodes, self.num_nodes), dtype=bool)
        for i, j in self.intra_edges + self.inter_edges:
            s[i, j] = s[j, i] = True
        return s

    def max_degree(self) -> int:
        return int(self.support().sum(axis=1).max(initial=0))

    def coverage(self) -> np.ndarray:
        """(K, K) bool: the off-diagonal W entries the plan can execute:
        every same-rank pair (the whole block sits in the buffer) and every
        pair of nodes whose ranks exchange in some color (an exchange
        carries the whole block)."""
        k, ln = self.num_nodes, self.local_nodes
        cov = np.zeros((k, k), dtype=bool)
        blocks = [np.arange(b * ln, (b + 1) * ln) for b in
                  range(self.num_devices)]
        for b in range(self.num_devices):
            cov[np.ix_(blocks[b], blocks[b])] = True
        for cls in self.block.colors:
            for u, v in cls:
                cov[np.ix_(blocks[u], blocks[v])] = True
                cov[np.ix_(blocks[v], blocks[u])] = True
        np.fill_diagonal(cov, False)
        return cov

    def device_of(self, node: int) -> int:
        return node // self.local_nodes

    def cache_token(self):
        return ("BlockPlan", self.num_nodes, self.num_devices,
                self.block.cache_token(), self.intra_edges, self.inter_edges)

    def bytes_per_device_per_step(self, d: int, itemsize: int = 4,
                                  wire: str | None = None) -> int:
        """Worst-case bytes a rank sends per gossip step: one (K/M, d)
        block per rank-level color."""
        return self.num_colors * _payload_bytes(d, itemsize, wire,
                                                rows=self.local_nodes)

    def bytes_per_link_per_step(self, d: int, itemsize: int = 4,
                                wire: str | None = None) -> int:
        """Bytes crossing one rank-pair link, both directions."""
        return 2 * _payload_bytes(d, itemsize, wire, rows=self.local_nodes)

    def total_bytes_per_step(self, d: int, itemsize: int = 4,
                             wire: str | None = None) -> int:
        return self.block.num_edges * self.bytes_per_link_per_step(
            d, itemsize, wire)

    def contract(self, d: int, itemsize: int = 4, *, gossip_steps: int = 1,
                 wire: str | None = None) -> CommContract:
        """The block round's budget (see ``CommPlan.contract``): exchanges
        of (K/M, d) blocks, at most Delta_block + 1 colors a step."""
        return _contract(
            self, f"block-K{self.num_nodes}-M{self.num_devices}-"
                  f"c{self.num_colors}", d, itemsize, gossip_steps, wire)

    def render(self, d: int | None = None, itemsize: int = 4,
               max_edges: int = 8, wire: str | None = None) -> str:
        """Human-readable block plan."""
        ln = self.local_nodes
        lines = [f"[block plan] K={self.num_nodes} nodes on "
                 f"M={self.num_devices} devices ({ln} nodes/device)  "
                 f"edges: intra={len(self.intra_edges)} "
                 f"inter={len(self.inter_edges)} "
                 f"(collapsed to {self.block.num_edges} device link(s))  "
                 f"colors={self.num_colors}"]
        for c, cls in enumerate(self.block.colors):
            shown = ", ".join(f"dev{i}<->dev{j}" for i, j in cls[:max_edges])
            more = f", ... +{len(cls) - max_edges}" if len(cls) > max_edges \
                else ""
            lines.append(f"  color {c}: {len(cls)} link(s)  {shown}{more}")
        if d is not None:
            lines.append(
                f"  bytes/round (1 gossip step, d={d}, itemsize={itemsize}): "
                f"per-device<={self.bytes_per_device_per_step(d, itemsize):,} "
                f"per-link={self.bytes_per_link_per_step(d, itemsize):,} "
                f"total={self.total_bytes_per_step(d, itemsize):,}  "
                f"(dense all-gather per-device="
                f"{self.num_nodes * d * itemsize:,})")
            lines.extend(_render_wire_line(self, d, itemsize, wire))
        return "\n".join(lines)


def compile_block_plan(support, num_devices: int, *,
                       method: str = "auto") -> BlockPlan:
    """Quotient a K-node support onto M ranks (K % M == 0, contiguous
    blocks) and color the rank-level graph."""
    adj = _support_adjacency(support)
    k = adj.shape[0]
    if num_devices < 1 or k % num_devices != 0:
        raise ValueError(f"K={k} nodes must divide over M={num_devices} "
                         "devices (contiguous node blocks)")
    ln = k // num_devices
    intra, inter = [], []
    block_adj = np.zeros((num_devices, num_devices), dtype=bool)
    for i, j in coloring.undirected_edges(adj):
        bi, bj = i // ln, j // ln
        if bi == bj:
            intra.append((i, j))
        else:
            inter.append((i, j))
            block_adj[bi, bj] = block_adj[bj, bi] = True
    block_edges = coloring.undirected_edges(block_adj)
    classes = coloring.edge_coloring(block_edges, num_devices, method=method)
    return BlockPlan(num_nodes=k, num_devices=num_devices,
                     block=_plan_from_classes(classes, num_devices,
                                              block_edges),
                     intra_edges=tuple(intra), inter_edges=tuple(inter))


def check_plan_covers(plan, w: np.ndarray, atol: float = 0.0) -> None:
    """Raise ValueError if ``w`` has off-diagonal mass outside the plan's
    ``coverage()`` (a ``CommPlan`` or a ``BlockPlan``): the plan would drop
    that weight. Churn only removes edges, so its rounds always pass."""
    w = np.asarray(w)
    if w.shape != (plan.num_nodes, plan.num_nodes):
        raise ValueError(f"W shape {w.shape} does not match the plan's "
                         f"K={plan.num_nodes}")
    off = np.abs(w.copy())
    np.fill_diagonal(off, 0.0)
    uncovered = off * ~plan.coverage()
    if uncovered.max(initial=0.0) > atol:
        i, j = np.unravel_index(np.argmax(uncovered), uncovered.shape)
        raise ValueError(
            f"W[{i},{j}]={w[i, j]:.3g} lies outside the compiled plan's "
            f"support — plan execution would drop that weight mass; "
            "recompile the plan from this W's support (or use the dense "
            "mixing path)")


def plan_coefficients(plan: CommPlan, w, *, check: bool = True
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(diag (K,), coefs (C, K)) of one round's ``w``: ``diag[k] = W_kk``,
    ``coefs[c, k] = W[k, partner_c(k)]`` (0 where unmatched)."""
    w = np.asarray(w)
    if check:
        check_plan_covers(plan, w)
    k = plan.num_nodes
    diag = np.ascontiguousarray(np.diag(w))
    coefs = np.zeros((plan.num_colors, k), dtype=w.dtype)
    rows = np.arange(k)
    for c, partner in enumerate(plan.partner_arrays()):
        matched = partner != rows
        coefs[c, matched] = w[rows[matched], partner[matched]]
    return diag, coefs


def _check_coef_shapes(plan: CommPlan, diag_shape, coefs_shape) -> None:
    k = plan.num_nodes
    if tuple(diag_shape) != (k,):
        raise ValueError(f"diag shape {tuple(diag_shape)} != ({k},)")
    if tuple(coefs_shape) != (plan.num_colors, k):
        raise ValueError(f"coefs shape {tuple(coefs_shape)} != "
                         f"({plan.num_colors}, {k})")


def w_from_coefficients(plan: CommPlan, diag, coefs) -> np.ndarray:
    """The (K, K) mixing matrix of one round's plan entries: the exact
    inverse of ``plan_coefficients`` over the plan's support."""
    diag = np.asarray(diag)
    coefs = np.asarray(coefs)
    _check_coef_shapes(plan, diag.shape, coefs.shape)
    k = plan.num_nodes
    w = np.zeros((k, k), dtype=np.result_type(diag.dtype, coefs.dtype))
    np.fill_diagonal(w, diag)
    rows = np.arange(k)
    for c, partner in enumerate(plan.partner_arrays()):
        matched = partner != rows
        w[rows[matched], partner[matched]] = coefs[c, matched]
    return w


def w_from_coefficients_device(plan: CommPlan, diag: torch.Tensor,
                               coefs: torch.Tensor) -> torch.Tensor:
    """``w_from_coefficients`` on tensors, on their device: the same
    scatter by the plan's partner tables."""
    _check_coef_shapes(plan, diag.shape, coefs.shape)
    k = plan.num_nodes
    rows = np.arange(k)
    w = torch.zeros((k, k), dtype=diag.dtype, device=diag.device)
    w[rows, rows] = diag
    for c, partner in enumerate(plan.partner_arrays()):
        matched = np.nonzero(partner != rows)[0]
        w[matched, partner[matched]] = coefs[c, matched]
    return w


@dataclasses.dataclass(frozen=True)
class PlanSchedule:
    """Per-round plan coefficients, ``diag`` (T, K) and ``coefs`` (T, C, K);
    a round-invariant W gives broadcast views (O(C K) memory for any T)."""

    diag: np.ndarray
    coefs: np.ndarray

    @classmethod
    def from_w_stack(cls, plan: CommPlan, w_stack, *,
                     static: bool = False) -> "PlanSchedule":
        """Every round's coefficients, coverage checked per round;
        ``static=True`` asserts the stack is round-invariant."""
        w_stack = np.asarray(w_stack)
        t = w_stack.shape[0]
        if static or t == 0:
            w0 = w_stack[0] if t else np.eye(plan.num_nodes)
            if t and not (w_stack == w0).all():
                raise ValueError(
                    "PlanSchedule.from_w_stack(static=True) requires a "
                    "round-invariant W stack — this one varies; drop "
                    "static= to materialize per-round coefficients")
            diag0, coefs0 = plan_coefficients(plan, w0)
            return cls(
                diag=np.broadcast_to(diag0.astype(w_stack.dtype),
                                     (t,) + diag0.shape),
                coefs=np.broadcast_to(coefs0.astype(w_stack.dtype),
                                      (t,) + coefs0.shape))
        diag = np.empty((t, plan.num_nodes), dtype=w_stack.dtype)
        coefs = np.empty((t, plan.num_colors, plan.num_nodes),
                         dtype=w_stack.dtype)
        for t_i in range(t):
            diag[t_i], coefs[t_i] = plan_coefficients(plan, w_stack[t_i])
        return cls(diag=diag, coefs=coefs)

    def entries(self) -> dict:
        """The schedule entries the distributed runtime reads."""
        return {"plan_diag": self.diag, "plan_coefs": self.coefs}


@functools.lru_cache(maxsize=64)
def _partner_index(plan: CommPlan, device: torch.device) -> torch.Tensor:
    """The (C, K) partner table as an int64 tensor on ``device``, made
    once per plan and device."""
    return torch.as_tensor(plan.partner_arrays(), dtype=torch.int64,
                           device=device)


def plan_mix_dense(plan: CommPlan, diag, coefs,
                   v_stack: torch.Tensor) -> torch.Tensor:
    """One plan-compiled gossip step on stacked (K, ...) state, without
    ranks: row gathers stand in for the exchanges, the self term first,
    then the colors in order (``lowering.plan_mix_step``'s order). Equals
    ``dense_mix`` within float summation order. ``diag`` / ``coefs``:
    arrays or tensors (tensors on the state's device copy nothing)."""
    flat = v_stack.reshape(v_stack.shape[0], -1)
    diag = torch.as_tensor(diag, device=flat.device).to(flat.dtype)
    coefs = torch.as_tensor(coefs, device=flat.device).to(flat.dtype)
    partners = _partner_index(plan, flat.device)
    out = diag[:, None] * flat
    for c in range(plan.num_colors):
        out = out + coefs[c][:, None] * flat.index_select(0, partners[c])
    return out.reshape(v_stack.shape)


def mix_with_plan(plan: CommPlan, w, v_stack: torch.Tensor) -> torch.Tensor:
    """One gossip step of ``w`` through the compiled plan."""
    diag, coefs = plan_coefficients(plan, w)
    return plan_mix_dense(plan, diag, coefs, v_stack)


@dataclasses.dataclass(frozen=True)
class BlockPlanSchedule:
    """Per-round mixing matrices ``w`` (T, K, K) for block mode, coverage
    checked per round (or once, for a ``static`` stack kept as broadcast
    views); each rank reads its (K/M, K) rows."""

    w: np.ndarray

    @classmethod
    def from_w_stack(cls, plan: BlockPlan, w_stack, *,
                     static: bool = False) -> "BlockPlanSchedule":
        w_stack = np.asarray(w_stack)
        t = w_stack.shape[0]
        if static or t == 0:
            w0 = w_stack[0] if t else np.eye(plan.num_nodes,
                                             dtype=w_stack.dtype)
            if t and not (w_stack == w0).all():
                raise ValueError(
                    "BlockPlanSchedule.from_w_stack(static=True) requires a "
                    "round-invariant W stack — this one varies; drop "
                    "static= to validate per-round coverage")
            check_plan_covers(plan, w0)
            return cls(w=np.broadcast_to(w0, (t,) + w0.shape))
        for t_i in range(t):
            check_plan_covers(plan, w_stack[t_i])
        return cls(w=w_stack)

    def entries(self) -> dict:
        return {"plan_w": self.w}


def rows_product(w_rows: torch.Tensor, buf: torch.Tensor,
                 row0: int) -> torch.Tensor:
    """Rows ``row0 : row0 + R`` of ``W @ buf`` from W's (R, K) rows
    ``w_rows``, computed at the dense mix's (K, K) @ (K, d) shape with the
    other rows zero. A BLAS picks its algorithm by shape (a single row
    takes a matrix-vector product that sums in another order), so the
    same shape is what makes a block's rows bitwise those of
    ``mixing.dense_mix``."""
    k, r = buf.shape[0], w_rows.shape[0]
    w_rows = w_rows.to(buf.dtype)
    if r == k:
        return w_rows @ buf
    w_full = w_rows.new_zeros((k, k))
    w_full[row0:row0 + r] = w_rows
    return (w_full @ buf)[row0:row0 + r]


def _block_buffer(plan: BlockPlan, flat: torch.Tensor,
                  dev: int) -> torch.Tensor:
    """Rank ``dev``'s (K, width) buffer without ranks: its own block and
    one partner block per color, the blocks it never exchanges with zero
    (``lowering.block_gather_neighbors``' result)."""
    ln = plan.local_nodes
    partners = plan.block.partner_arrays()  # (C, M)
    buf = torch.zeros_like(flat)
    for src in {dev, *(int(partners[c, dev])
                       for c in range(plan.num_colors))}:
        buf[src * ln:(src + 1) * ln] = flat[src * ln:(src + 1) * ln]
    return buf


def block_mix_dense(plan: BlockPlan, w, v_stack: torch.Tensor, *,
                    check: bool = True) -> torch.Tensor:
    """Block mode without ranks: per rank, the (K, d) buffer of its own
    block and one partner block per color (never-exchanged blocks stay
    zero), then its (K/M, K) rows of W against it (``rows_product``).
    Bitwise ``mixing.dense_mix``. ``w``: an array or a tensor (a tensor
    on the state's device copies nothing; ``check`` then reads it back)."""
    if check:
        check_plan_covers(plan, w.detach().cpu().numpy()
                          if torch.is_tensor(w) else w)
    k, m, ln = plan.num_nodes, plan.num_devices, plan.local_nodes
    flat = v_stack.reshape(k, -1)
    w_t = torch.as_tensor(w, device=flat.device).to(flat.dtype)
    outs = [rows_product(w_t[dev * ln:(dev + 1) * ln],
                         _block_buffer(plan, flat, dev), dev * ln)
            for dev in range(m)]
    return torch.cat(outs, dim=0).reshape(v_stack.shape)


def mix_with_block_plan(plan: BlockPlan, w, v_stack: torch.Tensor
                        ) -> torch.Tensor:
    """One gossip step of ``w`` through the block plan."""
    return block_mix_dense(plan, w, v_stack)


def block_robust_mix_dense(plan: BlockPlan, w, v_stack: torch.Tensor,
                           mode: str, *, trim: int = 1,
                           clip: float | None = None, check: bool = True,
                           self_stack: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """ROBUST block mode without ranks: per rank, the zero-filled buffer of
    ``block_mix_dense``, then its node rows aggregated by
    ``mixing.robust_neighborhood_mix`` instead of the product. The rule
    reads only the slots in each row's W support (coverage checked), so
    this is bitwise ``mixing.robust_mix_dense``: the executor the robust
    lowering (``lowering.block_robust_mix_step``) is held to.
    ``self_stack`` (K, ...): honest states overriding each node's own slot
    when ``v_stack`` holds attacked payloads."""
    from repro_torch.core import mixing
    if check:
        check_plan_covers(plan, w.detach().cpu().numpy()
                          if torch.is_tensor(w) else w)
    k, m, ln = plan.num_nodes, plan.num_devices, plan.local_nodes
    flat = v_stack.reshape(k, -1)
    w_t = torch.as_tensor(w, device=flat.device).to(flat.dtype)
    own_stack = None if self_stack is None else self_stack.reshape(k, -1)
    outs = []
    for dev in range(m):
        own = slice(dev * ln, (dev + 1) * ln)
        outs.append(mixing.robust_neighborhood_mix(
            w_t[own], _block_buffer(plan, flat, dev),
            torch.arange(dev * ln, (dev + 1) * ln, device=flat.device),
            mode, trim=trim, clip=clip,
            self_override=None if own_stack is None else own_stack[own]))
    return torch.cat(outs, dim=0).reshape(v_stack.shape).to(v_stack.dtype)
