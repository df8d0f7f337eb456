"""Network topologies and mixing matrices for decentralized learning
(CoLA §1.1, App. B).

The communication graph of the K nodes is a symmetric boolean adjacency
matrix; the gossip mixing matrix ``W`` is built from Metropolis-Hastings
weights (App. B), which makes ``W`` symmetric and doubly stochastic for any
connected undirected graph. The spectral gap ``1 - beta`` (beta = second
largest eigenvalue magnitude) governs the rates of Theorems 1 and 2.

Numpy only: graphs are host-side constants; the drivers move ``W`` to the
device once per run.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected communication graph over K nodes."""

    name: str
    adjacency: np.ndarray  # (K, K) bool, no self loops

    @property
    def num_nodes(self) -> int:
        return self.adjacency.shape[0]


def _empty_adj(k: int) -> np.ndarray:
    return np.zeros((k, k), dtype=bool)


def ring(k: int) -> Topology:
    adj = _empty_adj(k)
    idx = np.arange(k)
    adj[idx, (idx + 1) % k] = True
    adj[(idx + 1) % k, idx] = True
    return Topology("ring", adj)


def connected_cycle(k: int, c: int) -> Topology:
    """c-connected cycle: each node linked to its c nearest neighbors per side."""
    if c < 1 or 2 * c >= k:
        raise ValueError(f"need 1 <= c < k/2, got c={c}, k={k}")
    adj = _empty_adj(k)
    idx = np.arange(k)
    for off in range(1, c + 1):
        adj[idx, (idx + off) % k] = True
        adj[(idx + off) % k, idx] = True
    return Topology(f"{c}-connected-cycle", adj)


def grid_2d(rows: int, cols: int) -> Topology:
    """2-D grid (non-wrapping)."""
    k = rows * cols
    adj = _empty_adj(k)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                adj[i, i + 1] = adj[i + 1, i] = True
            if r + 1 < rows:
                adj[i, i + cols] = adj[i + cols, i] = True
    return Topology(f"grid-{rows}x{cols}", adj)


def torus_2d(rows: int, cols: int) -> Topology:
    """2-D torus (wrapping grid)."""
    k = rows * cols
    adj = _empty_adj(k)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            right = r * cols + (c + 1) % cols
            down = ((r + 1) % rows) * cols + c
            if right != i:  # degenerate 1-wide torus: no self loops
                adj[i, right] = adj[right, i] = True
            if down != i:
                adj[i, down] = adj[down, i] = True
    return Topology(f"torus-{rows}x{cols}", adj)


def complete(k: int) -> Topology:
    return Topology("complete", ~np.eye(k, dtype=bool))


def star(k: int) -> Topology:
    adj = _empty_adj(k)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return Topology("star", adj)


def _metropolis(adj: np.ndarray) -> np.ndarray:
    k = adj.shape[0]
    deg = adj.sum(axis=1).astype(np.float64)
    w = np.zeros((k, k), dtype=np.float64)
    ii, jj = np.nonzero(adj)
    w[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    w[np.arange(k), np.arange(k)] = 1.0 - w.sum(axis=1)
    return w


def metropolis_weights(topology: Topology) -> np.ndarray:
    """Metropolis-Hastings mixing matrix (App. B): symmetric, doubly
    stochastic. W_ij = 1 / (1 + max(d_i, d_j)) for edges, the diagonal
    absorbs the slack."""
    return _metropolis(topology.adjacency)


def beta(w: np.ndarray) -> float:
    """Second largest eigenvalue magnitude of a symmetric mixing matrix."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(eig[1]) if eig.size > 1 else 0.0


def spectral_gap(w: np.ndarray) -> float:
    return 1.0 - beta(w)


def reweight_for_active(topology: Topology, active: np.ndarray) -> np.ndarray:
    """Mixing matrix when only ``active`` nodes participate (§2): Metropolis
    weights on the induced subgraph; inactive nodes get W_kk = 1."""
    return _metropolis(topology.adjacency & active[:, None] & active[None, :])
