"""Graph families beyond the paper's sweep, and the registry by name.

``core.topology`` has the Fig.-3 family (ring, c-connected cycle, grid,
torus, complete, star). The plan compiler runs any sparse graph at
O(deg · d) bytes per node, so this module adds random regular expanders,
random geometric graphs and hypercubes. ``GRAPHS`` maps a name to a
function of K. Numpy only; each family is deterministic in its seed and
gives the adjacency of the JAX reference's ``repro.topo.graphs``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core import topology as topo


def is_connected(adj: np.ndarray) -> bool:
    """BFS connectivity of a boolean adjacency matrix."""
    k = adj.shape[0]
    if k == 0:
        return True
    seen = np.zeros(k, dtype=bool)
    frontier = [0]
    seen[0] = True
    while frontier:
        nxt = adj[frontier].any(axis=0) & ~seen
        frontier = list(np.nonzero(nxt)[0])
        seen |= nxt
    return bool(seen.all())


def expander(k: int, degree: int = 4, seed: int = 0,
             max_tries: int = 200) -> topo.Topology:
    """Random regular-ish expander: ``degree // 2`` random Hamiltonian
    cycles superposed (and a random perfect matching for an odd degree),
    drawn again until connected with every node at the full degree."""
    if degree < 2 or degree >= k:
        raise ValueError(f"need 2 <= degree < k, got degree={degree}, k={k}")
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        adj = np.zeros((k, k), dtype=bool)
        for _ in range(degree // 2):
            order = rng.permutation(k)
            for a, b in zip(order, np.roll(order, -1)):
                adj[a, b] = adj[b, a] = True
        if degree % 2:
            if k % 2:
                raise ValueError("odd degree expander needs even k")
            order = rng.permutation(k)
            for a, b in order.reshape(-1, 2):
                adj[a, b] = adj[b, a] = True
        np.fill_diagonal(adj, False)
        if is_connected(adj) and adj.sum(axis=1).min() >= degree:
            return topo.Topology(f"expander-d{degree}", adj)
    raise RuntimeError(f"no connected expander found for k={k}, "
                       f"degree={degree} in {max_tries} tries")


def random_geometric(k: int, radius: float | None = None,
                     seed: int = 0) -> topo.Topology:
    """K points in the unit square, edges within ``radius``. ``None``
    starts at the connectivity threshold sqrt(2 ln k / k) and grows it by
    1.25x until the graph is connected."""
    if k < 2:
        raise ValueError(f"need k >= 2, got {k}")
    rng = np.random.default_rng(seed)
    pts = rng.random((k, 2))
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    r = radius if radius is not None else float(
        np.sqrt(2.0 * np.log(max(k, 2)) / k))
    while True:
        adj = d2 <= r * r
        np.fill_diagonal(adj, False)
        if is_connected(adj):
            return topo.Topology(f"rgg-r{r:.2f}", adj)
        if radius is not None:
            raise ValueError(
                f"random_geometric(k={k}, radius={radius}, seed={seed}) is "
                "disconnected — grow the radius or pass radius=None")
        r *= 1.25


def hypercube(k: int) -> topo.Topology:
    """Boolean hypercube on K = 2^m nodes (degree and diameter log2 K)."""
    m = k.bit_length() - 1
    if k <= 0 or (1 << m) != k:
        raise ValueError(f"hypercube needs a power-of-two k, got {k}")
    adj = np.zeros((k, k), dtype=bool)
    for i in range(k):
        for b in range(m):
            j = i ^ (1 << b)
            adj[i, j] = adj[j, i] = True
    return topo.Topology(f"hypercube-{m}", adj)


# the paper's Fig.-3 family plus the families above, by name
GRAPHS: Dict[str, Callable[[int], topo.Topology]] = dict(topo.TOPOLOGIES)
GRAPHS.update({
    "torus2d": lambda k: topo.torus_2d(*topo._square_factors(k)),
    "expander": lambda k: expander(k, degree=4, seed=0),
    "rgg": lambda k: random_geometric(k, seed=0),
    "hypercube": hypercube,
})


def build(name: str, k: int) -> topo.Topology:
    """The registry's graph ``name`` over K nodes."""
    if name not in GRAPHS:
        raise ValueError(f"unknown topology {name!r} "
                         f"(want one of {sorted(GRAPHS)})")
    return GRAPHS[name](k)
