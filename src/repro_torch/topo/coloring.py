"""Edge coloring: cover a graph's edges with matchings.

One point-to-point exchange (``repro_torch.dist.axis.NodeAxis.permute``)
moves one permutation of the ranks. A matching, a set of vertex-disjoint
edges {i, j}, lowers to the swap i <-> j for each of its edges (unmatched
ranks send nothing and receive zeros), so a proper edge coloring, a
partition of the edges into matchings, is a gossip step of one exchange per
color.

Vizing's theorem bounds the colors by Delta + 1, which
``misra_gries_edge_coloring`` reaches on any simple graph. Greedy first-fit
is bounded by 2 Delta - 1: it lands on Delta or Delta + 1 on the paper's
regular graphs, but above Delta + 1 on odd complete graphs (K_5 takes 7
colors). ``edge_coloring(method="auto")`` runs greedy and falls back to
Misra–Gries exactly when greedy exceeds the Vizing bound.

Numpy only and deterministic: the same support gives the same colors, the
colors of the JAX reference's ``repro.topo.coloring`` (the tests hold the
two equal).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]


def undirected_edges(support: np.ndarray) -> List[Edge]:
    """Canonical (i < j) edges of a support matrix's off-diagonal pattern,
    symmetrized (a one-sided entry still means the two nodes exchange)."""
    s = np.asarray(support)
    nz = (s != 0) | (s != 0).T
    np.fill_diagonal(nz, False)
    ii, jj = np.nonzero(np.triu(nz))
    return [(int(i), int(j)) for i, j in zip(ii, jj)]


def _check_edges(edges, num_nodes: int) -> None:
    for i, j in edges:
        if not (0 <= i < num_nodes and 0 <= j < num_nodes) or i == j:
            raise ValueError(f"bad edge ({i}, {j}) for K={num_nodes}")


def _degrees(edges, num_nodes: int) -> np.ndarray:
    deg = np.zeros(num_nodes, dtype=np.int64)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    return deg


def greedy_edge_coloring(edges: Iterable[Edge], num_nodes: int
                         ) -> List[List[Edge]]:
    """First-fit proper edge coloring; the list of color classes.

    Edges are visited highest-degree endpoint first (ties by the canonical
    (i, j) order), each taking the smallest color free at both ends."""
    edges = list(edges)
    _check_edges(edges, num_nodes)
    deg = _degrees(edges, num_nodes)
    order = sorted(edges,
                   key=lambda e: (-max(deg[e[0]], deg[e[1]]),
                                  -min(deg[e[0]], deg[e[1]]), e))
    node_colors: List[set] = [set() for _ in range(num_nodes)]
    classes: List[List[Edge]] = []
    for i, j in order:
        used = node_colors[i] | node_colors[j]
        c = 0
        while c in used:
            c += 1
        while c >= len(classes):
            classes.append([])
        classes[c].append((i, j))
        node_colors[i].add(c)
        node_colors[j].add(c)
    return [sorted(cls) for cls in classes]


def misra_gries_edge_coloring(edges: Iterable[Edge], num_nodes: int
                              ) -> List[List[Edge]]:
    """Vizing-optimal edge coloring: at most Delta + 1 color classes.

    Misra and Gries (1992): each uncolored edge (u, v) grows a maximal fan
    of u from v, inverts the alternating cd-path through u so that the fan
    tip's free color d is free at u too, rotates a fan prefix and colors
    its last edge d. Edges in sorted order, fans along sorted adjacency,
    free colors always the smallest: deterministic."""
    edges = [(min(i, j), max(i, j)) for i, j in edges]
    _check_edges(edges, num_nodes)
    if len(set(edges)) != len(edges):
        raise ValueError("duplicate edges (Misra–Gries needs a simple graph)")

    adj: List[List[int]] = [[] for _ in range(num_nodes)]
    for i, j in edges:
        adj[i].append(j)
        adj[j].append(i)
    for nbrs in adj:
        nbrs.sort()

    # used[v]: color -> the neighbor v reaches over that color
    used: List[Dict[int, int]] = [dict() for _ in range(num_nodes)]
    color_of: Dict[Edge, int] = {}

    def set_color(a: int, b: int, c: int) -> None:
        color_of[(min(a, b), max(a, b))] = c
        used[a][c] = b
        used[b][c] = a

    def unset_color(a: int, b: int) -> int:
        c = color_of.pop((min(a, b), max(a, b)))
        del used[a][c]
        del used[b][c]
        return c

    def free_color(v: int) -> int:
        c = 0
        while c in used[v]:
            c += 1
        return c  # <= deg(v) <= Delta

    for u, v in sorted(edges):
        # maximal fan of u from v: fan[j + 1] is a colored neighbor whose
        # edge color is free on fan[j]
        fan = [v]
        in_fan = {v}
        grew = True
        while grew:
            grew = False
            last = fan[-1]
            for w in adj[u]:
                if w in in_fan:
                    continue
                cw = color_of.get((min(u, w), max(u, w)))
                if cw is not None and cw not in used[last]:
                    fan.append(w)
                    in_fan.add(w)
                    grew = True
                    break
        c = free_color(u)
        d = free_color(fan[-1])
        if c != d:
            # invert the cd-path from u (it starts with a d edge); then d
            # is free at u. Unset the whole path first: interior vertices
            # carry both colors.
            path = []
            cur, col = u, d
            while col in used[cur]:
                nxt = used[cur][col]
                path.append((cur, nxt))
                cur, col = nxt, (c if col == d else d)
            flipped = [(a, b, unset_color(a, b)) for a, b in path]
            for a, b, old in flipped:
                set_color(a, b, c if old == d else d)
        # the shortest fan prefix that is still a fan and whose tip has d
        # free
        w_idx = None
        for idx in range(len(fan)):
            if idx > 0:
                cj = color_of[(min(u, fan[idx]), max(u, fan[idx]))]
                if cj in used[fan[idx - 1]]:
                    break
            if d not in used[fan[idx]]:
                w_idx = idx
                break
        if w_idx is None:  # pragma: no cover - a broken invariant
            raise AssertionError("Misra–Gries: no rotatable fan prefix")
        # rotate: each fan edge takes its successor's color, the tip gets d
        shifted = [unset_color(u, fan[j + 1]) for j in range(w_idx)]
        for j in range(w_idx):
            set_color(u, fan[j], shifted[j])
        set_color(u, fan[w_idx], d)

    classes: List[List[Edge]] = [[] for _ in range(
        max(color_of.values(), default=-1) + 1)]
    for e, c in color_of.items():
        classes[c].append(e)
    return [sorted(cls) for cls in classes if cls]


def edge_coloring(edges: Iterable[Edge], num_nodes: int,
                  method: str = "auto") -> List[List[Edge]]:
    """The compiler's coloring pass: ``"auto"`` (greedy, Misra–Gries when
    greedy exceeds Delta + 1), ``"mg"`` or ``"greedy"``."""
    edges = list(edges)
    if method == "greedy":
        return greedy_edge_coloring(edges, num_nodes)
    if method == "mg":
        return misra_gries_edge_coloring(edges, num_nodes)
    if method != "auto":
        raise ValueError(f"unknown coloring method {method!r} "
                         "(want 'auto', 'mg' or 'greedy')")
    classes = greedy_edge_coloring(edges, num_nodes)
    if len(classes) > int(_degrees(edges, num_nodes).max(initial=0)) + 1:
        classes = misra_gries_edge_coloring(edges, num_nodes)
    return classes


def check_matching(edges: Sequence[Edge], num_nodes: int) -> None:
    """Raise unless ``edges`` are vertex-disjoint (one exchange's swaps)."""
    seen: set = set()
    for i, j in edges:
        if i in seen or j in seen:
            raise ValueError(f"color class is not a matching at edge ({i},{j})")
        seen.add(i)
        seen.add(j)


def check_coloring(classes: Sequence[Sequence[Edge]], edges: Iterable[Edge],
                   num_nodes: int) -> None:
    """Raise unless ``classes`` is a proper edge coloring of ``edges``:
    every class a matching, the classes an exact partition of the edges."""
    for cls in classes:
        check_matching(cls, num_nodes)
    flat = sorted((min(i, j), max(i, j)) for cls in classes for i, j in cls)
    want = sorted((min(i, j), max(i, j)) for i, j in edges)
    if flat != want:
        raise ValueError(
            f"color classes do not partition the edge set: colored "
            f"{len(flat)} edge slots vs {len(want)} graph edges")
