"""The cell's data, made on the device.

The base matrix stands in for the LIBSVM ``epsilon`` file, which is one
fixed data set: it is the repository's synthetic regression recipe
(``repro_torch.data.synthetic.regression``, drawn here on the device with
a ``torch.Generator``) at the published shape, from the configuration's
``data_seed``. ``--seed`` then shuffles it the way a user shuffles before
distributing: it draws an exact symmetry of the problem, so every seed
gives other bytes and the same work (the same rounds to the target, up to
rounding):

* a permutation of A's rows (the lasso's samples, the ridge dual's
  features): f and its gradient act on v elementwise;
* a sign for every column of A (feature j with its weight, or sample j with
  its label): g_j is even in (x_j, p_j);
* an automorphism of the node graph (a rotation or reflection of the
  ring) applied to the K column blocks, so each node's block moves whole.
"""
from __future__ import annotations

import math

import torch

# seeds reach a little over 2**31 and may be negative: folded into the
# generator's 64-bit range
_SEED_MOD = 2 ** 64


def base_regression(n_samples: int, n_features: int, *, data_seed: int,
                    noise: float, sparsity_solution: float, device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """X (n_samples, n_features) with normal entries scaled by
    1/sqrt(n_samples), a ``sparsity_solution``-sparse normal ground truth
    w and y = X w + noise * normal."""
    gen = torch.Generator(device=device).manual_seed(data_seed % _SEED_MOD)
    x = torch.randn((n_samples, n_features), generator=gen, device=device)
    x /= math.sqrt(n_samples)
    nnz = max(1, int(sparsity_solution * n_features))
    idx = torch.randperm(n_features, generator=gen, device=device)[:nnz]
    w = torch.zeros((n_features,), device=device)
    w[idx] = torch.randn((nnz,), generator=gen, device=device)
    y = x @ w + noise * torch.randn((n_samples,), generator=gen,
                                    device=device)
    return x, y


def ring_automorphism(k: int, gen: torch.Generator) -> list[int]:
    """pi(b) = (s * b + r) mod K, a rotation r and an orientation s."""
    draw = torch.randint(0, 2 * k, (1,), generator=gen,
                         device=gen.device).item()
    r, s = draw % k, (1 if draw < k else -1)
    return [(s * b + r) % k for b in range(k)]


GRAPH_AUTOMORPHISMS = {"ring": ring_automorphism}


def shuffled(x: torch.Tensor, y: torch.Tensor, *, problem: str, nodes: int,
             graph: str, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """X and y under the symmetry that ``seed`` draws (module docstring).
    For the lasso A = X (rows: samples, columns: features); for the ridge
    dual A = X^T (rows: features, columns: samples)."""
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(seed % _SEED_MOD)
    lasso = problem == "lasso"
    d, n = (x.shape[0], x.shape[1]) if lasso else (x.shape[1], x.shape[0])
    if n % nodes:
        raise ValueError(f"{n} columns of A do not split into {nodes} "
                         "equal blocks: the node automorphism moves whole "
                         "blocks")
    row_perm = torch.randperm(d, generator=gen, device=dev)
    signs = torch.randint(0, 2, (n,), generator=gen, device=dev) \
        .to(x.dtype) * 2 - 1
    pi = GRAPH_AUTOMORPHISMS[graph](nodes, gen)
    n_k = n // nodes
    # block b of the shuffled columns is block pi^-1(b) of the base ones
    inv = [0] * nodes
    for b, target in enumerate(pi):
        inv[target] = b
    cols = torch.cat([torch.arange(inv[b] * n_k, (inv[b] + 1) * n_k,
                                   device=dev) for b in range(nodes)])
    if lasso:
        x = x.index_select(0, row_perm).index_select(1, cols)
        x *= signs[None, :]
        y = y.index_select(0, row_perm)
    else:
        x = x.index_select(0, cols).index_select(1, row_perm)
        x *= signs[:, None]
        y = y.index_select(0, cols) * signs
    return x, y


def make(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell's (X, y) on ``device``."""
    data = config["data"]
    x, y = base_regression(config["n_samples"], config["n_features"],
                           data_seed=data["data_seed"], noise=data["noise"],
                           sparsity_solution=data["sparsity_solution"],
                           device=device)
    return shuffled(x, y, problem=config["problem"], nodes=config["nodes"],
                    graph=config["graph"], seed=seed)
