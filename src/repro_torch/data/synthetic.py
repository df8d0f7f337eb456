"""Synthetic dataset generators (numpy, seeded).

The paper's Fig. 1 uses a dense synthetic regression set; Figs. 2-4 use
LIBSVM datasets (URL, webspam, epsilon) that are not shipped, so runs use
these generators as stand-ins of the same shape. The recipe and the seeds
match the reference package's generator draw for draw, so both packages can
be fed identical data.
"""
from __future__ import annotations

import numpy as np


def regression(n_samples: int, n_features: int, *, noise: float = 0.1,
               density: float = 1.0, sparsity_solution: float = 0.1,
               seed: int = 0, dtype=np.float32):
    """Dense/sparse linear-regression data: X (n_samples, n_features), y, w.

    Ground-truth weights are ``sparsity_solution``-sparse; columns are
    roughly unit-norm (normal / sqrt(n_samples)).
    """
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_samples, n_features)).astype(dtype)
    if density < 1.0:
        mask = rng.random((n_samples, n_features)) < density
        x = np.where(mask, x, 0.0).astype(dtype)
    x /= np.sqrt(n_samples)
    w = np.zeros(n_features, dtype=dtype)
    nnz = max(1, int(sparsity_solution * n_features))
    idx = rng.choice(n_features, size=nnz, replace=False)
    w[idx] = rng.normal(size=nnz).astype(dtype)
    y = x @ w + noise * rng.normal(size=n_samples).astype(dtype)
    return x.astype(dtype), y.astype(dtype), w


def classification(n_samples: int, n_features: int, *, seed: int = 0,
                   density: float = 1.0, dtype=np.float32):
    """Binary classification with labels in {-1, +1} from a logistic model."""
    x, _, w = regression(n_samples, n_features, noise=0.0, density=density,
                         seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    logits = 5.0 * (x @ w)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = np.where(rng.random(n_samples) < p, 1.0, -1.0).astype(dtype)
    return x, y, w
