"""GLM problem definitions mapped to the CoLA primal/dual pair (A)/(B).

Problem (A):  min_x  f(A x) + sum_i g_i(x_i),  A in R^{d x n}, columns A_i.

Every problem supplies ``f``, ``grad_f`` and the smoothness constant
``1/tau``, the conjugate ``f_conj`` (for duality gaps, Lemma 2), separable
``g`` via elementwise ``g_el(x, p)`` / ``g_conj_el(u, p)`` with an optional
per-coordinate parameter ``p`` (the labels of the ridge-dual mapping), the
prox ``prox_g_el(z, step, p)``, ``mu_g`` (Thm 1), ``l_bound`` (Thm 2) and
``prox_spec = (l1, l2, box)``, the scalars of the generalized elastic-net
prox the CD kernels apply.

The data-fit functions take ``(..., d)`` tensors and reduce the last axis,
so one call evaluates all K stacked node estimates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Problem:
    """A composite objective f(Ax) + sum_i g_i(x_i) with its dual structure."""

    name: str
    a: torch.Tensor  # data matrix, (d, n)
    f: Callable[[torch.Tensor], torch.Tensor]
    grad_f: Callable[[torch.Tensor], torch.Tensor]
    f_conj: Callable[[torch.Tensor], torch.Tensor]
    g_el: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    g_conj_el: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    prox_g_el: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    tau: float          # f is (1/tau)-smooth
    mu_g: float         # strong convexity of every g_i
    l_bound: float      # L-bounded support of g_i (inf if not bounded)
    g_param: torch.Tensor | None = None  # (n,) per-coordinate parameter
    # (l1, l2, box) of the generalized elastic-net prox family
    #   prox(z) = clip(soft(z - step*g_param_i, step*l1) / (1 + step*l2), +-box)
    # — consumed by the CD kernels (repro_torch.kernels.cd_glm).
    prox_spec: tuple = (0.0, 0.0, math.inf)

    @property
    def d(self) -> int:
        return self.a.shape[0]

    @property
    def n(self) -> int:
        return self.a.shape[1]

    def g_params(self) -> torch.Tensor:
        if self.g_param is None:
            return torch.zeros((self.n,), dtype=self.a.dtype,
                               device=self.a.device)
        return self.g_param

    def g(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.g_el(x, self.g_params()))

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        """F_A(x) = f(Ax) + g(x)."""
        return self.f(self.a @ x) + self.g(x)

    def dual_objective(self, w: torch.Tensor) -> torch.Tensor:
        """F_B(w) = f*(w) + sum_i g_i*(-A_i^T w)  (problem (B))."""
        return self.f_conj(w) + torch.sum(
            self.g_conj_el(-(self.a.T @ w), self.g_params()))


# ---------------------------------------------------------------------------
# f parts (data-fit terms), on (..., d) with the last axis reduced
# ---------------------------------------------------------------------------

def _quadratic_f(b: torch.Tensor):
    """f(v) = 0.5 ||v - b||^2 -> 1-smooth (tau = 1); f*(w) = 0.5||w||^2 + <w, b>."""
    def f(v):
        return 0.5 * torch.sum((v - b) ** 2, dim=-1)

    def grad_f(v):
        return v - b

    def f_conj(w):
        return 0.5 * torch.sum(w ** 2, dim=-1) + torch.sum(w * b, dim=-1)

    return f, grad_f, f_conj, 1.0


def _logistic_f(y: torch.Tensor):
    """f(v) = sum_j log(1 + exp(-y_j v_j)); (1/4)-smooth -> tau = 4.

    f*(w): with u := -w.y constrained to [0,1],
    f*(w) = sum_j u log u + (1-u) log(1-u)  (negative binary entropy).
    """
    def f(v):
        yv = -y * v
        return torch.sum(torch.logaddexp(torch.zeros_like(yv), yv), dim=-1)

    def grad_f(v):
        return -y * torch.sigmoid(-y * v)

    def f_conj(w):
        u = torch.clamp(-w * y, 1e-12, 1.0 - 1e-12)
        return torch.sum(u * torch.log(u) + (1.0 - u) * torch.log1p(-u),
                         dim=-1)

    return f, grad_f, f_conj, 4.0


# ---------------------------------------------------------------------------
# g parts (separable terms), elementwise in (x, p)
# ---------------------------------------------------------------------------

def _l2_g(lam: float):
    def g_el(x, p):
        return 0.5 * lam * x ** 2

    def g_conj_el(u, p):
        return u ** 2 / (2.0 * lam)

    def prox(z, step, p):
        return z / (1.0 + step * lam)

    return g_el, g_conj_el, prox, lam, math.inf


def _l1_g(lam: float, box: float):
    """g_i(x) = lam |x| + i{|x| <= box}; g*(u) = box * max(0, |u| - lam)."""
    def g_el(x, p):
        return lam * torch.abs(x) + torch.where(
            torch.abs(x) <= box, 0.0, math.inf)

    def g_conj_el(u, p):
        return box * torch.clamp(torch.abs(u) - lam, min=0.0)

    def prox(z, step, p):
        soft = torch.sign(z) * torch.clamp(torch.abs(z) - step * lam, min=0.0)
        return torch.clamp(soft, -box, box)

    return g_el, g_conj_el, prox, 0.0, box


def _elastic_net_g(lam: float, alpha: float, box: float):
    """g_i(x) = lam * (alpha |x| + (1-alpha)/2 x^2)."""
    l1 = lam * alpha
    l2 = lam * (1.0 - alpha)

    def g_el(x, p):
        return l1 * torch.abs(x) + 0.5 * l2 * x ** 2

    def g_conj_el(u, p):
        if l2 > 0:
            return torch.clamp(torch.abs(u) - l1, min=0.0) ** 2 / (2.0 * l2)
        return box * torch.clamp(torch.abs(u) - l1, min=0.0)

    def prox(z, step, p):
        soft = torch.sign(z) * torch.clamp(torch.abs(z) - step * l1, min=0.0)
        return soft / (1.0 + step * l2)

    l_bound = math.inf if l2 > 0 else box
    return g_el, g_conj_el, prox, l2, l_bound


# ---------------------------------------------------------------------------
# Problem constructors: array-like data, placed on ``device`` (default cuda)
# ---------------------------------------------------------------------------

def _place(x_data, y, device):
    dev = resolve(device)
    return (torch.as_tensor(x_data, device=dev),
            torch.as_tensor(y, device=dev))


def ridge_primal(x_data, y, lam: float, *, device=None) -> Problem:
    """Ridge regression, feature-partitioned: min_x 0.5||Xx-y||^2 + lam/2||x||^2."""
    x_data, y = _place(x_data, y, device)
    f, grad_f, f_conj, tau = _quadratic_f(y)
    g_el, g_conj_el, prox, mu, l = _l2_g(lam)
    return Problem("ridge_primal", x_data, f, grad_f, f_conj,
                   g_el, g_conj_el, prox, tau, mu, l,
                   prox_spec=(0.0, lam, math.inf))


def ridge_dual(x_data, y, lam: float, *, device=None) -> Problem:
    """Ridge regression mapped through (B): sample-partitioned.

    Problem (B) over w (one dual variable per sample) is
    min_w 0.5||w||^2 + <w,y> + ||X^T w||^2/(2 lam), itself of form (A) with
    A~ = X^T (columns = samples), f~(u) = ||u||^2/(2 lam) and
    g~_j(w_j) = 0.5 w_j^2 + y_j w_j.
    """
    x_data, y = _place(x_data, y, device)
    at = x_data.T  # (n_features, n_samples): columns are samples

    def f(u):
        return torch.sum(u ** 2, dim=-1) / (2.0 * lam)

    def grad_f(u):
        return u / lam

    def f_conj(s):
        return 0.5 * lam * torch.sum(s ** 2, dim=-1)

    def g_el(w, p):
        return 0.5 * w ** 2 + p * w

    def g_conj_el(u, p):
        return 0.5 * (u - p) ** 2

    def prox(z, step, p):
        return (z - step * p) / (1.0 + step)

    return Problem("ridge_dual", at, f, grad_f, f_conj,
                   g_el, g_conj_el, prox, lam, 1.0, math.inf, g_param=y,
                   prox_spec=(0.0, 1.0, math.inf))


def lasso(x_data, y, lam: float, box: float = 10.0, *, device=None) -> Problem:
    """Lasso, feature-partitioned: min_x 0.5||Xx - y||^2 + lam ||x||_1."""
    x_data, y = _place(x_data, y, device)
    f, grad_f, f_conj, tau = _quadratic_f(y)
    g_el, g_conj_el, prox, mu, l = _l1_g(lam, box)
    return Problem("lasso", x_data, f, grad_f, f_conj,
                   g_el, g_conj_el, prox, tau, mu, l,
                   prox_spec=(lam, 0.0, box))


def elastic_net(x_data, y, lam: float, alpha: float = 0.5, box: float = 1e3,
                *, device=None) -> Problem:
    x_data, y = _place(x_data, y, device)
    f, grad_f, f_conj, tau = _quadratic_f(y)
    g_el, g_conj_el, prox, mu, l = _elastic_net_g(lam, alpha, box)
    return Problem("elastic_net", x_data, f, grad_f, f_conj,
                   g_el, g_conj_el, prox, tau, mu, l,
                   prox_spec=(lam * alpha, lam * (1.0 - alpha), box))


def logistic_l2(x_data, y, lam: float, *, device=None) -> Problem:
    """L2-regularized logistic regression, feature-partitioned. y in {-1, +1}."""
    x_data, y = _place(x_data, y, device)
    f, grad_f, f_conj, tau = _logistic_f(y)
    g_el, g_conj_el, prox, mu, l = _l2_g(lam)
    return Problem("logistic_l2", x_data, f, grad_f, f_conj,
                   g_el, g_conj_el, prox, tau, mu, l,
                   prox_spec=(0.0, lam, math.inf))


def logistic_l1(x_data, y, lam: float, box: float = 10.0, *,
                device=None) -> Problem:
    """Sparse logistic regression (general convex case of Thm 2)."""
    x_data, y = _place(x_data, y, device)
    f, grad_f, f_conj, tau = _logistic_f(y)
    g_el, g_conj_el, prox, mu, l = _l1_g(lam, box)
    return Problem("logistic_l1", x_data, f, grad_f, f_conj,
                   g_el, g_conj_el, prox, tau, mu, l,
                   prox_spec=(lam, 0.0, box))


PROBLEMS = {
    "ridge_primal": ridge_primal,
    "ridge_dual": ridge_dual,
    "lasso": lasso,
    "elastic_net": elastic_net,
    "logistic_l2": logistic_l2,
    "logistic_l1": logistic_l1,
}
