"""Decentralized duality machinery — the numeric core of both recorders.

* the **global** quantities of Lemmas 1/2 — H_A / H_B objectives, the
  decentralized duality gap (Eq. 6) and the consensus violation — from the
  full stacked state (``gap_report``, behind ``metrics.GapRecorder``);
* the **local** Prop.-1 certificates (Eqs. 9-10) — per-node conditions whose
  conjunction certifies ``G_H <= eps`` from one gossip exchange of neighbor
  gradients (``local_certificates`` and its pieces, which
  ``metrics.CertificateRecorder`` assembles on the device).

The Eq.-10 neighborhood mean averages exactly the gradient values a gossip
exchange delivers (a node's own plus its neighbors'), selected by the 0/1
support of the adjacency or of the round's mixing matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.partition import Partition


class GapReport(NamedTuple):
    primal: torch.Tensor               # F_A(x)
    hamiltonian: torch.Tensor          # H_A(x, {v_k})
    dual: torch.Tensor                 # -H_B({w_k}) with w_k = grad f(v_k)
    gap: torch.Tensor                  # G_H (Eq. 6)
    consensus_violation: torch.Tensor  # sum_k ||v_k - Ax||^2


def hamiltonian(problem, x_global, v_stack) -> torch.Tensor:
    """H_A(x, {v_k}) = (1/K) sum_k f(v_k) + g(x)   (Eq. DA)."""
    return torch.mean(problem.f(v_stack)) + problem.g(x_global)


def gap_report(problem, part: Partition, x_parts, v_stack) -> GapReport:
    """All Lemma-1/2 quantities at the optimality choice w_k = grad f(v_k)."""
    x = part.merge_vector(x_parts)
    ax = problem.a @ x
    w_stack = problem.grad_f(v_stack)                    # (K, d)
    w_bar = torch.mean(w_stack, dim=0)
    g_val = problem.g(x)
    gc_val = torch.sum(problem.g_conj_el(-(problem.a.T @ w_bar),
                                         problem.g_params()))
    h_a = torch.mean(problem.f(v_stack)) + g_val
    h_b = torch.mean(problem.f_conj(w_stack)) + gc_val
    cv = torch.sum((v_stack - ax[None, :]) ** 2)
    return GapReport(primal=problem.f(ax) + g_val, hamiltonian=h_a,
                     dual=-h_b, gap=h_a + h_b, consensus_violation=cv)


def block_spectral_norms(a_parts, iters: int = 50, seed: int = 0,
                         cache=None) -> torch.Tensor:
    """sigma_k = ||A_[k]||_2^2 (Eq. 7) for every node, by power iteration.

    ``cache`` short-circuits the iteration with a previously computed
    ``(K,)`` result. The start vector comes from a ``torch.Generator``
    seeded with ``seed``, so it differs from the reference's ``jax.random``
    start: the two agree to the power iteration's accuracy, not bitwise.
    """
    k, d, n_k = a_parts.shape
    if cache is not None:
        cache = torch.as_tensor(cache, dtype=a_parts.dtype,
                                device=a_parts.device)
        if tuple(cache.shape) != (k,):
            raise ValueError(f"sigma_k cache has shape {tuple(cache.shape)}, "
                             f"want ({k},)")
        return cache
    gen = torch.Generator(device=a_parts.device).manual_seed(seed)
    v = torch.randn((k, n_k, 1), generator=gen, dtype=a_parts.dtype,
                    device=a_parts.device)
    a_t = a_parts.transpose(1, 2)
    for _ in range(iters):
        w = torch.bmm(a_t, torch.bmm(a_parts, v))
        v = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-30)
    num = torch.sum(torch.bmm(a_t, torch.bmm(a_parts, v)) * v, dim=(1, 2))
    den = torch.sum(v * v, dim=(1, 2))
    return num / (den + 1e-30)


class CertificateReport(NamedTuple):
    """Prop. 1: per-node booleans whose conjunction certifies G_H <= eps."""

    local_gap: torch.Tensor          # (K,) LHS of Eq. 9
    local_gap_ok: torch.Tensor       # (K,) Eq. 9 holds
    grad_disagreement: torch.Tensor  # (K,) LHS of Eq. 10
    grad_ok: torch.Tensor            # (K,) Eq. 10 holds
    certified: torch.Tensor          # scalar bool: all nodes pass both


def neighbor_mask(neighbors, k: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Self-inclusive 0/1 neighborhood mask N_k ∪ {k} from a boolean
    adjacency (no self loops) or a mixing matrix W (its support)."""
    m = torch.as_tensor(np.asarray(neighbors) != 0, dtype=dtype, device=device)
    return torch.maximum(m, torch.eye(k, dtype=dtype, device=device))


def neighborhood_mean(grads, mask) -> torch.Tensor:
    """Eq.-10 neighborhood mean: each node averages the gradient rows its
    exchange delivers (``mask``-selected rows of ``grads``)."""
    sel = torch.where(mask[:, :, None] > 0, grads[None, :, :],
                      torch.zeros((), dtype=grads.dtype, device=grads.device))
    counts = torch.sum(mask, dim=1, keepdim=True)
    return torch.sum(sel, dim=1) / counts


def consensus_residual(v_sum, ax_sum, k_nodes: int) -> torch.Tensor:
    """Relative Lemma-1 invariant residual ||(1/K) sum_k v_k - A x|| /
    (||A x|| + 1): zero in exact arithmetic for every honest CoLA run."""
    rho = torch.linalg.vector_norm(v_sum / k_nodes - ax_sum)
    return rho / (torch.linalg.vector_norm(ax_sum) + 1.0)


def node_subproblem_gaps(problem, x_parts, v_stack, a_parts, gp_parts, masks,
                         grads) -> torch.Tensor:
    """(K,) LHS of condition (9): each node's local subproblem duality gap,
    from node-local quantities only."""
    atg = torch.bmm(grads.unsqueeze(1), a_parts).squeeze(1)     # (K, n_k)
    conj = problem.g_conj_el(-atg, gp_parts)
    prim = problem.g_el(x_parts, gp_parts)
    return torch.sum(v_stack * grads, dim=1) + torch.sum((prim + conj) * masks,
                                                         dim=1)


def certificate_thresholds(masks, sigma_k, beta_ub: float, l_bound: float,
                           eps: float, k_nodes: int):
    """(gap_thresh, grad_thresh): the Prop.-1 RHS of conditions (9), (10).
    Round-invariant, so recorders evaluate this once at init."""
    gap_thresh = eps / (2.0 * k_nodes)
    n_k_sizes = torch.sum(torch.as_tensor(masks), dim=1)
    scale = torch.sum(n_k_sizes ** 2 * torch.as_tensor(sigma_k))
    grad_thresh = (scale ** -0.5) * (1.0 - beta_ub) / (
        2.0 * l_bound * float(np.sqrt(float(k_nodes)))) * eps
    return gap_thresh, grad_thresh


def local_certificates(problem, part: Partition, x_parts, v_stack, a_parts,
                       gp_parts, masks, neighbors, beta_ub: float, sigma_k,
                       eps: float, l_bound: float, grads=None,
                       neigh_mean=None) -> CertificateReport:
    """Evaluate the Prop.-1 conditions (9) and (10) from local quantities.

    Args:
      neighbors: (K, K) boolean adjacency or the round's mixing matrix W;
        only the support is used (self always included).
      grads / neigh_mean: optional precomputed (K, d) gradients and Eq.-10
        neighborhood means — recomputed from ``v_stack`` when omitted.
    """
    k_nodes = v_stack.shape[0]
    if grads is None:
        grads = problem.grad_f(v_stack)
    local_gap = node_subproblem_gaps(problem, x_parts, v_stack, a_parts,
                                     gp_parts, masks, grads)
    if neigh_mean is None:
        mask = neighbor_mask(neighbors, k_nodes, dtype=grads.dtype,
                             device=grads.device)
        neigh_mean = neighborhood_mean(grads, mask)
    disagree = torch.linalg.vector_norm(grads - neigh_mean, dim=1)
    gap_thresh, grad_thresh = certificate_thresholds(
        masks, sigma_k, beta_ub, l_bound, eps, k_nodes)
    cond9 = local_gap <= gap_thresh
    cond10 = disagree <= grad_thresh
    return CertificateReport(
        local_gap=local_gap, local_gap_ok=cond9,
        grad_disagreement=disagree, grad_ok=cond10,
        certified=torch.all(cond9 & cond10))
