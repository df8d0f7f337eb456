"""The data-local quadratic subproblem G_k^{sigma'} (paper Eq. 1-2) and its
Theta-approximate block coordinate-descent solver (Assumption 1).

    G_k(dx; v_k, x_k) = (1/K) f(v_k) + <grad_f(v_k), A_k dx>
                        + sigma'/(2 tau) ||A_k dx||^2
                        + sum_{i in P_k} g_i(x_i + dx_i)

Each single-coordinate update has the closed form

    z      = x_i + dx_i
    grad_i = A_i^T (grad_f(v_k) + (sigma'/tau) r)        with r = A_k dx
    q_i    = (sigma'/tau) ||A_i||^2
    z_new  = prox_{g_i, 1/q_i}(z - grad_i / q_i)
    dx_i  += z_new - z;   r += A_i (z_new - z)

Two formulations of the per-coordinate gradient, identical in exact
arithmetic: the **residual** one above (two O(d) ops per step), and the
**Gram-cached** one, which carries h = G dx over the node-local Gram block
G = A_k^T A_k with c = A_k^T grad_f(v_k) taken once per round:

    grad_i = c_i + (sigma'/tau) h_i;   h += G[:, i] * delta

``cd_solve_all`` is the hand-written CUDA kernel on CUDA tensors
(``repro_torch.kernels.cd_glm``) and its plain PyTorch version on CPU
tensors. Both apply the problem's ``prox_spec`` (the generalized elastic-net
prox); it equals ``prox_g_el`` for every problem except that elastic net is
also clipped at its ``box`` (1e3), far outside any iterate it reaches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cd_glm


# Bytes of one node's (n_k, n_k) Gram block below which the Gram-cached
# path runs: the reference's budget (``GRAM_VMEM_BUDGET``, 8 MiB), kept so
# that both packages pick the same kernel at every shape. On Hopper it
# stands for "G small enough that streaming it beats re-reading rows of A";
# whether G also fits one block's shared memory only picks between the
# Gram kernel's two layouts (``cd_glm.gram_fits_smem``).
GRAM_BUDGET = 8 * 2 ** 20


def gram_pays(d: int, n_k: int, itemsize: int = 4) -> bool:
    """Cost model for the Gram-cached CD path, the reference's rule.

    A residual step moves ~2 * d * itemsize bytes, a Gram step
    ~n_k * itemsize. Caching pays iff the per-step saving is real
    (n_k < d) and the (n_k, n_k) block stays within ``GRAM_BUDGET``
    (n_k <= 1,448 in fp32).
    """
    return n_k < d and n_k * n_k * itemsize <= GRAM_BUDGET


def block_gram(a_parts: torch.Tensor) -> torch.Tensor:
    """(K, d, n_k) column blocks -> (K, n_k, n_k) node-local Gram blocks."""
    return torch.bmm(a_parts.transpose(1, 2), a_parts)


def block_cols(a_parts: torch.Tensor) -> torch.Tensor:
    """(K, d, n_k) column blocks -> contiguous (K, n_k, d) rows A_i, the
    residual kernel's layout."""
    return a_parts.transpose(1, 2).contiguous()


class SubproblemSpec(NamedTuple):
    """Static pieces of G_k shared by all nodes."""

    sigma_over_tau: float  # sigma' / tau
    inv_k: float           # 1 / K


def eval_subproblem(problem, spec: SubproblemSpec, a_k, x_k, dx_k, v_k,
                    grad_k, gp_k, mask_k) -> torch.Tensor:
    """Evaluate G_k^{sigma'}(dx; v_k, x_k) for one node."""
    r = a_k @ dx_k
    lin = torch.dot(grad_k, r)
    quad = 0.5 * spec.sigma_over_tau * torch.sum(r ** 2)
    g_term = torch.sum(problem.g_el(x_k + dx_k, gp_k) * mask_k)
    return spec.inv_k * problem.f(v_k) + lin + quad + g_term


def _kernel_args(problem, spec, num_steps, step_budgets):
    l1, l2, box = problem.prox_spec
    budgets = None
    if step_budgets is not None:
        budgets = step_budgets.to(torch.int32).contiguous()
    return dict(num_steps=int(num_steps),
                sigma_over_tau=float(spec.sigma_over_tau),
                l1=l1, l2=l2, box=box, budgets=budgets)


def cd_solve_all(problem, spec: SubproblemSpec, a_parts, x_parts, grads,
                 gp_parts, masks, num_steps: int, step_budgets=None,
                 gram_parts=None, a_cols=None, gram_cols=None) -> torch.Tensor:
    """Theta-approximate solve of every node's G_k by ``num_steps`` cyclic
    CD updates.

    Args:
      a_parts: (K, d, n_k) column blocks; x_parts/gp_parts/masks: (K, n_k);
        grads: (K, d) gradient of f at each node's (mixed) estimate.
      num_steps: single-coordinate updates per node — the paper's kappa
        knob (Fig. 1); may be less than one pass.
      step_budgets: optional (K,) per-node budgets <= num_steps (the
        node-specific Theta_k of Definition 5; budget 0 = no update).
      gram_parts: optional (K, n_k, n_k) Gram blocks — when given, the
        Gram-cached formulation runs.
      a_cols: optional (K, n_k, d) residual-kernel layout of ``a_parts``
        (``ColaEnv.a_cols``); built on the fly when omitted.
      gram_cols: optional Gram-kernel layout of ``gram_parts``
        (``cd_glm.gram_columns``, ``ColaEnv.gram_cols``); on the card the
        wrapper builds it when omitted.

    Returns dx_parts: (K, n_k).
    """
    kw = _kernel_args(problem, spec, num_steps, step_budgets)
    if gram_parts is not None:
        atg = torch.bmm(grads.unsqueeze(1), a_parts).squeeze(1)   # (K, n_k)
        return cd_glm.cd_solve_blocks_gram(gram_parts, x_parts, atg, gp_parts,
                                           masks, gram_cols=gram_cols, **kw)
    if a_cols is None:
        a_cols = block_cols(a_parts)
    return cd_glm.cd_solve_blocks(a_cols, x_parts, grads, gp_parts, masks, **kw)


def cd_solve(problem, spec: SubproblemSpec, a_k, x_k, grad_k, gp_k, mask_k,
             num_steps: int, step_budget=None) -> torch.Tensor:
    """``cd_solve_all`` for one node: a_k (d, n_k), x_k/gp_k/mask_k (n_k,),
    grad_k (d,). Returns dx_k (n_k,)."""
    budgets = None if step_budget is None else \
        torch.as_tensor(step_budget, device=a_k.device).reshape(1)
    return cd_solve_all(problem, spec, a_k[None], x_k[None], grad_k[None],
                        gp_k[None], mask_k[None], num_steps, budgets)[0]


def cd_solve_gram(problem, spec: SubproblemSpec, gram_k, atg_k, x_k, gp_k,
                  mask_k, num_steps: int, step_budget=None) -> torch.Tensor:
    """Gram-cached CD solve of G_k for one node: gram_k (n_k, n_k),
    atg_k = A_[k]^T grad_f(v_k) (n_k,). Returns dx_k (n_k,)."""
    budgets = None if step_budget is None else \
        torch.as_tensor(step_budget, device=gram_k.device).reshape(1)
    kw = _kernel_args(problem, spec, num_steps, budgets)
    return cd_glm.cd_solve_blocks_gram(
        gram_k[None].contiguous(), x_k[None].contiguous(),
        atg_k[None].contiguous(), gp_k[None].contiguous(),
        mask_k[None].contiguous(), **kw)[0]
