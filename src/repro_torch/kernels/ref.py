"""The plain PyTorch versions of the Hopper kernels, under the JAX
reference's oracle names (``repro.kernels.ref``): the allclose targets a
kernel is held to. They run eagerly on any device and never launch a
kernel.

* CD-GLM subproblem solver: ``cd_solve_ref`` (every node, the residual or
  the Gram-cached formulation) and ``cd_solve_gram_ref`` (one node, Gram
  cached): ``subproblem.cd_solve_all`` / ``cd_solve_gram`` run on CPU
  copies of the inputs, where the wrappers run ``kernels.cd_glm``'s plain
  versions; ``block_gram`` and ``gram_pays`` as the solver's.
* Flash attention: ``attention_ref`` (the naive masked softmax
  attention) and ``chunked_attention_ref`` (the online softmax over KV
  chunks), ``models.attention``'s.
"""
from __future__ import annotations

import torch

from repro_torch.core import subproblem
from repro_torch.core.subproblem import (  # noqa: F401
    SubproblemSpec, block_gram, gram_pays)
from repro_torch.models.attention import (  # noqa: F401
    chunked_attention as chunked_attention_ref,
    reference_attention as attention_ref)


def _cpu(t):
    return None if t is None else t.cpu()


def cd_solve_ref(problem, spec: SubproblemSpec, a_parts, x_parts, grads,
                 gp_parts, masks, num_steps: int, step_budgets=None,
                 gram_parts=None) -> torch.Tensor:
    """``subproblem.cd_solve_all`` on the plain versions: ``num_steps``
    cyclic CD updates of every node's G_k, the Gram-cached formulation
    when ``gram_parts`` is given. Returns dx_parts (K, n_k) on the inputs'
    device."""
    dx = subproblem.cd_solve_all(
        problem, spec, _cpu(a_parts), _cpu(x_parts), _cpu(grads),
        _cpu(gp_parts), _cpu(masks), num_steps,
        step_budgets=_cpu(step_budgets), gram_parts=_cpu(gram_parts))
    return dx.to(x_parts.device)


def cd_solve_gram_ref(problem, spec: SubproblemSpec, gram_k, atg_k, x_k,
                      gp_k, mask_k, num_steps: int,
                      step_budget=None) -> torch.Tensor:
    """``subproblem.cd_solve_gram`` on the plain version: one node's
    Gram-cached solve, gram_k (n_k, n_k), atg_k = A_[k]^T grad_f(v_k)."""
    dx = subproblem.cd_solve_gram(
        problem, spec, _cpu(gram_k), _cpu(atg_k), _cpu(x_k), _cpu(gp_k),
        _cpu(mask_k), num_steps, step_budget=step_budget)
    return dx.to(x_k.device)
