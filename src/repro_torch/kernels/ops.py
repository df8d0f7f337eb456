"""Wrappers connecting the kernels to the framework APIs.

``flash_attention_ops`` is the counterpart of the reference's
``repro.kernels.ops.flash_attention_ops``: the argument convention of
``chunked_attention``, on the flash kernel.

``cd_solve_kernel`` is the counterpart of the reference's
``repro.kernels.ops.cd_solve_pallas``: the same signature and semantics as
``repro_torch.core.subproblem.cd_solve_all``, with the formulation picked by
``cd_mode``. It maps a Problem to the kernels' ``(l1, l2, box)`` prox
scalars and its per-coordinate ``lin`` vector (``gp_parts``).
"""
from __future__ import annotations

from repro_torch.core.subproblem import (SubproblemSpec, block_gram,
                                         cd_solve_all, gram_pays)
from repro_torch.kernels import flash_attention as fa


def cd_solve_kernel(problem, spec: SubproblemSpec, a_parts, x_parts, grads,
                    gp_parts, masks, num_steps: int, *, gram_parts=None,
                    a_cols=None, step_budgets=None,
                    cd_mode: str = "residual"):
    """``cd_mode``: "residual" (the O(d)-per-step kernel), "gram" (force the
    O(n_k)-per-step Gram-cached kernel) or "auto" (pick by
    ``subproblem.gram_pays``). ``gram_parts`` may pass precomputed Gram
    blocks; otherwise they are built when the Gram kernel is selected."""
    if cd_mode not in ("residual", "gram", "auto"):
        raise ValueError(f"unknown cd_mode {cd_mode!r} "
                         "(want 'residual', 'gram' or 'auto')")
    k, d, n_k = a_parts.shape
    use_gram = (cd_mode == "gram"
                or (cd_mode == "auto"
                    and gram_pays(d, n_k, a_parts.element_size())))
    if use_gram and gram_parts is None:
        gram_parts = block_gram(a_parts)
    return cd_solve_all(problem, spec, a_parts, x_parts, grads, gp_parts,
                        masks, num_steps, step_budgets=step_budgets,
                        gram_parts=gram_parts if use_gram else None,
                        a_cols=a_cols)


def flash_attention_ops(q, k, v, q_pos, kv_pos, *, mode: str,
                        window: int = 0):
    """Drop-in for chunked_attention (same argument convention). The
    reference's ``block_q``/``block_kv``/``interpret`` have no counterpart:
    the kernel picks its tiles from the shapes."""
    return fa.flash_attention(q, k, v, q_pos, kv_pos, mode=mode,
                              window=window)
