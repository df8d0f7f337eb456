"""Carry data and state across from numpy, so a run can start from the same
inputs as another implementation (e.g. the JAX reference) and hand its
results back. Precomputed certificate constants need no conversion:
``metrics.certificate_recorder(sigma_k=)`` takes the (K,) sigma_k as any
array.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cola import ColaState
from repro_torch.core.problems import PROBLEMS, Problem
from repro_torch.device import resolve


def problem_from_numpy(name: str, x, y, lam: float, *, device,
                       **kw) -> Problem:
    """``PROBLEMS[name]`` built from numpy data on ``device`` — the same
    arguments ``repro.core.problems.PROBLEMS[name]`` takes."""
    return PROBLEMS[name](np.asarray(x), np.asarray(y), lam, device=device,
                          **kw)


def state_from_numpy(x_parts, v_stack, *, device) -> ColaState:
    """A ``ColaState`` from (K, n_k) / (K, d) arrays."""
    dev = resolve(device)
    return ColaState(x_parts=torch.as_tensor(np.asarray(x_parts), device=dev),
                     v_stack=torch.as_tensor(np.asarray(v_stack), device=dev))


def state_to_numpy(state: ColaState) -> tuple[np.ndarray, np.ndarray]:
    """(x_parts, v_stack) as numpy arrays."""
    return state.x_parts.cpu().numpy(), state.v_stack.cpu().numpy()

