"""Eavesdropper auditing: what does a passive link observer learn?

Every payload v_k a node emits is an estimate of the global consensus A x,
so one tapped link reconstructs the shared state, and through grad f(v)
the data-dependent residual, without compromising any node (Pasquini et
al., PAPERS.md). These helpers measure that leakage from the
``RunResult.taps`` trajectory an ``Eavesdropper`` scenario records. They
run on the host in float64, like the reference's.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def payload_cosines(taps, reference) -> np.ndarray:
    """(T, n_tap) cosine similarity of each tapped payload to ``reference``
    (d,), e.g. the true consensus A x*, per round. Zero rows (the initial
    state) give cosine 0."""
    taps = _host(taps).astype(np.float64)
    ref = _host(reference).astype(np.float64)
    num = taps @ ref
    den = np.linalg.norm(taps, axis=-1) * np.linalg.norm(ref) + 1e-30
    return num / den


def gradient_inversion_report(taps, problem, reference) -> dict:
    """Audit a tap trajectory for state and gradient reconstruction.

    Args:
      taps: (T, n_tap, d) recorded payloads (``RunResult.taps``).
      problem: the port's problem, whose batched ``grad_f`` maps payloads
        to the data-dependent gradient (for quadratic losses grad f(v)
        exposes the residual v - y, i.e. the labels).
      reference: (d,) ground-truth consensus (A x at the solution, or the
        final honest v).

    Returns a dict: ``state_cosine`` (T, n_tap) payload-vs-reference cosine
    per round; ``final_state_cosine`` its mean over taps at the last round;
    ``grad_cosine`` (n_tap,) cosine of grad f(tap_T) against grad
    f(reference); ``payload_norm`` (T,) mean tapped payload norm.
    """
    taps = _host(taps)
    if taps.ndim != 3:
        raise ValueError(f"taps must be (T, n_tap, d); got {taps.shape}")
    ref = _host(reference)
    state_cos = payload_cosines(taps, ref)
    dev, dtype = problem.a.device, problem.a.dtype
    g_ref = _host(problem.grad_f(torch.as_tensor(ref, dtype=dtype,
                                                 device=dev))
                  ).astype(np.float64)
    g_tap = _host(problem.grad_f(torch.as_tensor(taps[-1], dtype=dtype,
                                                 device=dev))
                  ).astype(np.float64)
    num = g_tap @ g_ref
    den = np.linalg.norm(g_tap, axis=-1) * np.linalg.norm(g_ref) + 1e-30
    return {
        "state_cosine": state_cos,
        "final_state_cosine": float(state_cos[-1].mean()),
        "grad_cosine": num / den,
        "payload_norm": np.linalg.norm(taps, axis=-1).mean(axis=-1),
    }
