"""The comparison that decides ``correct``: each solve the program
finished, against the plain reference's solve of the same data.

Four numbers, each the worst over the solves, each with its limit from
the cell's file (``limits``):

* ``x_err``: ||x - x_ref|| / ||x_ref|| of the final x (K, n_k), the
  iterate at the stop round;
* ``v_err``: the same for the nodes' estimates v (K, d);
* ``hist_err``: the recorder's history up to the earlier of the two
  stops, each continuous column, |row - row_ref| over the column's
  largest |row_ref|; a round up to there that one side recorded and the
  other did not counts 1;
* ``stop_shift``: |stop round - the reference's| in rounds, a side that
  never stopped counting as stopping at ``max_rounds``.

The node counts and flags of the certificate follow from the compared
columns, and the Lemma-1 residual is rounding noise (~1e-7) in every sound
run, so they are not compared one by one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

COLUMNS = ("primal", "hamiltonian", "dual", "gap", "consensus_violation",
           "local_gap_max", "grad_disagreement_max")
NUMBERS = ("x_err", "v_err", "hist_err", "stop_shift")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / max(den, 1e-30)


def history_err(hist: dict, ref: dict) -> float:
    end = min(hist["round"][-1], ref["round"][-1]) \
        if hist["round"] and ref["round"] else -1
    both = sorted(t for t in ref["round"] if t <= end)
    if not both or both != [t for t in hist["round"] if t <= end]:
        return 1.0
    at = {t: i for i, t in enumerate(hist["round"])}
    at_ref = {t: i for i, t in enumerate(ref["round"])}
    worst = 0.0
    for col in COLUMNS:
        if col not in ref:
            continue
        p = np.asarray([hist[col][at[t]] for t in both], np.float64)
        q = np.asarray([ref[col][at_ref[t]] for t in both], np.float64)
        scale = max(float(np.max(np.abs(ref[col]))), 1e-30)
        err = float(np.max(np.abs(p - q))) / scale
        worst = max(worst, err if math.isfinite(err) else math.inf)
    return worst


def numbers(solve: dict, ref, max_rounds: int) -> dict:
    """The four numbers of one solve (``x_parts``, ``v_stack``,
    ``history`` with its ``stop_round``) against the reference's
    ``RefResult``."""
    stop = lambda s: max_rounds if s is None else s
    return {"x_err": _rel(solve["x_parts"], ref.x_parts),
            "v_err": _rel(solve["v_stack"], ref.v_stack),
            "hist_err": history_err(solve["history"], ref.history),
            "stop_shift": float(abs(stop(solve["history"]["stop_round"])
                                    - stop(ref.stop_round)))}


def judge(solves: list, ref, limits: dict,
          max_rounds: int) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every solve's numbers at
    or under their limits; a NaN or a missing limit is not correct."""
    per = [numbers(s, ref, max_rounds) for s in solves]
    worst = {k: max((p[k] for p in per), default=math.nan) for k in NUMBERS}
    for k in NUMBERS:
        if any(math.isnan(p[k]) for p in per):
            worst[k] = math.nan
    out = {k: {"value": worst[k], "limit": limits.get(k)} for k in NUMBERS}
    ok = bool(solves) and all(
        v["limit"] is not None and v["value"] <= v["limit"]
        for v in out.values())
    return ok, out
