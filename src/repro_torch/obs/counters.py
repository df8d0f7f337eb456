"""On-device telemetry counters carried through the round-block executor.

``Counters`` rides the executor state (``ColaState.counters``, an optional
field defaulting to ``None``, so a telemetry-off run keeps its state and
its program). The reference (``repro.obs.counters``) recomputes the step-0
encode and the robust gate in its counter update and relies on XLA to merge
each recomputation with the round's own copy. Eager PyTorch merges
nothing, so here every signal is taken from what the round already
computed, never from a second copy of it:

* ``wire_bytes`` / ``permutes`` — static per-round increments: the budget
  of the plan compiled for the run's graph (``plan.contract(d, wire=)``),
  or of the distributed runtime's actual comm (``dist_round_increments``);
* ``sat_sum`` — the saturation fraction of the round's STEP-0 payload,
  the ``q`` the round encoded (or consumed from the pipelined ``buf``),
  handed out through the round body's ``sig`` dict (``sig["q"]``);
* ``ef_sq`` — ``||ef||^2`` of the residual the round left;
* ``gate`` — FIRST-step rejections per SENDER of the robust mix the round
  ran (``sig["gate"]``, the (R, K) mask ``mixing.robust_neighborhood_mix``
  decided with; wire attacks only exist on step 0, and with the default
  ``gossip_steps=1`` that is every rejection).

Over ranks each rank counts its own rows (its receiver rows' rejections,
its rows' share of the saturation and of ``||ef||^2``);
``combine_over_ranks`` sums them once, at the end of the run. The fp32
byte/permute device counters stay exact up to 2^24 increments;
``summarize`` reports the exact integer ``rounds x per-round budget``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quant


class Counters(NamedTuple):
    """Per-run telemetry accumulators (tensors of the carried state)."""

    rounds: torch.Tensor      # int32 () — rounds executed (before a stop)
    wire_bytes: torch.Tensor  # f32 () — cumulative per-rank gossip bytes
    permutes: torch.Tensor    # f32 () — cumulative exchange count
    sat_sum: torch.Tensor     # f32 () — sum of per-round step-0 saturation
    ef_sq: torch.Tensor       # f32 () — ||EF residual||^2 after last round
    gate: torch.Tensor        # (K,) int32 — gate rejections per SENDER


def init_counters(k: int, device="cpu") -> Counters:
    z = lambda dtype: torch.zeros((), dtype=dtype, device=device)
    return Counters(rounds=z(torch.int32), wire_bytes=z(torch.float32),
                    permutes=z(torch.float32), sat_sum=z(torch.float32),
                    ef_sq=z(torch.float32),
                    gate=torch.zeros((k,), dtype=torch.int32, device=device))


def _plan_increments(plan, d: int, cfg, itemsize: int) -> dict:
    from repro_torch.topo.lowering import comm_budget
    wire = cfg.wire if quant.is_quantized(cfg.wire) else None
    budget = comm_budget(plan, d, itemsize, gossip_steps=cfg.gossip_steps,
                         wire=wire)
    contract = plan.contract(d, itemsize, gossip_steps=cfg.gossip_steps,
                             wire=wire)
    return {"bytes_per_round": int(budget["bytes_per_device"]),
            "permutes_per_round": int(budget["collective_permutes"]),
            "contract": contract.describe(),
            "contract_name": contract.name}


def round_increments(graph, d: int, cfg, itemsize: int = 4) -> dict:
    """Static per-round wire budget of the plan compiled for ``graph``.

    Returns ``{"bytes_per_round", "permutes_per_round", "contract",
    "contract_name"}`` — the same ``comm_budget`` numbers the plan's
    ``CommContract`` (``repro_torch.analysis.contracts``) holds the
    distributed runtime's exchanges to, so the telemetry byte counter and
    the checked contract agree by construction.
    """
    from repro_torch.topo import compile_plan
    return _plan_increments(compile_plan(graph), d, cfg, itemsize)


def dist_round_increments(cfg, d: int, *, comm: str, plan=None,
                          conn: int = 1, k: int | None = None,
                          itemsize: int = 4) -> dict:
    """Per-round wire budget of the distributed runtime's ACTUAL comm.

    ``comm="plan"`` uses the compiled (Block)Plan's contract budget
    (exact); ``"ring"`` counts the banded exchanges; ``"dense"`` counts the
    all-gathered payload per rank (no exchanges).
    """
    if comm == "plan" and plan is not None:
        return _plan_increments(plan, d, cfg, itemsize)
    if comm == "ring":
        per = 2 * conn
        pb = quant.payload_bytes(d, cfg.wire)
        return {"bytes_per_round": cfg.gossip_steps * per * pb,
                "permutes_per_round": cfg.gossip_steps * per,
                "contract": f"ring conn={conn}: {per} ppermute(s)/step, "
                            f"{per * pb:,}B/device/step",
                "contract_name": f"ring-c{conn}-d{d}"}
    # dense all-gather: each rank receives the full K-row stack
    kk = int(k or 0)
    pb = quant.payload_bytes(d, cfg.wire, rows=max(kk, 1))
    return {"bytes_per_round": cfg.gossip_steps * pb,
            "permutes_per_round": 0,
            "contract": f"dense all-gather: {pb:,}B/device/step",
            "contract_name": f"dense-K{kk}-d{d}"}


def make_update(cfg, inc: dict, *, share: float = 1.0):
    """Build the per-round counter update for one run.

    Returns ``update(counters, sig, after) -> (Counters, obs_row)``:
    ``sig`` is the dict the round body filled (``"q"``: the step-0
    payload of its rows on a quantized wire; ``"gate"``: the (R, K) step-0
    rejection mask of its receiver rows under ``cfg.robust``), ``after``
    the state the round left. ``obs_row`` is the f32 (3,) per-round row
    ``[saturation, ef_sq, gate_total]`` (``summarize`` reports the square
    root of the middle column). ``share``: the rows' share of all K rows
    (K/M of K over ranks), which weights their saturation so that the sum
    over ranks is the mean over all rows.
    """
    quantized = quant.is_quantized(cfg.wire)
    robust = cfg.robust is not None
    b_inc, p_inc = float(inc["bytes_per_round"]), float(
        inc["permutes_per_round"])

    def update(c: Counters, sig: dict, after):
        zero = c.sat_sum.new_zeros(())
        sat_t = zero
        if quantized:
            sat_t = quant.saturation_frac(sig["q"], cfg.wire)
            if share != 1.0:
                sat_t = sat_t * share
        ef_sq = (zero if after.ef is None
                 else torch.sum(torch.square(after.ef)).to(torch.float32))
        gate = c.gate
        gate_total = zero
        if robust and "gate" in sig:  # no gossip step: no gate ran
            gate_t = torch.sum(sig["gate"], dim=0, dtype=torch.int32)
            gate = gate + gate_t
            gate_total = torch.sum(gate_t).to(torch.float32)
        row = torch.stack([sat_t, ef_sq, gate_total])
        return Counters(rounds=c.rounds + 1, wire_bytes=c.wire_bytes + b_inc,
                        permutes=c.permutes + p_inc,
                        sat_sum=c.sat_sum + sat_t, ef_sq=ef_sq,
                        gate=gate), row

    return update


def combine_over_ranks(counters: Counters, series, axis):
    """Each rank's counters and (T, 3) series rows summed over the ranks
    of ``axis``: one all-reduce (the (K,) per-sender gate partials, the
    saturation sum and ``||ef||^2``) and one all-gather (the series), once
    per run. ``rounds`` and the per-rank byte counters are the same on
    every rank. Returns ``(counters, series)``."""
    k = counters.gate.shape[0]
    packed = axis.psum(torch.cat([
        counters.gate.to(torch.float64),
        torch.stack([counters.sat_sum, counters.ef_sq]).to(torch.float64)]))
    out = counters._replace(gate=packed[:k].to(torch.int32),
                            sat_sum=packed[k].to(torch.float32),
                            ef_sq=packed[k + 1].to(torch.float32))
    if series is not None:
        series = axis.all_gather(series).reshape(
            axis.size, *series.shape).sum(dim=0)
    return out, series


def summarize(counters: Counters, inc: dict | None = None, *,
              series=None, stop_round=None, dishonest=None) -> dict:
    """Host-side counter totals for ``history["telemetry"]`` / RunReport.

    ``inc`` (the static per-round increments) upgrades the f32 device byte
    and permute counters to exact integer products; ``dishonest`` (the
    materialized (T, K) ``atk_dishonest`` schedule entry) splits the gate
    counts into honest vs dishonest sender columns; ``series`` is the
    (T, 3) per-round rows ``make_update`` produced (the executor's aux).
    """
    c = Counters(*(t.detach().cpu() for t in counters))
    n = int(c.rounds)
    gate = c.gate.numpy().astype(int)
    out = {
        "rounds": n,
        "wire_bytes": int(round(float(c.wire_bytes))),
        "permutes": int(round(float(c.permutes))),
        "saturation_mean": float(c.sat_sum) / max(n, 1),
        "ef_norm": float(np.sqrt(float(c.ef_sq))),
        "gate_rejections": gate.tolist(),
        "gate_total": int(gate.sum()),
        "stop_round": stop_round,
    }
    if inc is not None:
        # exact integer totals — the f32 device counters lose exactness
        # past 2^24 increments, the host product never does
        out["wire_bytes"] = n * int(inc["bytes_per_round"])
        out["permutes"] = n * int(inc["permutes_per_round"])
        out["contract"] = inc["contract"]
    if dishonest is not None:
        bad = np.any(np.asarray(dishonest).astype(bool), axis=0)
        out["dishonest_nodes"] = np.nonzero(bad)[0].tolist()
        out["gate_dishonest"] = int(gate[bad].sum())
        out["gate_honest"] = int(gate[~bad].sum())
    if series is not None:
        s = series.detach().cpu().numpy()
        m = min(n, s.shape[0])
        out["series"] = {"saturation": s[:m, 0].astype(float).tolist(),
                         "ef_norm": np.sqrt(s[:m, 1]).astype(float).tolist(),
                         "gate": s[:m, 2].astype(int).tolist()}
    return out


def render_footprint(k: int, axis: str = "nodes") -> str:
    """The counters' footprint for ``launch.dryrun --plan``: each leaf's
    shape, dtype, bytes and its placement over the ranks
    (``dist.sharding.cola_counters_pspecs``)."""
    from repro_torch.dist import sharding as shard_specs

    cts = init_counters(k, device="meta")
    specs = shard_specs.cola_counters_pspecs(axis)
    lines = [f"[obs counters] K={k} (ColaConfig.telemetry=True carry)"]
    total = 0
    for name, leaf, spec in zip(Counters._fields, cts, specs):
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        shape = "x".join(map(str, leaf.shape)) or "scalar"
        dtype = str(leaf.dtype).removeprefix("torch.")
        lines.append(f"  {name:<11} {shape:<8} {dtype:<8} "
                     f"{nbytes:>6,}B  pspec={spec}")
    lines.append(f"  total {total:,}B per run (held with the state)")
    return "\n".join(lines)
