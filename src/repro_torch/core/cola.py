"""CoLA — Algorithm 1 on stacked node state, plus the CoCoA special case.

All K nodes' state is stacked: x_parts (K, n_k), v_stack (K, d). One round
is: gossip mix -> gradients -> local CD solve on every node (the CUDA
kernels of ``repro_torch.kernels.cd_glm`` on the card) -> local updates.

Two interchangeable drivers execute the rounds:

* ``executor="loop"`` — one round at a time, metric rows fetched and the
  stop condition checked on the host every record round.
* ``executor="block"`` (default) — the round-block engine
  (``repro_torch.core.executor``): ``block_size`` rounds per host sync,
  history rows written on the device and fetched once, a device-side stop
  flag read once per block.

Recording and stopping go through the Recorder layer
(``repro_torch.core.metrics``); ``eps=`` arms early termination.

Elasticity (Fig. 4 / Fig. 6): an ``active_schedule`` drops nodes from
rounds, W_t is re-normalized over the active subgraph, and leavers either
freeze their block or reset it (``leave_mode="reset"``, which keeps the
Lemma-1 mean invariant); per-node CD budgets model heterogeneous Theta_k;
under churn the certificates judge each round's reweighted exchange
(``metrics.dynamize``). Both drivers draw the schedules from one
``numpy.random.default_rng(seed)`` in the reference's order.

This port covers the fp32 wire. Quantized wires, pipelining, robust
aggregation, client sampling, attacks and telemetry raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import executor as exec_engine, metrics as metrics_lib, \
    mixing, topology as topo
from repro_torch.core.partition import Partition, make_partition
from repro_torch.core.problems import Problem
from repro_torch.core.subproblem import (SubproblemSpec, block_cols,
                                         block_gram, cd_solve_all, gram_pays)
from repro_torch.device import resolve
from repro_torch.kernels.cd_glm import gram_columns


@dataclasses.dataclass(frozen=True)
class ColaConfig:
    """Hyper-parameters of Algorithm 1. The paper's safe defaults need no tuning."""

    gamma: float = 1.0              # aggregation parameter (paper uses 1)
    sigma_prime: float | None = None  # subproblem relaxation; default gamma*K
    kappa: float = 1.0              # CD passes over the local block per round;
    #   kappa * n_k = the paper's "number of coordinates updated" (Fig. 1).
    #   May be fractional.
    gossip_steps: int = 1           # B gossip steps per round (App. E.2)
    grad_mode: str = "local"        # "local" (Eq. 2) | "mixed" (App. E.1)
    cd_mode: str = "auto"           # local solver formulation:
    #   "auto" — Gram-cached when subproblem.gram_pays says it's cheaper,
    #   "gram" / "residual" — force one kernel.
    # Reference options not ported yet; run_cola rejects anything but the
    # defaults (see ``_check_supported``).
    robust: str | None = None
    wire: str = "fp32"
    pipeline: bool = False
    telemetry: bool = False
    participation: Any = None

    def resolved_sigma(self, k: int) -> float:
        return self.gamma * k if self.sigma_prime is None else self.sigma_prime

    def coord_steps(self, block: int) -> int:
        return max(1, int(round(self.kappa * block)))

    def use_gram(self, d: int, n_k: int, itemsize: int = 4) -> bool:
        if self.cd_mode == "gram":
            return True
        if self.cd_mode == "residual":
            return False
        return gram_pays(d, n_k, itemsize)


class ColaState(NamedTuple):
    x_parts: torch.Tensor  # (K, n_k)
    v_stack: torch.Tensor  # (K, d)


class ColaEnv(NamedTuple):
    """Per-run tensors derived from the problem + partition."""

    a_parts: torch.Tensor   # (K, d, n_k)
    gp_parts: torch.Tensor  # (K, n_k)
    masks: torch.Tensor     # (K, n_k)
    # (K, n_k, n_k) node-local Gram blocks, or None
    gram_parts: torch.Tensor | None = None
    # (K, n_k, d) contiguous rows A_i for the residual kernel, or None. At
    # the epsilon shape this copy is as large as A itself (3.2 GB in fp32).
    a_cols: torch.Tensor | None = None
    # (K, n_k, ld) columns G[:, i] as contiguous rows for the Gram kernel
    # on the card (``cd_glm.gram_columns``), or None (no Gram blocks, or
    # the CPU, where the plain version reads ``gram_parts``)
    gram_cols: torch.Tensor | None = None


def build_env(problem: Problem, part: Partition, *,
              with_gram: bool | None = None) -> ColaEnv:
    """Materialize the per-run tensors. ``with_gram=None`` builds the Gram
    blocks exactly when ``gram_pays`` picks the Gram kernel; the residual
    kernel's ``a_cols`` layout is built exactly when the Gram blocks are
    not. On the card the Gram blocks also get their column layout
    (``gram_cols``), built here once per run."""
    a_parts = part.split_matrix(problem.a)
    if with_gram is None:
        with_gram = gram_pays(problem.d, part.block, a_parts.element_size())
    gram = block_gram(a_parts) if with_gram else None
    on_card = a_parts.device.type == "cuda"
    return ColaEnv(
        a_parts=a_parts,
        gp_parts=part.split_vector(problem.g_params()).contiguous(),
        masks=part.mask(problem.a.dtype, device=problem.a.device),
        gram_parts=gram,
        a_cols=None if with_gram else block_cols(a_parts),
        gram_cols=gram_columns(gram) if with_gram and on_card else None,
    )


def init_state(problem: Problem, part: Partition) -> ColaState:
    kw = dict(dtype=problem.a.dtype, device=problem.a.device)
    return ColaState(
        x_parts=torch.zeros((part.num_nodes, part.block), **kw),
        v_stack=torch.zeros((part.num_nodes, problem.d), **kw),
    )


def _round_body(problem: Problem, part: Partition, cfg: ColaConfig) -> Callable:
    """The one-round function of Algorithm 1 on the fp32 wire, shared by
    both drivers: ``one_round(state, env, w, active, budgets=None)``."""
    k = part.num_nodes
    sigma = cfg.resolved_sigma(k)
    spec = SubproblemSpec(sigma_over_tau=sigma / problem.tau, inv_k=1.0 / k)
    steps = cfg.coord_steps(part.block)
    if cfg.grad_mode not in ("local", "mixed"):
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")

    def one_round(state: ColaState, env: ColaEnv, w: torch.Tensor,
                  active: torch.Tensor, budgets=None) -> ColaState:
        # Step 4: gossip mixing of the local estimates (B steps, App. E.2).
        v_half = mixing.mix_power_wire(w, state.v_stack, None,
                                       cfg.gossip_steps)
        # Gradient each node uses for its subproblem.
        grads = problem.grad_f(v_half)
        if cfg.grad_mode == "mixed":
            # App. E.1: the neighborhood-mixed gradient sum_l W_kl grad f(v_l)
            grads = mixing.dense_mix(w, grads)
        # Step 5: Theta-approximate local solve (kappa * n_k CD steps;
        # per-node budgets model heterogeneous Theta_k, Definition 5).
        use_gram = (env.gram_parts is not None
                    and cfg.use_gram(problem.d, part.block,
                                     env.a_parts.element_size()))
        if cfg.cd_mode == "gram" and env.gram_parts is None:
            raise ValueError(
                "cd_mode='gram' but the env has no Gram blocks — build it "
                "with build_env(problem, part, with_gram=True)")
        dx = cd_solve_all(problem, spec, env.a_parts, state.x_parts, grads,
                          env.gp_parts, env.masks, steps,
                          step_budgets=budgets,
                          gram_parts=env.gram_parts if use_gram else None,
                          a_cols=env.a_cols, gram_cols=env.gram_cols)
        dx = dx * active[:, None].to(dx.dtype)
        # Steps 6-8: local variable + local estimate updates.
        x_new = state.x_parts + cfg.gamma * dx
        dv = torch.bmm(env.a_parts, dx.unsqueeze(-1)).squeeze(-1)
        v_new = v_half + cfg.gamma * k * dv
        return ColaState(x_parts=x_new, v_stack=v_new)

    return one_round


def make_round(problem: Problem, part: Partition, cfg: ColaConfig) -> Callable:
    """The one-round function ``round(state, env, w, active, budgets=None)``.
    ``w`` and ``active`` are tensors on the problem's device."""
    return _round_body(problem, part, cfg)


def cocoa_mixing(k: int) -> np.ndarray:
    """W = (1/K) 11^T: one gossip step yields the exact consensus v_c = Ax,
    recovering centralized CoCoA as a special case of CoLA."""
    return np.full((k, k), 1.0 / k)


class RunResult(NamedTuple):
    state: ColaState
    history: dict  # lists keyed by metric name


def _check_supported(cfg: ColaConfig, *, attacks, leave_mode) -> None:
    """Reject the reference features this port does not run yet, each with
    the ROADMAP queue-1 item that brings it."""
    for bad, what, item in (
            (cfg.wire != "fp32", f"wire={cfg.wire!r}", "9 (quantized wire)"),
            (cfg.pipeline, "cfg.pipeline", "9 (quantized wire)"),
            (cfg.robust is not None, f"robust={cfg.robust!r}",
             "11 (attacks and robust mixing)"),
            (cfg.participation is not None, "cfg.participation",
             "10 (client sampling)"),
            (cfg.telemetry, "cfg.telemetry", "15 (observability)"),
            (attacks is not None, "attacks=", "11 (attacks and robust mixing)")):
        if bad:
            raise NotImplementedError(
                f"repro_torch.run_cola: {what} is not ported yet "
                f"(ROADMAP queue 1 item {item})")
    if leave_mode not in ("freeze", "reset"):
        raise ValueError(f"unknown leave_mode {leave_mode!r} (want 'freeze' "
                         "or 'reset')")


def _as_schedule_fn(s, rounds: int, k: int, name: str):
    """Normalize a schedule argument: callables (and None) pass through, a
    pre-materialized (T, K) array becomes a per-round lookup that takes no
    draw from the shared schedule rng."""
    if s is None or callable(s):
        return s
    arr = np.asarray(s)
    if arr.shape != (rounds, k):
        raise ValueError(f"pre-materialized {name} must be ({rounds}, {k}),"
                         f" got {arr.shape}")
    return lambda t, rng: arr[t]


def _materialize_schedule(graph, rounds, active_schedule, budget_schedule,
                          leave_mode, seed, base_w, dtype) -> dict:
    """Evaluate the host-side schedule callables for all T rounds up front
    into (T, ...) numpy arrays, which both drivers read.

    One ``numpy.random.default_rng(seed)`` is drawn from in the reference's
    order: in each round the active draw first, then the budget draw. A
    round with no active node runs with every node active. Entries: ``w``
    (T, K, K) mixing matrices (Metropolis weights over the active subgraph
    under churn, else ``base_w`` broadcast), ``active`` (T, K) 0/1,
    ``budgets`` (T, K) int32 when budgeted, and under ``leave_mode="reset"``
    ``leavers`` (T, K) bool (active last round, inactive now) and
    ``reset_any`` (T,) bool.
    """
    k = graph.num_nodes
    has_churn = active_schedule is not None
    has_budget = budget_schedule is not None
    has_reset = has_churn and leave_mode == "reset"
    rng = np.random.default_rng(seed)
    if has_churn:
        w_stack = np.empty((rounds, k, k), dtype=dtype)
        actives = np.empty((rounds, k), dtype=dtype)
    else:
        # every round shares base_w: broadcast views, O(K^2) on the host
        w_stack = np.broadcast_to(np.asarray(base_w, dtype=dtype),
                                  (rounds, k, k))
        actives = np.broadcast_to(np.ones((k,), dtype=dtype), (rounds, k))
    budgets = np.empty((rounds, k), np.int32) if has_budget else None
    leavers = np.zeros((rounds, k), bool) if has_reset else None
    reset_any = np.zeros((rounds,), bool) if has_reset else None

    prev_active = np.ones((k,), dtype=bool)
    if has_churn or has_budget:
        for t in range(rounds):
            if has_churn:
                active = np.asarray(active_schedule(t, rng), dtype=bool)
                if not active.any():
                    active = np.ones((k,), dtype=bool)
                w_stack[t] = topo.reweight_for_active(graph, active)
                actives[t] = active.astype(dtype)
                if has_reset:
                    left = prev_active & ~active
                    leavers[t] = left
                    reset_any[t] = left.any()
                prev_active = active
            if has_budget:
                budgets[t] = np.asarray(budget_schedule(t, rng),
                                        dtype=np.int32)
    sched = {"w": w_stack, "active": actives}
    if has_budget:
        sched["budgets"] = budgets
    if has_reset:
        sched["leavers"] = leavers
        sched["reset_any"] = reset_any
    return sched


def _reset_leavers(state: ColaState, env: ColaEnv,
                   leavers: torch.Tensor) -> ColaState:
    """Fig.-6 model: zero x_[k] of the leaving nodes (``leavers``, (K,)
    bool on the state's device); every node subtracts
    sum_leavers A_[k] x_[k] from its estimate, so (1/K) sum_k v_k = A x
    still holds (Lemma 1). One bmm over all K blocks: a read of A."""
    leave = leavers.to(state.x_parts.dtype)
    contrib = torch.bmm(env.a_parts,
                        (state.x_parts * leave[:, None]).unsqueeze(-1))
    total = contrib.squeeze(-1).sum(dim=0)                      # (d,)
    x_new = torch.where(leavers[:, None], torch.zeros_like(state.x_parts),
                        state.x_parts)
    return ColaState(x_parts=x_new, v_stack=state.v_stack - total[None, :])


def run_cola(problem: Problem, graph: topo.Topology, cfg: ColaConfig,
             rounds: int, *, record_every=1, recorder: str | Any = "gap",
             eps: float | None = None, active_schedule=None,
             budget_schedule=None, leave_mode: str = "freeze", seed: int = 0,
             w_override: np.ndarray | None = None, attacks=None,
             executor: str = "block", block_size: int = 64,
             device=None) -> RunResult:
    """Driver: runs Algorithm 1 under a pluggable metric Recorder.

    Args:
      recorder: "gap", "certificate", "gap+certificate" or a Recorder
        instance; history keys follow its labels.
      eps: target accuracy; arms early stopping at the first record round
        whose row certifies (certificate) or reaches ``gap <= eps`` (gap
        recorder). ``record_every`` is the certification cadence.
      record_every: fixed integer cadence, or ``"adaptive"`` / a
        ``metrics.AdaptiveCadence``.
      active_schedule: optional (round, rng) -> (K,) bool mask of the nodes
        taking part (node churn, Fig. 4/6), or a (T, K) bool array (which
        takes no draw from the shared rng). W is re-normalized over the
        active subgraph each round, and certificates judge that exchange.
      budget_schedule: optional (round, rng) -> (K,) int CD-step budgets
        (heterogeneous Theta_k, Definition 5), or a (T, K) int array.
      leave_mode: "freeze" (a leaver keeps x_[k]) or "reset" (App. D,
        Fig. 6: x_[k] zeroed and every v_j adjusted to keep the Lemma-1
        mean invariant).
      seed: seed of the ``numpy.random.default_rng`` the schedule callables
        draw from (active draw, then budget draw, in each round).
      w_override: this mixing matrix instead of Metropolis weights (rounds
        without churn).
      executor: "block" (default) or "loop".
      device: where the run happens (default "cuda"); the problem must
        live there. Without a card, pass ``device="cpu"`` explicitly.
    """
    dev = resolve(device)
    if problem.a.device != dev:
        raise ValueError(f"problem data is on {problem.a.device}, run_cola "
                         f"was asked to run on {dev}")
    _check_supported(cfg, attacks=attacks, leave_mode=leave_mode)
    k = graph.num_nodes
    part = make_partition(problem.n, k)
    env = build_env(problem, part,
                    with_gram=cfg.use_gram(problem.d, part.block,
                                           problem.a.element_size()))
    state = init_state(problem, part)
    base_w = w_override if w_override is not None \
        else topo.metropolis_weights(graph)
    rec = metrics_lib.make_recorder(recorder, problem, part, env, graph,
                                    base_w, eps)
    active_schedule = _as_schedule_fn(active_schedule, rounds, k,
                                      "active_schedule")
    budget_schedule = _as_schedule_fn(budget_schedule, rounds, k,
                                      "budget_schedule")
    if active_schedule is not None:
        # certificates judge each churn round's reweighted exchange, not
        # the static graph
        rec = metrics_lib.dynamize(rec)
    np_dtype = torch.empty((), dtype=problem.a.dtype).numpy().dtype
    sched = _materialize_schedule(graph, rounds, active_schedule,
                                  budget_schedule, leave_mode, seed, base_w,
                                  np_dtype)
    body = _round_body(problem, part, cfg)
    if executor == "block":
        return _run_cola_block(body, env, state, rounds, record_every, rec,
                               sched, block_size)
    if executor == "loop":
        return _run_cola_loop(body, env, state, rounds, record_every, rec,
                              sched)
    raise ValueError(f"unknown executor {executor!r} (want 'block' or 'loop')")


def _run_cola_loop(body, env, state, rounds, record_every, recorder,
                   sched) -> RunResult:
    """Reference driver: one round at a time (the leaver reset before the
    round), a blocking metric fetch every record round and a host-side stop
    check. A schedule-aware recorder gets the round's certificate inputs."""
    history: dict = {"round": []}
    history.update({name: [] for name in recorder.labels})
    history["stop_round"] = None
    stop_fn = recorder.stop_fn
    uses_sched = bool(getattr(recorder, "uses_schedule", False))
    cert = metrics_lib.first_certificate(recorder) if uses_sched else None
    cad = metrics_lib.as_cadence(record_every)
    next_rec, every = 0, (cad.base if cad else None)
    dev = state.x_parts.device
    dtype = state.x_parts.dtype
    on_dev = lambda a, **kw: torch.tensor(np.asarray(a), device=dev, **kw)
    for t in range(rounds):
        if "reset_any" in sched and sched["reset_any"][t]:
            state = _reset_leavers(state, env, on_dev(sched["leavers"][t]))
        b_t = on_dev(sched["budgets"][t]) if "budgets" in sched else None
        state = body(state, env, on_dev(sched["w"][t]),
                     on_dev(sched["active"][t]), b_t)
        due = (t >= next_rec) if cad else (t % record_every == 0)
        if due or t == rounds - 1:
            if uses_sched:
                mask_t, thr_t = metrics_lib.certificate_round_inputs(
                    cert, sched["w"][t], sched["active"][t])
                row = recorder.record_fn(state, {
                    "cert_mask": on_dev(mask_t, dtype=dtype),
                    "cert_grad_thresh": on_dev(thr_t, dtype=dtype)})
            else:
                row = recorder.record_fn(state)
            row = row.to(torch.float32)
            history["round"].append(t)
            for j, val in enumerate(row.cpu().tolist()):
                history[recorder.labels[j]].append(val)
            if cad:
                far = (np.float32(recorder.cadence_ratio(row).item())
                       > np.float32(cad.near))
                every = (min(every * cad.grow, cad.max_every) if far
                         else cad.base)
                next_rec = t + every
            if stop_fn is not None and bool(stop_fn(row)):
                history["stop_round"] = t
                break
    return RunResult(state=state,
                     history=metrics_lib.annotate_violation(history))


def _run_cola_block(body, env, state, rounds, record_every, recorder, sched,
                    block_size) -> RunResult:
    """Round-block driver (see ``repro_torch.core.executor``).

    The leaver reset is decided on the host: ``reset_any`` is a host entry
    of the schedule (``host_entries``), so a round without leavers runs no
    reset and reads A no extra time, and the decision costs no device sync
    (the reference gates it with a ``lax.cond`` on the same flag)."""
    has_reset = "reset_any" in sched

    def step_fn(st, env_ctx, s_t):
        if has_reset and s_t["reset_any"]:
            st = _reset_leavers(st, env_ctx, s_t["leavers"])
        return body(st, env_ctx, s_t["w"], s_t["active"], s_t.get("budgets"))

    cad = metrics_lib.as_cadence(record_every)
    rec_mask = None if cad else exec_engine.record_flags(rounds, record_every)
    cert = metrics_lib.first_certificate(recorder)
    if cert is not None and cert.dynamic:
        # the churn certificate's per-round mask and threshold ride the
        # schedule; under an adaptive cadence any round may record
        sched = dict(sched, **metrics_lib.certificate_schedule(
            recorder, sched["w"], sched["active"],
            np.ones((rounds,), dtype=bool) if cad else rec_mask))
    res = exec_engine.run_round_blocks(
        step_fn, state, sched, context=env, recorder=recorder,
        record_mask=rec_mask, block_size=block_size, cadence=cad,
        num_rounds=rounds, host_entries=("reset_any",))
    return RunResult(state=res.state,
                     history=metrics_lib.history_from(recorder, res))


def solve_reference(problem: Problem, rounds: int = 3000,
                    kappa: int = 10) -> float:
    """High-accuracy reference optimum via single-node CoCoA (used as F*
    when reporting suboptimality, as in the paper's App. D)."""
    graph = topo.complete(2)
    res = run_cola(problem, graph, ColaConfig(kappa=kappa), rounds,
                   record_every=max(rounds // 4, 1),
                   w_override=cocoa_mixing(2), device=problem.a.device)
    return min(res.history["primal"])
