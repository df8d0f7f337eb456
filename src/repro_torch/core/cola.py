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

This port covers the fp32 wire with an optional per-node CD budget
schedule. Churn, resets, quantized wires, pipelining, robust aggregation,
client sampling, attacks and telemetry raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
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


def _check_supported(cfg: ColaConfig, *, attacks, active_schedule,
                     leave_mode) -> None:
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
            (attacks is not None, "attacks=", "11 (attacks and robust mixing)"),
            (active_schedule is not None, "active_schedule=",
             "7 (elasticity)"),
            (leave_mode == "reset", "leave_mode='reset'", "7 (elasticity)")):
        if bad:
            raise NotImplementedError(
                f"repro_torch.run_cola: {what} is not ported yet "
                f"(ROADMAP queue 1 item {item})")
    if leave_mode != "freeze":
        raise ValueError(f"unknown leave_mode {leave_mode!r}")


def _as_budgets(budget_schedule, rounds: int, k: int, seed: int):
    """Materialize a budget schedule into a (T, K) int32 array. A callable
    ``(round, rng) -> (K,)`` draws from ``numpy.random.default_rng(seed)``
    in round order, exactly as the reference does without churn; a
    pre-materialized (T, K) array is taken as it is."""
    if budget_schedule is None:
        return None
    if callable(budget_schedule):
        rng = np.random.default_rng(seed)
        return np.stack([np.asarray(budget_schedule(t, rng), dtype=np.int32)
                         for t in range(rounds)]).reshape(rounds, k)
    arr = np.asarray(budget_schedule)
    if arr.shape != (rounds, k):
        raise ValueError(f"pre-materialized budget_schedule must be "
                         f"({rounds}, {k}), got {arr.shape}")
    return arr.astype(np.int32)


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
      budget_schedule: optional (round, rng) -> (K,) int CD-step budgets
        (heterogeneous Theta_k, Definition 5), or a (T, K) int array.
      w_override: this mixing matrix instead of Metropolis weights.
      executor: "block" (default) or "loop".
      device: where the run happens (default "cuda"); the problem must
        live there. Without a card, pass ``device="cpu"`` explicitly.
    """
    dev = resolve(device)
    if problem.a.device != dev:
        raise ValueError(f"problem data is on {problem.a.device}, run_cola "
                         f"was asked to run on {dev}")
    _check_supported(cfg, attacks=attacks, active_schedule=active_schedule,
                     leave_mode=leave_mode)
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
    budgets = _as_budgets(budget_schedule, rounds, k, seed)
    w = torch.as_tensor(np.asarray(base_w), dtype=problem.a.dtype, device=dev)
    active = torch.ones((k,), dtype=problem.a.dtype, device=dev)
    body = _round_body(problem, part, cfg)
    if executor == "block":
        return _run_cola_block(body, env, state, rounds, record_every, rec,
                               budgets, w, active, block_size)
    if executor == "loop":
        return _run_cola_loop(body, env, state, rounds, record_every, rec,
                              budgets, w, active)
    raise ValueError(f"unknown executor {executor!r} (want 'block' or 'loop')")


def _run_cola_loop(body, env, state, rounds, record_every, recorder, budgets,
                   w, active) -> RunResult:
    """Reference driver: one round at a time, a blocking metric fetch every
    record round and a host-side stop check."""
    history: dict = {"round": []}
    history.update({name: [] for name in recorder.labels})
    history["stop_round"] = None
    stop_fn = recorder.stop_fn
    cad = metrics_lib.as_cadence(record_every)
    next_rec, every = 0, (cad.base if cad else None)
    dev = w.device
    for t in range(rounds):
        b_t = None if budgets is None else torch.as_tensor(budgets[t],
                                                           device=dev)
        state = body(state, env, w, active, b_t)
        due = (t >= next_rec) if cad else (t % record_every == 0)
        if due or t == rounds - 1:
            row = recorder.record_fn(state).to(torch.float32)
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


def _run_cola_block(body, env, state, rounds, record_every, recorder,
                    budgets, w, active, block_size) -> RunResult:
    """Round-block driver (see ``repro_torch.core.executor``)."""
    sched = {} if budgets is None else {"budgets": budgets}

    def step_fn(st, env_ctx, s_t):
        return body(st, env_ctx, w, active, s_t.get("budgets"))

    cad = metrics_lib.as_cadence(record_every)
    rec_mask = None if cad else exec_engine.record_flags(rounds, record_every)
    res = exec_engine.run_round_blocks(
        step_fn, state, sched, context=env, recorder=recorder,
        record_mask=rec_mask, block_size=block_size, cadence=cad,
        num_rounds=rounds)
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
