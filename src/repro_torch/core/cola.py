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

Quantized gossip (``cfg.wire``, ``repro_torch.core.quant``): each gossip
step sends an int8/fp8 payload plus one fp32 scale per node, with
stochastic rounding and, by default, an error-feedback residual carried in
``ColaState.ef``; ``cfg.pipeline`` encodes round t+1's first payload at the
end of round t (``ColaState.buf``), bitwise the same run. The uniforms come
from ``wire_draws`` (the port's counter stream by default).

Client sampling (``cfg.participation``, ``repro_torch.core.schedule``): K'
of K nodes of a complete graph take part in each round, drawn on the
device inside the round loop. Dense mode streams the active mask and the
reweighted W through the standard round body; cohort mode
(``_run_cola_cohort``, million-node populations) gathers and updates only
the cohort's rows.

Attacks and defenses (``repro_torch.attack``, ``cfg.robust``): attack
scenarios transform the materialized schedule (``attacks=``, block
executor only); a Byzantine payload exists only on the wire (receivers mix
``coef * v + bias``, each node's own term and state stay honest), free
riders' dx is zeroed, an eavesdropper's taps land in ``RunResult.taps``.
``cfg.robust`` swaps the linear mix for a gated trimmed mean, a gated
median or per-neighbor clipping (``mixing.robust_mix_steps``). On a
quantized wire the lie is encoded like any payload (one gossip step, no
pipeline). The certificate of an attacked run audits the honest cohort
(``metrics.attackify``).

Telemetry (``cfg.telemetry``, ``repro_torch.obs``): counters carried in
``ColaState.counters`` through the block executor count the wire's bytes
and exchanges (the compiled plan's budget), the step-0 payload's
saturation, the EF residual's norm and the robust gate's rejections per
sender, each taken from what the round computed (the round body hands its
step-0 payload and gate mask out through ``sig``). The totals land in
``history["telemetry"]`` and a ``RunReport`` in the run registry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import attack as attack_lib
from repro_torch.core import executor as exec_engine, metrics as metrics_lib, \
    mixing, quant, schedule as schedule_lib, topology as topo
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
    wire: str = "fp32"              # gossip payload codec (core/quant.py):
    #   "fp32", or "int8" / "fp8" / "fp8_e5m2": per-node-row absmax
    #   quantization with stochastic rounding, 1 byte per element plus a
    #   4-byte fp32 scale per row.
    error_feedback: bool = True     # on a quantized wire, send Q(v + e) and
    #   keep e' = (v + e) - deq (ColaState.ef): the error telescopes across
    #   rounds instead of leaving a noise floor.
    pipeline: bool = False          # quantized wires only: encode round
    #   t+1's first payload at the end of round t (ColaState.buf); the run
    #   is bitwise the unpipelined one.
    participation: Any = None       # client sampling: a
    #   core.schedule.SampleConfig; K' of K nodes of a complete graph take
    #   part in each round (block executor only).
    robust: str | None = None       # Byzantine-resilient v aggregation:
    #   None (the linear W mix) or "trim" / "median" / "clip"
    #   (mixing.robust_neighborhood_mix). Nonlinear: B gossip steps apply
    #   one after the other.
    robust_trim: int = 1            # collusion depth of the norm gate
    robust_clip: float | None = None  # clip radius; None = median-adaptive
    telemetry: bool = False         # carry repro_torch.obs.Counters in the
    #   state (block executor only): per-round wire bytes / exchanges,
    #   saturation and EF norm, robust-gate rejections. Totals land in
    #   history["telemetry"] and a RunReport in the run registry. Off: the
    #   state has no counters and the run is the same, bitwise.

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
    # (K, d) error-feedback residual on a quantized wire with EF (else None)
    ef: torch.Tensor | None = None
    # pipelined wire: the (payload, scale) of the next round's first step
    buf: Any = None
    # repro_torch.obs.Counters under cfg.telemetry (else None)
    counters: Any = None


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
              with_gram: bool | None = None,
              nodes: slice | None = None) -> ColaEnv:
    """Materialize the per-run tensors. ``with_gram=None`` builds the Gram
    blocks exactly when ``gram_pays`` picks the Gram kernel; the residual
    kernel's ``a_cols`` layout is built exactly when the Gram blocks are
    not. On the card the Gram blocks also get their column layout
    (``gram_cols``), built here once per run. ``nodes``: build only that
    node range's rows of every tensor (a rank's block over
    ``repro_torch.dist``), from its own columns of A."""
    a_parts = part.split_matrix(problem.a, nodes)
    if with_gram is None:
        with_gram = gram_pays(problem.d, part.block, a_parts.element_size())
    gram = block_gram(a_parts) if with_gram else None
    on_card = a_parts.device.type == "cuda"
    # the rank's rows as tensors of their own (a view would keep the
    # whole alive)
    rows = (lambda t: t.contiguous()) if nodes is None else \
        (lambda t: t[nodes].clone())
    return ColaEnv(
        a_parts=a_parts,
        gp_parts=rows(part.split_vector(problem.g_params())),
        masks=rows(part.mask(problem.a.dtype, device=problem.a.device)),
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


def _apply_payload_attack(v: torch.Tensor, atk: dict | None) -> torch.Tensor:
    """The wire transform of a Byzantine / free-rider schedule on the
    OUTGOING per-node payloads: ``coef * v + bias_coef * bias``. The round
    body's mix input and the eavesdropper's taps both come from here, so
    a tap records exactly what crossed the wire. Elementwise per node."""
    if not atk:
        return v
    if "coef" in atk:
        v = atk["coef"][:, None].to(v.dtype) * v
    if "bias_coef" in atk:
        v = v + (atk["bias_coef"][:, None].to(v.dtype)
                 * atk["bias"].to(v.dtype))
    return v


def _round_body(problem: Problem, part: Partition, cfg: ColaConfig, *,
                mix_fn: Callable | None = None,
                grad_mix_fn: Callable | None = None,
                qmix_fn: Callable | None = None) -> Callable:
    """The one-round function of Algorithm 1, shared by ``run_cola``'s two
    executors and the distributed runtime (``repro_torch.dist.runtime``):
    ``one_round(state, env, w, active, budgets=None, draws=None,
    draws_next=None, atk=None)``. ``mix_fn(w, v_send, v_self)`` applies
    the B gossip steps on the fp32 wire (default: ``mix_power_wire`` on
    the stacked state, or the robust aggregation under ``cfg.robust``;
    ``v_self`` is None unless an attack corrupted the payloads), and
    ``grad_mix_fn(w, grads)`` the one step of ``grad_mode="mixed"``
    (default ``dense_mix``); the distributed runtime passes exchanges over
    ranks, and ``w`` is then whatever its mixers read (the round's W, or a
    plan's coefficients). On a quantized wire ``draws(step)``
    gives this round's (K, d) rounding uniforms of gossip step ``step``
    (None: round to nearest), and ``draws_next`` the next round's, which
    the pipelined body encodes with. ``qmix_fn(w, v, ef, draws, payload)
    -> (mixed, ef_new)`` runs the B steps on the wire (default
    ``mixing.qmix_steps``; ``payload`` is the pipelined ``state.buf``).
    Every hook also takes ``sig=``, the round's signal dict (below).
    A caller's ``qmix_fn`` is a lowered wire (the distributed runtime's
    exchanges, robust-aware under ``cfg.robust``): the composed branch of
    the stacked body then gives way to it, as in the reference. ``atk``
    holds the round's attack entries (``coef``, ``bias_coef``, ``bias``, ``work``; see
    ``repro_torch.attack``): the emitted payloads become ``coef * v +
    bias_coef * bias`` on the wire before the mix, while every node's own
    mixing term and state stay honest, and ``work`` masks dx (free
    riders). ``sig``: an optional dict the round fills with what the
    telemetry counters read (``repro_torch.obs.counters``): ``"q"``, the
    step-0 payload it encoded or consumed, on a quantized wire; ``"gate"``,
    the (R, K) step-0 rejection mask of the robust mix it ran. The round
    computes the same with or without it."""
    k = part.num_nodes
    sigma = cfg.resolved_sigma(k)
    spec = SubproblemSpec(sigma_over_tau=sigma / problem.tau, inv_k=1.0 / k)
    steps = cfg.coord_steps(part.block)
    quantized = quant.is_quantized(cfg.wire)
    if cfg.grad_mode not in ("local", "mixed"):
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
    robust = cfg.robust
    if robust is not None and robust not in mixing.ROBUST_MODES:
        raise ValueError(f"unknown robust mode {robust!r} "
                         f"(want one of {mixing.ROBUST_MODES})")

    def mix(w, v_send, v_self, sig=None):
        if robust is None:
            return mixing.mix_power_wire(w, v_send, v_self, cfg.gossip_steps)
        return mixing.robust_mix_steps(
            w, v_send, robust, trim=cfg.robust_trim, clip=cfg.robust_clip,
            steps=cfg.gossip_steps, self_stack=v_self, sig=sig)

    if mix_fn is not None:
        mix = mix_fn
    if grad_mix_fn is None:
        grad_mix_fn = mixing.dense_mix
    lowered_qmix = qmix_fn is not None
    if qmix_fn is None:
        qmix_fn = lambda w, v, ef, draws, payload, sig=None: \
            mixing.qmix_steps(w, v, ef, cfg.gossip_steps, cfg.wire, draws,
                              payload=payload, sig=sig)

    def one_round(state: ColaState, env: ColaEnv, w: torch.Tensor,
                  active: torch.Tensor, budgets=None, draws=None,
                  draws_next=None, atk: dict | None = None,
                  sig: dict | None = None) -> ColaState:
        # Step 4: gossip mixing of the local estimates (B steps, App. E.2).
        # A payload attack exists only on the wire: receivers mix the lie,
        # each node's own term uses its honest state (v_self; None on the
        # honest path, which is then the unattacked program).
        if quantized and not lowered_qmix and (robust is not None or atk):
            # a quantized wire composed with attacks or a defense (one
            # gossip step, no pipeline: _check_wire_config): the lie is
            # encoded like any payload, with the honest encode's draws;
            # each node's own slot and EF residual follow the codec view
            # of its honest value
            u0 = None if draws is None else draws(0)
            q, _, deq_self, ef_new = quant.encode(state.v_stack, cfg.wire,
                                                  u0, state.ef)
            if sig is not None:
                sig["q"] = q
            v_send = _apply_payload_attack(state.v_stack, atk)
            if v_send is state.v_stack:
                deq_send, self_stack = deq_self, None
            else:
                p_atk = v_send if state.ef is None else v_send + state.ef
                deq_send = quant.dequantize(
                    *quant.quantize_rows(p_atk, cfg.wire, u0))
                self_stack = deq_self
            v_half = mix(w, deq_send, self_stack, sig=sig)
        elif quantized:
            # every step mixes the codec's view of every payload; a
            # pipelined run's first payload is state.buf
            v_half, ef_new = qmix_fn(w, state.v_stack, state.ef, draws,
                                     state.buf, sig=sig)
        else:
            v_send = _apply_payload_attack(state.v_stack, atk)
            v_half = mix(w, v_send,
                         None if v_send is state.v_stack else state.v_stack,
                         sig=sig)
        # Gradient each node uses for its subproblem.
        grads = problem.grad_f(v_half)
        if cfg.grad_mode == "mixed":
            # App. E.1: the neighborhood-mixed gradient sum_l W_kl grad f(v_l)
            grads = grad_mix_fn(w, grads)
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
        if atk is not None and "work" in atk:
            # free riders: no local progress this round
            dx = dx * atk["work"][:, None].to(dx.dtype)
        # Steps 6-8: local variable + local estimate updates.
        x_new = state.x_parts + cfg.gamma * dx
        dv = torch.bmm(env.a_parts, dx.unsqueeze(-1)).squeeze(-1)
        v_new = v_half + cfg.gamma * k * dv
        if not quantized:
            return ColaState(x_parts=x_new, v_stack=v_new)
        buf_new = None
        if cfg.pipeline:
            # the next round's step-0 encode, with the next round's draws:
            # bitwise what that round would encode at its top
            q, s, _, ef_new = quant.encode(
                v_new, cfg.wire, None if draws_next is None
                else draws_next(0), ef_new)
            buf_new = (q, s)
        return ColaState(x_parts=x_new, v_stack=v_new, ef=ef_new,
                         buf=buf_new)

    return one_round


def make_round(problem: Problem, part: Partition, cfg: ColaConfig) -> Callable:
    """The one-round function ``round(state, env, w, active, budgets=None,
    draws=None, draws_next=None, atk=None)``. ``w`` and ``active`` are
    tensors on the problem's device; ``draws`` and ``atk`` as
    ``_round_body`` says."""
    return _round_body(problem, part, cfg)


def cocoa_mixing(k: int) -> np.ndarray:
    """W = (1/K) 11^T: one gossip step yields the exact consensus v_c = Ax,
    recovering centralized CoCoA as a special case of CoLA."""
    return np.full((k, k), 1.0 / k)


class RunResult(NamedTuple):
    state: ColaState
    history: dict  # lists keyed by metric name
    # (T, n_tap, d) eavesdropper taps on the run's device when the attack
    # list holds an Eavesdropper (rows after an early stop are zeros), else
    # None
    taps: Any = None


def _check_supported(cfg: ColaConfig, *, leave_mode) -> None:
    """Reject an unknown ``leave_mode``."""
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


def _check_wire_config(cfg: ColaConfig, *, attacks=None,
                       leave_mode: str = "freeze", dist: bool = False) -> None:
    """Reject the corners the quantized wire does not support, as the
    reference does (each would change what crosses the wire); ``dist``:
    the distributed runtime's corners too."""
    if not quant.is_quantized(cfg.wire):
        if cfg.pipeline:
            raise ValueError(
                "cfg.pipeline requires a quantized wire — the fp32 payload "
                "has no encode step to hoist (set wire='int8'/'fp8')")
        return
    composed = attacks is not None or cfg.robust is not None
    if dist and attacks is not None:
        raise NotImplementedError(
            "attacks= with a quantized wire on the distributed runtime: "
            "its wire lowerings have no attacked-encode path, as in the "
            "reference (run_cola supports this composition)")
    if composed and cfg.pipeline:
        raise NotImplementedError(
            "cfg.pipeline with attacks=/cfg.robust on a quantized wire: "
            "the double-buffered payload is encoded a round early, before "
            "the attack transform / gate decision for its round exists")
    if composed and cfg.gossip_steps != 1:
        raise NotImplementedError(
            "attacks=/cfg.robust on a quantized wire require "
            "gossip_steps=1: steps 2..B would have to re-encode mixed "
            "values, which the composed path does not model yet")
    if cfg.grad_mode == "mixed":
        raise NotImplementedError(
            "grad_mode='mixed' with a quantized wire: the gradient exchange "
            "would cross in fp32 and break the declared byte budget")
    if cfg.pipeline and leave_mode == "reset":
        raise NotImplementedError(
            "cfg.pipeline with leave_mode='reset': the pre-encoded payload "
            "in flight would be stale after the leaver reset")


def _arm_wire_state(state: ColaState, cfg: ColaConfig,
                    wire_draws) -> ColaState:
    """Attach the quantized wire's state to a fresh state: the EF residual
    (zeros) and, when pipelining, round 0's pre-encoded first payload."""
    if not quant.is_quantized(cfg.wire):
        return state
    ef = quant.ef_init(state.v_stack, cfg.wire) if cfg.error_feedback \
        else None
    buf = None
    if cfg.pipeline:
        q, s, _, ef = quant.encode(state.v_stack, cfg.wire, wire_draws(0, 0),
                                   ef)
        buf = (q, s)
    return state._replace(ef=ef, buf=buf)


def _round_draws(wire_draws, t: int) -> dict:
    """The ``draws`` / ``draws_next`` arguments of round ``t``'s body."""
    if wire_draws is None:
        return {}
    return {"draws": lambda step: wire_draws(t, step),
            "draws_next": lambda step: wire_draws(t + 1, step)}


def _cohort_round(problem: Problem, part: Partition, cfg: ColaConfig,
                  env: ColaEnv) -> Callable:
    """The cohort round body of ``_run_cola_cohort``, ``step(state, env,
    sched_t, stopped)``: gathers the cohort's rows, mixes with the
    closed-form sampled-complete W (the exact uniform average over the
    cohort), solves on the slices and writes the cohort's rows back in
    place, keeping the old rows where ``stopped`` (a 0-d bool tensor, or
    None) is set."""
    k = part.num_nodes
    sigma = cfg.resolved_sigma(k)
    spec = SubproblemSpec(sigma_over_tau=sigma / problem.tau, inv_k=1.0 / k)
    gamma = cfg.gamma
    steps = cfg.coord_steps(part.block)
    use_gram = (env.gram_parts is not None
                and cfg.use_gram(problem.d, part.block,
                                 env.a_parts.element_size()))
    if cfg.cd_mode == "gram" and env.gram_parts is None:
        raise ValueError(
            "cd_mode='gram' but the env has no Gram blocks — build it "
            "with build_env(problem, part, with_gram=True)")
    rows = lambda t, idx: None if t is None else t.index_select(0, idx)

    def step_fn(st, env_ctx, s_t, stopped):
        idx = s_t["cohort_idx"]                              # (K',) sorted
        v_sub = rows(st.v_stack, idx)                        # (K', d)
        x_sub = rows(st.x_parts, idx)
        a_sub = rows(env_ctx.a_parts, idx)                   # (K', d, n_k)
        # Step 4 over the sampled complete subnetwork: the exact uniform
        # cohort average (rank-one W); inactive nodes untouched
        v_half = torch.mean(v_sub, dim=0, keepdim=True).expand_as(v_sub) \
            .contiguous()
        grads = problem.grad_f(v_half)
        dx = cd_solve_all(
            problem, spec, a_sub, x_sub, grads, rows(env_ctx.gp_parts, idx),
            rows(env_ctx.masks, idx), steps,
            gram_parts=rows(env_ctx.gram_parts, idx) if use_gram else None,
            a_cols=rows(env_ctx.a_cols, idx),
            gram_cols=rows(env_ctx.gram_cols, idx) if use_gram else None)
        # Steps 6-8 on the cohort's rows, written back in place
        dv = torch.bmm(a_sub, dx.unsqueeze(-1)).squeeze(-1)
        x_new = x_sub + gamma * dx
        v_new = v_half + gamma * k * dv
        if stopped is not None:
            x_new = torch.where(stopped, x_sub, x_new)
            v_new = torch.where(stopped, v_sub, v_new)
        st.x_parts.index_copy_(0, idx, x_new)
        st.v_stack.index_copy_(0, idx, v_new)
        return st

    return step_fn


def _reset_leavers(state: ColaState, env: ColaEnv, leavers: torch.Tensor,
                   total_fn: Callable | None = None) -> ColaState:
    """Fig.-6 model: zero x_[k] of the leaving nodes (``leavers``, (K,)
    bool on the state's device); every node subtracts
    sum_leavers A_[k] x_[k] from its estimate, so (1/K) sum_k v_k = A x
    still holds (Lemma 1). One bmm over all K blocks: a read of A. A
    leaver's EF residual describes payloads that no longer exist and is
    zeroed too (a pipelined wire rejects reset, so ``buf`` is None).
    ``total_fn(contrib)`` sums the (K, d) contributions over all K nodes
    (default: over the stacked axis; the distributed runtime completes its
    block's sum across ranks)."""
    leave = leavers.to(state.x_parts.dtype)
    contrib = torch.bmm(env.a_parts,
                        (state.x_parts * leave[:, None]).unsqueeze(-1))
    if total_fn is None:
        total_fn = lambda c: c.sum(dim=0)
    total = total_fn(contrib.squeeze(-1))                       # (d,)
    x_new = torch.where(leavers[:, None], torch.zeros_like(state.x_parts),
                        state.x_parts)
    ef_new = (None if state.ef is None else
              torch.where(leavers[:, None], torch.zeros_like(state.ef),
                          state.ef))
    return state._replace(x_parts=x_new,
                          v_stack=state.v_stack - total[None, :], ef=ef_new)


def run_cola(problem: Problem, graph: topo.Topology, cfg: ColaConfig,
             rounds: int, *, record_every=1, recorder: str | Any = "gap",
             eps: float | None = None, active_schedule=None,
             budget_schedule=None, leave_mode: str = "freeze", seed: int = 0,
             w_override: np.ndarray | None = None, attacks=None,
             executor: str = "block", block_size: int = 64,
             wire_draws: Callable | None = None, device=None) -> RunResult:
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
        draw from (active draw, then budget draw, in each round), of the
        wire's rounding draws and of the participation draws.
      w_override: this mixing matrix instead of Metropolis weights (rounds
        without churn).
      attacks: optional ``repro_torch.attack`` scenario or list (Byzantine
        payloads, free riders, link corruption, eavesdropper taps),
        applied to the materialized schedule after churn and budgets
        (block executor only; a participation run streams the generative
        ones). An ``Eavesdropper`` fills ``RunResult.taps``; defenses are
        ``cfg.robust``.
      executor: "block" (default) or "loop".
      wire_draws: on a quantized wire, ``(round, step) -> (K, d)`` fp32
        uniforms in [0, 1) for the stochastic rounding of that gossip step
        (row k: node k's draws). Default: the port's own counter stream
        from ``seed`` (``quant.wire_uniforms``). It exists for the parity
        tests, which feed in the reference's threefry uniforms.
      device: where the run happens (default "cuda"); the problem must
        live there. Without a card, pass ``device="cpu"`` explicitly.
    """
    dev = resolve(device)
    if problem.a.device != dev:
        raise ValueError(f"problem data is on {problem.a.device}, run_cola "
                         f"was asked to run on {dev}")
    _check_supported(cfg, leave_mode=leave_mode)
    _check_wire_config(cfg, attacks=attacks, leave_mode=leave_mode)
    k = graph.num_nodes
    part = make_partition(problem.n, k)
    sample = cfg.participation
    if sample is not None:
        if not isinstance(sample, schedule_lib.SampleConfig):
            raise TypeError(
                "cfg.participation must be a repro_torch.core.schedule."
                f"SampleConfig, got {type(sample).__name__}")
        if active_schedule is not None:
            raise ValueError(
                "participation= and active_schedule= both set: client "
                "sampling IS an active schedule — pass one or the other")
        if executor != "block":
            raise ValueError(
                "cfg.participation requires executor='block' — the sampled "
                "schedule streams through the round-block executor")
        schedule_lib.require_complete(graph)
        if sample.resolve_mode(k) == "cohort":
            return _run_cola_cohort(
                problem, cfg, rounds, part=part, record_every=record_every,
                recorder=recorder, eps=eps, budget_schedule=budget_schedule,
                leave_mode=leave_mode, seed=seed, w_override=w_override,
                attacks=attacks, block_size=block_size)
    env = build_env(problem, part,
                    with_gram=cfg.use_gram(problem.d, part.block,
                                           problem.a.element_size()))
    state = init_state(problem, part)
    if quant.is_quantized(cfg.wire):
        if wire_draws is None:
            wire_draws = quant.wire_uniforms(seed, k, problem.d, dev)
        state = _arm_wire_state(state, cfg, wire_draws)
    else:
        wire_draws = None
    base_w = w_override if w_override is not None \
        else topo.metropolis_weights(graph)
    rec = metrics_lib.make_recorder(recorder, problem, part, env, graph,
                                    base_w, eps)
    active_schedule = _as_schedule_fn(active_schedule, rounds, k,
                                      "active_schedule")
    budget_schedule = _as_schedule_fn(budget_schedule, rounds, k,
                                      "budget_schedule")
    if active_schedule is not None or sample is not None:
        # certificates judge each churn round's reweighted exchange, not
        # the static graph (client sampling is streamed churn)
        rec = metrics_lib.dynamize(rec)
    np_dtype = torch.empty((), dtype=problem.a.dtype).numpy().dtype
    sched = _materialize_schedule(graph, rounds, active_schedule,
                                  budget_schedule, leave_mode, seed, base_w,
                                  np_dtype)
    body = _round_body(problem, part, cfg)
    if executor == "block":
        stream = atk_part = atk_info = telemetry = None
        if cfg.telemetry:
            from repro_torch.obs import counters as obs_counters
            inc = obs_counters.round_increments(graph, problem.d, cfg,
                                                problem.a.element_size())
            telemetry = (obs_counters.make_update(cfg, inc), inc)
            state = state._replace(
                counters=obs_counters.init_counters(k, dev))
        if attacks is not None:
            ctx = attack_lib.AttackContext(graph=graph, rounds=rounds, k=k,
                                           d=problem.d, dtype=np_dtype,
                                           seed=seed, device=dev)
            if sample is not None:
                # a participation run streams its schedule: the attacks
                # ride the same stream as one more generator part
                atk_part, atk_info = attack_lib.streamed_attacks(attacks, ctx)
            else:
                # after churn and budgets, before the certificate schedule:
                # certificates judge the corrupted exchange
                sched, atk_info = attack_lib.apply_attacks(sched, attacks,
                                                           ctx)
            if "dishonest" in atk_info.entry_names:
                rec = metrics_lib.attackify(rec)
        if sample is not None:
            sched, stream = _participation_schedule(
                sched, sample, rec, k=k, rounds=rounds, seed=seed,
                leave_mode=leave_mode, dtype=problem.a.dtype, device=dev,
                extra_parts=() if atk_part is None else (atk_part,))
        from repro_torch.obs import trace as obs_trace
        with obs_trace.run_tracer(cfg.telemetry) as tracer:
            res = _run_cola_block(body, env, state, rounds, record_every,
                                  rec, sched, block_size, stream=stream,
                                  wire_draws=wire_draws, atk_info=atk_info,
                                  telemetry=telemetry)
        if cfg.telemetry:
            _emit_report("run_cola", problem, cfg, graph, telemetry[1],
                         res.history, tracer.summary())
        return res
    if executor == "loop":
        if attacks is not None:
            raise ValueError(
                "attacks= requires executor='block' — attack scenarios are "
                "schedule transforms over the pre-materialized (T, ...) "
                "schedules the loop driver does not build")
        if cfg.telemetry:
            raise ValueError(
                "cfg.telemetry requires executor='block' — the obs "
                "counters ride the round-block executor's state")
        return _run_cola_loop(body, env, state, rounds, record_every, rec,
                              sched, wire_draws=wire_draws)
    raise ValueError(f"unknown executor {executor!r} (want 'block' or 'loop')")


def _participation_schedule(sched, sample, recorder, *, k, rounds, seed,
                            leave_mode, dtype, device, extra_parts=()):
    """A dense participation run's schedule: the sampler's generator parts
    (and ``extra_parts``, the streamed attacks) stream (``sample.stream``;
    the broadcast w/active give way to them) or are materialized into
    (T, ...) stacks. Under reset, the host flag ``reset_any`` comes from
    the same draws on the CPU. Returns ``(sched, stream)``."""
    cert = metrics_lib.first_certificate(recorder)
    prog = schedule_lib.ScheduleProgram(parts=schedule_lib.participation_parts(
        k, sample, dtype=dtype, run_seed=seed, device=device,
        cert=cert if cert is not None and cert.dynamic else None,
        leave_reset=leave_mode == "reset") + tuple(extra_parts))
    sched = {name: v for name, v in sched.items()
             if name not in ("w", "active")}
    if leave_mode == "reset":
        sched["reset_any"] = schedule_lib.reset_flags(k, sample, seed, rounds)
    if sample.stream:
        return sched, prog.stream_fn()
    sched.update(prog.materialize(rounds))
    return sched, None


def _run_cola_loop(body, env, state, rounds, record_every, recorder,
                   sched, wire_draws=None) -> RunResult:
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
                     on_dev(sched["active"][t]), b_t,
                     **_round_draws(wire_draws, t))
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
                    block_size, *, stream=None, wire_draws=None,
                    atk_info=None, telemetry=None) -> RunResult:
    """Round-block driver (see ``repro_torch.core.executor``).

    The leaver reset is decided on the host: ``reset_any`` is a host entry
    of the schedule (``host_entries``), so a round without leavers runs no
    reset and reads A no extra time, and the decision costs no device sync
    (the reference gates it with a ``lax.cond`` on the same flag). So is
    the round index ``round`` that keys a quantized wire's draws.
    ``stream``: a participation run's generator (its entries replace w,
    active and the certificate's). ``atk_info``: the attacks' entries; the
    random payloads' run-constant (K, d) directions go to the device once
    (the stacked ``atk_bias`` is a (T, K, d) broadcast of them), and the
    eavesdropper's taps are the round's aux output. ``telemetry``:
    ``(update, inc)`` of ``repro_torch.obs.counters`` when the state
    carries counters: each round's signals update them, its counter row is
    aux ``"obs"`` (the taps then aux ``"taps"``), and the history gets
    ``"telemetry"`` (``summarize``)."""
    has_reset = "reset_any" in sched
    if wire_draws is not None:
        sched = dict(sched, round=np.arange(rounds))
    dev = state.x_parts.device
    # the round body's entries (the recorder reads atk_dishonest itself)
    atk_names = tuple(n for n in (atk_info.entry_names if atk_info else ())
                      if n != "dishonest")
    bias = None
    if "atk_bias" in sched:
        bias = torch.as_tensor(np.array(sched["atk_bias"][0]), device=dev)
        sched = {n: v for n, v in sched.items() if n != "atk_bias"}
    taps = atk_info.tap_nodes if atk_info is not None else ()
    tap_idx = torch.as_tensor(taps, dtype=torch.int64, device=dev) \
        if taps else None

    def step_fn(st, env_ctx, s_t):
        if has_reset and s_t["reset_any"]:
            st = _reset_leavers(st, env_ctx, s_t["leavers"])
        draws = {} if wire_draws is None else _round_draws(
            wire_draws, int(s_t["round"]))
        atk = {n: s_t["atk_" + n] if n != "bias" else s_t.get("atk_bias",
                                                              bias)
               for n in atk_names} or None
        sig = None if telemetry is None else {}
        new = body(st, env_ctx, s_t["w"], s_t["active"], s_t.get("budgets"),
                   atk=atk, sig=sig, **draws)
        tap = None
        if tap_idx is not None:
            # what the tapped nodes emit this round (post-reset state, the
            # round's wire transform), from their rows alone
            rows = lambda t: t.index_select(0, tap_idx)
            tap = _apply_payload_attack(
                rows(st.v_stack),
                atk and {n: rows(a) for n, a in atk.items()})
        if telemetry is None:
            return new if tap is None else (new, tap)
        # the round body builds a new state: carry the updated counters
        counters, row = telemetry[0](st.counters, sig, new)
        aux = {"obs": row} if tap is None else {"obs": row, "taps": tap}
        return new._replace(counters=counters), aux

    cad = metrics_lib.as_cadence(record_every)
    rec_mask = None if cad else exec_engine.record_flags(rounds, record_every)
    cert = metrics_lib.first_certificate(recorder)
    if cert is not None and cert.dynamic and "cert_mask" not in sched \
            and stream is None:
        # the churn certificate's per-round mask and threshold ride the
        # schedule; under an adaptive cadence any round may record
        sched = dict(sched, **metrics_lib.certificate_schedule(
            recorder, sched["w"], sched["active"],
            np.ones((rounds,), dtype=bool) if cad else rec_mask))
    res = exec_engine.run_round_blocks(
        step_fn, state, sched, context=env, recorder=recorder,
        record_mask=rec_mask, block_size=block_size, cadence=cad,
        num_rounds=rounds, host_entries=("reset_any", "round"),
        stream=stream, with_aux=tap_idx is not None or telemetry is not None)
    history = metrics_lib.history_from(recorder, res)
    if telemetry is None:
        return RunResult(state=res.state, history=history, taps=res.aux)
    from repro_torch.obs import counters as obs_counters
    history["telemetry"] = obs_counters.summarize(
        res.state.counters, telemetry[1], series=res.aux["obs"],
        stop_round=res.stop_round, dishonest=sched.get("atk_dishonest"))
    return RunResult(state=res.state, history=history,
                     taps=res.aux.get("taps"))


def _emit_report(driver: str, problem: Problem, cfg, graph, inc: dict,
                 history: dict, spans: dict) -> None:
    """Append a telemetry run's ``RunReport`` to the run registry
    (``repro_torch.obs.report.auto_emit``)."""
    from repro_torch.obs import report as obs_report
    stop = history["telemetry"]["stop_round"]
    obs_report.auto_emit(obs_report.make_report(
        driver=driver, problem_fp=exec_engine.fingerprint(problem),
        config=dataclasses.asdict(cfg),
        graph={"kind": graph.name, "num_nodes": graph.num_nodes},
        rounds=history["telemetry"]["rounds"] if stop is None else stop + 1,
        history=history, contract=inc["contract"], spans=spans))


def _run_cola_cohort(problem, cfg, rounds, *, part, record_every, recorder,
                     eps, budget_schedule, leave_mode, seed, w_override,
                     attacks, block_size) -> RunResult:
    """Million-node client sampling: each round only the sampled K'-node
    cohort computes, and nothing (K, K)- or (T, K)-shaped exists.

    The streamed schedule gives the sorted cohort indices (K',) and the
    active mask (K,). The round body gathers the cohort's (K', ...) rows of
    the state and the env (``a_parts``, and the CD kernel's layout:
    ``gram_cols`` for the Gram kernel, ``a_cols`` for the residual one),
    mixes with the closed-form sampled-complete W (the exact uniform
    average over the cohort), runs the local solve on the slices and
    writes the cohort's rows back in place (``index_copy_``): frozen nodes
    are untouched, the dense participation semantics. It selects the old
    rows itself once the stop flag is set (``in_place``), so a round
    copies K' rows, never the (K, d) state.
    """
    sample = cfg.participation
    k = part.num_nodes
    for flag, what in (
            (attacks is not None, "attacks="),
            (budget_schedule is not None, "budget_schedule="),
            (leave_mode != "freeze", f"leave_mode={leave_mode!r}"),
            (w_override is not None, "w_override="),
            (cfg.telemetry, "cfg.telemetry"),
            (cfg.robust is not None, "cfg.robust"),
            (quant.is_quantized(cfg.wire), f"wire={cfg.wire!r}"),
            (cfg.grad_mode != "local", f"grad_mode={cfg.grad_mode!r}"),
            (cfg.gossip_steps != 1, "gossip_steps != 1")):
        if flag:
            raise NotImplementedError(
                f"{what} is not supported in cohort participation mode — "
                "the gather/scatter round body implements the bare "
                "Algorithm-1 round over the sampled cohort (dense "
                f"participation mode, K <= {schedule_lib.DENSE_MAX_NODES}, "
                "supports these compositions)")
    env = build_env(problem, part,
                    with_gram=cfg.use_gram(problem.d, part.block,
                                           problem.a.element_size()))
    state = init_state(problem, part)
    if isinstance(recorder, str):
        # make_recorder wants a dense graph and W for the certificate; the
        # cohort form derives its thresholds without either
        if recorder not in ("gap", "certificate", "gap+certificate"):
            raise ValueError(f"unknown recorder {recorder!r} (want 'gap', "
                             "'certificate', 'gap+certificate' or a "
                             "Recorder instance)")
        recs = []
        if recorder in ("gap", "gap+certificate"):
            recs.append(metrics_lib.GapRecorder(
                problem, part, eps=eps if recorder == "gap" else None))
        if recorder in ("certificate", "gap+certificate"):
            if eps is None:
                raise ValueError(
                    f"recorder={recorder!r} needs eps=: the Prop.-1 "
                    "conditions certify a specific accuracy")
            recs.append(metrics_lib.cohort_certificate_recorder(
                problem, part, env, eps))
        rec = (recs[0] if len(recs) == 1
               else metrics_lib.ComposedRecorder(tuple(recs)))
    else:
        rec = recorder

    step_fn = _cohort_round(problem, part, cfg, env)
    prog = schedule_lib.ScheduleProgram(parts=schedule_lib.cohort_parts(
        k, sample, dtype=problem.a.dtype, run_seed=seed,
        device=problem.a.device))
    if sample.stream:
        sched, stream = {}, prog.stream_fn()
    else:
        sched, stream = prog.materialize(rounds), None
    cad = metrics_lib.as_cadence(record_every)
    rec_mask = None if cad else exec_engine.record_flags(rounds, record_every)
    res = exec_engine.run_round_blocks(
        step_fn, state, sched, context=env, recorder=rec,
        record_mask=rec_mask, block_size=block_size, cadence=cad,
        num_rounds=rounds, stream=stream, in_place=True)
    return RunResult(state=res.state,
                     history=metrics_lib.history_from(rec, res))


def solve_reference(problem: Problem, rounds: int = 3000,
                    kappa: int = 10) -> float:
    """High-accuracy reference optimum via single-node CoCoA (used as F*
    when reporting suboptimality, as in the paper's App. D)."""
    graph = topo.complete(2)
    res = run_cola(problem, graph, ColaConfig(kappa=kappa), rounds,
                   record_every=max(rounds // 4, 1),
                   w_override=cocoa_mixing(2), device=problem.a.device)
    return min(res.history["primal"])
