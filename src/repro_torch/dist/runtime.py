"""``run_dist_cola``: COLA with the node axis over ``torch.distributed`` ranks.

``run_cola`` keeps all K nodes stacked on one device; ``run_dist_cola``
lays the node axis over the M ranks of a process group (one rank per
device: NCCL on cards, gloo on the CPU), K/M nodes per rank, with no
coordinator. Every rank runs the same program on its own block:

* **the same round body**: ``cola._round_body`` with its two mixing hooks
  swapped for exchanges over the ranks (``_dist_mixers``); the local CD
  solve (the CUDA kernels on the card), the updates and the churn masking
  are ``run_cola``'s code on the rank's (K/M, ...) block;
* **the same executor and schedules**: every rank materializes
  ``run_cola``'s schedule from the same seed and keeps its rows
  (``sharding.schedule_block``); rounds run in blocks of ``block_size``;
* **neighbor exchange, not all-reduce**: ``comm="ring"`` mixes over the
  circulant band (one node per rank); ``comm="plan"`` compiles the graph
  (``repro_torch.topo``) into one exchange per color of a node's vector
  (``CommPlan``, one node per rank) or of a rank's (K/M, d) block
  (``BlockPlan``); ``comm="dense"`` all-gathers the stack and mixes it
  (the oracle). A ``ring`` request runs the plan under churn, on a
  non-circulant W, or with fewer ranks than nodes.

Recording follows the reference: the gap recorder gathers the stacks (its
row is rank 0's, broadcast, so every rank takes the same stop decision);
the certificate records from the rank's block, its Eq.-10 neighborhood
mean exchanged like the mix, its row completed by ``psum`` / ``pmax``.
Every rank makes the same collectives in the same order, and the stop
flag is the same on every rank.

At M = 1 the block plan has no colors and every collective leaves values
unchanged, so ``comm="plan"`` and ``comm="dense"`` run ``run_cola``'s
operations on the same tensors: bitwise its result. At M > 1 the dense
path stays bitwise (every rank mixes the gathered stack) and the block
plan's products run at the dense shape (``topo.plan.rows_product``); the
certificate's cross-rank sums add in another order.

The quantized wire, robust mixing and attacks over ranks raise
``NotImplementedError`` (ROADMAP queue 1 item 14.1), telemetry too (item
15).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import cola, executor as exec_engine, metrics as \
    metrics_lib, mixing, quant, topology as topo
from repro_torch.core.cola import (ColaConfig, ColaState, RunResult,
                                   _as_schedule_fn, _check_wire_config,
                                   _materialize_schedule, _reset_leavers,
                                   _round_body, build_env, init_state)
from repro_torch.core.duality import consensus_residual, neighborhood_mean
from repro_torch.core.partition import make_partition
from repro_torch.core.problems import Problem
from repro_torch.device import resolve
from repro_torch.dist import sharding
from repro_torch.dist.axis import NodeAxis
from repro_torch.topo import lowering as topo_lowering, plan as topo_plan

DIST_TODO = "over torch.distributed ranks: ROADMAP queue 1 item 14.1"


def _check_supported(cfg: ColaConfig, attacks) -> None:
    """Reject what this slice does not run over ranks, naming the ROADMAP
    item that brings it."""
    if quant.is_quantized(cfg.wire):
        raise NotImplementedError(
            f"run_dist_cola: the quantized wire ({cfg.wire!r}) {DIST_TODO}")
    if cfg.robust is not None:
        raise NotImplementedError(
            f"run_dist_cola: robust mixing (cfg.robust={cfg.robust!r}) "
            f"{DIST_TODO}")
    if attacks is not None:
        raise NotImplementedError(f"run_dist_cola: attacks= {DIST_TODO}")
    if cfg.telemetry:
        raise NotImplementedError(
            "run_dist_cola: cfg.telemetry is not ported yet (ROADMAP queue "
            "1 item 15 (observability))")
    if cfg.participation is not None:
        raise ValueError(
            "run_dist_cola: cfg.participation (client sampling) runs on "
            "run_cola; the distributed runtime lays a fixed node set over "
            "the ranks")


def _check_device(axis: NodeAxis, dev: torch.device) -> None:
    """NCCL for a card, gloo for the CPU, and the card is the current one
    (NCCL's point-to-point calls need it)."""
    want = "nccl" if dev.type == "cuda" else "gloo"
    if axis.backend != want:
        raise ValueError(f"run_dist_cola on {dev} needs a {want!r} process "
                         f"group, got {axis.backend!r}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"run_dist_cola on {dev}: set it as the current "
                         "device first (torch.cuda.set_device)")


def _dist_mixers(axis: NodeAxis, local_nodes: int, conn: int, comm: str,
                 gossip_steps: int, plan=None) -> tuple[Callable, Callable]:
    """(mix_fn, grad_mix_fn) for the round body on this rank's block.

    The first argument of each is the round's comm payload, the schedule
    slice ``step_fn`` routes in: the (K, K) W for ``dense`` / ``ring``,
    this rank's (K/M, K) rows of W for a block plan, the (diag, coefs) of
    its node for a per-node plan.

    ``dense``: all-gather the (K, d) stack, ``mix_power`` it (W^B folded,
    every rank the whole product), keep this rank's rows: bitwise
    ``run_cola``'s mix. ``ring``: the banded ring, one node per rank.
    ``plan``: one exchange per color per gossip step (``topo.lowering``).
    """
    if comm == "dense":
        def steps_mix(w, stack, steps):
            if steps <= 0:
                return stack
            mixed = mixing.mix_power(w, axis.all_gather(stack), steps)
            return sharding.node_block(mixed, axis)
    elif comm == "ring":
        if local_nodes != 1:
            raise ValueError(
                f"comm='ring' places one node per rank; got {local_nodes} "
                "nodes per rank — use comm='plan' or 'dense'")

        def steps_mix(w, stack, steps):
            band = mixing.banded_weights(w, conn)
            out = stack[0]
            for _ in range(steps):
                out = mixing.ring_mix_ppermute(out, axis, band, conn)
            return out[None]
    elif comm == "plan" and isinstance(plan, topo_plan.BlockPlan):
        if local_nodes != plan.local_nodes:
            raise ValueError(
                f"block plan carries {plan.local_nodes} nodes per rank but "
                f"the layout has {local_nodes}")

        def steps_mix(w_rows, stack, steps):
            return topo_lowering.block_mix_steps(stack, axis, plan, w_rows,
                                                 steps)
    elif comm == "plan":
        if local_nodes != 1:
            raise ValueError(
                f"a per-node CommPlan places one node per rank; got "
                f"{local_nodes} nodes per rank — compile a BlockPlan "
                "(run_dist_cola does this itself)")

        def steps_mix(payload, stack, steps):
            diag, coefs = payload        # this node's (1,), (C, 1)
            return topo_lowering.plan_mix_steps(
                stack[0], axis, plan, diag[0], coefs[:, 0], steps)[None]
    else:
        raise ValueError(
            f"unknown comm {comm!r} (want 'dense', 'ring' or 'plan')")

    # no attacks over ranks yet: v_self is always None
    mix_fn = lambda w, v_send, v_self: steps_mix(w, v_send, gossip_steps)
    grad_mix_fn = lambda w, g: steps_mix(w, g, 1)
    return mix_fn, grad_mix_fn


# ---------------------------------------------------------------------------
# distributed recorders
# ---------------------------------------------------------------------------

def _certificate_dist_record(rec, axis: NodeAxis, local_nodes: int,
                             comm: str, conn: int, env_l,
                             plan=None) -> Callable:
    """The certificate's row from this rank's block, O(colors (K/M) d)
    bytes a record.

    Condition (9) is node-local. Condition (10)'s neighborhood mean comes
    from the exchange pattern of the mix: ``2 conn`` ring exchanges of the
    node's gradient; one exchange per color with the round's mask row
    selecting what arrives (per-node plan: under churn the mask follows
    the reweighted support); one exchange of the (K/M, d) gradient block
    per rank-level color, mask rows selecting per node (block plan); or
    the all-gather (dense). A ring request whose mask is not the band
    compiles the mask's own plan. The Lemma-1 sums complete with one
    ``psum`` of a (2, d) stack, the counts and maxima with scalar
    ``psum`` / ``pmax``."""
    k = rec.part.num_nodes

    def compile_support(support):
        return (topo_plan.compile_plan(support) if local_nodes == 1
                else topo_plan.compile_block_plan(support,
                                                  k // local_nodes))

    neigh_host = rec.neigh_mask.cpu().numpy()
    if comm == "ring":
        band = np.zeros((k, k))
        idx = np.arange(k)
        for off in range(-conn, conn + 1):
            band[idx, (idx + off) % k] = 1.0
        if not np.array_equal(neigh_host != 0, band != 0):
            comm, plan = "plan", compile_support(neigh_host)
    if comm == "plan" and plan is None:
        plan = compile_support(neigh_host)
    static_rows = sharding.node_block(rec.neigh_mask, axis)
    local = dataclasses.replace(rec, a_parts=env_l.a_parts,
                                gp_parts=env_l.gp_parts, masks=env_l.masks)

    def record(state, sched=None):
        if rec.dynamic:
            # churn: the round's mask rows and threshold from the schedule
            nm_l, thr = sched["cert_mask"], sched["cert_grad_thresh"]
        else:
            nm_l, thr = static_rows, None
        x_l, v_l = state.x_parts, state.v_stack
        grads = rec.problem.grad_f(v_l)                      # (ln, d)
        if comm == "plan" and isinstance(plan, topo_plan.BlockPlan):
            nsum, count = topo_lowering.block_neighborhood_stats(
                grads, axis, plan, nm_l)
            neigh_mean = nsum / count[:, None]
        elif comm == "plan":
            nsum, count = topo_lowering.plan_neighborhood_stats(
                grads[0], axis, plan, nm_l[0])
            neigh_mean = (nsum / count)[None]
        elif comm == "ring":
            g = grads[0]
            nsum = g
            for off in range(1, conn + 1):
                nsum = (nsum + axis.permute(g, [(i, (i + off) % k)
                                                for i in range(k)])
                        + axis.permute(g, [((i + off) % k, i)
                                           for i in range(k)]))
            neigh_mean = (nsum / (2 * conn + 1))[None]
        else:
            neigh_mean = neighborhood_mean(axis.all_gather(grads), nm_l)
        local_gap, disagree = local.local_row_inputs(x_l, v_l, grads,
                                                     neigh_mean)
        sums = axis.psum(torch.stack(local.invariant_sums(x_l, v_l)))
        resid = consensus_residual(sums[0], sums[1], k)
        return rec.summarize(local_gap, disagree, resid=resid,
                             grad_thresh=thr, psum=axis.psum,
                             pmax=axis.pmax)

    return record


def _dist_record_fn(recorder, axis: NodeAxis, local_nodes: int, comm: str,
                    conn: int, env_l, plan=None) -> Callable:
    """``record(state, sched)`` on this rank's block for any recorder:
    certificates from local quantities, anything else on the gathered
    stacks (every rank evaluates it; rank 0's row is broadcast)."""
    if isinstance(recorder, metrics_lib.ComposedRecorder):
        parts = [_dist_record_fn(p, axis, local_nodes, comm, conn, env_l,
                                 plan) for p in recorder.parts]
        return lambda st, sched=None: torch.cat([f(st, sched)
                                                 for f in parts])
    if isinstance(recorder, metrics_lib.CertificateRecorder):
        return _certificate_dist_record(recorder, axis, local_nodes, comm,
                                        conn, env_l, plan)
    def gathered(st, sched=None):
        full = ColaState(x_parts=axis.all_gather(st.x_parts),
                         v_stack=axis.all_gather(st.v_stack))
        return axis.broadcast(recorder.record_fn(full))

    return gathered


class _DistRecorder:
    """A Recorder whose row comes from ``_dist_record_fn``; labels, the
    stop condition and the cadence are the inner recorder's."""

    def __init__(self, inner, record_fn):
        self._inner = inner
        self._record_fn = record_fn

    @property
    def labels(self):
        return self._inner.labels

    @property
    def uses_schedule(self) -> bool:
        return bool(getattr(self._inner, "uses_schedule", False))

    def record_fn(self, state, sched=None):
        return self._record_fn(state, sched)

    @property
    def stop_fn(self):
        return self._inner.stop_fn

    def cadence_ratio(self, row):
        return self._inner.cadence_ratio(row)


def _resolve_comm(comm: str, graph, base_w, *, local_nodes: int, m: int,
                  churn: bool, conn: int):
    """(comm, plan) after the reference's dispatch: ``ring`` becomes
    ``plan`` under churn, on a non-circulant W or with fewer ranks than
    nodes; a plan is per node at one node per rank, else a block plan.
    The plan's support is the graph's (churn only removes edges) plus a
    static W's own off-diagonal pattern."""
    if comm == "ring":
        if churn or local_nodes != 1:
            comm = "plan"
        else:
            try:
                mixing.check_circulant_band(base_w, conn)
            except ValueError:
                comm = "plan"
    if comm != "plan":
        return comm, None
    support = graph.adjacency.copy()
    if not churn:
        off = np.asarray(base_w) != 0
        np.fill_diagonal(off, False)
        support = support | off
    return comm, (topo_plan.compile_plan(support) if local_nodes == 1
                  else topo_plan.compile_block_plan(support, m))


def run_dist_cola(problem: Problem, graph: topo.Topology, cfg: ColaConfig,
                  group, rounds: int, *, comm: str = "ring", conn: int = 1,
                  record_every=1, recorder="gap", eps: float | None = None,
                  active_schedule=None, budget_schedule=None,
                  leave_mode: str = "freeze", seed: int = 0,
                  w_override: np.ndarray | None = None, attacks=None,
                  wire: str | None = None, block_size: int = 64,
                  device=None) -> RunResult:
    """Run Algorithm 1 with the node axis over the ranks of ``group``.

    Arguments and result mirror ``run_cola`` (same schedules from the same
    rng, same history, same ``recorder`` / ``eps`` stopping), plus:

      group: the process group (None: the default one, initialised by the
        caller) or a ``NodeAxis`` over it; K % M == 0, K/M nodes per rank.
      comm: "ring" (circulant band, one node per rank), "plan" (the
        compiled topology program: any sparse graph and its churn
        reweightings) or "dense" (all-gather and mix). See the module.
      conn: the band's connectivity for ``comm="ring"``.
      wire: overrides ``cfg.wire``.
      device: this rank's device (default "cuda", the current card, on an
        NCCL group; pass ``device="cpu"`` on a gloo group). The problem
        must live there.

    Every rank gets the full stacked (K, ...) ``RunResult`` and the same
    history.
    """
    dev = resolve(device)
    if problem.a.device != dev:
        raise ValueError(f"problem data is on {problem.a.device}, "
                         f"run_dist_cola was asked to run on {dev}")
    if wire is not None:
        cfg = dataclasses.replace(cfg, wire=wire)
    _check_supported(cfg, attacks)
    cola._check_supported(cfg, leave_mode=leave_mode)
    _check_wire_config(cfg, leave_mode=leave_mode)
    axis = group if isinstance(group, NodeAxis) else NodeAxis(group)
    _check_device(axis, dev)
    m, k = axis.size, graph.num_nodes
    if k % m != 0:
        raise ValueError(f"K={k} nodes must divide over {m} ranks")
    local_nodes = k // m

    active_schedule = _as_schedule_fn(active_schedule, rounds, k,
                                      "active_schedule")
    budget_schedule = _as_schedule_fn(budget_schedule, rounds, k,
                                      "budget_schedule")
    churn = active_schedule is not None
    base_w = (w_override if w_override is not None
              else topo.metropolis_weights(graph))
    comm, plan = _resolve_comm(comm, graph, base_w, local_nodes=local_nodes,
                               m=m, churn=churn, conn=conn)
    block_mode = isinstance(plan, topo_plan.BlockPlan)

    part = make_partition(problem.n, k)
    env = build_env(problem, part,
                    with_gram=cfg.use_gram(problem.d, part.block,
                                           problem.a.element_size()))
    np_dtype = torch.empty((), dtype=problem.a.dtype).numpy().dtype
    sched = _materialize_schedule(graph, rounds, active_schedule,
                                  budget_schedule, leave_mode, seed, base_w,
                                  np_dtype)
    has_reset = "reset_any" in sched
    rec = metrics_lib.make_recorder(recorder, problem, part, env, graph,
                                    base_w, eps)
    if churn:
        rec = metrics_lib.dynamize(rec)
    env_l = sharding.cola_env_block(env, axis)
    del env
    state = sharding.cola_state_block(init_state(problem, part), axis)
    axis.warm_up(dev)
    dist_rec = _DistRecorder(
        rec, _dist_record_fn(rec, axis, local_nodes, comm, conn, env_l,
                             plan))
    mix_fn, grad_mix_fn = _dist_mixers(axis, local_nodes, conn, comm,
                                       cfg.gossip_steps, plan)
    body = _round_body(problem, part, cfg, mix_fn=mix_fn,
                       grad_mix_fn=grad_mix_fn)
    total_fn = lambda c: axis.psum(c.sum(dim=0))

    def step_fn(st, env_ctx, s_t):
        if has_reset and s_t["reset_any"]:
            # the leaver reset, its node sum completed across ranks
            st = _reset_leavers(st, env_ctx, s_t["leavers"],
                                total_fn=total_fn)
        if plan is None:
            payload = s_t["w"]
        elif block_mode:
            payload = s_t["plan_w"]
        else:
            payload = (s_t["plan_diag"], s_t["plan_coefs"])
        return body(st, env_ctx, payload, s_t["active"], s_t.get("budgets"))

    cad = metrics_lib.as_cadence(record_every)
    rec_mask = (None if cad
                else exec_engine.record_flags(rounds, record_every))
    cert = metrics_lib.first_certificate(rec)
    if cert is not None and cert.dynamic:
        sched.update(metrics_lib.certificate_schedule(
            rec, sched["w"], sched["active"],
            np.ones((rounds,), dtype=bool) if cad else rec_mask))
    if plan is not None:
        # the per-round plan entries, coverage checked each round; the
        # (T, K, K) W stack then has no reader
        sched_cls = (topo_plan.BlockPlanSchedule if block_mode
                     else topo_plan.PlanSchedule)
        sched.update(sched_cls.from_w_stack(plan, sched["w"],
                                            static=not churn).entries())
        del sched["w"]
    res = exec_engine.run_round_blocks(
        step_fn, state, sharding.schedule_block(sched, axis), context=env_l,
        recorder=dist_rec, record_mask=rec_mask, block_size=block_size,
        cadence=cad, num_rounds=rounds, host_entries=("reset_any",))
    return RunResult(state=sharding.gather_state(res.state, axis),
                     history=metrics_lib.history_from(dist_rec, res))
