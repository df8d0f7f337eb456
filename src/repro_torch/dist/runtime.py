"""``run_dist_cola``: COLA with the node axis over ``torch.distributed`` ranks.

``run_cola`` keeps all K nodes stacked on one device; ``run_dist_cola``
lays the node axis over the M ranks of a process group (one rank per
device: NCCL on cards, gloo on the CPU), K/M nodes per rank, with no
coordinator. Every rank runs the same program on its own block:

* **the same round body** (``dist_round_body``): ``cola._round_body``
  with its mixing hooks swapped for exchanges over the ranks
  (``_dist_mixers``, and ``_dist_qmixers`` on a quantized wire); the local
  CD solve (the CUDA kernels on the card), the updates, the churn masking
  and the attacks' wire transform are ``run_cola``'s code on the rank's
  (K/M, ...) block;
* **the same executor and schedules**: every rank materializes
  ``run_cola``'s schedule from the same seed, applies the same attacks,
  and keeps its rows (``sharding.schedule_block``); rounds run in blocks
  of ``block_size``. The env holds only the rank's K/M column blocks of A;
* **neighbor exchange, not all-reduce**: ``comm="ring"`` mixes over the
  circulant band (one node per rank); ``comm="plan"`` compiles the graph
  (``repro_torch.topo``) into one exchange per color of a node's vector
  (``CommPlan``, one node per rank) or of a rank's (K/M, d) block
  (``BlockPlan``); ``comm="dense"`` all-gathers the stack and mixes it
  (the oracle). A ``ring`` request runs the plan under churn, on a
  non-circulant W, with fewer ranks than nodes, on a quantized wire or
  under ``cfg.robust``; the last two always compile a ``BlockPlan``, even
  at one node per rank (the robust rule needs the assembled neighborhood
  buffer, and the block product keeps the wire bitwise).

The quantized wire sends the narrow payload and its fp32 scale sidecar
(two exchanges a color; the dense oracle all-gathers both), drawn from
the rank's rows of the round's uniforms, so its bits do not depend on M.
Robust mixing aggregates the assembled buffer (``mixing
.robust_neighborhood_mix``); on a quantized wire it judges the
dequantized rows. Attacks corrupt the first step's payloads as
``run_cola``'s do; an attacked run's certificate audits the honest cohort.
As in the reference, attacks on a quantized wire raise
``NotImplementedError`` and eavesdropper taps ``ValueError``.

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
plan's products run at the dense shape (``topo.plan.rows_product``,
``mixing._Neighborhood.rows_matmul``); the certificate's cross-rank sums
add in another order.

Telemetry (``cfg.telemetry``, ``repro_torch.obs``) counts on each rank:
the wire's bytes and exchanges are the static budget of the comm the run
uses (``obs.counters.dist_round_increments``); each rank counts the gate
rejections of its own receiver rows and its rows' share of the saturation
and of the EF residual, from the signals its round body hands out. The
ranks combine them once, at the end of the run (one all-reduce, one
all-gather), so telemetry adds no collective to a round.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import attack as attack_lib
from repro_torch.core import cola, executor as exec_engine, metrics as \
    metrics_lib, mixing, quant, topology as topo
from repro_torch.core.cola import (ColaConfig, ColaState, RunResult,
                                   _arm_wire_state, _as_schedule_fn,
                                   _check_wire_config,
                                   _materialize_schedule, _reset_leavers,
                                   _round_body, _round_draws)
from repro_torch.core.duality import (block_spectral_norms,
                                      consensus_residual, neighborhood_mean)
from repro_torch.core.partition import make_partition
from repro_torch.core.problems import Problem
from repro_torch.device import resolve
from repro_torch.dist import sharding
from repro_torch.dist.axis import NodeAxis
from repro_torch.topo import lowering as topo_lowering, plan as topo_plan


def _check_supported(cfg: ColaConfig) -> None:
    """Reject what the distributed runtime does not run: client sampling
    (a fixed node set lies over the ranks)."""
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
                 gossip_steps: int, plan=None, robust: str | None = None,
                 robust_trim: int = 1, robust_clip: float | None = None
                 ) -> tuple[Callable, Callable]:
    """(mix_fn, grad_mix_fn) for the round body on this rank's block.

    The first argument of each is the round's comm payload, the schedule
    slice ``step_fn`` routes in: the (K, K) W for ``dense`` / ``ring``,
    this rank's (K/M, K) rows of W for a block plan, the (diag, coefs) of
    its node for a per-node plan. ``mix_fn(payload, v_send, v_self)``
    follows ``run_cola``'s attack contract: ``v_send`` crosses the wire,
    ``v_self`` (None unless attacked) is the block's honest state, used for
    each node's own term on the first step.

    ``dense``: all-gather the (K, d) stack, ``mix_power`` it (W^B folded,
    every rank the whole product), keep this rank's rows: bitwise
    ``run_cola``'s mix. ``ring``: the banded ring, one node per rank.
    ``plan``: one exchange per color per gossip step (``topo.lowering``).

    ``robust`` aggregates v with ``mixing.robust_neighborhood_mix``: on
    ``dense`` every rank robust-mixes the gathered stack; on ``plan`` the
    plan must be a ``BlockPlan`` (``run_dist_cola`` compiles one whenever
    ``robust`` is set). The gradient mixer stays linear, as ``run_cola``'s
    ``grad_mode="mixed"``. ``mix_fn(..., sig=)`` hands the robust mix's
    first-step rejection mask of this rank's receiver rows out as
    ``sig["gate"]`` (``cola._round_body``'s signal dict).
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

    block_plan = isinstance(plan, topo_plan.BlockPlan)
    if robust is None:
        if comm == "dense":
            def mix_fn(w, v_send, v_self, sig=None):
                if v_self is None or gossip_steps <= 0:
                    return steps_mix(w, v_send, gossip_steps)
                # bitwise run_cola's mix_power_wire: the gathered payloads
                # and honest states, the whole product on every rank
                mixed = mixing.mix_power_wire(
                    w, axis.all_gather(v_send), axis.all_gather(v_self),
                    gossip_steps)
                return sharding.node_block(mixed, axis)
        elif comm == "ring":
            def mix_fn(w, v_send, v_self, sig=None):
                if v_self is None or gossip_steps <= 0:
                    return steps_mix(w, v_send, gossip_steps)
                band = mixing.banded_weights(w, conn)
                out = mixing.ring_mix_ppermute(v_send[0], axis, band, conn)
                out = out + band[conn] * (v_self[0] - v_send[0])
                for _ in range(gossip_steps - 1):
                    out = mixing.ring_mix_ppermute(out, axis, band, conn)
                return out[None]
        elif block_plan:
            def mix_fn(w_rows, v_send, v_self, sig=None):
                return topo_lowering.block_mix_steps_wire(
                    v_send, v_self, axis, plan, w_rows, gossip_steps)
        else:
            def mix_fn(payload, v_send, v_self, sig=None):
                diag, coefs = payload
                return topo_lowering.plan_mix_steps_wire(
                    v_send[0], None if v_self is None else v_self[0], axis,
                    plan, diag[0], coefs[:, 0], gossip_steps)[None]
    elif comm == "dense":
        def mix_fn(w, v_send, v_self, sig=None):
            if gossip_steps <= 0:
                return v_send
            full = None if sig is None else {}
            mixed = mixing.robust_mix_steps(
                w, axis.all_gather(v_send), robust, trim=robust_trim,
                clip=robust_clip, steps=gossip_steps,
                self_stack=None if v_self is None
                else axis.all_gather(v_self), sig=full)
            if sig is not None:
                sig["gate"] = sharding.node_block(full["gate"], axis)
            return sharding.node_block(mixed, axis)
    elif comm == "plan" and block_plan:
        def mix_fn(w_rows, v_send, v_self, sig=None):
            return topo_lowering.block_robust_mix_steps(
                v_send, axis, plan, w_rows, robust, trim=robust_trim,
                clip=robust_clip, steps=gossip_steps, v_self=v_self, sig=sig)
    else:
        raise ValueError(
            f"robust={robust!r} needs comm='dense' or a block plan; got "
            f"comm={comm!r} (run_dist_cola compiles the block plan and "
            "re-dispatches 'ring' itself)")
    # one LINEAR step for grad_mode="mixed", as run_cola's dense_mix
    grad_mix_fn = lambda w, g: steps_mix(w, g, 1)
    return mix_fn, grad_mix_fn


def _dist_qmixers(axis: NodeAxis, comm: str, cfg: ColaConfig,
                  plan) -> Callable:
    """``qmix_fn``, the quantized wire's mix hook of the round body on this
    rank's block (``cola._round_body``).

    ``qmix_fn(payload, v, ef, draws, buf)`` runs the B EF-compensated
    steps: ``draws(step)`` gives the rank's (K/M, d) rows of the round's
    uniforms and ``buf`` the pipelined ``(payload, scale)`` of the first
    step. ``plan`` (a ``BlockPlan``, which ``run_dist_cola`` compiles for
    every quantized run, one node per rank included): the (K/M, d)
    payload and (K/M, 1) scales per rank-level color into the dequantized
    buffer, one product against the W rows (``lowering.block_qmix_steps``),
    or under ``cfg.robust`` the robust aggregation of that buffer
    (``lowering.block_robust_qmix_step``). ``dense``: encode the block,
    all-gather the narrow payload and the scales (the oracle keeps the
    byte budget), dequantize, mix, keep this rank's rows.

    The pipelined encode of the next round's first payload is the round
    body's own, on the block: the draws are already the rank's rows.
    ``sig`` receives the first step's payload of the rank's rows
    (``sig["q"]``) and under ``cfg.robust`` the rejection mask of its
    receiver rows (``sig["gate"]``).
    """
    wire, steps = cfg.wire, cfg.gossip_steps
    if comm == "plan" and not isinstance(plan, topo_plan.BlockPlan):
        raise ValueError("the quantized wire on comm='plan' needs a "
                         "BlockPlan (run_dist_cola compiles one)")
    if comm == "plan" and cfg.robust is not None:
        # composed robust x wire: one step, no pipeline
        # (cola._check_wire_config), so buf is always None
        def qmix_fn(w_rows, v, ef, draws, buf, sig=None):
            return topo_lowering.block_robust_qmix_step(
                v, ef, axis, plan, w_rows, wire, draws, cfg.robust,
                trim=cfg.robust_trim, clip=cfg.robust_clip, sig=sig)
    elif comm == "plan":
        def qmix_fn(w_rows, v, ef, draws, buf, sig=None):
            return topo_lowering.block_qmix_steps(
                v, ef, axis, plan, w_rows, steps, wire, draws, payload=buf,
                sig=sig)
    elif comm == "dense":
        def qmix_fn(w, v, ef, draws, buf, sig=None):
            out = v
            for s in range(steps):
                if s == 0 and buf is not None:
                    q, sc = buf
                else:
                    q, sc, _, ef = quant.encode(
                        out, wire, None if draws is None else draws(s), ef)
                step_sig = sig if s == 0 else None
                if step_sig is not None:
                    step_sig["q"] = q
                # quantize, then gather: the narrow payload and the
                # sidecar cross, never the dequantized stack
                deq = quant.dequantize(axis.all_gather(q),
                                       axis.all_gather(sc))
                if cfg.robust is not None:
                    full = None if step_sig is None else {}
                    mixed = mixing.robust_mix_steps(
                        w, deq, cfg.robust, trim=cfg.robust_trim,
                        clip=cfg.robust_clip, steps=1, sig=full)
                    if step_sig is not None:
                        step_sig["gate"] = sharding.node_block(full["gate"],
                                                               axis)
                else:
                    mixed = mixing.dense_mix(w, deq)
                out = sharding.node_block(mixed, axis)
            return out, ef
    else:
        raise ValueError(
            f"the quantized wire has no comm={comm!r} lowering (a 'ring' "
            "request re-dispatches to 'plan' in run_dist_cola)")
    return qmix_fn


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
    ``psum`` / ``pmax``. An attack-aware certificate (``attackify``)
    audits the honest cohort: the schedule's whole (K,) ``atk_dishonest``
    masks the neighborhood columns, and its rows of the rank's nodes the
    Lemma-1 sums and conditions (9), (10); the ring has no slot for the
    per-round mask, so it records over the plan."""
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
        if rec.attack_aware or not np.array_equal(neigh_host != 0,
                                                  band != 0):
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
        hon_l = None
        if rec.attack_aware:
            # a liar's gradient leaves every neighborhood mean; its own
            # rows leave the cohort's sums and conditions
            hon = (sched["atk_dishonest"] <= 0).to(v_l.dtype)
            nm_l = nm_l * hon[None, :]
            hon_l = sharding.node_block(hon, axis)
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
            # each distinct neighbor once (the two-node ring has one)
            g = grads[0]
            nsum, count = g, 1
            for off in range(1, conn + 1):
                nsum = nsum + axis.permute(g, [(i, (i + off) % k)
                                               for i in range(k)])
                count += 1
                if (2 * off) % k or off % k == 0:
                    nsum = nsum + axis.permute(g, [((i + off) % k, i)
                                                   for i in range(k)])
                    count += 1
            neigh_mean = (nsum / count)[None]
        else:
            neigh_mean = neighborhood_mean(axis.all_gather(grads), nm_l)
        local_gap, disagree = local.local_row_inputs(x_l, v_l, grads,
                                                     neigh_mean)
        sums = axis.psum(torch.stack(local.invariant_sums(x_l, v_l,
                                                          honest=hon_l)))
        resid = consensus_residual(sums[0], sums[1], k)
        return rec.summarize(local_gap, disagree, resid=resid,
                             grad_thresh=thr, honest=hon_l, psum=axis.psum,
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

    def init_spec(self):
        return self._inner.init_spec()


def _resolve_comm(comm: str, graph, base_w, *, local_nodes: int, m: int,
                  churn: bool, conn: int, block: bool = False):
    """(comm, plan) after the reference's dispatch: ``ring`` becomes
    ``plan`` under churn, on a non-circulant W, with fewer ranks than
    nodes, or with ``block`` (a quantized wire or robust mixing); a plan
    is per node at one node per rank, else (and always with ``block``) a
    block plan. The plan's support is the graph's (churn only removes
    edges) plus a static W's own off-diagonal pattern."""
    if comm == "ring":
        if churn or local_nodes != 1 or block:
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
    return comm, (topo_plan.compile_plan(support)
                  if local_nodes == 1 and not block
                  else topo_plan.compile_block_plan(support, m))


def dist_round_body(problem: Problem, part, cfg: ColaConfig,
                    axis: NodeAxis, graph, base_w, *, comm: str,
                    conn: int = 1, churn: bool = False):
    """The rank's round body over ``axis`` and the comm it runs:
    ``(body, comm, plan)``. The ``comm`` request is resolved as
    ``run_dist_cola`` resolves it (a quantized wire or robust mixing
    compiles a ``BlockPlan``), and ``body`` is ``cola._round_body`` with
    the mixers of that comm (``_dist_mixers``, and ``_dist_qmixers`` on a
    quantized wire). ``run_dist_cola`` runs this body; a profile of the
    round calls it for the same one."""
    local_nodes = part.num_nodes // axis.size
    quantized = quant.is_quantized(cfg.wire)
    comm, plan = _resolve_comm(comm, graph, base_w, local_nodes=local_nodes,
                               m=axis.size, churn=churn, conn=conn,
                               block=quantized or cfg.robust is not None)
    mix_fn, grad_mix_fn = _dist_mixers(
        axis, local_nodes, conn, comm, cfg.gossip_steps, plan,
        robust=cfg.robust, robust_trim=cfg.robust_trim,
        robust_clip=cfg.robust_clip)
    body = _round_body(
        problem, part, cfg, mix_fn=mix_fn, grad_mix_fn=grad_mix_fn,
        qmix_fn=_dist_qmixers(axis, comm, cfg, plan) if quantized else None)
    return body, comm, plan


def _recorder_on_block(recorder, problem: Problem, part, env_l, graph,
                       base_w, eps, axis: NodeAxis):
    """``metrics.make_recorder`` from the rank's env block: a string
    certificate's sigma_k comes from the rank's blocks (each from its own
    rows of the K-node start vector) and one all-gather."""
    sigma = None
    if isinstance(recorder, str) and "certificate" in recorder \
            and eps is not None:
        k = part.num_nodes
        sigma = axis.all_gather(block_spectral_norms(
            env_l.a_parts, nodes=sharding.node_rows(axis, k), num_nodes=k))
    return metrics_lib.make_recorder(recorder, problem, part, env_l, graph,
                                     base_w, eps, sigma_k=sigma)


def run_dist_cola(problem: Problem, graph: topo.Topology, cfg: ColaConfig,
                  group, rounds: int, *, comm: str = "ring", conn: int = 1,
                  record_every=1, recorder="gap", eps: float | None = None,
                  active_schedule=None, budget_schedule=None,
                  leave_mode: str = "freeze", seed: int = 0,
                  w_override: np.ndarray | None = None, attacks=None,
                  wire: str | None = None, block_size: int = 64,
                  wire_draws: Callable | None = None,
                  device=None) -> RunResult:
    """Run Algorithm 1 with the node axis over the ranks of ``group``.

    Arguments and result mirror ``run_cola`` (same schedules from the same
    rng, same attacks, same history, same ``recorder`` / ``eps``
    stopping), plus:

      group: the process group (None: the default one, initialised by the
        caller) or a ``NodeAxis`` over it; K % M == 0, K/M nodes per rank.
      comm: "ring" (circulant band, one node per rank), "plan" (the
        compiled topology program: any sparse graph and its churn
        reweightings) or "dense" (all-gather and mix). See the module.
      conn: the band's connectivity for ``comm="ring"``.
      wire: overrides ``cfg.wire``: on "int8" / "fp8" / "fp8_e5m2" every
        gossip exchange moves the 1-byte payload and its fp32 scale per
        row instead of the fp32 stack.
      wire_draws: as ``run_cola``'s, ``(round, step) -> (K, d)`` uniforms;
        each rank takes its rows. Default: the rank's rows of the port's
        stream from ``seed`` (``quant.wire_uniforms(rows=)``).
      attacks: ``run_cola``'s scenarios on the same materialized schedule;
        an ``Eavesdropper`` raises ValueError, and attacks on a quantized
        wire raise NotImplementedError, as in the reference.
      device: this rank's device (default "cuda", the current card, on an
        NCCL group; pass ``device="cpu"`` on a gloo group). The problem
        must live there.

    ``cfg.robust`` aggregates with the robust rule on every comm (see the
    module). Every rank gets the full stacked (K, ...) ``RunResult`` and
    the same history.
    """
    dev = resolve(device)
    if problem.a.device != dev:
        raise ValueError(f"problem data is on {problem.a.device}, "
                         f"run_dist_cola was asked to run on {dev}")
    if wire is not None:
        cfg = dataclasses.replace(cfg, wire=wire)
    _check_supported(cfg)
    cola._check_supported(cfg, leave_mode=leave_mode)
    _check_wire_config(cfg, attacks=attacks, leave_mode=leave_mode,
                       dist=True)
    quantized = quant.is_quantized(cfg.wire)
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
    part = make_partition(problem.n, k)
    body, comm, plan = dist_round_body(problem, part, cfg, axis, graph,
                                       base_w, comm=comm, conn=conn,
                                       churn=churn)
    block_mode = isinstance(plan, topo_plan.BlockPlan)
    env_l = sharding.cola_env_block(
        problem, part, axis,
        with_gram=cfg.use_gram(problem.d, part.block,
                               problem.a.element_size()))
    np_dtype = torch.empty((), dtype=problem.a.dtype).numpy().dtype
    sched = _materialize_schedule(graph, rounds, active_schedule,
                                  budget_schedule, leave_mode, seed, base_w,
                                  np_dtype)
    atk_info = None
    if attacks is not None:
        # after churn and budgets, before the certificate and plan
        # schedules: both judge the corrupted exchange
        sched, atk_info = attack_lib.apply_attacks(
            sched, attacks, attack_lib.AttackContext(
                graph=graph, rounds=rounds, k=k, d=problem.d,
                dtype=np_dtype, seed=seed, device=dev))
        if atk_info.tap_nodes:
            raise ValueError(
                "Eavesdropper taps are run_cola's (its payload trajectories "
                "are an analysis artifact): record them with "
                "run_cola(attacks=...)")
    atk_names = atk_info.entry_names if atk_info else ()
    has_reset = "reset_any" in sched
    rec = _recorder_on_block(recorder, problem, part, env_l, graph, base_w,
                             eps, axis)
    if churn:
        rec = metrics_lib.dynamize(rec)
    if "dishonest" in atk_names:
        rec = metrics_lib.attackify(rec)
    kw = dict(dtype=problem.a.dtype, device=dev)
    state = ColaState(x_parts=torch.zeros((local_nodes, part.block), **kw),
                      v_stack=torch.zeros((local_nodes, problem.d), **kw))
    obs_upd = obs_inc = None
    if cfg.telemetry:
        from repro_torch.obs import counters as obs_counters
        obs_inc = obs_counters.dist_round_increments(
            cfg, problem.d, comm=comm, plan=plan, conn=conn, k=k,
            itemsize=problem.a.element_size())
        obs_upd = obs_counters.make_update(cfg, obs_inc,
                                           share=local_nodes / k)
        state = state._replace(counters=obs_counters.init_counters(k, dev))
    draws = None
    if quantized:
        draws = (quant.wire_uniforms(seed, k, problem.d, dev,
                                     rows=sharding.node_rows(axis, k))
                 if wire_draws is None else
                 lambda t, step: sharding.node_block(wire_draws(t, step),
                                                     axis))
        state = _arm_wire_state(state, cfg, draws)
    axis.warm_up(dev)
    dist_rec = _DistRecorder(
        rec, _dist_record_fn(rec, axis, local_nodes, comm, conn, env_l,
                             plan))
    total_fn = lambda c: axis.psum(c.sum(dim=0))
    # the round body's attack entries (the recorder reads atk_dishonest);
    # the random payloads' run-constant (K, d) directions: the rank's
    # rows, on the device once
    body_atk = tuple(n for n in atk_names if n != "dishonest")
    bias = None
    if "atk_bias" in sched:
        bias = torch.as_tensor(
            np.array(sharding.node_block(sched["atk_bias"][0], axis)),
            device=dev)
        del sched["atk_bias"]
    if quantized:
        # the round index keys the draws
        sched["round"] = np.arange(rounds)

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
        atk = {n: bias if n == "bias" else s_t["atk_" + n]
               for n in body_atk} or None
        wire_kw = ({} if draws is None
                   else _round_draws(draws, int(s_t["round"])))
        sig = None if obs_upd is None else {}
        new = body(st, env_ctx, payload, s_t["active"], s_t.get("budgets"),
                   atk=atk, sig=sig, **wire_kw)
        if obs_upd is None:
            return new
        # the round body builds a new state: carry the updated counters
        counters, row = obs_upd(st.counters, sig, new)
        return new._replace(counters=counters), {"obs": row}

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
        # (T, K, K) W stack then has no reader. A link corruption rewrites
        # W per round even without churn.
        sched_cls = (topo_plan.BlockPlanSchedule if block_mode
                     else topo_plan.PlanSchedule)
        static = not churn and not (atk_info is not None
                                    and atk_info.w_modified)
        sched.update(sched_cls.from_w_stack(plan, sched["w"],
                                            static=static).entries())
        del sched["w"]
    from repro_torch.obs import trace as obs_trace
    with obs_trace.run_tracer(obs_upd is not None) as tracer:
        res = exec_engine.run_round_blocks(
            step_fn, state, sharding.schedule_block(sched, axis),
            context=env_l, recorder=dist_rec, record_mask=rec_mask,
            block_size=block_size, cadence=cad, num_rounds=rounds,
            host_entries=("reset_any", "round"),
            with_aux=obs_upd is not None)
    history = metrics_lib.history_from(dist_rec, res)
    if obs_upd is not None:
        # the ranks' counts, combined once for the run
        counters, series = obs_counters.combine_over_ranks(
            res.state.counters, res.aux["obs"], axis)
        history["telemetry"] = obs_counters.summarize(
            counters, obs_inc, series=series, stop_round=res.stop_round,
            dishonest=sched.get("atk_dishonest"))
        cola._emit_report("run_dist_cola", problem, cfg, graph, obs_inc,
                          history, tracer.summary())
    return RunResult(state=sharding.gather_state(res.state, axis),
                     history=history)
