"""Gossip data-parallelism: CoLA's communication pattern as an optimizer
for the model zoo (counterpart of ``repro.optim.gossip``).

Instead of an all-reduce of gradients, K nodes each hold their own model
replica, take local optimizer steps on local data, and mix parameters
with a doubly stochastic Metropolis matrix over the node graph: Algorithm
1's communication step applied to the parameter vector. A frozen node
keeps its state (its replica still moves by mixing), and W re-normalizes
over the survivors.

The replicas are (K, ...) stacks, one per leaf of the training layout
(``transformer.param_paths``), in one ``TrainState``. Node k's local step
reads and writes its row of every stack in place (``_row``). Every node
runs its step, as the reference's ``vmap`` does, so the metrics rows are
the reference's; a frozen node's step commits nothing (``commit=False``).
The mix then replaces each leaf by its mixed value one leaf at a time, so
a mix holds one mixed leaf beside the replicas, never a second copy of
them all.

With ``mesh=`` (a ``repro_torch.dist.NodeAxis``, or a process group) the
K nodes are the K ranks of the group, one node per rank: each rank holds
its node's (1, ...) rows of the states and batches, and the mix is the
banded ring over the ranks (``ring_mix_pytree``: ``2 conn`` exchanges of
each leaf per gossip step, ``mixing.ring_mix_ppermute``), which needs a
circulant W of connectivity ``conn``. As in the reference, robust mixing,
a quantized wire and DP run on the dense path only. The block runner's
``telemetry=True`` models the wire's bytes per mixed round and reports the
run (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import executor as exec_engine, metrics as \
    metrics_lib, mixing, quant, topology as topo
from repro_torch.optim import privacy


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Node graph and mixing schedule of gossip data-parallelism."""

    num_nodes: int
    topology: str = "ring"        # any key of topology.TOPOLOGIES
    gossip_steps: int = 1         # B mixing applications per round
    mix_every: int = 1            # local steps between gossip rounds
    # Byzantine-resilient aggregation of the neighbour replicas (the robust
    # mixing layer of core.mixing), dense path only
    robust: str | None = None     # None | "trim" | "median" | "clip"
    robust_trim: int = 1
    robust_clip: float | None = None
    # parameter codec on the wire ("fp32" | "int8" | "fp8" | "fp8_e5m2"):
    # every emitted replica, the own diagonal term included, is
    # quantize-dequantized before the mix; stateless
    wire: str = "fp32"

    def graph(self) -> topo.Topology:
        return topo.TOPOLOGIES[self.topology](self.num_nodes)

    def weights(self, active: np.ndarray | None = None) -> np.ndarray:
        g = self.graph()
        if active is None:
            return topo.metropolis_weights(g)
        return topo.reweight_for_active(g, active)


def _mix_(w: torch.Tensor, params: dict, *, steps: int = 1,
          robust: str | None = None, trim: int = 1,
          clip: float | None = None, wire: str = "fp32",
          keep=None) -> dict:
    """``steps`` gossip steps applied IN PLACE to every leaf of a (K,
    ...)-stacked flat dict, one leaf at a time: the dense mix, the robust
    aggregation ``robust`` (``mixing.robust_mix_steps`` over the leaf as a
    (K, d) stack) or the dense mix on a quantized ``wire`` (every emission,
    the own term included, quantize-dequantized round-to-nearest before
    each step). ``keep`` (0-d bool): where False the leaves keep their
    values."""
    wired = quant.is_quantized(wire)
    for p in params.values():
        flat = p.view(p.shape[0], -1)
        if robust is not None:
            new = mixing.robust_mix_steps(w, flat, robust, trim=trim,
                                          clip=clip, steps=steps)
        elif not wired:
            new = flat
            for _ in range(steps):
                new = mixing.dense_mix(w, new)
        else:
            for _ in range(steps):      # each step's emissions on the wire
                quant.wire_view_leaf_(p, wire, keep=keep)
                _put(flat, mixing.dense_mix(w, flat).to(p.dtype), keep)
            continue
        _put(flat, new.to(p.dtype), keep)
    return params


def _put(p: torch.Tensor, new: torch.Tensor, keep) -> None:
    p.copy_(new if keep is None else torch.where(keep, new, p))


def _cloned(stacked: dict) -> dict:
    return {n: p.clone() for n, p in stacked.items()}


def mix_pytree(w: torch.Tensor, stacked: dict, steps: int = 1) -> dict:
    """The gossip matrix applied ``steps`` times to every leaf of a (K,
    ...)-stacked flat dict (``_mix_`` on a copy: a new dict)."""
    return _mix_(w, _cloned(stacked), steps=steps)


def ring_mix_pytree(stacked_local: dict, axis, band: torch.Tensor,
                    conn: int, steps: int = 1) -> dict:
    """The banded ring over the ranks of ``axis`` (a ``NodeAxis``, one
    node per rank) applied ``steps`` times to every leaf of this rank's
    (1, ...)-stacked flat dict: ``mixing.ring_mix_ppermute`` with the
    ``band`` of ``mixing.banded_weights`` (a new dict)."""
    out = {}
    for name, p in stacked_local.items():
        v = p[0]
        for _ in range(steps):
            v = mixing.ring_mix_ppermute(v, axis, band, conn)
        out[name] = v[None].to(p.dtype)
    return out


def _ring_axis(gcfg: GossipConfig, mesh, axis, conn: int):
    """The ``NodeAxis`` of the ring (``mesh``: a NodeAxis or a process
    group; ``axis``: a NodeAxis; anything with ``permute`` serves as
    one), checked: one node per rank and a circulant W of connectivity
    ``conn``."""
    from repro_torch.dist.axis import NodeAxis
    node_axis = next((a for a in (mesh, axis) if hasattr(a, "permute")),
                     None)
    if node_axis is None:
        node_axis = NodeAxis(mesh)
    if node_axis.size != gcfg.num_nodes:
        raise ValueError(
            f"the gossip ring places one node per rank: {gcfg.num_nodes} "
            f"nodes over {node_axis.size} ranks")
    mixing.check_circulant_band(gcfg.weights(), conn)
    return node_axis


def robust_mix_pytree(w: torch.Tensor, stacked: dict, mode: str, *,
                      trim: int = 1, clip: float | None = None,
                      steps: int = 1) -> dict:
    """Byzantine-resilient gossip over a (K, ...)-stacked flat dict: each
    leaf, as a (K, d) stack, goes through ``mixing.robust_mix_steps``
    (``_mix_`` on a copy: a new dict)."""
    return _mix_(w, _cloned(stacked), steps=steps, robust=mode, trim=trim,
                 clip=clip)


def _param_mixer(gcfg: GossipConfig, mesh, axis: str | None,
                 conn: int | None,
                 dp: privacy.DPConfig | None = None) -> Callable:
    """``mix_(w, params, dp_round=0, keep=None)``: the B gossip steps
    applied IN PLACE to the (K, ...) stacks of ``params`` (dense, robust,
    quantized or DP-noised), the one dispatch both drivers share. The
    reference's rejected combinations raise its ValueErrors."""
    if gcfg.robust is not None and mesh is not None:
        raise ValueError(
            "robust= gossip needs the dense path: the ppermute ring folds "
            "W^B and exposes no per-neighborhood buffer (drop mesh/axis)")
    wired = quant.is_quantized(gcfg.wire)
    if wired:
        if mesh is not None:
            raise ValueError(
                "wire= gossip quantization is implemented on the dense path "
                "— the ppermute ring folds W^B and has no codec lowering "
                "(drop mesh/axis)")
        if gcfg.robust is not None:
            raise ValueError(
                "wire= with robust= is unsupported: the robust aggregators "
                "consume raw neighbor stacks, not codec payloads")
    if dp is not None:
        if mesh is not None:
            raise ValueError("dp= gossip is implemented on the dense path "
                             "(drop mesh/axis)")
        if gcfg.robust is not None:
            raise ValueError(
                "dp= with robust= is unsupported: per-link noise gives "
                "every receiver a distinct wire view, which the shared "
                "neighborhood buffer of the robust aggregation cannot "
                "represent")
    if mesh is not None or axis is not None:
        ring, c = _ring_axis(gcfg, mesh, axis, conn or 1), conn or 1

        def ring_mix_(w, params: dict, dp_round: int = 0, keep=None) -> dict:
            mixed = ring_mix_pytree(params, ring, mixing.banded_weights(w, c),
                                    c, gcfg.gossip_steps)
            for name, p in params.items():
                _put(p, mixed[name], keep)
            return params

        ring_mix_.axis = ring
        return ring_mix_
    if dp is not None:   # the pairs that may carry noise: the graph's
        links = privacy.graph_links(topo.metropolis_weights(gcfg.graph()))

    def mix_(w, params: dict, dp_round: int = 0, keep=None) -> dict:
        if dp is not None:
            return privacy.noisy_dense_mix_(
                w, params, dp, dp.round_key(dp_round), gcfg.gossip_steps,
                wire_codec=gcfg.wire, links=links, keep=keep)
        return _mix_(w, params, steps=gcfg.gossip_steps, robust=gcfg.robust,
                     trim=gcfg.robust_trim, clip=gcfg.robust_clip,
                     wire=gcfg.wire, keep=keep)

    mix_.axis = None
    return mix_


def _node_active(active, ring):
    """The active mask of the nodes this process holds: all K, or on the
    ring over ranks its own node's entry, (1,)."""
    return active if ring is None else active[ring.index:ring.index + 1]


def _row(tree: Any, k: int):
    """Node k's views into a (K, ...)-stacked state."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    if isinstance(tree, dict):
        return {key: _row(val, k) for key, val in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_row(val, k) for val in tree))
    raise TypeError(f"cannot take a node row of {type(tree)}")


def _local_steps(local_step, states, batches: dict, active: torch.Tensor,
                 stopped) -> dict:
    """Every node's local step on its rows, committed where active (and
    not stopped); metrics stacked to (K,)."""
    rows = []
    for k in range(active.shape[0]):
        commit = active[k] > 0
        if stopped is not None:
            commit = commit & ~stopped
        _, m = local_step(_row(states, k), {key: val[k] for key, val in
                                            batches.items()},
                          commit=commit)
        rows.append(m)
    return {name: torch.stack([m[name] for m in rows]) for name in rows[0]}


def make_gossip_step(local_step: Callable, gcfg: GossipConfig, *,
                     mesh=None, axis: str | None = None,
                     conn: int | None = None,
                     dp: privacy.DPConfig | None = None) -> Callable:
    """Wrap a local ``(state, batch, commit=None) -> (state, metrics)``
    step (``train.steps.make_train_step``) with gossip mixing.

    Returns ``step(states, batches, w, active, do_mix=True, dp_round=0)``
    over (K, ...)-stacked states and batches (tensors on the states'
    device), ``w`` (K, K) and ``active`` (K,) device tensors:

      1. every node runs ``local_step`` on its rows; an inactive node's
         state does not change (Theta_k = 1);
      2. parameters are gossip-mixed ``gossip_steps`` times with ``w``
         (dense, robust with ``gcfg.robust``, on ``gcfg.wire``, or with
         the DP wire mechanism under ``dp=``, keyed by ``dp_round``).

    Updates ``states`` in place and returns ``(states, metrics)``, metrics
    (K,) device tensors. The step also carries ``local_step`` and its
    mixer ``mix_(w, params, dp_round=0)``, for a driver that times the
    two apart.

    With ``mesh=`` (the ring over the ranks, see the module) ``states``
    and ``batches`` hold this rank's node, (1, ...); ``w`` and ``active``
    stay whole, and the metrics are the node's (1,).
    """
    mix_ = _param_mixer(gcfg, mesh, axis, conn, dp)

    def step(states, batches, w, active, do_mix=True, dp_round=0):
        metrics = _local_steps(local_step, states, batches,
                               _node_active(active, mix_.axis), None)
        if do_mix:
            mix_(w, states.params, dp_round)
        return states, metrics

    step.local_step, step.mix_ = local_step, mix_
    return step


def mix_schedule(rounds: int, mix_every: int) -> np.ndarray:
    """(T,) bool: gossip-mix on every ``mix_every``-th round, i.e.
    ``(t + 1) % mix_every == 0``."""
    return (np.arange(rounds) + 1) % mix_every == 0


def make_gossip_block_runner(local_step: Callable, gcfg: GossipConfig, *,
                             mesh=None, axis: str | None = None,
                             conn: int | None = None,
                             recorder=None,
                             dp: privacy.DPConfig | None = None,
                             telemetry: bool = False) -> Callable:
    """Gossip rounds on the round-block executor (``core.executor``): one
    host sync per block, per-round metrics fetched once at the end.

    Returns ``run(states, batches, w, active, mix, *, block_size=32,
    record_mask=None)`` with host arrays
      batches: {key: (T, K, ...)},
      w:       (T, K, K) per-round mixing matrices,
      active:  (T, K) participation masks,
      mix:     (T,) gossip-mix flags (``mix_schedule``),
    returning ``(states, metrics)`` (metrics (T, K) device tensors) or,
    with a recorder, ``(states, metrics, history)``; ``states`` is updated
    in place. The mix flag and the DP round index stay on the host
    (``host_entries``), so a round branches on them without a device sync.
    A recorder's stop condition (``ConsensusRecorder(eps=)``) ends the run
    early; the rounds after the stop change nothing.

    With ``dp=`` every mixed round applies the DP wire mechanism keyed by
    the round index, and the history gains ``dp_epsilon`` (cumulative
    epsilon at each recorded round) and a ``dp`` summary (final epsilon,
    rho, releases).

    With ``mesh=`` (the ring over the ranks) ``states`` and ``batches``
    hold this rank's node, (1, ...) and (T, 1, ...); ``w`` and ``active``
    stay whole. A ``ConsensusRecorder`` then sums over the ranks, so every
    rank records the same row and stops on the same round.

    With ``telemetry=True`` (a recorder needed) the history gets
    ``"telemetry"``: the modeled wire bytes per mixed round (the
    parameters x the codec's bytes per emission; K emissions a gossip step
    on the dense path, the all-gather oracle's view, 2 conn exchanges on
    the ring), the final ``dp_epsilon`` under ``dp=``, and the run
    registry a ``RunReport`` (``driver="gossip"``).
    """
    mix_ = _param_mixer(gcfg, mesh, axis, conn, dp)
    if mix_.axis is not None and recorder is not None:
        if not isinstance(recorder, ConsensusRecorder):
            raise ValueError(
                "the gossip ring over ranks records with a "
                "ConsensusRecorder (its row sums over the ranks)")
        recorder = dataclasses.replace(recorder, axis=mix_.axis)
    if telemetry and recorder is None:
        raise ValueError("telemetry=True needs a recorder (the history "
                         "carries the counters and the dp_epsilon series)")
    names: list = []

    def step_fn(states, _ctx, sched_t, stopped):
        batch = {key[len("batch."):]: val for key, val in sched_t.items()
                 if key.startswith("batch.")}
        metrics = _local_steps(local_step, states, batch,
                               _node_active(sched_t["active"], mix_.axis),
                               stopped)
        if bool(sched_t["mix"]):
            mix_(sched_t["w"], states.params,
                 int(sched_t["dp_round"]) if dp is not None else 0,
                 keep=None if stopped is None else ~stopped)
        if not names:
            names.extend(metrics)
        return states, torch.stack([metrics[n].float() for n in names])

    def run(states, batches, w, active, mix, *, block_size: int = 32,
            record_mask=None):
        mix = np.asarray(mix).astype(bool)
        sched = {f"batch.{key}": np.asarray(val)
                 for key, val in batches.items()}
        sched.update(w=np.asarray(w, np.float32),
                     active=np.asarray(active, np.float32), mix=mix)
        host = ("mix",)
        if dp is not None:
            # the round index keys the draws: a function of the round, not
            # of block boundaries or early stopping
            sched["dp_round"] = np.arange(len(mix))
            host += ("dp_round",)
        from repro_torch.obs import trace as obs_trace
        with obs_trace.run_tracer(telemetry) as tracer:
            res = exec_engine.run_round_blocks(
                step_fn, states, sched, recorder=recorder,
                record_mask=record_mask, block_size=block_size,
                host_entries=host, in_place=True, with_aux=True)
        metrics = {n: res.aux[:, i] for i, n in enumerate(names)}
        if recorder is None:
            return res.state, metrics
        history = metrics_lib.history_from(recorder, res)
        if dp is not None:
            rounds_rec = np.asarray(history["round"], dtype=np.int64)
            cum = np.cumsum(mix)
            history["dp_epsilon"] = privacy.epsilon_schedule(
                dp, gcfg.graph(), gcfg.gossip_steps,
                cum[np.clip(rounds_rec, 0, len(cum) - 1)]).tolist()
            final = privacy.GaussianAccountant(dp.sigma, dp.delta).add(
                int(cum[-1]) * dp.releases_per_mix_round(gcfg.graph(),
                                                         gcfg.gossip_steps))
            history["dp"] = {
                "clip": dp.clip, "sigma": dp.sigma, "delta": dp.delta,
                "per_link": dp.per_link, "releases": final.releases,
                "rho": final.rho, "epsilon": final.epsilon()}
        if telemetry:
            _gossip_telemetry(gcfg, states.params, mix, history,
                              res.stop_round, ring=mix_.axis is not None,
                              conn=conn, spans=tracer.summary())
        return res.state, metrics, history

    return run


def _gossip_telemetry(gcfg: GossipConfig, params: dict, mix, history: dict,
                      stop_round, *, ring: bool, conn, spans: dict) -> None:
    """The block runner's ``history["telemetry"]`` and RunReport: the
    modeled bytes per mixed round of the replicas' parameters on the
    wire."""
    from repro_torch.core.executor import fingerprint
    from repro_torch.obs import report as obs_report
    pcount = int(sum(np.prod(p.shape[1:]) for p in params.values()))
    pb = quant.payload_bytes(pcount, gcfg.wire)
    if not ring:
        per_mix = gcfg.gossip_steps * gcfg.num_nodes * pb
        permutes_mix = 0
        contract = (f"gossip dense x{gcfg.gossip_steps}: "
                    f"{per_mix:,}B/device/mixed-round "
                    f"({pcount:,} params, wire={gcfg.wire})")
    else:
        c = conn or 1
        per_mix = gcfg.gossip_steps * 2 * c * pb
        permutes_mix = gcfg.gossip_steps * 2 * c
        contract = (f"gossip ring conn={c}: {per_mix:,}B/device/"
                    f"mixed-round ({pcount:,} params)")
    mixed = int(np.asarray(mix, dtype=bool).sum())
    t_total = int(np.asarray(mix).shape[0])
    history["telemetry"] = {
        "rounds": t_total, "mixed_rounds": mixed,
        "wire_bytes": mixed * per_mix, "permutes": mixed * permutes_mix,
        "contract": contract, "stop_round": stop_round}
    if history.get("dp_epsilon"):
        history["telemetry"]["dp_epsilon"] = float(history["dp_epsilon"][-1])
    obs_report.auto_emit(obs_report.make_report(
        driver="gossip", problem_fp=fingerprint(gcfg),
        config=dataclasses.asdict(gcfg),
        graph={"kind": gcfg.topology, "num_nodes": gcfg.num_nodes},
        rounds=t_total, history=history, contract=contract, spans=spans))


@dataclasses.dataclass(frozen=True)
class ConsensusRecorder:
    """Recorder over the (K, ...)-stacked replicas: the consensus distance,
    with an optional early stop once the replicas agree to ``eps``."""

    eps: float | None = None
    # the ring over ranks: the NodeAxis its sums run over (set by the
    # block runner), else None
    axis: Any = None

    labels = ("consensus_distance",)

    def record_fn(self, states) -> torch.Tensor:
        return torch.stack([consensus_distance(states.params, self.axis)])

    @property
    def stop_fn(self):
        if self.eps is None:
            return None
        eps = self.eps
        return lambda row: row[0] <= eps

    def init_spec(self) -> dict:
        return {}


def replicate_state(state: Any, k: int) -> Any:
    """K copies of a state stacked on a new leading node axis."""
    if isinstance(state, torch.Tensor):
        return state.unsqueeze(0).repeat((k,) + (1,) * state.dim())
    if isinstance(state, dict):
        return {key: replicate_state(val, k) for key, val in state.items()}
    return type(state)(*(replicate_state(val, k) for val in state))


def consensus_distance(params_stack: dict, axis=None) -> torch.Tensor:
    """sum_k ||p_k - p_bar||^2 over all leaves (0-d fp32, on the device):
    the deep-net analogue of the paper's consensus violation. One node row
    at a time, so no (K, ...) temporary of a leaf is made. ``axis``: the
    stack holds this rank's nodes of the ranks of a ``NodeAxis``; the mean
    and the sum then run over the ranks (two all-reduces a leaf)."""
    total = 0.0
    for p in params_stack.values():
        if axis is None:
            mean = torch.mean(p, dim=0).float()
        else:
            mean = axis.psum(torch.sum(p.float(), dim=0)) / (
                p.shape[0] * axis.size)
        for k in range(p.shape[0]):
            total = total + torch.sum(torch.square(p[k].float() - mean))
    if axis is not None:
        total = axis.psum(torch.as_tensor(total, dtype=torch.float32))
    return total


def average_params(params_stack: dict) -> dict:
    return {n: torch.mean(p, dim=0) for n, p in params_stack.items()}
