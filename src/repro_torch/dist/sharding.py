"""Sharding rules (counterpart of ``repro.dist.sharding``): the LM zoo's
FSDP + TP specs for the dry run, and COLA's node axis over the ranks.

**The LM half.** A spec is ``P``: a tuple with one entry per dimension,
each ``None``, a mesh axis name or a tuple of names (the reference's
``PartitionSpec``). ``param_pspecs``, ``cache_pspecs`` and
``batch_pspecs`` are the reference's divisibility-guarded rules: an axis
goes on a dim only where the dim divides that axis's size, so every spec
of all ten architectures holds on the production mesh. ``local_shape`` and
``rank_bytes`` size one rank's block of a tensor or a tree. Parameters are
the port's flat dotted dict (``transformer.param_paths`` order); an expert
leaf is a name ending in ``moe.w_gate`` / ``moe.w_up`` / ``moe.w_down``
with ndim >= 3 (the reference's ``keys[-2] == "moe"``).

**COLA's node axis.**
The JAX reference declares this as ``PartitionSpec``s (``P(axis)`` on the
node dimension). Here each rank keeps rows ``index * K/M : (index + 1) *
K/M`` of every per-node tensor as a view of the (K, ...) whole, and the
gathers bring the blocks back:

=====================  ==========================  ======================
Paper quantity          Tensor (shape)              On each rank
=====================  ==========================  ======================
local iterate x_[k]     ``x_parts`` (K, n_k)        its K/M rows
local estimate v_k      ``v_stack`` (K, d)          its K/M rows
wire state              ``ef`` (K, d), ``buf``      its K/M rows
                        ((K, d) payload, (K, 1))
data columns A_[k]      ``a_parts`` (K, d, n_k)     its K/M blocks, built
                                                    from its columns only
mixing matrix W         ``w`` (T, K, K)             all of it
churn mask, Theta_k     ``active``/``budgets`` (T, K)  its columns
plan coefficients       ``plan_diag`` (T, K), ``plan_coefs`` (T, C, K),
                        ``plan_w`` (T, K, K)        its nodes (W: its rows)
certificate mask        ``cert_mask`` (T, K, K)     its rows
attack entries          ``atk_coef``, ``atk_bias_coef``, ``atk_work``
                        (T, K), ``atk_bias`` (T, K, d)  its nodes
dishonesty mask         ``atk_dishonest`` (T, K)    all of it (the
                                                    certificate reads it)
metric rows             ``(m,)`` per record round   all of it (reduced)
=====================  ==========================  ======================
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.cola import ColaEnv, ColaState, build_env


# ---------------------------------------------------------------------------
# the LM zoo: FSDP + TP specs on a (pod,) data x model mesh
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry per dimension (``None``, an axis name
    or a tuple of names); ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis names of the production mesh: ``data`` carries batch
    and FSDP shards, ``model`` tensor-parallel shards, ``pod`` (multi-pod
    meshes only) the CoLA gossip node axis."""

    data: str = "data"
    model: str = "model"
    pod: str | None = None

    @property
    def batch_axes(self):
        """Axes the batch dimension shards over (pod-major when present)."""
        return (self.pod, self.data) if self.pod else self.data


def _size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        total = 1
        for a in axis:
            total *= sizes[a]
        return total
    return sizes[axis]


def _matrix_spec(shape, data_size: int, model_size: int, *, fsdp: bool,
                 expert_data_dim: int | None = None) -> P:
    """FSDP + TP spec for one weight leaf: ``model`` on the last divisible
    dim (falling back to the second-to-last), ``data`` on the best
    remaining divisible dim scanning from the second-to-last backwards;
    with ``expert_data_dim`` the FSDP shards land on the experts axis."""
    ndim = len(shape)
    entries: list = [None] * ndim
    if ndim < 2:
        return P()  # norms / biases: replicate
    model_dim = None
    for dim in (ndim - 1, ndim - 2):
        if shape[dim] % model_size == 0:
            model_dim = dim
            entries[dim] = "model"
            break
    if fsdp:
        if expert_data_dim is not None and expert_data_dim != model_dim \
                and shape[expert_data_dim] % data_size == 0:
            entries[expert_data_dim] = "data"
        else:
            for dim in range(ndim - 2, -1, -1):
                if dim != model_dim and shape[dim] % data_size == 0:
                    entries[dim] = "data"
                    break
            else:
                if model_dim != ndim - 1 and shape[-1] % data_size == 0:
                    entries[-1] = "data"
    return P(*entries)


def _rename(spec: P, axes: MeshAxes) -> P:
    table = {"data": axes.data, "model": axes.model, None: None}
    return P(*(table[a] for a in spec))


def _is_expert(name: str, ndim: int) -> bool:
    keys = name.split(".")
    return (len(keys) >= 2 and keys[-2] == "moe"
            and keys[-1] in ("w_gate", "w_up", "w_down") and ndim >= 3)


def param_pspecs(params: dict, axes: MeshAxes, sizes: dict, *,
                 fsdp: bool = True, moe_output_fsdp: bool = False) -> dict:
    """{name: P} for the flat parameter dict (tensors of any device,
    ``meta`` included). ``sizes``: mesh axis -> size, for the
    divisibility guards; ``fsdp`` shards each weight's non-TP dim over
    ``axes.data`` (off: resident weights for serving);
    ``moe_output_fsdp`` puts the expert tensors' FSDP shards on the
    experts axis."""
    data_size, model_size = sizes[axes.data], sizes[axes.model]
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        expert_dim = (len(shape) - 3 if moe_output_fsdp
                      and _is_expert(name, len(shape)) else None)
        out[name] = _rename(_matrix_spec(shape, data_size, model_size,
                                         fsdp=fsdp,
                                         expert_data_dim=expert_dim), axes)
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict / list / tuple (a
    NamedTuple keeps its type); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, sub) for sub in tree))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, sub) for sub in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple in insertion order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def cache_pspecs(cfg, cache: Any, global_batch: int, axes: MeshAxes,
                 sizes: dict) -> Any:
    """Decode-cache specs, leaf by leaf: axis 1 (batch, behind the stacked
    layer axis) over ``axes.batch_axes`` where the batch divides, and the
    last axis over ``model`` for leaves of ndim >= 4 where it divides
    (3-D leaves such as ``pos`` end in the sequence axis)."""
    batch_ax = axes.batch_axes
    b_size = _size(sizes, batch_ax)
    model_size = sizes[axes.model]

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim < 2:
            return P()
        entries: list = [None] * ndim
        if shape[1] == global_batch and global_batch % b_size == 0:
            entries[1] = batch_ax
        if ndim >= 4 and shape[-1] % model_size == 0:
            entries[-1] = axes.model
        return P(*entries)

    return tree_map(leaf_spec, cache)


def batch_pspecs(cfg, shape, axes: MeshAxes) -> dict:
    """Input-batch specs: the leading batch dim over ``axes.batch_axes``."""
    from repro_torch.launch import specs as specs_lib

    return {key: (P() if leaf.dim() == 0 else
                  P(axes.batch_axes, *([None] * (leaf.dim() - 1))))
            for key, leaf in specs_lib.input_specs(cfg, shape).items()}


def local_shape(shape, spec: P, sizes: dict) -> tuple:
    """One rank's block of a tensor of ``shape`` laid out by ``spec``
    (every named dim divided by its axes' sizes; the rules only name an
    axis where it divides)."""
    shape = tuple(shape)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        n = _size(sizes, axis)
        if dim % n:
            raise ValueError(f"local_shape: dim {dim} does not split over "
                             f"{axis} ({n})")
        out.append(dim // n)
    return tuple(out)


def rank_bytes(tree: Any, specs: Any, sizes: dict) -> int:
    """Bytes one rank holds of ``tree`` (tensors on any device) laid out
    by ``specs`` (the same structure of ``P``)."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        n = 1
        for d in local_shape(leaf.shape, spec, sizes):
            n *= d
        total += n * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# COLA state (Algorithm 1): the node axis over the ranks
# ---------------------------------------------------------------------------

# schedule entries with a node dimension, and which one; every other entry
# (w, cert_grad_thresh, reset_any, atk_dishonest) is the same on every rank
SCHEDULE_NODE_DIM = {"active": 1, "budgets": 1, "leavers": 1,
                     "cert_mask": 1, "plan_diag": 1, "plan_coefs": 2,
                     "plan_w": 1, "atk_coef": 1, "atk_bias_coef": 1,
                     "atk_bias": 1, "atk_work": 1}


def node_rows(axis, k: int) -> slice:
    """This rank's node rows of a K-node axis."""
    ln = k // axis.size
    return slice(axis.index * ln, (axis.index + 1) * ln)


def node_block(x, axis, dim: int = 0):
    """This rank's block of ``x`` (tensor or array) along node dim
    ``dim``: a view."""
    idx = [slice(None)] * dim + [node_rows(axis, x.shape[dim])]
    return x[tuple(idx)]


def _map_state(state: ColaState, fn) -> ColaState:
    """``state`` with ``fn`` applied to each per-node tensor, the wire's
    residual and pipelined (payload, scale) included."""
    buf = None if state.buf is None else tuple(fn(t) for t in state.buf)
    return ColaState(x_parts=fn(state.x_parts), v_stack=fn(state.v_stack),
                     ef=None if state.ef is None else fn(state.ef), buf=buf)


def cola_state_block(state: ColaState, axis) -> ColaState:
    """This rank's (K/M, ...) rows of the node state, the wire's residual
    and pipelined (payload, scale) included."""
    return _map_state(state, lambda t: node_block(t, axis))


def cola_env_block(problem, part, axis, *,
                   with_gram: bool | None = None) -> ColaEnv:
    """This rank's blocks of every per-node tensor of the env, built from
    its own K/M column blocks of A (``cola.build_env(nodes=)``): the rank
    holds 1/M of the env, bitwise the rows of the whole one."""
    return build_env(problem, part, with_gram=with_gram,
                     nodes=node_rows(axis, part.num_nodes))


def schedule_block(sched: dict, axis) -> dict:
    """This rank's view of a materialized (T, ...) schedule: the node
    entries of ``SCHEDULE_NODE_DIM`` cut to its nodes, the rest whole."""
    return {name: (node_block(v, axis, SCHEDULE_NODE_DIM[name])
                   if name in SCHEDULE_NODE_DIM else v)
            for name, v in sched.items()}


def gather_state(state: ColaState, axis) -> ColaState:
    """The full (K, ...) node state on every rank, from each rank's
    block."""
    return _map_state(state, axis.all_gather)


def cola_counters_pspecs(axis: str):
    """Placement of the telemetry ``obs.counters.Counters`` carry: the
    scalar accumulators are the same number on every rank (``P()``), and
    the per-sender ``gate`` (K,) rejection counter is node rows like every
    other per-node tensor (``P(axis)``: a rank holds its K/M)."""
    from repro_torch.obs.counters import Counters

    rep = P()
    return Counters(rounds=rep, wire_bytes=rep, permutes=rep, sat_sum=rep,
                    ef_sq=rep, gate=P(axis))


def cola_recorder_pspecs(axis: str, rec_state: dict) -> dict:
    """Placement of a recorder's per-run state (``Recorder.init_spec()``):
    every tensor with a leading node dimension (``sigma_k`` (K,), the
    neighbour mask (K, K)) is node rows (``P(axis)``); scalars replicate."""
    return tree_map(lambda x: P(axis) if getattr(x, "ndim", 0) >= 1
                    else P(), rec_state)
