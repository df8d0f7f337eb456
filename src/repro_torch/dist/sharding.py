"""COLA's node axis over the ranks: which rows each rank holds.

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

from repro_torch.core.cola import ColaEnv, ColaState, build_env

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
