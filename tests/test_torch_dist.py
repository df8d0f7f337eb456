"""``repro_torch.dist`` at world size 1, in process, on gloo.

A world of one rank runs the whole distributed code path (the node axis,
the block plan without colors, the dense all-gather, the recorders'
reductions), with every collective leaving values unchanged. So
``run_dist_cola`` must reproduce the port's ``run_cola`` BITWISE: state
and history, for ring (which dispatches to the block plan: fewer ranks
than nodes), plan and dense, over the elasticity surface of the
reference's ``tests/test_dist_parity.py``. Against the reference's
``run_dist_cola`` on a 1-device mesh, histories hold at
``tests/test_torch_cola.py``'s tolerance (rtol 1e-4, atol 1e-4
max|primal|) with the same recorded rounds and ``stop_round``.

The process group is made by a fixture on a file store under the test's
``tmp_path`` and destroyed after the test, so no other test of the worker
inherits it.
"""
import datetime
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import problems as jprob, topology as jtopo
from repro.core.cola import ColaConfig as JConfig
from repro.data import synthetic
from repro.dist.runtime import run_dist_cola as j_run_dist
from repro_torch import attack, convert
from repro_torch.core import cola as tcola, schedule, topology as ttopo
from repro_torch.dist import NodeAxis, run_dist_cola, sharding
from repro_torch.optim import gossip as tgossip

K = 8
RTOL = 1e-4


@pytest.fixture
def group1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    yield None
    dist.destroy_process_group()


def _ridge():
    x, y, _ = synthetic.regression(150, 48, seed=4)
    return (jprob.ridge_primal(jnp.asarray(x), jnp.asarray(y), 1e-2),
            convert.problem_from_numpy("ridge_primal", x, y, 1e-2,
                                       device="cpu"))


def _lasso():
    x, y, _ = synthetic.regression(150, 48, seed=2, sparsity_solution=0.2)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), 5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


def _drop(t, rng):
    return rng.random(K) < 0.7


def _budgets(t, rng):
    b = np.full(K, 16)
    b[rng.random(K) < 0.5] = 4
    return b


CASES = {
    "plain": {},
    "churn_freeze": dict(active_schedule=_drop),
    "churn_reset": dict(active_schedule=_drop, leave_mode="reset"),
    "budgets": dict(budget_schedule=_budgets),
    "churn_budgets_reset": dict(active_schedule=_drop,
                                budget_schedule=_budgets, leave_mode="reset"),
}


def _assert_bitwise(got, want):
    assert torch.equal(got.state.x_parts, want.state.x_parts)
    assert torch.equal(got.state.v_stack, want.state.v_stack)
    assert got.history == want.history


@pytest.mark.parametrize("comm", ["ring", "plan", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dist1_bitwise_matches_run_cola(group1, comm, case):
    _, port = _ridge()
    graph = ttopo.connected_cycle(K, 2)
    cfg = tcola.ColaConfig(kappa=1.0)
    kw = dict(record_every=10, seed=3, **CASES[case])
    want = tcola.run_cola(port, graph, cfg, 41, device="cpu", **kw)
    got = run_dist_cola(port, graph, cfg, None, 41, comm=comm, device="cpu",
                        block_size=16, **kw)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("comm", ["ring", "plan", "dense"])
@pytest.mark.parametrize("case", ["plain", "churn_budgets_reset"])
def test_dist1_matches_reference_dist(group1, comm, case):
    """The reference's run_dist_cola on a 1-device mesh against the port's
    at world size 1 (torus: a non-circulant graph)."""
    ref, port = _ridge()
    kw = dict(record_every=6, seed=3, **CASES[case])
    want = j_run_dist(ref, jtopo.torus_2d(2, 4), JConfig(kappa=1.0),
                      jax.make_mesh((1,), ("data",)), 25, comm=comm,
                      block_size=16, **kw)
    got = run_dist_cola(port, ttopo.torus_2d(2, 4),
                        tcola.ColaConfig(kappa=1.0), None, 25, comm=comm,
                        device="cpu", block_size=16, **kw)
    h, g = want.history, got.history
    assert g["round"] == h["round"] and g["stop_round"] == h["stop_round"]
    atol = RTOL * max(abs(v) for v in h["primal"])
    for key in ("primal", "hamiltonian", "dual", "gap",
                "consensus_violation"):
        np.testing.assert_allclose(g[key], h[key], rtol=RTOL, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("comm", ["plan", "dense"])
def test_dist1_certificate_stop_bitwise(group1, comm):
    """gap + certificate with eps= on both paths: the stop round, every row
    and the stopped state are run_cola's, bit for bit."""
    _, port = _lasso()
    graph = ttopo.torus_2d(2, 4)
    cfg = tcola.ColaConfig(kappa=8.0)
    kw = dict(record_every=20, recorder="gap+certificate", eps=0.1)
    want = tcola.run_cola(port, graph, cfg, 400, device="cpu", **kw)
    got = run_dist_cola(port, graph, cfg, None, 400, comm=comm,
                        device="cpu", **kw)
    assert want.history["stop_round"] is not None
    _assert_bitwise(got, want)


@pytest.mark.parametrize("cfg,comm,bitwise", [
    (dict(kappa=0.5, gossip_steps=2), "dense", True),
    # the plan's B sequential steps against run_cola's folded W^B
    (dict(kappa=0.5, gossip_steps=2), "plan", False),
    (dict(kappa=1.0, cd_mode="residual"), "plan", True),
    (dict(kappa=1.0, grad_mode="mixed"), "plan", True),
    (dict(kappa=1.0, grad_mode="mixed"), "dense", True)])
def test_dist1_round_options(group1, cfg, comm, bitwise):
    _, port = _ridge()
    graph = ttopo.ring(K)
    want = tcola.run_cola(port, graph, tcola.ColaConfig(**cfg), 30,
                          record_every=29, device="cpu")
    got = run_dist_cola(port, graph, tcola.ColaConfig(**cfg), None, 30,
                        comm=comm, record_every=29, device="cpu")
    if bitwise:
        _assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(got.state.v_stack, want.state.v_stack,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.history["gap"], want.history["gap"],
                                   rtol=1e-6, atol=1e-6)


def test_dist1_adaptive_cadence_and_w_override(group1):
    _, port = _ridge()
    graph = ttopo.ring(K)
    w = ttopo.metropolis_weights(ttopo.connected_cycle(K, 2))
    kw = dict(record_every="adaptive", recorder="gap", eps=1e-2,
              w_override=w)
    want = tcola.run_cola(port, graph, tcola.ColaConfig(), 40, device="cpu",
                          **kw)
    got = run_dist_cola(port, graph, tcola.ColaConfig(), None, 40,
                        comm="plan", device="cpu", **kw)
    _assert_bitwise(got, want)


def test_dist1_block_boundaries_invisible(group1):
    _, port = _ridge()
    cfg = tcola.ColaConfig(kappa=1.0)
    a = run_dist_cola(port, ttopo.ring(K), cfg, None, 24, comm="plan",
                      block_size=24, device="cpu")
    b = run_dist_cola(port, ttopo.ring(K), cfg, None, 24, comm="plan",
                      block_size=5, device="cpu")
    _assert_bitwise(a, b)


def test_dist1_zero_rounds(group1):
    _, port = _ridge()
    res = run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(), None, 0,
                        comm="dense", device="cpu")
    assert res.history["round"] == []
    assert float(res.state.x_parts.abs().max()) == 0.0
    assert res.state.x_parts.shape[0] == K


@pytest.mark.parametrize("kw,exc,match", [
    (dict(cfg=dict(wire="int8")), NotImplementedError, "item 14.1"),
    (dict(wire="fp8"), NotImplementedError, "item 14.1"),
    (dict(cfg=dict(robust="trim")), NotImplementedError, "item 14.1"),
    (dict(attacks="byz"), NotImplementedError, "item 14.1"),
    (dict(cfg=dict(telemetry=True)), NotImplementedError, "item 15"),
    (dict(cfg=dict(participation="half")), ValueError, "participation"),
    (dict(cfg=dict(pipeline=True)), ValueError, "quantized wire"),
    (dict(leave_mode="rejoin"), ValueError, "leave_mode"),
    (dict(comm="star"), ValueError, "unknown comm")],
    ids=["wire", "wire_arg", "robust", "attacks", "telemetry",
         "participation", "pipeline", "leave_mode", "comm"])
def test_unported_and_bad_options_raise(group1, kw, exc, match):
    _, port = _ridge()
    kw = dict(kw)
    cfg = kw.pop("cfg", {})
    if cfg.get("participation"):
        cfg["participation"] = schedule.SampleConfig(k_active=K // 2)
    if kw.get("attacks"):
        kw["attacks"] = [attack.Byzantine(nodes=(1,), mode="sign_flip")]
    with pytest.raises(exc, match=match):
        run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(**cfg), None, 2,
                      device="cpu", **kw)


def test_gossip_mesh_ring_waits_for_item_14_1():
    assert "item 14.1" in tgossip.RING_TODO


def test_device_checks(group1):
    _, port = _ridge()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(), None, 1)
    with pytest.raises(ValueError, match="problem data is on"):
        run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(), None, 1,
                      device="meta")


def test_node_axis_at_world_size_1(group1):
    axis = NodeAxis()
    assert (axis.index, axis.size, axis.backend) == (0, 1, "gloo")
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(axis.permute(x, [(0, 0)]), x)        # a self pair
    assert torch.equal(axis.permute(x, []), torch.zeros_like(x))
    assert torch.equal(axis.psum(x), x) and torch.equal(axis.pmax(x), x)
    assert torch.equal(axis.all_gather(x), x)
    assert torch.equal(axis.broadcast(x), x)
    assert dict(axis.counts) == {"permute": 2, "all-reduce": 2,
                                 "all-gather": 1, "broadcast": 1}
    # a self pair and an empty permutation send nothing
    assert axis.sent_bytes["permute"] == 0
    assert axis.sent_bytes["all-gather"] == 24
    with pytest.raises(ValueError, match="not a permutation"):
        axis.permute(x, [(0, 0), (0, 1)])
    axis.reset_counts()
    assert not axis.counts and not axis.sent_bytes


def test_one_node_mixers_at_world_size_1(group1):
    """The ring and the all-gather mix for one node per rank (K = 1)."""
    from repro_torch.core import mixing
    axis = NodeAxis()
    v = torch.arange(5.0)
    w = torch.ones((1, 1))
    assert torch.equal(mixing.dense_mix_shardmap(v, axis, w), v)
    assert torch.equal(mixing.ring_mix_ppermute(
        v, axis, torch.tensor([0.25, 0.5, 0.25]), 1), v)


def test_node_axis_needs_a_group():
    if dist.is_initialized():
        pytest.skip("a default process group is initialised in this worker")
    with pytest.raises(RuntimeError, match="init_process_group"):
        NodeAxis()


def test_sharding_cuts_node_entries():
    axis = types.SimpleNamespace(index=1, size=2)
    t, k, c = 3, 4, 2
    sched = {"w": np.zeros((t, k, k)),
             "active": np.arange(t * k).reshape(t, k),
             "plan_coefs": np.arange(t * c * k).reshape(t, c, k),
             "plan_w": np.arange(t * k * k).reshape(t, k, k),
             "cert_grad_thresh": np.ones(t), "reset_any": np.zeros(t, bool)}
    got = sharding.schedule_block(sched, axis)
    assert got["w"] is sched["w"] and got["reset_any"] is sched["reset_any"]
    np.testing.assert_array_equal(got["active"], sched["active"][:, 2:])
    np.testing.assert_array_equal(got["plan_coefs"],
                                  sched["plan_coefs"][:, :, 2:])
    np.testing.assert_array_equal(got["plan_w"], sched["plan_w"][:, 2:])
    st = tcola.ColaState(torch.arange(8.0).reshape(4, 2),
                         torch.arange(12.0).reshape(4, 3))
    blk = sharding.cola_state_block(st, axis)
    assert torch.equal(blk.x_parts, st.x_parts[2:]) and blk.ef is None
