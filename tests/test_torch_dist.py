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

The quantized wire, robust mixing and attacks over ranks are held the same
way: bitwise the port's ``run_cola`` at world size 1 (the wire with the
reference's threefry uniforms fed in through ``wire_draws=``), and against
the reference's ``run_dist_cola`` / ``run_cola`` at the flip-aware
tolerance of ``tests/test_torch_quant.py`` (wire) or rtol 1e-4 (fp32).

The process group is made by a fixture on a file store under the test's
``tmp_path`` and destroyed after the test, so no other test of the worker
inherits it.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import datetime
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import attack as jattack
from repro.core import problems as jprob, topology as jtopo
from repro.core.cola import ColaConfig as JConfig, run_cola as j_run
from repro.data import synthetic
from repro.dist.runtime import run_dist_cola as j_run_dist
from repro_torch import attack, convert
from repro_torch.core import cola as tcola, mixing as tmixing, \
    quant as tquant, schedule, topology as ttopo
from repro_torch.dist import NodeAxis, run_dist_cola, runtime, sharding
from repro_torch.optim import gossip as tgossip
from repro_torch.topo import lowering as tlow, plan as tplan
from test_torch_quant import _assert_wire_run, _recorders, _ref_draws

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
    # ported: the wire (cfg or argument) and robust mixing run, bitwise
    # run_cola (exc None); an attack on a quantized wire raises as the
    # reference's does, and so do eavesdropper taps
    (dict(cfg=dict(wire="int8")), None, None),
    (dict(wire="fp8"), None, None),
    (dict(cfg=dict(robust="trim")), None, None),
    (dict(attacks="byz", cfg=dict(wire="int8")), NotImplementedError,
     "quantized wire"),
    (dict(cfg=dict(telemetry=True)), None, None),
    (dict(cfg=dict(participation="half")), ValueError, "participation"),
    (dict(cfg=dict(pipeline=True)), ValueError, "quantized wire"),
    (dict(leave_mode="rejoin"), ValueError, "leave_mode"),
    (dict(comm="star"), ValueError, "unknown comm")],
    ids=["wire", "wire_arg", "robust", "attacks", "telemetry",
         "participation", "pipeline", "leave_mode", "comm"])
def test_unported_and_bad_options_raise(group1, kw, exc, match,
                                       monkeypatch):
    """Telemetry (ported): the run bitwise its telemetry-off twin and
    ``run_cola``'s, and the telemetry entry against the reference's
    ``run_dist_cola`` on a 1-device mesh (fp32; the reference's counters
    fail on a quantized wire over a mesh): on ring(8) at one rank the
    block plan has no colors, so 0 bytes and 0 exchanges, the contract
    line, the rounds and the gate counts equal."""
    monkeypatch.setenv("REPRO_RUNS_DIR", "off")
    ref, port = _ridge()
    kw = dict(kw)
    cfg = kw.pop("cfg", {})
    if cfg.get("telemetry"):
        got = run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(**cfg),
                            None, 6, device="cpu")
        off = run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(), None,
                            6, device="cpu")
        tel = got.history.pop("telemetry")
        _assert_bitwise(got, off)
        _assert_bitwise(got, tcola.run_cola(port, ttopo.ring(K),
                                            tcola.ColaConfig(), 6,
                                            device="cpu"))
        want = j_run_dist(ref, jtopo.ring(K), JConfig(**cfg), _mesh1(), 6)
        rtel = want.history["telemetry"]
        for key in ("wire_bytes", "permutes", "contract", "rounds",
                    "gate_rejections", "stop_round"):
            assert tel[key] == rtel[key], key
        assert tel["wire_bytes"] == 0
        return
    if cfg.get("participation"):
        cfg["participation"] = schedule.SampleConfig(k_active=K // 2)
    if kw.get("attacks"):
        kw["attacks"] = [attack.Byzantine(nodes=(1,), mode="sign_flip")]
        with pytest.raises(ValueError, match="Eavesdropper taps"):
            run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(), None, 2,
                          device="cpu",
                          attacks=[attack.Eavesdropper(nodes=(0,))])
    if exc is None:
        got = run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(**cfg),
                            None, 6, device="cpu", **kw)
        if "wire" in kw:
            cfg["wire"] = kw["wire"]
        want = tcola.run_cola(port, ttopo.ring(K), tcola.ColaConfig(**cfg),
                              6, device="cpu")
        _assert_bitwise(got, want)
        return
    with pytest.raises(exc, match=match):
        run_dist_cola(port, ttopo.ring(K), tcola.ColaConfig(**cfg), None, 2,
                      device="cpu", **kw)


def test_gossip_mesh_ring_waits_for_item_14_1(group1):
    """The gossip ring over a NodeAxis (ported): one node per rank, so
    four nodes on one rank are refused; on one rank the ring with a band
    summing to 1 leaves every leaf as it was (its exchanges are local
    copies). The multi-rank ring: ``tests/test_torch_dist_wire.py``."""
    axis = NodeAxis()
    with pytest.raises(ValueError, match="one node per rank"):
        tgossip._param_mixer(tgossip.GossipConfig(num_nodes=4), axis, None,
                             None)
    leaves = {"a": torch.arange(6.0).reshape(1, 2, 3),
              "b": torch.ones((1, 4))}
    out = tgossip.ring_mix_pytree(leaves, axis,
                                  torch.tensor([0.25, 0.5, 0.25]), 1, 2)
    for name, p in leaves.items():
        assert torch.equal(out[name], p)


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
    # the attack entries by node; the dishonesty mask whole
    atk = {"atk_coef": np.arange(t * k).reshape(t, k),
           "atk_bias": np.arange(t * k * 2).reshape(t, k, 2),
           "atk_dishonest": np.ones((t, k))}
    got = sharding.schedule_block(atk, axis)
    np.testing.assert_array_equal(got["atk_coef"], atk["atk_coef"][:, 2:])
    np.testing.assert_array_equal(got["atk_bias"], atk["atk_bias"][:, 2:])
    assert got["atk_dishonest"] is atk["atk_dishonest"]
    # the wire's residual and the pipelined (payload, scale)
    wst = st._replace(ef=torch.arange(12.0).reshape(4, 3),
                      buf=(torch.arange(12, dtype=torch.int8).reshape(4, 3),
                           torch.arange(4.0).reshape(4, 1)))
    blk = sharding.cola_state_block(wst, axis)
    assert torch.equal(blk.ef, wst.ef[2:])
    assert torch.equal(blk.buf[0], wst.buf[0][2:])
    assert torch.equal(blk.buf[1], wst.buf[1][2:])


# ---------------------------------------------------------------------------
# the quantized wire, robust mixing and attacks at world size 1
# ---------------------------------------------------------------------------

def _mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.mark.parametrize("comm", ["plan", "dense"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_dist1_wire_bitwise_matches_run_cola(group1, wire, comm):
    """The twin of the reference's ``test_quant_dist_bitwise_matches_sim_1dev``
    (tests/test_quant_wire.py:259): int8 / fp8 with EF, static and under
    churn, bitwise run_cola on the reference's uniforms, and the
    reference's run_dist_cola on a 1-device mesh at the flip-aware
    tolerance; the plan path's exchanges carry nothing at M = 1."""
    ref, port = _ridge()
    graph, rounds = ttopo.torus_2d(2, K // 2), 25
    for kw in ({}, dict(active_schedule=_drop)):
        j_rec, t_rec = _recorders(ref, port, K)
        draws = _ref_draws(3, rounds, K, ref.d)
        cfg = tcola.ColaConfig(kappa=1.0, wire=wire)
        want = tcola.run_cola(port, graph, cfg, rounds, record_every=6,
                              seed=3, recorder=t_rec, wire_draws=draws,
                              device="cpu", **kw)
        got = run_dist_cola(port, graph, cfg, None, rounds, comm=comm,
                            record_every=6, seed=3, recorder=t_rec,
                            wire_draws=draws, device="cpu", block_size=16,
                            **kw)
        _assert_bitwise(got, want)
        assert torch.equal(got.state.ef, want.state.ef)
        ref_run = j_run_dist(ref, jtopo.torus_2d(2, K // 2),
                             JConfig(kappa=1.0, wire=wire), _mesh1(), rounds,
                             comm=comm, record_every=6, seed=3,
                             recorder=j_rec, **kw)
        _assert_wire_run(got, ref_run, wire, True)


def test_dist1_wire_kwarg_and_pipeline_and_own_draws(group1):
    """``wire=`` overrides ``cfg.wire`` (the reference's
    ``test_wire_kwarg_overrides_cfg``); a pipelined run is bitwise the
    unpipelined one, its double buffer what that run encodes next
    (``test_pipeline_is_bitwise_noop``); the port's own draws: each rank's
    rows of the stream are bitwise rows of the (K, d) draw."""
    _, port = _ridge()
    graph = ttopo.torus_2d(2, K // 2)
    a = run_dist_cola(port, graph, tcola.ColaConfig(kappa=1.0, wire="int8"),
                      None, 12, comm="dense", record_every=6, device="cpu")
    b = run_dist_cola(port, graph, tcola.ColaConfig(kappa=1.0), None, 12,
                      comm="dense", record_every=6, wire="int8",
                      device="cpu")
    _assert_bitwise(a, b)
    for wire in ("int8", "fp8"):
        base = tcola.run_cola(port, graph,
                              tcola.ColaConfig(kappa=1.0, wire=wire), 25,
                              record_every=6, device="cpu")
        piped = run_dist_cola(
            port, graph, tcola.ColaConfig(kappa=1.0, wire=wire,
                                          pipeline=True), None, 25,
            comm="plan", record_every=6, device="cpu")
        _assert_bitwise(piped, base)
        u = tquant.wire_uniforms(0, K, port.d, "cpu")(25, 0)
        q, sc, _, _ = tquant.encode(base.state.v_stack, wire, u,
                                    base.state.ef)
        assert torch.equal(piped.state.buf[0].view(torch.uint8),
                           q.view(torch.uint8))
        assert torch.equal(piped.state.buf[1], sc)
    full = tquant.wire_uniforms(5, K, 7, "cpu")
    for r0, r1 in ((0, 2), (2, 4), (6, 8)):
        rows = tquant.wire_uniforms(5, K, 7, "cpu", rows=slice(r0, r1))
        assert torch.equal(rows(3, 1), full(3, 1)[r0:r1])


@pytest.mark.parametrize("comm", ["plan", "dense"])
@pytest.mark.parametrize("robust", ["trim", "median", "clip"])
def test_dist1_robust_wire_bitwise_matches_run_cola(group1, robust, comm):
    """The twin of ``test_robust_quant_dist_matches_sim_1dev``
    (tests/test_quant_wire.py:363): robust mixing on the int8 wire with
    EF; the gate judges the dequantized rows. Bitwise run_cola at world
    size 1 on every mode (the reference holds clip on its plan path only
    allclose), and the reference's run at the flip-aware tolerance."""
    ref, port = _ridge()
    graph, rounds = ttopo.torus_2d(2, K // 2), 25
    j_rec, t_rec = _recorders(ref, port, K)
    draws = _ref_draws(3, rounds, K, ref.d)
    cfg = tcola.ColaConfig(kappa=1.0, wire="int8", robust=robust)
    want = tcola.run_cola(port, graph, cfg, rounds, record_every=6, seed=3,
                          recorder=t_rec, wire_draws=draws, device="cpu")
    got = run_dist_cola(port, graph, cfg, None, rounds, comm=comm,
                        record_every=6, seed=3, recorder=t_rec,
                        wire_draws=draws, device="cpu")
    _assert_bitwise(got, want)
    ref_run = j_run(ref, jtopo.torus_2d(2, K // 2),
                    JConfig(kappa=1.0, wire="int8", robust=robust), rounds,
                    record_every=6, seed=3, recorder=j_rec)
    _assert_wire_run(got, ref_run, "int8", True)


def _byz(pkg):
    return [pkg.Byzantine(nodes=(1, 6), mode="sign_flip", scale=10.0,
                          start=5, seed=1)]


@pytest.mark.parametrize("comm", ["plan", "dense"])
@pytest.mark.parametrize("robust", ["trim", "median", "clip"])
def test_dist1_attacked_defended_matches_run_cola(group1, robust, comm):
    """The twin of ``test_plan_attacked_defended_matches_sim``
    (tests/test_dist_plan.py:296) at world size 1: a two-node x10 sign
    flip on torus_2d(2, 4) under each defense, gap + the honest-cohort
    certificate. Bitwise run_cola; the reference's run_cola at rtol 1e-4
    with the same violated and stop rounds, through the first violated
    row (two liars among a node's three neighbors outnumber trim's depth
    1, and after the violation the run diverges, where the last bits of
    two frameworks part, as ``test_torch_attack.py`` holds it)."""
    ref, port = _lasso()
    graph = ttopo.torus_2d(2, 4)
    rounds = 20 if robust == "clip" else 60
    kw = dict(record_every=10, recorder="gap+certificate", eps=1.0)
    cfg = tcola.ColaConfig(kappa=2.0, robust=robust)
    want = tcola.run_cola(port, graph, cfg, rounds, attacks=_byz(attack),
                          device="cpu", **kw)
    got = run_dist_cola(port, graph, cfg, None, rounds, comm=comm,
                        attacks=_byz(attack), device="cpu", **kw)
    _assert_bitwise(got, want)
    ref_run = j_run(ref, jtopo.torus_2d(2, 4),
                    JConfig(kappa=2.0, robust=robust), rounds,
                    attacks=_byz(jattack), **kw)
    h, r = got.history, ref_run.history
    assert h["round"] == r["round"] and h["stop_round"] == r["stop_round"]
    assert h["violated_round"] == r["violated_round"]
    upto = (None if r["violated_round"] is None
            else r["round"].index(r["violated_round"]) + 1)
    for key in ("primal", "gap", "consensus_residual"):
        scale = RTOL * max(abs(v) for v in r[key][:upto])
        np.testing.assert_allclose(h[key][:upto], r[key][:upto], rtol=RTOL,
                                   atol=scale, err_msg=key)
    for key in ("cond9_nodes", "cond10_nodes", "certified",
                "certificate_violated"):
        assert h[key][:upto] == r[key][:upto], key


@pytest.mark.parametrize("comm", ["ring", "plan", "dense"])
def test_dist1_attack_scenarios_bitwise(group1, comm):
    """Undefended scenarios at world size 1: a sign flip (the honest
    cohort's certificate trips), random payloads (the run-constant
    directions), a stale free rider and a link corruption (W rewritten
    per round), each bitwise run_cola."""
    _, port = _lasso()
    graph = ttopo.connected_cycle(K, 2)
    cases = [_byz(attack),
             [attack.Byzantine(nodes=(2,), mode="random", scale=0.3, seed=5,
                               start=4)],
             [attack.FreeRider(nodes=(2,)),
              attack.FreeRider(nodes=(5,), stale=True, start=10)],
             [attack.LinkCorruption(edges=((0, 1),), scale=0.0, start=3)]]
    for atk in cases:
        kw = dict(record_every=5, recorder="gap+certificate", eps=1.0,
                  attacks=atk)
        want = tcola.run_cola(port, graph, tcola.ColaConfig(kappa=2.0), 20,
                              device="cpu", **kw)
        got = run_dist_cola(port, graph, tcola.ColaConfig(kappa=2.0), None,
                            20, comm=comm, device="cpu", **kw)
        _assert_bitwise(got, want)


def test_wire_lowerings_at_world_size_1(group1):
    """The wire's lowerings on one rank: a float8 payload crosses
    ``NodeAxis`` as its bytes; the block wire mix is bitwise ``qmix_steps``
    and the composed robust step bitwise the stacked composed branch; each
    counts its calls and bytes; the wire's mixer refuses a per-node
    ``CommPlan`` (``run_dist_cola`` compiles a block plan for a wire)."""
    axis = NodeAxis()
    gen = torch.Generator().manual_seed(0)
    v = torch.randn((K, 33), generator=gen)
    ef = 0.01 * torch.randn((K, 33), generator=gen)
    u = torch.rand((K, 33), generator=gen)
    q, sc = tquant.quantize_rows(v, "fp8", u)
    axis.reset_counts()
    got = axis.permute(q, [(0, 0)])
    assert got.dtype == q.dtype
    assert torch.equal(got.view(torch.uint8), q.view(torch.uint8))
    gathered = axis.all_gather(q)
    assert gathered.dtype == q.dtype
    assert torch.equal(gathered.view(torch.uint8), q.view(torch.uint8))
    assert axis.sent_bytes["all-gather"] == K * 33
    w = torch.as_tensor(ttopo.metropolis_weights(ttopo.torus_2d(2, 4)),
                        dtype=torch.float32)
    bp = tplan.compile_block_plan(ttopo.torus_2d(2, 4), 1)
    draws = lambda s: u
    for wire in ("int8", "fp8", "fp8_e5m2"):
        want, ef_want = tmixing.qmix_steps(w, v, ef, 2, wire, draws)
        got, ef_got = tlow.block_qmix_steps(v, ef, axis, bp, w, 2, wire,
                                            draws)
        assert torch.equal(got, want) and torch.equal(ef_got, ef_want)
        _, _, deq, ef_c = tquant.encode(v, wire, u, ef)
        for mode in ("trim", "median", "clip"):
            got, ef_got = tlow.block_robust_qmix_step(v, ef, axis, bp, w,
                                                      wire, draws, mode)
            assert torch.equal(got, tmixing.robust_mix_dense(w, deq, mode))
            assert torch.equal(ef_got, ef_c)
    single = tplan.compile_plan(np.zeros((1, 1), bool))
    with pytest.raises(ValueError, match="BlockPlan"):
        runtime._dist_qmixers(axis, "plan", tcola.ColaConfig(wire="int8"),
                              single)


def test_rank_env_is_the_whole_envs_block(group1):
    """At world size 1 the rank's env is the whole env, bitwise (the
    multi-rank blocks: ``tests/test_torch_dist_wire.py``)."""
    _, port = _ridge()
    part = tcola.make_partition(port.n, K)
    whole = tcola.build_env(port, part)
    for with_gram in (True, False):
        whole = tcola.build_env(port, part, with_gram=with_gram)
        block = sharding.cola_env_block(port, part, NodeAxis(),
                                        with_gram=with_gram)
        for a, b in zip(block, whole):
            assert (a is None and b is None) or torch.equal(a, b)
