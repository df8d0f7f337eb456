"""The port's Algorithm-1 driver against the JAX reference, on the CPU.

Same numpy data into both packages; histories compared column by column
with rtol=1e-4 and atol=1e-4 * max|primal| (fp32 runs of the same algorithm
whose CD dot products and mixing products sum in another order), and
``stop_round`` exactly. The port's two executors are compared bitwise.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmet, problems as jprob, topology as jtopo
from repro.core.cola import (ColaConfig as JConfig, build_env as j_build_env,
                             make_round as j_make_round, run_cola as j_run)
from repro.core.partition import make_partition as j_make_partition
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import cola as tcola, duality as tdual, \
    metrics as tmet, topology as ttopo
from repro_torch.core.partition import make_partition as t_make_partition

RTOL = 1e-4
HIST = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")


def _assert_history(got, want, keys=HIST):
    assert got["round"] == want["round"]
    assert got["stop_round"] == want["stop_round"]
    atol = 1e-4 * max(abs(v) for v in want["primal"])
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=atol,
                                   err_msg=key)


def _ridge():
    x, y, _ = synthetic.regression(200, 64, seed=0)
    return (jprob.ridge_primal(jnp.asarray(x), jnp.asarray(y), 1e-4),
            convert.problem_from_numpy("ridge_primal", x, y, 1e-4,
                                       device="cpu"))


def _lasso():
    x, y, _ = synthetic.regression(200, 24, seed=3, sparsity_solution=0.2)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), lam=5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_quickstart_ridge_matches_reference(executor):
    ref, port = _ridge()
    want = j_run(ref, jtopo.ring(8), JConfig(kappa=2.0), 100,
                 record_every=10)
    got = tcola.run_cola(port, ttopo.ring(8), tcola.ColaConfig(kappa=2.0),
                         100, record_every=10, executor=executor,
                         block_size=16, device="cpu")
    _assert_history(got.history, want.history)


@pytest.mark.parametrize("cfg", [
    dict(kappa=1.0, cd_mode="residual"),
    dict(kappa=1.5, gossip_steps=2, grad_mode="mixed"),
    dict(kappa=0.5, gamma=0.5, sigma_prime=3.0, cd_mode="gram")])
def test_round_options_match_reference(cfg):
    ref, port = _ridge()
    want = j_run(ref, jtopo.ring(8), JConfig(**cfg), 30, record_every=5)
    got = tcola.run_cola(port, ttopo.ring(8), tcola.ColaConfig(**cfg), 30,
                         record_every=5, device="cpu")
    _assert_history(got.history, want.history)


def test_cocoa_mixing_matches_reference():
    ref, port = _ridge()
    want = j_run(ref, jtopo.complete(4), JConfig(kappa=1.0), 20,
                 w_override=np.full((4, 4), 0.25))
    got = tcola.run_cola(port, ttopo.complete(4), tcola.ColaConfig(kappa=1.0),
                         20, w_override=tcola.cocoa_mixing(4), device="cpu")
    _assert_history(got.history, want.history)


def _cert_recorders(ref, port, k, eps):
    """Both packages' gap+certificate recorders, certifying with the same
    sigma_k (the exact ||A_[k]||_2^2) — the reference's power iteration
    starts from ``jax.random`` and the port's from a ``torch.Generator``."""
    jpart = j_make_partition(ref.n, k)
    tpart = t_make_partition(port.n, k)
    j_env = j_build_env(ref, jpart)
    t_env = tcola.build_env(port, tpart)
    a_parts = np.asarray(j_env.a_parts)
    sigma = np.array([np.linalg.norm(a_parts[i], 2) ** 2 for i in range(k)],
                     dtype=np.float32)
    graph_j, graph_t = jtopo.ring(k), ttopo.ring(k)
    j_cert = jmet.certificate_recorder(ref, jpart, j_env, graph_j, eps,
                                       sigma_k=jnp.asarray(sigma))
    t_cert = tmet.certificate_recorder(
        port, tpart, t_env, graph_t, eps,
        sigma_k=sigma)
    j_rec = jmet.ComposedRecorder((jmet.GapRecorder(ref, jpart), j_cert))
    t_rec = tmet.ComposedRecorder((tmet.GapRecorder(port, tpart), t_cert))
    return j_rec, t_rec


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_certified_lasso_stops_at_reference_round(executor):
    ref, port = _lasso()
    j_rec, t_rec = _cert_recorders(ref, port, 4, eps=0.2)
    want = j_run(ref, jtopo.ring(4), JConfig(kappa=4.0), 400,
                 record_every=5, recorder=j_rec)
    got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(kappa=4.0),
                         400, record_every=5, recorder=t_rec,
                         executor=executor, block_size=16, device="cpu")
    assert want.history["stop_round"] is not None
    _assert_history(got.history, want.history)
    for key in ("cond9_nodes", "cond10_nodes", "certified",
                "certificate_violated"):
        assert got.history[key] == want.history[key], key
    assert got.history["violated_round"] == want.history["violated_round"]


def _lasso_wide():
    """400 samples x 600 features on ring(2): n_k = 300, above the 236
    where G leaves shared memory, below the 1,448 where the Gram rule
    stops."""
    x, y, _ = synthetic.regression(400, 600, seed=4, sparsity_solution=0.1)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), lam=5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_wide_lasso_takes_gram_path_and_matches_reference(executor):
    from repro.core import subproblem as jsub
    from repro_torch.kernels import cd_glm
    ref, port = _lasso_wide()
    part = t_make_partition(port.n, 2)
    assert part.block == 300 and not cd_glm.gram_fits_smem(part.block)
    assert jsub.gram_pays(ref.d, part.block)
    assert tcola.build_env(port, part).gram_parts is not None
    want = j_run(ref, jtopo.ring(2), JConfig(kappa=1.0), 40, record_every=2,
                 recorder="gap", eps=2.0)
    got = tcola.run_cola(port, ttopo.ring(2), tcola.ColaConfig(kappa=1.0),
                         40, record_every=2, recorder="gap", eps=2.0,
                         executor=executor, block_size=8, device="cpu")
    assert want.history["stop_round"] is not None
    _assert_history(got.history, want.history,
                    keys=("primal", "dual", "gap", "consensus_violation"))


def test_make_recorder_gap_certificate_runs_and_stops():
    """The string form builds its own sigma_k (power iteration) and stops
    on certification within the same budget as the reference."""
    ref, port = _lasso()
    want = j_run(ref, jtopo.ring(4), JConfig(kappa=4.0), 400,
                 record_every=5, recorder="gap+certificate", eps=0.2)
    got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(kappa=4.0),
                         400, record_every=5, recorder="gap+certificate",
                         eps=0.2, device="cpu")
    assert got.history["stop_round"] == want.history["stop_round"]


def _budgets(t, rng):
    return rng.integers(0, 9, size=4)


def _churn(t, rng):
    return rng.random(4) < 0.7


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_budget_schedule_matches_reference(executor):
    ref, port = _lasso()
    want = j_run(ref, jtopo.ring(4), JConfig(kappa=1.5), 40, record_every=4,
                 budget_schedule=_budgets, seed=11)
    got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(kappa=1.5), 40,
                         record_every=4, budget_schedule=_budgets, seed=11,
                         executor=executor, block_size=8, device="cpu")
    _assert_history(got.history, want.history)


@pytest.mark.parametrize("kw", [
    dict(recorder="gap", record_every=3),
    dict(recorder="gap+certificate", eps=0.2, record_every=5),
    dict(recorder="gap", eps=5.0, record_every=2),
    dict(recorder="gap+certificate", eps=0.2, record_every="adaptive"),
    dict(recorder="gap", budget_schedule=_budgets, record_every=7),
    dict(recorder="gap", active_schedule=_churn, record_every=3),
    dict(recorder="gap", active_schedule=_churn, leave_mode="reset",
         budget_schedule=_budgets, record_every=4),
    dict(recorder="gap+certificate", eps=0.2, active_schedule=_churn,
         record_every=5),
    dict(recorder="gap+certificate", eps=0.2, active_schedule=_churn,
         leave_mode="reset", record_every="adaptive")])
def test_loop_and_block_executors_bitwise(kw):
    _, port = _lasso()
    runs = [tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(kappa=2.0),
                           60, executor=ex, block_size=16, device="cpu", **kw)
            for ex in ("loop", "block")]
    loop, block = runs
    assert loop.history == block.history
    for a, b in zip(loop.state, block.state):   # the fp32 wire: ef, buf None
        assert (a is None and b is None) or torch.equal(a, b)


def test_adaptive_cadence_matches_reference():
    ref, port = _lasso()
    want = j_run(ref, jtopo.ring(4), JConfig(kappa=4.0), 300,
                 record_every="adaptive", recorder="gap", eps=0.05)
    got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(kappa=4.0),
                         300, record_every="adaptive", recorder="gap",
                         eps=0.05, device="cpu")
    _assert_history(got.history, want.history)


def test_round_from_the_same_mid_run_state():
    """Both packages start one round from the same (x, v)."""
    ref, port = _lasso()
    k = 4
    rng = np.random.default_rng(5)
    jpart = j_make_partition(ref.n, k)
    x_parts = (0.2 * rng.normal(size=(k, jpart.block))).astype(np.float32)
    v_stack = (0.2 * rng.normal(size=(k, ref.d))).astype(np.float32)
    w = jtopo.metropolis_weights(jtopo.ring(k)).astype(np.float32)
    from repro.core.cola import ColaState as JState
    j_out = j_make_round(ref, jpart, JConfig(kappa=2.0))(
        JState(jnp.asarray(x_parts), jnp.asarray(v_stack)),
        j_build_env(ref, jpart), jnp.asarray(w), jnp.ones((k,)))
    tpart = t_make_partition(port.n, k)
    state = convert.state_from_numpy(x_parts, v_stack, device="cpu")
    t_out = tcola.make_round(port, tpart, tcola.ColaConfig(kappa=2.0))(
        state, tcola.build_env(port, tpart), torch.as_tensor(w),
        torch.ones((k,)))
    got_x, got_v = convert.state_to_numpy(t_out)
    np.testing.assert_allclose(got_x, np.asarray(j_out.x_parts), atol=1e-5)
    np.testing.assert_allclose(got_v, np.asarray(j_out.v_stack), atol=1e-5)


def test_block_spectral_norms_against_exact():
    x, _, _ = synthetic.regression(120, 40, seed=2)
    part = t_make_partition(40, 4)
    a_parts = part.split_matrix(torch.as_tensor(x))
    exact = np.array([np.linalg.norm(a_parts[i].numpy(), 2) ** 2
                      for i in range(4)])
    np.testing.assert_allclose(tdual.block_spectral_norms(a_parts).numpy(),
                               exact, rtol=1e-3)
    cache = torch.arange(1.0, 5.0)
    assert torch.equal(tdual.block_spectral_norms(a_parts, cache=cache),
                       cache)
    with pytest.raises(ValueError, match="shape"):
        tdual.block_spectral_norms(a_parts, cache=torch.ones(3))


def test_solve_reference_matches_reference():
    from repro.core.cola import solve_reference as j_solve
    ref, port = _ridge()
    np.testing.assert_allclose(tcola.solve_reference(port, rounds=40),
                               j_solve(ref, rounds=40), rtol=1e-4)


@pytest.mark.parametrize("bad", [
    dict(cfg=dict(robust="trim")), dict(cfg=dict(telemetry=True)),
    dict(attacks=[object()])])
def test_unported_features_raise(bad, monkeypatch):
    """Every case is ported now. Robust mixing and attacks (item 11):
    robust="trim" matches the reference's run (the tolerances of
    ``_assert_history``), and an attack list holding something that is no
    scenario raises TypeError in both packages. Telemetry (item 15): the
    history matches the reference's at the same tolerances, and the
    counters' integers (rounds, wire bytes, exchanges, the contract line,
    gate counts) equal the reference's (no registry written)."""
    monkeypatch.setenv("REPRO_RUNS_DIR", "off")
    ref, port = _lasso()
    bad = dict(bad)
    cfg = bad.pop("cfg", {})
    if cfg.get("telemetry"):
        want = j_run(ref, jtopo.ring(4), JConfig(**cfg), 20, record_every=4)
        got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(**cfg), 20,
                             record_every=4, device="cpu")
        _assert_history(got.history, want.history)
        tel, rtel = got.history["telemetry"], want.history["telemetry"]
        for key in ("rounds", "wire_bytes", "permutes", "contract",
                    "gate_rejections", "gate_total", "stop_round"):
            assert tel[key] == rtel[key], key
        assert tel["wire_bytes"] > 0
        return
    if cfg.get("robust"):
        want = j_run(ref, jtopo.ring(4), JConfig(**cfg), 20, record_every=4)
        got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(**cfg), 20,
                             record_every=4, device="cpu")
        _assert_history(got.history, want.history)
        return
    with pytest.raises(TypeError, match="not an attack scenario"):
        j_run(ref, jtopo.ring(4), JConfig(), 5, **bad)
    with pytest.raises(TypeError, match="not an attack scenario"):
        tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(), 5,
                       device="cpu", **bad)


@pytest.mark.parametrize("cfg,exc", [
    (dict(participation=object()), TypeError),
    (dict(pipeline=True), ValueError),
    (dict(wire="int4"), ValueError)])
def test_wire_and_participation_rejections_match_reference(cfg, exc):
    """The quantized wire and client sampling run now (ROADMAP queue 1
    items 9 and 10): a participation that is no SampleConfig, a pipeline
    on the fp32 wire and an unknown wire raise as the reference does."""
    ref, port = _lasso()
    with pytest.raises(exc):
        j_run(ref, jtopo.ring(4), JConfig(**cfg), 5)
    with pytest.raises(exc):
        tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(**cfg), 5,
                       device="cpu")


@pytest.mark.parametrize("kw", [
    dict(active_schedule=np.ones((5, 4), bool)),
    dict(leave_mode="reset"),
    dict(active_schedule=np.array([[1, 1, 0, 1]] * 2 + [[0, 1, 1, 1]] * 3,
                                  bool), leave_mode="reset")])
def test_elasticity_arguments_match_reference(kw):
    """The churn arguments run now (ROADMAP queue 1 item 7): an all-active
    (T, K) mask, reset without churn (nothing leaves), and resets."""
    ref, port = _lasso()
    want = j_run(ref, jtopo.ring(4), JConfig(), 5, **kw)
    got = tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(), 5,
                         device="cpu", **kw)
    _assert_history(got.history, want.history)


def test_unported_certificate_modes_raise():
    """The attack-audit mode (ROADMAP queue 1 item 11) is ported: the
    attackified certificate's row over the honest cohort matches the
    reference's on the same state and dishonesty mask (rtol 1e-4, atol
    1e-4 * max|column|: fp32 sums in another order), and a node marked
    dishonest leaves the conditions' count."""
    ref, port = _lasso()
    k = 4
    jpart, tpart = j_make_partition(ref.n, k), t_make_partition(port.n, k)
    jenv, tenv = j_build_env(ref, jpart), tcola.build_env(port, tpart)
    sigma = np.array([np.linalg.norm(a, 2) ** 2
                      for a in np.asarray(jenv.a_parts)], np.float32)
    jrec = jmet.attackify(jmet.certificate_recorder(
        ref, jpart, jenv, jtopo.ring(k), 0.1, sigma_k=jnp.asarray(sigma)))
    trec = tmet.attackify(tmet.certificate_recorder(
        port, tpart, tenv, ttopo.ring(k), 0.1, sigma_k=sigma))
    assert trec.attack_aware and trec.uses_schedule
    assert (trec.cons_tol, trec.viol_tol) == (jrec.cons_tol, jrec.viol_tol)
    rng = np.random.default_rng(7)
    x = (0.1 * rng.standard_normal((k, tpart.block))).astype(np.float32)
    v = rng.standard_normal((k, port.d)).astype(np.float32)
    from repro.core.cola import ColaState as JState
    for dis in ([0, 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 1]):
        dis = np.asarray(dis, np.float32)
        want = np.asarray(jrec.record_fn(
            JState(jnp.asarray(x), jnp.asarray(v)),
            {"atk_dishonest": jnp.asarray(dis)}))
        got = trec.record_fn(
            tcola.ColaState(torch.as_tensor(x), torch.as_tensor(v)),
            {"atk_dishonest": torch.as_tensor(dis)}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        labels = tmet.CERT_METRICS
        assert got[labels.index("cond9_nodes")] <= k - dis.sum()


def test_run_on_another_device_than_the_problem_raises():
    _, port = _lasso()
    with pytest.raises(ValueError, match="problem data is on"):
        tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(), 2,
                       device="meta")
