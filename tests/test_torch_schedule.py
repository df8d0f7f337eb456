"""The port's streamed schedules and client sampling, on the CPU.

* Port against port: a streamed participation run (the generators
  evaluated for each round inside the block executor) is bitwise its
  materialized twin (``SampleConfig(stream=False)``), in dense and in
  cohort mode, with the gap recorder and with the certificate.
* Against the reference, by the chain the reference pins itself
  (``tests/test_schedule_stream.py``): the port's own draws, as a (T, K)
  ``active_schedule`` array (``participation_callable``), go into the
  reference's churn run on ``complete(K)``; that run must match the port's
  dense participation run and, at small K, its cohort run, with the gap
  recorder and with the dynamic (cohort) certificate. Histories at rtol
  1e-4 and atol 1e-4 * max|primal| (fp32 runs whose mixing and CD
  products sum in another order; the cohort mix is a mean over the
  cohort where the churn run multiplies by W_t), stop rounds exactly; the
  certificates take the exact sigma_k in both packages (their power
  iterations start from different random vectors).
* The cohort round writes the cohort's rows in place; with ``eps`` armed
  a stopped run's state equals the run truncated at its stop round.
* The footprint renderer, the auto mode, the rejections and the
  million-node (K = 10^6, K' = 10^3) smoke at d = 8.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmet, problems as jprob, \
    topology as jtopo
from repro.core.cola import ColaConfig as JConfig, build_env as j_env, \
    run_cola as j_run
from repro.core.partition import make_partition as j_make_partition
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import cola as tcola, metrics as tmet, \
    schedule as ts, topology as ttopo
from repro_torch.core.partition import make_partition as t_make_partition

K = 16
ROUNDS = 24
RTOL = 1e-4
HIST = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")
CERT = ("local_gap_max", "grad_disagreement_max", "cond9_nodes",
        "cond10_nodes", "certified", "consensus_residual")


@functools.lru_cache(maxsize=None)
def _lasso():
    x, y, _ = synthetic.regression(48, 16, seed=2, sparsity_solution=0.2)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), 5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


def _cfg(k_active=4, *, stream=True, mode="dense", **kw):
    return tcola.ColaConfig(kappa=1.0, participation=ts.SampleConfig(
        k_active=k_active, mode=mode, stream=stream), **kw)


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 and \
        t.dtype.is_floating_point else t


def _assert_bitwise(a, b):
    assert a.history == b.history
    for x, y in zip(a.state, b.state):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert torch.equal(_bits(u), _bits(v))
        else:
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("mode", ["dense", "cohort"])
@pytest.mark.parametrize("recorder", ["gap", "gap+certificate"])
def test_streamed_vs_materialized_bitwise(mode, recorder):
    _, port = _lasso()
    kw = dict(record_every=4, recorder=recorder, seed=7, device="cpu",
              eps=1.0 if recorder != "gap" else None)
    runs = [tcola.run_cola(port, ttopo.complete(K),
                           _cfg(mode=mode, stream=s), ROUNDS, **kw)
            for s in (True, False)]
    _assert_bitwise(*runs)


@pytest.mark.parametrize("kw", [
    dict(leave_mode="reset", recorder="gap+certificate", eps=1.0),
    dict(cfg=dict(wire="int8"), leave_mode="reset"),
    dict(cfg=dict(wire="fp8", pipeline=True),
         budget_schedule=lambda t, rng: rng.integers(0, 3, K))])
def test_streamed_vs_materialized_bitwise_composed(kw):
    """Dense participation composed with resets, the quantized wire and
    budgets: streamed and materialized still agree bitwise."""
    _, port = _lasso()
    kw = dict(kw)
    cfg = kw.pop("cfg", {})
    runs = [tcola.run_cola(port, ttopo.complete(K),
                           _cfg(stream=s, **cfg), ROUNDS, record_every=4,
                           seed=3, device="cpu", **kw)
            for s in (True, False)]
    _assert_bitwise(*runs)


@functools.lru_cache(maxsize=None)
def _exact_sigma():
    ref, _ = _lasso()
    a_parts = np.asarray(j_env(ref, j_make_partition(ref.n, K)).a_parts)
    return np.array([np.linalg.norm(a_parts[i], 2) ** 2 for i in range(K)],
                    dtype=np.float32)


def _recorders(kind, cohort=False):
    """Both packages' recorder: "gap", or gap + the certificate with the
    exact sigma_k (the port's cohort certificate when ``cohort``)."""
    ref, port = _lasso()
    if kind == "gap":
        return "gap", "gap"
    jpart, tpart = j_make_partition(ref.n, K), t_make_partition(port.n, K)
    sigma = _exact_sigma()
    j_cert = jmet.certificate_recorder(
        ref, jpart, j_env(ref, jpart), jtopo.complete(K), 1.0,
        sigma_k=jnp.asarray(sigma))
    t_env = tcola.build_env(port, tpart)
    t_cert = (tmet.cohort_certificate_recorder(port, tpart, t_env, 1.0,
                                               sigma_k=sigma) if cohort
              else tmet.certificate_recorder(port, tpart, t_env,
                                             ttopo.complete(K), 1.0,
                                             sigma_k=sigma))
    return (jmet.ComposedRecorder((jmet.GapRecorder(ref, jpart), j_cert)),
            tmet.ComposedRecorder((tmet.GapRecorder(port, tpart), t_cert)))


def _assert_history(got, want, keys):
    assert got["round"] == want["round"]
    assert got["stop_round"] == want["stop_round"]
    atol = 1e-4 * max(abs(v) for v in want["primal"])
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("mode", ["dense", "cohort"])
@pytest.mark.parametrize("kind", ["gap", "cert"])
@pytest.mark.parametrize("k_active", [2, 6])
def test_participation_matches_reference_churn_run(mode, kind, k_active):
    """The reference's churn run on complete(K), fed the port's draws as
    its (T, K) active schedule, against the port's participation run."""
    ref, port = _lasso()
    seed = 11
    sample = ts.SampleConfig(k_active=k_active, mode=mode)
    draw = ts.participation_callable(K, sample, seed)
    active = np.stack([draw(t, None) for t in range(ROUNDS)])
    assert (active.sum(axis=1) == k_active).all()
    j_rec, t_rec = _recorders(kind, cohort=mode == "cohort")
    kw = dict(record_every=3, eps=1.0 if kind == "cert" else None)
    want = j_run(ref, jtopo.complete(K), JConfig(kappa=1.0), ROUNDS,
                 recorder=j_rec, active_schedule=active, seed=seed, **kw)
    got = tcola.run_cola(port, ttopo.complete(K),
                         tcola.ColaConfig(kappa=1.0, participation=sample),
                         ROUNDS, recorder=t_rec, seed=seed, device="cpu",
                         **kw)
    _assert_history(got.history, want.history,
                    HIST + (CERT if kind == "cert" else ()))


def test_cohort_stop_leaves_the_state_of_the_truncated_run():
    """The cohort round writes its rows in place and keeps the old rows
    once the stop flag is set: a run stopped by eps (in the middle of a
    block) ends in the state of the run truncated at its stop round, and
    its state is the tensors it started with, updated in place."""
    _, port = _lasso()
    cfg = _cfg(mode="cohort")
    kw = dict(record_every=1, recorder="gap", seed=5, device="cpu")
    full = tcola.run_cola(port, ttopo.complete(K), cfg, 40, **kw)
    eps = full.history["gap"][10] * 1.0001
    stop = tcola.run_cola(port, ttopo.complete(K), cfg, 40, eps=eps,
                          block_size=16, **kw)
    s = stop.history["stop_round"]
    assert s is not None and s % 16 != 15
    trunc = tcola.run_cola(port, ttopo.complete(K), cfg, s + 1, **kw)
    _assert_bitwise(_without_stop(stop), trunc)


def _without_stop(res):
    """A stopped run with its stop round cleared: its rows are those of the
    run truncated at the stop round."""
    return res._replace(history=dict(res.history, stop_round=None))


def test_cohort_writes_the_state_in_place(monkeypatch):
    _, port = _lasso()
    seen = []
    real = tcola.init_state

    def spy(problem, part):
        seen.append(real(problem, part))
        return seen[-1]

    monkeypatch.setattr(tcola, "init_state", spy)
    res = tcola.run_cola(port, ttopo.complete(K), _cfg(mode="cohort"), 5,
                         device="cpu")
    assert res.state.v_stack is seen[0].v_stack
    assert res.state.x_parts is seen[0].x_parts
    assert res.state.v_stack.abs().sum() > 0


def test_draws_are_uniform_k_subsets_keyed_by_the_sampler_seed():
    sample = ts.SampleConfig(k_active=3)
    draw = ts.participation_callable(K, sample, run_seed=0)
    masks = np.stack([draw(t, None) for t in range(50)])
    assert masks.dtype == bool and masks.shape == (50, K)
    assert (masks.sum(axis=1) == 3).all()
    assert len({tuple(m) for m in masks}) > 1
    assert masks.any(axis=0).all()
    # node k is in a round's draw with probability K'/K: its count over
    # 50 rounds within 5 sigma of the mean
    n, p = 50, 3 / K
    assert np.all(np.abs(masks.sum(axis=0) - n * p)
                  <= 5 * np.sqrt(n * p * (1 - p)))
    fixed = ts.SampleConfig(k_active=4, seed=11)
    a = ts.participation_callable(K, fixed, run_seed=0)
    b = ts.participation_callable(K, fixed, run_seed=99)
    assert all((a(t, None) == b(t, None)).all() for t in range(8))
    # the cohort indices are the same draw, sorted
    key = ts.sample_key(sample, 0)
    for t in range(4):
        idx = ts.cohort_indices(key, t, K, 3, "cpu")
        assert torch.equal(idx, torch.sort(idx).values)
        assert np.array_equal(np.nonzero(draw(t, None))[0], idx.numpy())


def test_reset_flags_match_the_streamed_leavers():
    sample = ts.SampleConfig(k_active=5)
    parts = ts.participation_parts(K, sample, dtype=torch.float32,
                                   run_seed=2, device="cpu",
                                   leave_reset=True)
    stream = ts.ScheduleProgram(parts=parts).stream_fn()
    flags = ts.reset_flags(K, sample, 2, 12)
    got = np.array([bool(stream(t)["leavers"].any()) for t in range(12)])
    np.testing.assert_array_equal(flags, got)
    assert flags[0]        # before round 0 every node counts as active
    assert flags[1:].any()


def test_materialize_matches_stream_fn():
    parts = ts.participation_parts(8, ts.SampleConfig(k_active=3),
                                   dtype=torch.float32, run_seed=4,
                                   device="cpu")
    prog = ts.ScheduleProgram(parts=parts)
    stacked = prog.materialize(6)
    fn = prog.stream_fn()
    for t in range(6):
        for name, val in fn(t).items():
            assert np.array_equal(stacked[name][t], val.numpy()), (name, t)
    assert (stacked["active"].sum(axis=1) == 3).all()
    np.testing.assert_allclose(stacked["w"].sum(axis=2), 1.0, rtol=0,
                               atol=1e-6)
    # the sampled W is the reference's reweighted complete graph
    for t in range(6):
        want = jtopo.reweight_for_active(jtopo.complete(8),
                                         stacked["active"][t] > 0)
        np.testing.assert_allclose(stacked["w"][t], want, rtol=0, atol=1e-7)


def test_footprint_and_renderer():
    prog = ts.ScheduleProgram(parts=ts.cohort_parts(
        1000, ts.SampleConfig(k_active=10, mode="cohort"),
        dtype=torch.float32, run_seed=0, device="cpu"))
    fp = prog.footprint(100)
    assert fp["streamed_bytes"] == sum(fp["entries"].values())
    assert fp["stacked_bytes"] == fp["streamed_bytes"] * 100
    # (K',) int64 indices (the reference's are int32) + the (K,) mask
    assert fp["entries"] == {"cohort_idx": 10 * 8, "active": 1000 * 4}
    text = ts.render_stream_footprint(1_000_000, 1_000, 1_000, 8)
    assert "mode=cohort" in text
    assert "4,008,000 B total" in text
    assert "4,008,000,000 B total" in text
    small = ts.render_stream_footprint(16, 4, 100, 8)
    assert "mode=dense" in small and " w " in small


def test_sample_config_validation_and_auto_mode():
    with pytest.raises(ValueError, match="k_active"):
        ts.SampleConfig(k_active=0)
    with pytest.raises(ValueError, match="mode"):
        ts.SampleConfig(k_active=2, mode="sparse")
    with pytest.raises(ValueError, match="exceeds"):
        ts.SampleConfig(k_active=32).resolve_mode(K)
    s = ts.SampleConfig(k_active=8)
    assert s.resolve_mode(ts.DENSE_MAX_NODES) == "dense"
    assert s.resolve_mode(ts.DENSE_MAX_NODES + 1) == "cohort"
    assert ts.SampleConfig(k_active=2, mode="cohort").resolve_mode(16) \
        == "cohort"
    assert s.resolve_seed(3) == 3
    assert ts.SampleConfig(k_active=2, seed=9).resolve_seed(3) == 9
    g = ttopo.implicit_complete(10 ** 6)
    assert g.name == "complete" and g.num_nodes == 10 ** 6


@pytest.mark.parametrize("make,kw,exc", [
    (lambda: _cfg(), dict(executor="loop"), ValueError),
    (lambda: _cfg(), dict(graph="ring"), ValueError),
    (lambda: _cfg(), dict(active_schedule=np.ones((ROUNDS, K), bool)),
     ValueError),
    (lambda: tcola.ColaConfig(participation={"k_active": 4}), {}, TypeError),
    (lambda: _cfg(mode="cohort"), dict(leave_mode="reset"),
     NotImplementedError),
    (lambda: _cfg(mode="cohort"), dict(budget_schedule=lambda t, rng:
                                       np.ones(K, np.int32)),
     NotImplementedError),
    (lambda: _cfg(mode="cohort", wire="int8"), {}, NotImplementedError),
    (lambda: _cfg(mode="cohort", gossip_steps=2), {}, NotImplementedError)])
def test_participation_rejections(make, kw, exc):
    _, port = _lasso()
    kw = dict(kw)
    graph = ttopo.ring(K) if kw.pop("graph", None) else ttopo.complete(K)
    with pytest.raises(exc):
        tcola.run_cola(port, graph, make(), ROUNDS, device="cpu", **kw)


def test_million_node_cohort_smoke():
    """K = 10^6, K' = 10^3 at d = 8: the population appears only as
    (K,)-shaped state, no (T, K) or (K, K) tensor exists; two rounds run
    and record finite rows."""
    k, n = 1_000_000, 2_000_000
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, n)).astype(np.float32)
    y = rng.standard_normal((8,)).astype(np.float32)
    prob = convert.problem_from_numpy("lasso", a, y, 1e-3, device="cpu")
    cfg = tcola.ColaConfig(kappa=1.0,
                           participation=ts.SampleConfig(k_active=1_000))
    assert cfg.participation.resolve_mode(k) == "cohort"
    res = tcola.run_cola(prob, ttopo.implicit_complete(k), cfg, 2,
                         record_every=1, seed=0, device="cpu")
    gaps = np.asarray(res.history["gap"], dtype=np.float64)
    assert gaps.shape == (2,) and np.isfinite(gaps).all()
