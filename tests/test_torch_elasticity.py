"""The port's elasticity against the JAX reference, on the CPU: node churn
(``active_schedule``) with leavers that freeze or reset, per-node CD
budgets under churn (heterogeneous Theta_k), and the dynamic certificates.

The schedules draw from ``numpy.random.default_rng(seed)`` in both
packages, so the same callables give both the same rounds. Histories are
compared column by column with rtol=1e-4 and atol=1e-4 * max|primal| (fp32
runs of the same algorithm whose products sum in another order),
``stop_round`` exactly; the certificate helpers' masks exactly and their
thresholds at rtol=1e-6 (the same float64 formula on the same float32
inputs). The port's two executors are compared bitwise.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cola as jcola, metrics as jmet, problems as jprob, \
    topology as jtopo
from repro.core.partition import make_partition as j_make_partition
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import cola as tcola, executor as texec, \
    metrics as tmet, topology as ttopo
from repro_torch.core.partition import make_partition as t_make_partition

RTOL = 1e-4
K = 4
HIST = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")


def _assert_history(got, want, keys=HIST):
    assert got["round"] == want["round"]
    assert got["stop_round"] == want["stop_round"]
    atol = 1e-4 * max(abs(v) for v in want["primal"])
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=atol,
                                   err_msg=key)


@functools.lru_cache(maxsize=None)
def _lasso():
    x, y, _ = synthetic.regression(200, 24, seed=3, sparsity_solution=0.2)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), lam=5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


@functools.lru_cache(maxsize=None)
def _exact_sigma():
    ref, _ = _lasso()
    a_parts = np.asarray(jcola.build_env(ref, j_make_partition(ref.n, K))
                         .a_parts)
    return np.array([np.linalg.norm(a_parts[i], 2) ** 2 for i in range(K)],
                    dtype=np.float32)


def _recorders(kind, eps=0.2):
    """Both packages' recorder for ``kind``: "gap", or gap+certificate
    certifying ``eps`` with the exact sigma_k (the two power iterations
    start from different random vectors)."""
    ref, port = _lasso()
    if kind == "gap":
        return "gap", "gap"
    jpart, tpart = j_make_partition(ref.n, K), t_make_partition(port.n, K)
    sigma = _exact_sigma()
    j_cert = jmet.certificate_recorder(
        ref, jpart, jcola.build_env(ref, jpart), jtopo.ring(K), eps,
        sigma_k=jnp.asarray(sigma))
    t_cert = tmet.certificate_recorder(
        port, tpart, tcola.build_env(port, tpart), ttopo.ring(K), eps,
        sigma_k=sigma)
    return (jmet.ComposedRecorder((jmet.GapRecorder(ref, jpart), j_cert)),
            tmet.ComposedRecorder((tmet.GapRecorder(port, tpart), t_cert)))


def _churn(t, rng):
    return rng.random(K) < 0.7


def _budgets(t, rng):
    return rng.integers(0, 9, size=K)


def _stay_masks(rounds, k, p_stay, seed=0):
    """``benchmarks/fig4_fault.py``'s ``_stay_masks`` recipe."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(k) < p_stay for _ in range(rounds)])


def _straggler_budgets(rounds, k, full, seed=0):
    """``benchmarks/fig4_fault.py``'s ``_straggler_budgets`` recipe."""
    rng = np.random.default_rng(seed)
    out = np.full((rounds, k), full, np.int32)
    for t in range(rounds):
        out[t, rng.random(k) < 0.5] = max(full // 4, 1)
    return out


def _blackout(t, rng):
    """Churn with rounds where every node is out (run as all-active)."""
    mask = rng.random(K) < 0.6
    return np.zeros(K, bool) if t % 7 == 3 else mask


SCHEDULES = {
    "callable": dict(active_schedule=_churn, budget_schedule=_budgets),
    "array": dict(active_schedule=_stay_masks(200, K, 0.8),
                  budget_schedule=_straggler_budgets(200, K, 12, seed=1)),
    "blackout": dict(active_schedule=_blackout),
}


@functools.lru_cache(maxsize=None)
def _reference(schedule, leave_mode, kind, rounds, record_every):
    ref, _ = _lasso()
    rec, _ = _recorders(kind)
    return jcola.run_cola(ref, jtopo.ring(K), jcola.ColaConfig(kappa=4.0),
                          rounds, record_every=record_every, recorder=rec,
                          leave_mode=leave_mode, seed=3,
                          **SCHEDULES[schedule])


def _port(schedule, leave_mode, kind, rounds, record_every, executor):
    _, port = _lasso()
    _, rec = _recorders(kind)
    return tcola.run_cola(port, ttopo.ring(K), tcola.ColaConfig(kappa=4.0),
                          rounds, record_every=record_every, recorder=rec,
                          leave_mode=leave_mode, seed=3, executor=executor,
                          block_size=16, device="cpu", **SCHEDULES[schedule])


@pytest.mark.parametrize("kind", ["gap", "cert"])
@pytest.mark.parametrize("leave_mode", ["freeze", "reset"])
@pytest.mark.parametrize("executor", ["block", "loop"])
def test_churn_with_budgets_matches_reference(executor, leave_mode, kind):
    """Callable churn and budgets share the rng: this pins the interleaved
    draw order (active, then budget, in each round). The certified freeze
    run stops, at the reference's round."""
    want = _reference("callable", leave_mode, kind, 300, 5)
    got = _port("callable", leave_mode, kind, 300, 5, executor)
    if (kind, leave_mode) == ("cert", "freeze"):
        assert want.history["stop_round"] is not None
    _assert_history(got.history, want.history)
    if kind == "cert":
        for key in ("cond9_nodes", "cond10_nodes", "certified"):
            assert got.history[key] == want.history[key], key


@pytest.mark.parametrize("leave_mode", ["freeze", "reset"])
@pytest.mark.parametrize("executor", ["block", "loop"])
def test_fig4_array_schedules_match_reference(executor, leave_mode):
    """The (T, K) array forms (fig4's recipes) take no draw from the rng."""
    want = _reference("array", leave_mode, "gap", 200, 10)
    got = _port("array", leave_mode, "gap", 200, 10, executor)
    _assert_history(got.history, want.history)


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_round_with_every_node_out_runs_all_active(executor):
    want = _reference("blackout", "reset", "gap", 60, 3)
    got = _port("blackout", "reset", "gap", 60, 3, executor)
    _assert_history(got.history, want.history)


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_adaptive_cadence_under_churn_matches_reference(executor):
    want = _reference("callable", "freeze", "cert", 300, "adaptive")
    got = _port("callable", "freeze", "cert", 300, "adaptive", executor)
    assert want.history["stop_round"] is not None
    _assert_history(got.history, want.history)


def _certs():
    """Both packages' bare certificate recorders (exact sigma_k)."""
    j_rec, t_rec = _recorders("cert")
    return j_rec.parts[1], t_rec.parts[1]


@pytest.mark.parametrize("drop", [(), (1,), (0, 2), (0, 1, 2)])
def test_certificate_round_inputs_match_reference(drop):
    j_cert, t_cert = _certs()
    graph = ttopo.ring(K)
    active = np.ones(K, bool)
    active[list(drop)] = False
    w_t = ttopo.reweight_for_active(graph, active).astype(np.float32)
    j_mask, j_thr = jmet.certificate_round_inputs(j_cert, jnp.asarray(w_t),
                                                  active)
    t_mask, t_thr = tmet.certificate_round_inputs(t_cert, w_t, active)
    np.testing.assert_array_equal(t_mask, np.asarray(j_mask))
    np.testing.assert_allclose(t_thr, j_thr, rtol=1e-6)
    if not drop:   # no churn: the static graph's mask and threshold
        np.testing.assert_array_equal(t_mask,
                                      t_cert.neigh_mask.numpy() > 0)
        np.testing.assert_allclose(t_thr, t_cert.grad_thresh, rtol=1e-6)


def test_certificate_schedule_matches_reference():
    j_cert, t_cert = _certs()
    rounds = 12
    sched = tcola._materialize_schedule(
        ttopo.ring(K), rounds, tcola._as_schedule_fn(
            _stay_masks(rounds, K, 0.6), rounds, K, "active"),
        None, "freeze", 0, ttopo.metropolis_weights(ttopo.ring(K)),
        np.float32)
    record = texec.record_flags(rounds, 5)
    got = tmet.certificate_schedule(t_cert, sched["w"], sched["active"],
                                    record)
    want = jmet.certificate_schedule(j_cert, sched["w"], sched["active"],
                                     record)
    np.testing.assert_array_equal(got["cert_mask"], want["cert_mask"])
    np.testing.assert_allclose(got["cert_grad_thresh"],
                               want["cert_grad_thresh"], rtol=1e-6)
    assert not got["cert_mask"][~record].any()


def test_dynamize_reaches_every_certificate_part():
    _, t_rec = _recorders("cert")
    dyn = tmet.dynamize(t_rec)
    assert dyn.uses_schedule and not t_rec.uses_schedule
    assert tmet.first_certificate(dyn).dynamic
    assert tmet.dynamize(t_rec.parts[0]) is t_rec.parts[0]


def _mid_run_state(port, rng):
    """A state that satisfies Lemma 1: (1/K) sum_k v_k = A x."""
    part = t_make_partition(port.n, K)
    assert part.pad_width() == 0
    x_parts = (0.3 * rng.normal(size=(K, part.block))).astype(np.float32)
    noise = (0.1 * rng.normal(size=(K, port.d))).astype(np.float32)
    ax = port.a.numpy() @ x_parts.reshape(-1)[:port.n]
    v_stack = noise - noise.mean(axis=0) + ax[None, :]
    return part, x_parts, v_stack.astype(np.float32)


@pytest.mark.parametrize("leavers", [(0,), (1, 3), (0, 1, 2, 3)])
def test_reset_holds_the_lemma1_invariant(leavers):
    ref, port = _lasso()
    part, x_parts, v_stack = _mid_run_state(port, np.random.default_rng(4))
    mask = np.zeros(K, bool)
    mask[list(leavers)] = True
    env = tcola.build_env(port, part)
    out = tcola._reset_leavers(
        convert.state_from_numpy(x_parts, v_stack, device="cpu"), env,
        torch.as_tensor(mask))
    x_new, v_new = convert.state_to_numpy(out)
    assert not x_new[mask].any()
    np.testing.assert_array_equal(x_new[~mask], x_parts[~mask])
    ax_new = port.a.numpy() @ x_new.reshape(-1)[:port.n]
    np.testing.assert_allclose(v_new.mean(axis=0), ax_new, atol=1e-5)
    # and as the reference resets
    j_out = jcola._reset_leavers(
        jcola.ColaState(jnp.asarray(x_parts), jnp.asarray(v_stack)),
        jcola.build_env(ref, j_make_partition(ref.n, K)), part, mask)
    np.testing.assert_array_equal(x_new, np.asarray(j_out.x_parts))
    np.testing.assert_allclose(v_new, np.asarray(j_out.v_stack), atol=1e-5)


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_reset_runs_exactly_on_rounds_with_leavers(executor, monkeypatch):
    """The driver resets before exactly the rounds whose mask drops a node
    that was active the round before (round 0 counts all as active), with
    exactly those leavers, and never under freeze."""
    _, port = _lasso()
    rounds = 40
    active = _stay_masks(rounds, K, 0.8, seed=5)
    active[9] = False                          # every node out: all active
    calls = []
    real = tcola._reset_leavers

    def spy(state, env, leavers):
        calls.append(leavers.numpy().copy())
        return real(state, env, leavers)

    monkeypatch.setattr(tcola, "_reset_leavers", spy)
    want, prev = [], np.ones(K, bool)
    for row in active:
        row = row if row.any() else np.ones(K, bool)
        if (prev & ~row).any():
            want.append(prev & ~row)
        prev = row
    assert 0 < len(want) < rounds
    for mode, expect in (("reset", want), ("freeze", [])):
        calls.clear()
        tcola.run_cola(port, ttopo.ring(K), tcola.ColaConfig(kappa=1.0),
                       rounds, record_every=10, active_schedule=active,
                       leave_mode=mode, executor=executor, block_size=8,
                       device="cpu")
        assert len(calls) == len(expect)
        for got_mask, want_mask in zip(calls, expect):
            np.testing.assert_array_equal(got_mask, want_mask)


def test_host_entries_stay_on_the_host():
    """Entries named in ``host_entries`` reach the round body as numpy
    values (a branch on them needs no device sync); the others as tensors."""
    seen = []

    def step(state, _ctx, s_t):
        seen.append((type(s_t["flag"]), torch.is_tensor(s_t["inc"])))
        return state + s_t["inc"] if s_t["flag"] else state

    sched = {"flag": np.array([True, False, True, True, False]),
             "inc": np.arange(5, dtype=np.float32)}
    res = texec.run_round_blocks(step, torch.zeros(()), sched, block_size=2,
                                 host_entries=("flag",))
    assert float(res.state) == 0.0 + 2.0 + 3.0
    assert seen == [(np.bool_, True)] * 5


def test_unknown_leave_mode_raises():
    _, port = _lasso()
    with pytest.raises(ValueError, match="leave_mode"):
        tcola.run_cola(port, ttopo.ring(K), tcola.ColaConfig(), 2,
                       leave_mode="drop", device="cpu")
