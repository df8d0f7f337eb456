"""The port's quantized gossip wire against the JAX reference, on the CPU.

* The codec (``repro_torch.core.quant``): with round-to-nearest, and with
  the reference's own threefry uniforms fed in for stochastic rounding,
  the payload bits and the scales equal the reference's, bitwise, for
  int8, fp8 (e4m3) and fp8_e5m2. The one difference by design (the fp8
  rounding grid's exponent, exact in the port) is pinned.
* The port's own draws (a counter hash, ``core/streams.py``): stochastic
  rounding stays unbiased (a z-bound over a fixed number of draws), and a
  draw is a function of (seed, round, step, node) alone.
* Runs (``run_cola(wire=...)``) against the reference with ``wire_draws``
  replaying the reference's uniforms. Both compute the same codec on fp32
  states that differ in the last bits (products summed in another order),
  so now and then a value lands on the other side of a rounding boundary
  and one payload element moves by one grid step. Each run records a
  probe of the state (a fixed random projection of v) beside its history:
  the rows before the first row where the probes part (a flip) are held to
  the tolerances of ``test_torch_cola.py`` (rtol 1e-4, atol 1e-4 *
  max|primal|), and the final state to fp32 noise when nothing flipped,
  else to one grid step of its row (the row's absmax / 127 for int8, the
  row's absmax * 2^-mantissa bits for fp8) with error feedback — the
  residual takes a flipped step back — and two without (flips are then
  not compensated and may add up). Stop rounds are equal.
* Port against port: loop and block executors, and pipelined and
  unpipelined runs, bitwise.

Fixed cases only: no hypothesis draws.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmet, mixing as jmix, problems as jprob, \
    quant as jq, topology as jtopo
from repro.core.cola import ColaConfig as JConfig, run_cola as j_run
from repro.core.partition import make_partition as j_make_partition
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import cola as tcola, metrics as tmet, \
    mixing as tmix, quant as tq, streams, topology as ttopo
from repro_torch.core.partition import make_partition as t_make_partition

WIRES = ("int8", "fp8", "fp8_e5m2")
MANT = {"int8": None, "fp8": 3, "fp8_e5m2": 2}
HIST = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")
RTOL = 1e-4
# |probe difference| above which a rounding decision has flipped: fp32
# noise keeps the probes within ~5e-6 of each other, a flipped int8/fp8
# step moves them by ~1e-3
PROBE_TOL = 1e-4


def _bits(q):
    return (q.view(torch.uint8).numpy() if torch.is_tensor(q)
            else np.asarray(q).view(np.uint8))


def _rows(seed, k=6, d=37):
    """Seeded rows of assorted magnitudes: an all-zero row, a row of equal
    values, a row rescaled by a power of two."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, d)) * 10.0 ** rng.uniform(-4, 4, (k, 1))
         ).astype(np.float32)
    x[0] = 0.0
    x[1] = -3.25
    x[2] = x[3] * np.float32(2.0 ** -7)
    return x


def _ref_uniforms(key, k, d):
    """The reference's per-node uniforms under a (round, step) key."""
    keys = jq.node_keys(key, jnp.arange(k))
    return np.array(jax.vmap(lambda kk: jax.random.uniform(kk, (d,)))(keys))


def _ref_draws(seed, rounds, k, d):
    """``wire_draws`` replaying the reference's stochastic-rounding
    uniforms of ``run_cola(seed=seed)``."""
    keys = jq.round_keys(seed, rounds + 1)

    @functools.lru_cache(maxsize=None)
    def draws(t, step):
        return torch.as_tensor(_ref_uniforms(jq.step_key(keys[t], step), k, d))

    return draws


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", WIRES)
def test_round_to_nearest_bits_match_reference(wire):
    for seed in range(4):
        x = _rows(seed)
        q_j, s_j = jq.quantize(jnp.asarray(x), wire)
        q_t, s_t = tq.quantize(torch.as_tensor(x), wire)
        assert q_t.dtype == tq.wire_dtype(wire)
        np.testing.assert_array_equal(_bits(q_t), _bits(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(
            tq.dequantize(q_t, s_t).numpy(),
            np.asarray(jq.dequantize(q_j, s_j)))
        # power-of-two rescale: the same payload bits, the scale rescaled
        q2, s2 = tq.quantize(torch.as_tensor(x * np.float32(64.0)), wire)
        np.testing.assert_array_equal(_bits(q2), _bits(q_t))
        live = np.abs(x).max(axis=1) > 0       # a zero row's scale is 1
        np.testing.assert_array_equal(s2.numpy()[live],
                                      s_t.numpy()[live] * 64.0)
        # the same share of saturated elements (an fp32 mean, summed in
        # another order: to 1e-6)
        assert float(tq.saturation_frac(q_t, wire)) == pytest.approx(
            float(jq.saturation_frac(q_j, wire)), rel=1e-6)


@pytest.mark.parametrize("wire", WIRES)
def test_stochastic_rounding_with_reference_uniforms_is_bitwise(wire):
    for t in range(3):
        x = _rows(10 + t)
        key = jq.step_key(jq.round_keys(5, 3)[t], 1)
        q_j, s_j = jq.quantize_rows(jnp.asarray(x), wire, key)
        u = torch.as_tensor(_ref_uniforms(key, *x.shape))
        q_t, s_t = tq.quantize_rows(torch.as_tensor(x), wire, u)
        np.testing.assert_array_equal(_bits(q_t), _bits(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        # and the EF encode built on it
        ef = np.full(x.shape, 0.01, np.float32)
        _, _, deq_j, ef_j = jq.encode(jnp.asarray(x), wire, key, None,
                                      jnp.asarray(ef))
        _, _, deq_t, ef_t = tq.encode(torch.as_tensor(x), wire, u,
                                      torch.as_tensor(ef))
        np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq_j))
        np.testing.assert_array_equal(ef_t.numpy(), np.asarray(ef_j))


def test_fp8_grid_exponent_is_exact_below_a_power_of_two():
    """The one codec difference by design: the reference takes the fp8
    rounding grid's exponent as floor(log2|y|), which XLA's log2 rounds up
    to e + 1 within a few fp32 ulps below 2^e (here just below 8), so its
    grid there is twice as coarse; the port takes the exponent exactly
    (frexp). Both land on fp8 points and both are unbiased."""
    y = np.array([np.nextafter(np.float32(8.0), np.float32(0.0)), 5.0],
                 np.float32)
    u = np.zeros_like(y)
    got = tq._sr_f8_grid(torch.as_tensor(y), torch.as_tensor(u), 3).numpy()
    want = np.asarray(jq._sr_f8_grid(jnp.asarray(y), jnp.asarray(u), 3))
    np.testing.assert_array_equal(got, [7.5, 5.0])
    np.testing.assert_array_equal(want, [7.0, 5.0])


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_port_stream_rounding_is_unbiased(wire):
    """E[dequantize(quantize(x, u))] = x over the port's own draws: the
    mean of n = 4,000 draws (rounds 0..n-1 of seed 0) lies within 5 sigma
    of x, sigma <= grid step / (2 sqrt(n))."""
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((1, 16))
                        .astype(np.float32))
    n = 4000
    draws = tq.wire_uniforms(0, 1, 16, "cpu")
    total = torch.zeros_like(x, dtype=torch.float64)
    for t in range(n):
        q, s = tq.quantize(x, wire, draws(t, 0))
        total += tq.dequantize(q, s).double()
    mean = (total / n).numpy()
    xn = x.numpy().astype(np.float64)
    if wire == "int8":
        step = np.broadcast_to(np.abs(xn).max(-1, keepdims=True) / 127.0,
                               xn.shape)
    else:
        step = np.abs(xn) * 2.0 ** -3 + 1e-6
    assert np.all(np.abs(mean - xn) <= 5.0 * step / (2 * n ** 0.5))


def test_port_stream_is_keyed_by_seed_round_step_node():
    draws = tq.wire_uniforms(3, 8, 50, "cpu")
    a = draws(4, 1)
    assert a.shape == (8, 50) and a.dtype == torch.float32
    assert torch.equal(a, tq.wire_uniforms(3, 8, 50, "cpu")(4, 1))
    # a node's row does not depend on how many nodes there are
    assert torch.equal(a[:4], tq.wire_uniforms(3, 4, 50, "cpu")(4, 1))
    for other in (draws(5, 1), draws(4, 0), tq.wire_uniforms(4, 8, 50,
                                                             "cpu")(4, 1)):
        assert not torch.equal(a, other)
    u = draws(0, 0).numpy().astype(np.float64)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert np.array_equal(u * 2 ** 24, np.floor(u * 2 ** 24))  # 2^-24 grid
    # uniform mean 1/2, sd 1/sqrt(12): within 5 sigma over 400 draws
    assert abs(u.mean() - 0.5) <= 5.0 / np.sqrt(12.0 * u.size)


def test_counter_hash_is_distinct_and_folds_in_order():
    b = streams.bits(streams.fold(1, 2), (1000,), "cpu")
    assert b.unique().numel() == 1000
    assert int(b.min()) >= 0 and int(b.max()) <= streams.M32
    assert streams.fold(streams.fold(7, 1), 2) == streams.fold(7, 1, 2)
    assert streams.fold(7, 1, 2) != streams.fold(7, 2, 1)
    assert streams.fold(0, 0) != 0
    with pytest.raises(ValueError, match=">= 0"):
        streams.fold(1, -1)


def test_wire_names_bytes_and_rejections():
    assert tq.canonical_wire(None) == "fp32"
    assert not tq.is_quantized("fp32") and tq.is_quantized("int8")
    with pytest.raises(ValueError, match="wire="):
        tq.canonical_wire("int4")
    with pytest.raises(ValueError, match="no quantization grid"):
        tq.wire_qmax("fp32")
    for w in tq.WIRES:
        assert tq.wire_itemsize(w) == jq.wire_itemsize(w)
        for d, rows in ((100, 2), (2000, 16)):
            assert tq.payload_bytes(d, w, rows) == jq.payload_bytes(d, w,
                                                                    rows)
        if w != "fp32":
            assert tq.wire_qmax(w) == jq.wire_qmax(w)
    assert tq.payload_bytes(100, "int8", 2) == 2 * (100 + 4)
    v = torch.ones((3, 4))
    out, ef = tq.wire_view(v, None, "fp32")
    assert out is v and ef is None
    assert tq.ef_init(v, "fp32") is None
    assert torch.equal(tq.ef_init(v, "int8"), torch.zeros_like(v))


def test_ef_telescopes_and_residual_bounded():
    """EF sends Q(v + ef) and keeps ef' = (v + ef) - deq, so over T rounds
    sum(deq_t) = sum(v_t) - ef_T, and the residual stays within two grid
    steps (stochastic rounding moves at most one)."""
    rng = np.random.default_rng(5)
    draws = tq.wire_uniforms(0, 3, 20, "cpu")
    ef = tq.ef_init(torch.zeros((3, 20)), "int8")
    total_v = np.zeros((3, 20))
    total_deq = np.zeros((3, 20))
    for t in range(30):
        v = torch.as_tensor(rng.standard_normal((3, 20)).astype(np.float32))
        _, s, deq, ef = tq.encode(v, "int8", draws(t, 0), ef)
        total_v += v.double().numpy()
        total_deq += deq.double().numpy()
        assert np.all(np.abs(ef.numpy()) <= 2.0 * s.numpy() + 1e-6)
    np.testing.assert_allclose(total_deq + ef.double().numpy(), total_v,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("payload", [False, True])
def test_qmix_steps_matches_reference(payload):
    """Two gossip steps over int8 with EF, the reference's uniforms fed in;
    optionally the first step from a pre-encoded payload."""
    k, d = 4, 9
    rng = np.random.default_rng(1)
    v = rng.standard_normal((k, d)).astype(np.float32)
    ef = (0.01 * rng.standard_normal((k, d))).astype(np.float32)
    w = jtopo.metropolis_weights(jtopo.ring(k)).astype(np.float32)
    key = jq.round_keys(2, 1)[0]
    u = {s: torch.as_tensor(_ref_uniforms(jq.step_key(key, s), k, d))
         for s in range(2)}
    pay_j = pay_t = None
    if payload:
        pay_j = jq.quantize(jnp.asarray(v), "int8")
        pay_t = tq.quantize(torch.as_tensor(v), "int8")
    out_j, ef_j = jmix.qmix_steps(jnp.asarray(w), jnp.asarray(v),
                                  jnp.asarray(ef), 2, "int8", key,
                                  payload=pay_j)
    out_t, ef_t = tmix.qmix_steps(torch.as_tensor(w), torch.as_tensor(v),
                                  torch.as_tensor(ef), 2, "int8", u.__getitem__,
                                  payload=pay_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# runs against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ridge():
    x, y, _ = synthetic.regression(150, 48, seed=4)
    return (jprob.ridge_primal(jnp.asarray(x), jnp.asarray(y), 1e-2),
            convert.problem_from_numpy("ridge_primal", x, y, 1e-2,
                                       device="cpu"))


@functools.lru_cache(maxsize=None)
def _lasso():
    x, y, _ = synthetic.regression(200, 24, seed=3, sparsity_solution=0.2)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), lam=5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


def _probe(k, d):
    p = np.random.default_rng(99).standard_normal((k, d)).astype(np.float32)
    return (jmet.FnRecorder(("probe",), lambda s, p=jnp.asarray(p):
                            jnp.sum(s.v_stack * p)[None]),
            tmet.FnRecorder(("probe",), lambda s, p=torch.as_tensor(p):
                            torch.sum(s.v_stack * p)[None]))


def _recorders(ref, port, k, cert_eps=None, sigma=None, graph=None):
    """Both packages' gap recorder (plus the exact-sigma certificate when
    ``cert_eps``) and the state probe, composed."""
    jpart, tpart = j_make_partition(ref.n, k), t_make_partition(port.n, k)
    jp, tp = _probe(k, ref.d)
    j_parts, t_parts = [jmet.GapRecorder(ref, jpart)], \
        [tmet.GapRecorder(port, tpart)]
    if cert_eps is not None:
        from repro.core.cola import build_env as j_env
        j_parts.append(jmet.certificate_recorder(
            ref, jpart, j_env(ref, jpart), graph[0], cert_eps,
            sigma_k=jnp.asarray(sigma)))
        t_parts.append(tmet.certificate_recorder(
            port, tpart, tcola.build_env(port, tpart), graph[1], cert_eps,
            sigma_k=sigma))
    return (jmet.ComposedRecorder(tuple(j_parts) + (jp,)),
            tmet.ComposedRecorder(tuple(t_parts) + (tp,)))


def _grid_step(wire, v):
    am = np.abs(v).max(axis=1, keepdims=True)
    return am / 127.0 if MANT[wire] is None else am * 2.0 ** -MANT[wire]


def _assert_wire_run(got, want, wire, ef, keys=HIST):
    """The comparison the module docstring states."""
    g, w = got.history, want.history
    assert g["round"] == w["round"]
    assert g["stop_round"] == w["stop_round"]
    parted = np.abs(np.asarray(g["probe"]) - np.asarray(w["probe"])) \
        > PROBE_TOL
    first = int(np.argmax(parted)) if parted.any() else len(w["round"])
    atol = 1e-4 * max(abs(v) for v in w["primal"])
    for key in keys:
        np.testing.assert_allclose(g[key][:first], w[key][:first], rtol=RTOL,
                                   atol=atol, err_msg=key)
    gs, ws = got.state, want.state
    v_ref = np.asarray(ws.v_stack)
    if first == len(w["round"]):     # nothing flipped: fp32 noise
        steps = 0.0
    else:
        steps = 1.0 if ef else 2.0
    step = steps * _grid_step(wire, v_ref)
    x_ref = np.asarray(ws.x_parts)
    v_noise = 1e-4 * float(np.abs(v_ref).max())
    # (got, want, fp32 noise, grid steps); the EF residual is a difference
    # of v-sized terms, so its fp32 noise is v's
    pairs = [(gs.v_stack.numpy(), v_ref, v_noise, step),
             (gs.x_parts.numpy(), x_ref, 1e-4 * float(np.abs(x_ref).max()),
              step.max())]
    if ef:
        pairs.append((gs.ef.numpy(), np.asarray(ws.ef), v_noise, step))
    for a, b, noise, s in pairs:
        limit = noise + s
        assert np.all(np.abs(a - b) <= limit), (np.abs(a - b).max(), limit)
    return first


@pytest.mark.parametrize("wire,ef,steps", [
    ("int8", True, 1), ("int8", False, 1), ("fp8", True, 1),
    ("fp8", False, 1), ("fp8_e5m2", True, 1), ("int8", True, 2),
    ("fp8", True, 2)])
def test_quantized_run_matches_reference(wire, ef, steps):
    ref, port = _ridge()
    k, rounds = 8, 30
    j_rec, t_rec = _recorders(ref, port, k)
    cfg = dict(kappa=1.0, wire=wire, error_feedback=ef, gossip_steps=steps)
    want = j_run(ref, jtopo.ring(k), JConfig(**cfg), rounds, record_every=3,
                 recorder=j_rec, seed=3)
    got = tcola.run_cola(port, ttopo.ring(k), tcola.ColaConfig(**cfg), rounds,
                         record_every=3, recorder=t_rec, seed=3,
                         wire_draws=_ref_draws(3, rounds, k, ref.d),
                         device="cpu")
    _assert_wire_run(got, want, wire, ef)


@functools.lru_cache(maxsize=None)
def _exact_sigma(k):
    ref, _ = _lasso()
    from repro.core.cola import build_env as j_env
    a_parts = np.asarray(j_env(ref, j_make_partition(ref.n, k)).a_parts)
    return np.array([np.linalg.norm(a_parts[i], 2) ** 2 for i in range(k)],
                    dtype=np.float32)


def _churn(t, rng):
    return rng.random(4) < 0.7


def _churn_then_all(t, rng):
    return rng.random(4) < 0.7 if t < 12 else np.ones(4, bool)


@pytest.mark.parametrize("executor", ["block", "loop"])
def test_int8_churn_reset_certificate_matches_reference(executor):
    """int8 with EF under churn (rounds 0-11; every node after), leavers
    reset (their EF residual zeroed), the dynamic certificate with eps = 3:
    the stop rounds are equal (round 39 in the reference)."""
    ref, port = _lasso()
    k, rounds = 4, 80
    j_rec, t_rec = _recorders(ref, port, k, cert_eps=3.0,
                              sigma=_exact_sigma(k),
                              graph=(jtopo.ring(k), ttopo.ring(k)))
    kw = dict(record_every=1, active_schedule=_churn_then_all,
              leave_mode="reset", eps=3.0, seed=2)
    want = j_run(ref, jtopo.ring(k), JConfig(kappa=2.0, wire="int8"), rounds,
                 recorder=jmet.dynamize(j_rec), **kw)
    got = tcola.run_cola(port, ttopo.ring(k),
                         tcola.ColaConfig(kappa=2.0, wire="int8"), rounds,
                         recorder=t_rec, executor=executor,
                         wire_draws=_ref_draws(2, rounds, k, ref.d),
                         device="cpu", block_size=16, **kw)
    assert want.history["stop_round"] is not None
    _assert_wire_run(got, want, "int8", True,
                     keys=HIST + ("local_gap_max", "cond9_nodes",
                                  "cond10_nodes", "certified"))


@pytest.mark.parametrize("kw", [
    dict(wire="int8"), dict(wire="fp8", error_feedback=False),
    dict(wire="fp8_e5m2", gossip_steps=2),
    dict(wire="int8", pipeline=True)])
def test_loop_and_block_bitwise_on_the_wire(kw):
    _, port = _lasso()
    sched = dict(active_schedule=_churn, budget_schedule=lambda t, rng:
                 rng.integers(1, 10, 4))
    runs = [tcola.run_cola(port, ttopo.ring(4), tcola.ColaConfig(kappa=2.0,
                                                                 **kw),
                           30, record_every=4, recorder="gap+certificate",
                           eps=0.2, executor=ex, block_size=8, seed=1,
                           device="cpu", **sched)
            for ex in ("loop", "block")]
    assert runs[0].history == runs[1].history
    _assert_states_bitwise(runs[0].state, runs[1].state)


def _assert_states_bitwise(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _assert_states_bitwise(x, y)
        else:
            assert (x is None and y is None) or np.array_equal(_bits(x),
                                                               _bits(y))


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("wire", WIRES)
def test_pipeline_is_bitwise_the_unpipelined_run(wire, steps):
    """Pipelining only moves round t+1's first encode to the end of round
    t, with round t+1's draws: x, v and the history are bitwise the
    unpipelined run's, and the pipelined state's payload and residual are
    what the unpipelined run would encode next."""
    _, port = _lasso()
    kw = dict(record_every=5, recorder="gap+certificate", eps=0.2, seed=4,
              active_schedule=_churn, device="cpu")
    base = tcola.run_cola(port, ttopo.ring(4),
                          tcola.ColaConfig(kappa=2.0, wire=wire,
                                           gossip_steps=steps), 25, **kw)
    piped = tcola.run_cola(port, ttopo.ring(4),
                           tcola.ColaConfig(kappa=2.0, wire=wire,
                                            gossip_steps=steps,
                                            pipeline=True), 25, **kw)
    assert base.history == piped.history
    _assert_states_bitwise(base.state[:2], piped.state[:2])
    u = tq.wire_uniforms(4, 4, port.d, "cpu")(25, 0)
    q, s, _, ef = tq.encode(base.state.v_stack, wire, u, base.state.ef)
    _assert_states_bitwise((q, s, ef), (*piped.state.buf, piped.state.ef))


@pytest.mark.parametrize("mode", ["dense", "cohort"])
def test_sampled_int8_run_matches_reference_churn_run(mode):
    """Client sampling composed with the int8 wire (dense mode; cohort
    mode rejects a quantized wire, as the reference does): the
    reference's churn run on complete(K), fed the port's participation
    draws as its (T, K) schedule and its own SR uniforms, against the
    port's participation run with those uniforms."""
    from repro_torch.core import schedule as ts
    ref, port = _ridge()
    k, rounds, seed = 8, 24, 6
    sample = ts.SampleConfig(k_active=3, mode=mode)
    cfg = tcola.ColaConfig(kappa=1.0, wire="int8", participation=sample)
    if mode == "cohort":
        with pytest.raises(NotImplementedError, match="wire="):
            tcola.run_cola(port, ttopo.complete(k), cfg, rounds,
                           device="cpu")
        return
    draw = ts.participation_callable(k, sample, seed)
    active = np.stack([draw(t, None) for t in range(rounds)])
    j_rec, t_rec = _recorders(ref, port, k)
    want = j_run(ref, jtopo.complete(k), JConfig(kappa=1.0, wire="int8"),
                 rounds, record_every=3, recorder=j_rec,
                 active_schedule=active, seed=seed)
    got = tcola.run_cola(port, ttopo.complete(k), cfg, rounds,
                         record_every=3, recorder=t_rec, seed=seed,
                         wire_draws=_ref_draws(seed, rounds, k, ref.d),
                         device="cpu")
    _assert_wire_run(got, want, "int8", True)


def test_wire_config_rejections_match_reference():
    ref, port = _ridge()
    cases = [
        (dict(kappa=1.0, pipeline=True), {}, ValueError),
        (dict(kappa=1.0, wire="int8", grad_mode="mixed"), {},
         NotImplementedError),
        (dict(kappa=1.0, wire="int8", pipeline=True),
         dict(active_schedule=lambda t, rng: rng.random(8) < 0.7,
              leave_mode="reset"), NotImplementedError),
        (dict(kappa=1.0, wire="int4"), {}, ValueError)]
    for cfg, kw, exc in cases:
        with pytest.raises(exc):
            j_run(ref, jtopo.ring(8), JConfig(**cfg), 4, **kw)
        with pytest.raises(exc):
            tcola.run_cola(port, ttopo.ring(8), tcola.ColaConfig(**cfg), 4,
                           device="cpu", **kw)


def test_reset_zeroes_the_leavers_residual():
    _, port = _lasso()
    part = t_make_partition(port.n, 4)
    rng = np.random.default_rng(0)
    state = convert.state_from_numpy(
        rng.standard_normal((4, part.block)).astype(np.float32),
        rng.standard_normal((4, port.d)).astype(np.float32), device="cpu",
        ef=rng.standard_normal((4, port.d)).astype(np.float32))
    leavers = torch.tensor([True, False, False, True])
    out = tcola._reset_leavers(state, tcola.build_env(port, part), leavers)
    assert not out.ef[leavers].any()
    assert torch.equal(out.ef[~leavers], state.ef[~leavers])


def test_convert_carries_the_references_wire_state():
    """A pipelined reference run's state (EF residual and the fp8 payload
    in flight) crosses into the port and back bit for bit."""
    ref, _ = _ridge()
    want = j_run(ref, jtopo.ring(8),
                 JConfig(kappa=1.0, wire="fp8", pipeline=True), 3)
    st = want.state
    q, s = st.buf
    port_state = convert.state_from_numpy(
        st.x_parts, st.v_stack, ef=st.ef, buf=(np.asarray(q).view(np.uint8),
                                               s),
        wire="fp8", device="cpu")
    assert port_state.buf[0].dtype == torch.float8_e4m3fn
    x, v, ef, (bits, scale) = convert.state_to_numpy(port_state)
    np.testing.assert_array_equal(bits, np.asarray(q).view(np.uint8))
    np.testing.assert_array_equal(scale, np.asarray(s))
    np.testing.assert_array_equal(ef, np.asarray(st.ef))
    np.testing.assert_array_equal(
        tq.dequantize(*port_state.buf).numpy(),
        np.asarray(jq.dequantize(q, s)))
    with pytest.raises(ValueError, match="buf="):
        convert.state_from_numpy(x, v, buf=(bits, scale), device="cpu")
