"""The port's attack harness (``repro_torch.attack``), the attack paths of
its drivers and the honest-cohort certificate against the JAX reference,
on the CPU.

* Schedules: both packages draw node sets and random payload directions
  from ``numpy.random.default_rng``, so every stacked entry (``atk_coef``,
  ``atk_bias_coef``, ``atk_bias``, ``atk_work``, ``atk_dishonest``, the
  rewritten W) and every streamed row equal the reference's bitwise.
* Runs (``run_cola(attacks=..., robust=...)``): history columns within
  rtol 1e-4 and atol 1e-4 * max|column| (fp32 runs of the same algorithm
  whose products sum in another order), and ``stop_round`` /
  ``violated_round`` equal. The Lemma-1 residual of an honest run is fp32
  noise of sums taken in another order (~1e-7 to 1e-6, relative): it is
  held to atol 1e-5 at least, far inside the 1e-2 it certifies at. An
  undefended Byzantine run grows without bound (about 100x per record
  interval), so both packages amplify their last-bit differences
  geometrically: its rows are compared through the first violated row.
* The quantized wire composed with attacks and trim: the reference's
  stochastic-rounding uniforms fed in (``wire_draws=``), held to the
  flip-aware tolerance of ``test_torch_quant.py``.
* Taps, ``attackify`` rows, the audit helpers and robust DGD / DIGing
  against the reference; rejections as the reference raises them.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import attack as ja
from repro.core import baselines as jbl, problems as jprob, \
    topology as jtopo
from repro.core.cola import ColaConfig as JConfig, run_cola as j_run
from repro.data import synthetic
from repro_torch import attack as ta, convert
from repro_torch.core import baselines as tbl, cola as tcola, \
    schedule as tsched, topology as ttopo
from test_torch_quant import _assert_wire_run, _recorders, _ref_draws

RTOL = 1e-4
# columns at fp32 noise in an honest run: an absolute floor
NOISE = {"consensus_residual": 1e-5}
HIST = ("primal", "dual", "gap", "consensus_violation")
CERT = ("local_gap_max", "grad_disagreement_max", "cond9_nodes",
        "cond10_nodes", "certified", "consensus_residual",
        "certificate_violated")


@functools.lru_cache(maxsize=None)
def _lasso():
    x, y, _ = synthetic.regression(48, 24, seed=0)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), 5e-2, box=5.0),
            convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                       device="cpu"))


def _assert_history(got, want, keys=HIST, upto=None):
    g, w = got.history, want.history
    assert g["stop_round"] == w["stop_round"]
    assert g.get("violated_round") == w.get("violated_round")
    assert g["round"] == w["round"]
    n = len(w["round"]) if upto is None else upto
    for key in keys:
        b = np.asarray(w[key][:n])
        np.testing.assert_allclose(
            g[key][:n], b, rtol=RTOL,
            atol=max(RTOL * float(np.max(np.abs(b))), NOISE.get(key, 0.0)),
            err_msg=key)


def _ctx(pkg, k=8, rounds=10, d=6, seed=0):
    graph = (jtopo if pkg is ja else ttopo).connected_cycle(k, 2)
    kw = {} if pkg is ja else dict(device="cpu")
    return pkg.AttackContext(graph=graph, rounds=rounds, k=k, d=d,
                             dtype=np.float32, seed=seed, **kw)


def _sched(ctx, churn=False):
    w = jtopo.metropolis_weights(jtopo.connected_cycle(ctx.k, 2)) \
        .astype(np.float32)
    w = np.broadcast_to(w, (ctx.rounds,) + w.shape)
    if churn:
        w = np.array(w)
        w[3] = np.eye(ctx.k, dtype=np.float32)
    return {"w": w}


def _scenarios(pkg):
    """Scenario lists of both packages, built from the same arguments."""
    return [
        [pkg.Byzantine(nodes=(2, 5), mode="sign_flip", scale=3.0, start=4,
                       stop=8)],
        [pkg.Byzantine(nodes=(1,), mode="scale", scale=0.5)],
        [pkg.Byzantine(nodes=(1, 6), mode="random", scale=2.0, seed=7,
                       start=2)],
        [pkg.Byzantine(fraction=0.25, seed=3, mode="random", start=1),
         pkg.Byzantine(nodes=(0,), mode="random", seed=4, stop=5),
         pkg.FreeRider(nodes=(0, 4), stale=True, start=3)],
        [pkg.FreeRider(nodes=(3,)), pkg.Eavesdropper(nodes=(3, 0)),
         pkg.Eavesdropper(nodes=(0,))],
        [pkg.LinkCorruption(edges=((0, 1), (2, 1)), scale=0.0, start=2),
         pkg.Byzantine(nodes=(7,), stop=3)],
        [pkg.scenario("free_rider", nodes=(2,), stop=4),
         pkg.scenario("byzantine", fraction=0.3, seed=11)],
    ]


# ---------------------------------------------------------------- scenarios

def test_registry_matches_reference():
    assert sorted(ta.SCENARIOS) == sorted(ja.SCENARIOS)
    assert ta.ATTACK_ENTRY_NAMES == ja.ATTACK_ENTRY_NAMES
    byz = ta.scenario("byzantine", nodes=(1, 3), mode="scale", scale=2.0)
    assert isinstance(byz, ta.Byzantine) and byz.nodes == (1, 3)
    assert repr(byz) == repr(ja.scenario("byzantine", nodes=(1, 3),
                                         mode="scale", scale=2.0))
    with pytest.raises(ValueError, match="unknown attack scenario"):
        ta.scenario("not_a_scenario")


@pytest.mark.parametrize("bad,exc,match", [
    (lambda p: p.Byzantine(nodes=(99,)), ValueError, "out of range"),
    (lambda p: p.Byzantine(nodes=(0,), mode="nope"), ValueError,
     "unknown Byzantine mode"),
    (lambda p: p.Byzantine(nodes=(0,), start=8, stop=2), ValueError,
     "round window"),
    (lambda p: p.Byzantine(), ValueError, "need nodes= or fraction="),
    (lambda p: p.LinkCorruption(edges=((2, 2),)), ValueError, "self term"),
    (lambda p: p.LinkCorruption(edges=((0, 9),)), ValueError,
     "out of range"),
    (lambda p: p.Eavesdropper(nodes=(8,)), ValueError, "out of range"),
    (lambda p: "byzantine", TypeError, "not an attack scenario")])
def test_scenario_validation_errors_match_reference(bad, exc, match):
    for pkg in (ja, ta):
        ctx = _ctx(pkg)
        with pytest.raises(exc, match=match):
            pkg.apply_attacks(_sched(ctx), [bad(pkg)], ctx)


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("case", range(7))
def test_stacked_schedules_are_bitwise_the_references(case, churn):
    want, jinfo = ja.apply_attacks(_sched(_ctx(ja), churn),
                                   _scenarios(ja)[case], _ctx(ja))
    got, tinfo = ta.apply_attacks(_sched(_ctx(ta), churn),
                                  _scenarios(ta)[case], _ctx(ta))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for field in ("token", "entry_names", "tap_nodes", "w_modified"):
        assert getattr(tinfo, field) == getattr(jinfo, field), field


@pytest.mark.parametrize("case", [0, 1, 2, 3, 6])
def test_streamed_rows_are_bitwise_the_references(case):
    ctx_t = _ctx(ta)
    jpart, jinfo = ja.streamed_attacks(_scenarios(ja)[case], _ctx(ja))
    tpart, tinfo = ta.streamed_attacks(_scenarios(ta)[case], ctx_t)
    stacked, _ = ta.apply_attacks(_sched(ctx_t), _scenarios(ta)[case], ctx_t)
    for field in ("token", "entry_names", "tap_nodes", "w_modified"):
        assert getattr(tinfo, field) == getattr(jinfo, field), field
    for t in range(ctx_t.rounds):
        want, got = jpart(t), tpart(t)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]),
                                          err_msg=f"{name} round {t}")
            np.testing.assert_array_equal(got[name].numpy(),
                                          stacked[name][t])


def test_streamed_attacks_reject_recording_and_rewriting_scenarios():
    for atk in (ta.LinkCorruption(edges=((0, 1),)),
                ta.Eavesdropper(nodes=(0,))):
        with pytest.raises(NotImplementedError, match="no streamable"):
            ta.streamed_attacks([atk], _ctx(ta))


def test_streamed_participation_run_is_bitwise_the_materialized_one():
    """Client sampling over complete(8) with streamed Byzantine (random
    payloads) and free-rider parts: the streamed run and the same run with
    every part materialized up front agree bitwise."""
    _, port = _lasso()
    atk = [ta.Byzantine(nodes=(1, 6), mode="random", scale=0.5, seed=2,
                        start=3),
           ta.FreeRider(nodes=(4,), stale=True, stop=9)]
    runs = [tcola.run_cola(
        port, ttopo.complete(8), tcola.ColaConfig(
            kappa=2.0, robust="trim", participation=tsched.SampleConfig(
                k_active=5, mode="dense", stream=stream)), 16,
        record_every=3, recorder="gap+certificate", eps=0.5, attacks=atk,
        block_size=8, device="cpu") for stream in (True, False)]
    assert runs[0].history == runs[1].history
    for a, b in zip(runs[0].state[:2], runs[1].state[:2]):
        assert torch.equal(a, b)


# ---------------------------------------------------- runs against run_cola

def test_undefended_detected_trim_certified():
    """The reference's end-to-end story on torus_2d(4, 4): an undefended
    sign flip trips the honest-cohort certificate, trim certifies within
    2x the clean round count, and the port's runs match the reference's
    (the undefended one through its first violated row)."""
    ref, port = _lasso()
    kw = dict(rounds=600, record_every=20, recorder="gap+certificate",
              eps=1.0)
    runs = {}
    for name, robust, atk in (("clean", None, False),
                              ("undefended", None, True),
                              ("trim", "trim", True)):
        args = dict(nodes=(0, 10), mode="sign_flip", scale=10.0, start=5,
                    seed=1)
        want = j_run(ref, jtopo.torus_2d(4, 4), JConfig(kappa=2.0,
                                                        robust=robust),
                     attacks=[ja.Byzantine(**args)] if atk else None, **kw)
        got = tcola.run_cola(port, ttopo.torus_2d(4, 4),
                             tcola.ColaConfig(kappa=2.0, robust=robust),
                             attacks=[ta.Byzantine(**args)] if atk else None,
                             device="cpu", **kw)
        upto = None
        if want.history["violated_round"] is not None:
            upto = want.history["round"].index(
                want.history["violated_round"]) + 1
        _assert_history(got, want, HIST + CERT, upto=upto)
        runs[name] = got.history
    assert runs["clean"]["stop_round"] is not None
    assert runs["clean"]["violated_round"] is None
    assert runs["undefended"]["violated_round"] is not None
    assert runs["trim"]["violated_round"] is None
    assert runs["trim"]["stop_round"] <= 2 * runs["clean"]["stop_round"]


@pytest.mark.parametrize("robust", [None, "median", "clip"])
def test_free_rider_run_matches_reference(robust):
    ref, port = _lasso()
    kw = dict(rounds=30, record_every=5)
    want = j_run(ref, jtopo.connected_cycle(8, 2),
                 JConfig(kappa=2.0, robust=robust),
                 attacks=[ja.FreeRider(nodes=(2,)),
                          ja.FreeRider(nodes=(5,), stale=True, start=10)],
                 **kw)
    got = tcola.run_cola(port, ttopo.connected_cycle(8, 2),
                         tcola.ColaConfig(kappa=2.0, robust=robust),
                         attacks=[ta.FreeRider(nodes=(2,)),
                                  ta.FreeRider(nodes=(5,), stale=True,
                                               start=10)],
                         device="cpu", **kw)
    _assert_history(got, want)
    assert torch.all(got.state.x_parts[2] == 0.0)
    x_ref = np.asarray(want.state.x_parts)
    np.testing.assert_allclose(got.state.x_parts.numpy(), x_ref, rtol=0,
                               atol=RTOL * np.abs(x_ref).max())


def test_identity_link_corruption_is_bitwise_clean():
    """scale=1.0 rewrites the W stack with the same values: bitwise the
    clean run, and the reference's run within the run tolerance."""
    ref, port = _lasso()
    cfg = tcola.ColaConfig(kappa=2.0)
    graph = ttopo.connected_cycle(8, 2)
    clean = tcola.run_cola(port, graph, cfg, 12, record_every=4,
                           device="cpu")
    noop = tcola.run_cola(port, graph, cfg, 12, record_every=4,
                          attacks=[ta.LinkCorruption(edges=((0, 1),),
                                                     scale=1.0)],
                          device="cpu")
    assert clean.history == noop.history
    for a, b in zip(clean.state[:2], noop.state[:2]):
        assert torch.equal(a, b)
    want = j_run(ref, jtopo.connected_cycle(8, 2), JConfig(kappa=2.0), 12,
                 record_every=4,
                 attacks=[ja.LinkCorruption(edges=((0, 1),), scale=0.0,
                                            start=3)])
    got = tcola.run_cola(port, graph, cfg, 12, record_every=4,
                         attacks=[ta.LinkCorruption(edges=((0, 1),),
                                                    scale=0.0, start=3)],
                         device="cpu")
    _assert_history(got, want)


def test_eavesdropper_taps_record_wire_payloads():
    ref, port = _lasso()
    graph = ttopo.connected_cycle(8, 2)
    cfg = tcola.ColaConfig(kappa=2.0)
    tap = ta.Eavesdropper(nodes=(3, 0))
    byz = ta.Byzantine(nodes=(3,), mode="sign_flip", scale=2.0, start=4)
    clean = tcola.run_cola(port, graph, cfg, 8, record_every=4,
                           attacks=[tap], device="cpu")
    lied = tcola.run_cola(port, graph, cfg, 8, record_every=4,
                          attacks=[tap, byz], device="cpu")
    assert clean.taps.shape == (8, 2, port.d)
    assert torch.equal(lied.taps[:4], clean.taps[:4])
    assert torch.equal(lied.taps[4, 0], -2.0 * clean.taps[4, 0])
    assert torch.equal(lied.taps[4, 1], clean.taps[4, 1])
    want = j_run(ref, jtopo.connected_cycle(8, 2), JConfig(kappa=2.0), 8,
                 record_every=4,
                 attacks=[ja.Eavesdropper(nodes=(3, 0)),
                          ja.Byzantine(nodes=(3,), mode="sign_flip",
                                       scale=2.0, start=4)])
    taps = np.asarray(want.taps)
    np.testing.assert_allclose(lied.taps.numpy(), taps, rtol=0,
                               atol=RTOL * np.abs(taps).max())


def test_taps_under_early_stop_have_the_references_shape():
    """A run that certifies stops mid-block: the taps hold every round of
    the executed blocks, zeros after the stop round, as the reference's."""
    ref, port = _lasso()
    kw = dict(rounds=400, record_every=10, recorder="gap+certificate",
              eps=1.0, block_size=16)
    want = j_run(ref, jtopo.torus_2d(4, 4), JConfig(kappa=2.0), **kw,
                 attacks=[ja.Eavesdropper(nodes=(5,))])
    got = tcola.run_cola(port, ttopo.torus_2d(4, 4),
                         tcola.ColaConfig(kappa=2.0), device="cpu", **kw,
                         attacks=[ta.Eavesdropper(nodes=(5,))])
    stop = want.history["stop_round"]
    assert stop is not None and got.history["stop_round"] == stop
    assert tuple(got.taps.shape) == np.asarray(want.taps).shape
    assert not got.taps[stop + 1:].any()
    taps = np.asarray(want.taps)
    np.testing.assert_allclose(got.taps.numpy(), taps, rtol=0,
                               atol=RTOL * np.abs(taps).max())


@pytest.mark.parametrize("wire,robust", [("int8", "trim"),
                                         ("fp8", "median"),
                                         ("int8", None)])
def test_quantized_wire_with_attacks_matches_reference(wire, robust):
    """A quantized wire with EF, a random-payload Byzantine and a sign
    flip, defended or not: the lie is encoded with the honest encode's
    draws (the reference's uniforms fed in), the gate judges the
    dequantized rows."""
    ref, port = _lasso()
    k, rounds = 8, 30
    j_rec, t_rec = _recorders(ref, port, k)
    atk = lambda p: [p.Byzantine(nodes=(2,), mode="random", scale=0.3,
                                 seed=5, start=4),
                     p.Byzantine(nodes=(6,), scale=5.0, start=8)]
    cfg = dict(kappa=2.0, wire=wire, robust=robust)
    want = j_run(ref, jtopo.connected_cycle(k, 2), JConfig(**cfg), rounds,
                 record_every=3, recorder=j_rec, seed=3, attacks=atk(ja))
    got = tcola.run_cola(port, ttopo.connected_cycle(k, 2),
                         tcola.ColaConfig(**cfg), rounds, record_every=3,
                         recorder=t_rec, seed=3, attacks=atk(ta),
                         wire_draws=_ref_draws(3, rounds, k, ref.d),
                         device="cpu")
    _assert_wire_run(got, want, wire, True)


def test_churn_budgets_attacks_and_trim_compose_as_the_reference():
    """Churn (a (T, K) mask, leavers reset), straggler budgets, a sign flip
    and a stale free rider under trim, with the dynamic certificate of the
    honest cohort (eps 1.0): the attacks transform the schedule after
    churn and budgets, and the certificate judges the corrupted exchange."""
    ref, port = _lasso()
    k, rounds = 8, 40
    rng = np.random.default_rng(4)
    active = rng.random((rounds, k)) < 0.8
    budgets = np.where(rng.random((rounds, k)) < 0.5, 1, 3).astype(np.int32)
    atk = lambda p: [p.Byzantine(nodes=(1,), scale=4.0, start=6),
                     p.FreeRider(nodes=(5,), stale=True, start=10)]
    kw = dict(record_every=4, recorder="gap+certificate", eps=1.0,
              active_schedule=active, budget_schedule=budgets,
              leave_mode="reset")
    want = j_run(ref, jtopo.connected_cycle(k, 2),
                 JConfig(kappa=2.0, robust="trim"), rounds,
                 attacks=atk(ja), **kw)
    got = tcola.run_cola(port, ttopo.connected_cycle(k, 2),
                         tcola.ColaConfig(kappa=2.0, robust="trim"), rounds,
                         attacks=atk(ta), device="cpu", block_size=16, **kw)
    _assert_history(got, want, HIST + CERT)


def test_composed_wire_corners_are_rejected_as_the_reference_does():
    ref, port = _lasso()
    byz = dict(nodes=(0,), mode="sign_flip", scale=10.0, start=1)
    cases = [
        (dict(pipeline=True), None, ValueError, "pipeline requires"),
        (dict(wire="int8", pipeline=True), "byz", NotImplementedError,
         "pipeline"),
        (dict(wire="int8", robust="trim", pipeline=True), None,
         NotImplementedError, "pipeline"),
        (dict(wire="int8", robust="trim", gossip_steps=2), None,
         NotImplementedError, "gossip_steps"),
        (dict(wire="int8", gossip_steps=3), "byz", NotImplementedError,
         "gossip_steps"),
        (dict(wire="int8", grad_mode="mixed"), None, NotImplementedError,
         "grad_mode"),
        (dict(wire="int4"), None, ValueError, "wire=")]
    for cfg, atk, exc, match in cases:
        for pkg, run, conf, topo in ((ja, j_run, JConfig, jtopo),
                                     (ta, tcola.run_cola, tcola.ColaConfig,
                                      ttopo)):
            kw = {} if pkg is ja else dict(device="cpu")
            attacks = [pkg.Byzantine(**byz)] if atk else None
            with pytest.raises(exc, match=match):
                run(ref if pkg is ja else port, topo.ring(8),
                    conf(kappa=1.0, **cfg), 4, attacks=attacks, **kw)


def test_attacks_require_the_block_executor_and_no_cohort():
    ref, port = _lasso()
    byz = [ta.Byzantine(nodes=(0,))]
    with pytest.raises(ValueError, match="executor='block'"):
        tcola.run_cola(port, ttopo.connected_cycle(8, 2), tcola.ColaConfig(),
                       4, executor="loop", attacks=byz, device="cpu")
    cohort = tsched.SampleConfig(k_active=4, mode="cohort")
    for cfg, kw, what in (
            (dict(participation=cohort), dict(attacks=byz), "attacks="),
            (dict(participation=cohort, robust="trim"), {}, "cfg.robust")):
        with pytest.raises(NotImplementedError, match=what):
            tcola.run_cola(port, ttopo.implicit_complete(8),
                           tcola.ColaConfig(**cfg), 4, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown robust mode"):
        tcola.run_cola(port, ttopo.ring(8), tcola.ColaConfig(robust="nope"),
                       2, device="cpu")


# ----------------------------------------------- audit and the baselines

def test_audit_matches_reference():
    ref, port = _lasso()
    rng = np.random.default_rng(3)
    taps = rng.standard_normal((5, 2, ref.d)).astype(np.float32)
    taps[0] = 0.0
    target = rng.standard_normal(ref.d).astype(np.float32)
    np.testing.assert_allclose(ta.payload_cosines(torch.as_tensor(taps),
                                                  target),
                               ja.payload_cosines(taps, target), rtol=1e-12)
    want = ja.gradient_inversion_report(taps, ref, target)
    got = ta.gradient_inversion_report(torch.as_tensor(taps), port, target)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    with pytest.raises(ValueError, match="taps must be"):
        ta.gradient_inversion_report(taps[0], port, target)


@pytest.mark.parametrize("robust", ["trim", "median", "clip"])
def test_robust_baselines_match_reference(robust):
    """DGD and DIGing with every robust mode against the reference, at the
    tolerances of ``test_torch_baselines.py``."""
    x, y, _ = synthetic.regression(200, 32, seed=5)
    ref = jbl.make_consensus_problem(x, y, 8, loss="square", reg="l1",
                                     lam=1e-2)
    port = convert.consensus_problem_from_numpy(
        np.asarray(ref.x_parts), np.asarray(ref.y_parts),
        np.asarray(ref.row_mask), loss="square", reg="l1", lam=ref.lam,
        device="cpu")
    graph = (jtopo.connected_cycle(8, 2), ttopo.connected_cycle(8, 2))
    for j_run_b, t_run_b in ((jbl.run_dgd, tbl.run_dgd),
                             (jbl.run_diging, tbl.run_diging)):
        kw = dict(step=0.1, rounds=30, record_every=5, robust=robust)
        want = j_run_b(ref, graph[0], **kw)
        got = t_run_b(port, graph[1], device="cpu", **kw)
        h, w = got.history, want.history
        assert h["round"] == w["round"]
        np.testing.assert_allclose(h["objective"], w["objective"], rtol=1e-4)
        np.testing.assert_allclose(h["consensus"], w["consensus"], rtol=1e-4,
                                   atol=1e-4 * max(w["consensus"]))
    with pytest.raises(ValueError, match="unknown robust mode"):
        tbl.run_dgd(port, graph[1], step=0.1, rounds=2, robust="nope",
                    device="cpu")
