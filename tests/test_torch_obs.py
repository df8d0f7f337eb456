"""``repro_torch.obs`` against the reference's ``repro.obs``, on the CPU: the
twin of ``tests/test_obs.py``, at its size (a 120 x 48 lasso, torus2d(16),
10 rounds).

* Telemetry off and on: the port's final state and every history column
  equal, bitwise (fp32, int8, and int8 + trim under the reference's
  two-node sign flip).
* ``history["telemetry"]`` against the reference's on the same inputs:
  ``wire_bytes``, ``permutes``, ``contract``, ``rounds``,
  ``gate_rejections``, ``dishonest_nodes`` and the honest / dishonest
  split equal; ``saturation_mean``, ``ef_norm`` and the per-round series
  within rtol 1e-5. On the wire the reference's uniforms are replayed
  (``run_cola(wire_draws=)``) and the runs carry
  ``tests/test_torch_quant.py``'s probe of v: the series are compared on
  the rounds before the first row where the probes part (a flipped
  rounding decision, ``PROBE_TOL``), and the totals only when no row
  parted.
* The registry (report round trip, ``find_report``, ``diff_reports``,
  retention and its environment overrides, ``obs list``'s pruned count),
  the executor's ``cache_listener`` nesting on its bypass events, the
  tracer's spans and Chrome export, ``torch_profile``, ``sparkline``, the
  content fingerprint, the block-executor requirement, and
  ``python -m repro_torch.obs smoke --device cpu``.
* The spans inside a solve (``obs.trace``): off without a scoped tracer
  or a profiler session (no ``record_function`` at all), counted per
  executed round, block and record under either, nested as the round
  nests them, aggregated past the raw deque's bound, and the run's values
  bitwise the same with them on and off.

The reference's ``test_telemetry_carry_pass`` (a jaxpr lint) belongs to
the contract analysis, and its dist counters are held over gloo ranks
(``tests/_torch_dist_ranks.py``, group "wire", cases ``tel_*``).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import attack as jattack, topo as jtopo
from repro.core import problems as jprob
from repro.core.cola import ColaConfig as JConfig, run_cola as j_run
from repro.data import synthetic
from repro_torch import attack, convert, topo
from repro_torch.core import cola as tcola, executor as texec
from repro_torch.obs import cli as obs_cli, report as obs_report, \
    trace as obs_trace
from repro_torch.obs.cli import sparkline
from test_torch_quant import PROBE_TOL, _recorders, _ref_draws

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 10
SERIES_RTOL = 1e-5
EQUAL_KEYS = ("wire_bytes", "permutes", "contract", "rounds",
              "gate_rejections", "gate_total", "dishonest_nodes",
              "gate_dishonest", "gate_honest", "stop_round")


@pytest.fixture(autouse=True)
def _registry_off(monkeypatch):
    # no test run appends to .repro_runs unless it points REPRO_RUNS_DIR
    # at its own tmpdir
    monkeypatch.setenv(obs_report.ENV_DIR, "off")


@pytest.fixture(scope="module")
def probs():
    x, y, _ = synthetic.regression(120, 48, seed=1, sparsity_solution=0.2)
    return (jprob.lasso(jnp.asarray(x), jnp.asarray(y), 1e-3),
            convert.problem_from_numpy("lasso", x, y, 1e-3, device="cpu"))


@pytest.fixture(scope="module")
def graphs():
    return jtopo.build("torus2d", 16), topo.build("torus2d", 16)


def _byz(pkg):
    return [pkg.Byzantine(nodes=(1, 6), mode="sign_flip", scale=10.0,
                          start=4)]


def _run(port, graph, tel: bool, **kw):
    attacks = _byz(attack) if "robust" in kw else None
    return tcola.run_cola(port, graph,
                          tcola.ColaConfig(kappa=1.0, telemetry=tel, **kw),
                          ROUNDS, attacks=attacks, device="cpu")


CASES = [dict(), dict(wire="int8"), dict(wire="int8", robust="trim")]
IDS = ["fp32", "int8", "int8_trim"]


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_telemetry_off_bitwise(probs, graphs, kw):
    """Turning counters on changes no bit of the computation."""
    _, port = probs
    off, on = (_run(port, graphs[1], tel, **kw) for tel in (False, True))
    assert torch.equal(off.state.x_parts, on.state.x_parts)
    assert torch.equal(off.state.v_stack, on.state.v_stack)
    assert set(on.history) - set(off.history) == {"telemetry"}
    for key, val in off.history.items():
        assert val == on.history[key], key
    assert off.state.counters is None and on.state.counters is not None


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_counters_match_reference(probs, graphs, kw):
    """The port's ``history["telemetry"]`` against the reference's on the
    same inputs (the tolerances of the module docstring), and the byte
    and exchange counters against the plan's ``contract(wire=)``."""
    ref, port = probs
    jrec, trec = _recorders(ref, port, 16)
    wire = kw.get("wire", "fp32")
    draws = (None if wire == "fp32"
             else _ref_draws(0, ROUNDS, 16, port.d))
    got = tcola.run_cola(
        port, graphs[1], tcola.ColaConfig(kappa=1.0, telemetry=True, **kw),
        ROUNDS, recorder=trec, wire_draws=draws, device="cpu",
        attacks=_byz(attack) if "robust" in kw else None)
    want = j_run(ref, graphs[0], JConfig(kappa=1.0, telemetry=True, **kw),
                 ROUNDS, recorder=jrec,
                 attacks=_byz(jattack) if "robust" in kw else None)
    tel, rtel = got.history["telemetry"], want.history["telemetry"]
    for key in EQUAL_KEYS:
        assert tel.get(key) == rtel.get(key), key
    parted = np.abs(np.asarray(got.history["probe"])
                    - np.asarray(want.history["probe"])) > PROBE_TOL
    first = int(np.argmax(parted)) if parted.any() else ROUNDS
    for key in ("saturation", "ef_norm", "gate"):
        np.testing.assert_allclose(tel["series"][key][:first],
                                   rtel["series"][key][:first],
                                   rtol=SERIES_RTOL, atol=1e-12, err_msg=key)
    if first == ROUNDS:
        for key in ("saturation_mean", "ef_norm"):
            np.testing.assert_allclose(tel[key], rtel[key],
                                       rtol=SERIES_RTOL, err_msg=key)
    contract = topo.compile_plan(graphs[1]).contract(
        port.d, wire=None if wire == "fp32" else wire)
    assert tel["wire_bytes"] == \
        ROUNDS * contract.max_collective_permute_bytes
    assert tel["permutes"] == ROUNDS * contract.max_collective_permute_count
    assert tel["contract"] == contract.describe()
    if wire == "int8":
        assert 0.0 <= tel["saturation_mean"] < 1.0
        assert tel["ef_norm"] > 0.0


def test_gate_rejections_only_dishonest(probs, graphs):
    _, port = probs
    tel = _run(port, graphs[1], True, wire="int8",
               robust="trim").history["telemetry"]
    assert tel["dishonest_nodes"] == [1, 6]
    assert tel["gate_dishonest"] >= 1
    assert tel["gate_honest"] == 0
    gate = np.asarray(tel["gate_rejections"])
    assert gate.sum() == tel["gate_total"] == tel["gate_dishonest"]
    assert set(np.nonzero(gate)[0]) == {1, 6}
    # a clean run under the same defense rejects nobody
    clean = tcola.run_cola(port, graphs[1], tcola.ColaConfig(
        kappa=1.0, wire="int8", robust="trim", telemetry=True), ROUNDS,
        device="cpu").history["telemetry"]
    assert clean["gate_total"] == 0


def test_report_roundtrip_and_find(probs, graphs, tmp_path, monkeypatch):
    monkeypatch.setenv(obs_report.ENV_DIR, str(tmp_path))
    _, port = probs
    _run(port, graphs[1], True)
    _run(port, graphs[1], True)
    reports = obs_report.load_reports()
    assert len(reports) == 2
    rep = obs_report.RunReport.from_dict(reports[-1])
    assert rep.driver == "run_cola"
    assert rep.rounds == ROUNDS
    assert rep.counters["wire_bytes"] > 0
    assert rep.series["round"] == list(range(ROUNDS))
    assert "block-first-dispatch" in rep.spans["spans"]
    assert rep.spans["cache"]["bypass"] == 1
    # the content fingerprint of the same Problem: the same digest
    assert reports[0]["problem"] == rep.problem
    # ref resolution: negative index and run_id prefix hit the same record
    assert obs_report.find_report("-1", reports) == reports[-1]
    assert obs_report.find_report(rep.run_id[:6], reports) == reports[-1]
    with pytest.raises(KeyError):
        obs_report.find_report("nope", reports)


def test_diff_only_telemetry(probs, graphs, tmp_path, monkeypatch):
    """Two runs that computed the same thing diff to telemetry-only; a
    different wire does not."""
    monkeypatch.setenv(obs_report.ENV_DIR, str(tmp_path))
    _, port = probs
    _run(port, graphs[1], True)
    _run(port, graphs[1], True)
    _run(port, graphs[1], True, wire="int8")
    reports = obs_report.load_reports()
    twin = obs_report.diff_reports(reports[0], reports[1])
    assert twin["only_telemetry"]
    assert twin["history"] == {}
    wired = obs_report.diff_reports(reports[0], reports[2])
    assert not wired["only_telemetry"]
    assert "wire" in wired["config"]
    assert obs_report.diff_reports(reports[0], reports[1]) == twin


def test_registry_retention_prunes_oldest_first(tmp_path, monkeypatch):
    monkeypatch.setenv(obs_report.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(obs_report.ENV_KEEP, "5")
    for i in range(9):
        obs_report.append_report({"run_id": f"run{i:02d}", "rounds": i})
    reports = obs_report.load_reports()
    assert [r["run_id"] for r in reports] == \
        [f"run{i:02d}" for i in range(4, 9)]
    assert obs_report.pruned_total() == 4
    obs_report.append_report({"run_id": "run09", "rounds": 9})
    assert len(obs_report.load_reports()) == 5
    assert obs_report.pruned_total() == 5


def test_registry_retention_env_and_overrides(tmp_path, monkeypatch):
    monkeypatch.setenv(obs_report.ENV_DIR, str(tmp_path))
    monkeypatch.delenv(obs_report.ENV_KEEP, raising=False)
    assert obs_report.retention_limit() == obs_report.DEFAULT_KEEP
    assert obs_report.retention_limit(keep=7) == 7
    monkeypatch.setenv(obs_report.ENV_KEEP, "3")
    assert obs_report.retention_limit() == 3
    for i in range(6):
        obs_report.append_report({"run_id": f"r{i}"}, keep=0)
    assert len(obs_report.load_reports()) == 6
    assert obs_report.pruned_total() == 0
    obs_report.append_report({"run_id": "r6"})  # env cap=3 kicks in
    assert len(obs_report.load_reports()) == 3
    assert obs_report.pruned_total() == 4
    monkeypatch.setenv(obs_report.ENV_KEEP, "many")
    with pytest.raises(ValueError, match="REPRO_RUNS_KEEP"):
        obs_report.retention_limit()


def test_obs_list_reports_pruned_count(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(obs_report.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(obs_report.ENV_KEEP, "2")
    for i in range(4):
        obs_report.append_report({"run_id": f"run{i}", "rounds": i})
    assert obs_cli.main(["--dir", str(tmp_path), "list"]) == 0
    out = capsys.readouterr().out
    assert "2 older run(s) pruned by retention" in out
    assert obs_report.ENV_KEEP in out


def test_cache_listener_nesting():
    """Each run_round_blocks call is one "bypass" event (the port has no
    driver cache); nested listeners each see it once and leave with their
    scope."""
    outer, inner = [], []
    step = lambda s, _c, _t: s + 1.0
    run = lambda: texec.run_round_blocks(step, torch.zeros(()), None,
                                         num_rounds=2)
    run()
    with texec.cache_listener(lambda k, kind: outer.append(kind)):
        with texec.cache_listener(lambda k, kind: inner.append(kind)):
            run()
        assert inner == ["bypass"] and outer == ["bypass"]
        run()
    assert inner == ["bypass"]
    assert outer == ["bypass", "bypass"]
    run()
    assert outer == ["bypass", "bypass"]


def test_tracer_spans_chrome_export_and_profile(probs, graphs, tmp_path):
    """A tracer over a run holds one span per block with the reference's
    names and metadata; its Chrome export and ``torch_profile``'s trace
    are JSON with those names in them."""
    _, port = probs
    with obs_trace.use(obs_trace.Tracer()) as tr, tr.attach():
        with obs_trace.torch_profile(str(tmp_path / "prof"), device="cpu"):
            tcola.run_cola(port, graphs[1], tcola.ColaConfig(), ROUNDS,
                           block_size=4, device="cpu")
    summ = tr.summary()
    assert summ["spans"]["block-first-dispatch"]["count"] == 1
    assert summ["spans"]["block-dispatch"]["count"] == 2
    assert summ["cache"] == {"hits": 0, "misses": 0, "bypass": 1}
    assert [s["meta"] for s in tr.spans
            if s["name"] in ("block-first-dispatch", "block-dispatch")] == [
        {"start": 0, "rounds": 4}, {"start": 4, "rounds": 4},
        {"start": 8, "rounds": 2}]
    trace = json.loads(Path(tr.export(str(tmp_path / "t.json"))).read_text())
    names = [ev["name"] for ev in trace["traceEvents"]]
    assert names.count("block-dispatch") == 2
    assert "driver-cache bypass" in names
    prof = (tmp_path / "prof" / "trace.json").read_text()
    assert "block-first-dispatch" in prof


SPAN_BLOCK = 4
# certified first at round 8 or 10 of the 120 x 48 lasso on torus2d(16)
# (round 6 needs eps above 2,200, round 12 below 1,600)
CERT_EPS = 1900.0
BODY_SPANS = ("cola.mix", "cola.local_solve", "cola.update")


@pytest.fixture
def fresh_default(monkeypatch):
    """A fresh default tracer (the module's own collects under every
    profiler session in the process)."""
    tracer = obs_trace.Tracer()
    monkeypatch.setattr(obs_trace, "_STACK", [tracer])
    return tracer


def _span_run(port, graph, eps=CERT_EPS, rounds=5 * SPAN_BLOCK):
    """A run with spans to count: the certificate every second round
    stops it in its third block; ``eps=None``: the gap alone, no stop."""
    return tcola.run_cola(port, graph, tcola.ColaConfig(), rounds,
                          recorder="gap" if eps is None
                          else "gap+certificate", record_every=2, eps=eps,
                          block_size=SPAN_BLOCK, device="cpu")


def test_spans_off_without_tracer_or_profiler(probs, graphs, monkeypatch,
                                               fresh_default):
    """No scoped tracer and no profiler: not one ``record_function``, and
    the default tracer collects nothing."""
    calls = []
    real = torch.profiler.record_function

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    res = _span_run(probs[1], graphs[1])
    assert res.history["stop_round"] is not None
    assert calls == []
    assert fresh_default.summary()["spans"] == {}
    assert len(fresh_default.spans) == 0
    # the gate lets a scoped tracer through
    with obs_trace.use(obs_trace.Tracer()):
        _span_run(probs[1], graphs[1], rounds=SPAN_BLOCK)
    assert calls


def _within(inner, outer) -> bool:
    return (outer["t0"] <= inner["t0"]
            and inner["t0"] + inner["dur"] <= outer["t0"] + outer["dur"])


def test_spans_count_rounds_blocks_and_records(probs, graphs):
    """Under a scoped tracer: ``round`` and the round body's spans count
    the executed rounds, ``round-record`` and ``record.certificate`` the
    record rounds run; with a stop armed one ``block-stop-read`` a block
    and one ``block-gap`` fewer, without one neither; the body's spans lie
    inside a ``round``, the certificate inside a ``round-record``."""
    _, port = probs
    with obs_trace.use(obs_trace.Tracer()) as tr:
        res = _span_run(port, graphs[1])
    stop = res.history["stop_round"]
    assert stop is not None and stop // SPAN_BLOCK == 2
    executed = 3 * SPAN_BLOCK
    spans = tr.summary()["spans"]
    assert spans["round"]["count"] == executed
    for name in BODY_SPANS:
        assert spans[name]["count"] == executed, name
    records = len(range(0, executed, 2))
    assert spans["round-record"]["count"] == records
    assert spans["record.certificate"]["count"] == records
    assert spans["cola.setup"]["count"] == 1
    assert spans["block-first-dispatch"]["count"] == 1
    assert spans["block-dispatch"]["count"] == 2
    assert spans["block-stop-read"]["count"] == 3
    assert spans["block-gap"]["count"] == 2
    assert all("device_s" not in v for v in spans.values())   # the CPU
    raw = list(tr.spans)
    rounds = [s for s in raw if s["name"] == "round"]
    records_raw = [s for s in raw if s["name"] == "round-record"]
    for s in raw:
        if s["name"] in BODY_SPANS + ("round-record",):
            assert any(_within(s, r) for r in rounds), s
        if s["name"] == "record.certificate":
            assert any(_within(s, r) for r in records_raw), s
    # neither a block-stop-read nor a block-gap without a stop
    with obs_trace.use(obs_trace.Tracer()) as tr:
        _span_run(port, graphs[1], eps=None)
    spans = tr.summary()["spans"]
    assert spans["round"]["count"] == 5 * SPAN_BLOCK
    assert "block-stop-read" not in spans and "block-gap" not in spans


def test_spans_collect_on_default_tracer_under_profiler(probs, graphs,
                                                        fresh_default):
    """A profiler session and no scoped tracer: the default tracer
    collects, and the profiler's events hold every span's name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _span_run(probs[1], graphs[1])
    names = {"cola.setup", "round", "round-record", "record.certificate",
             "block-first-dispatch", "block-dispatch", "block-stop-read",
             "block-gap", *BODY_SPANS}
    spans = fresh_default.summary()["spans"]
    assert set(spans) == names
    assert spans["round"]["count"] == 3 * SPAN_BLOCK
    assert names <= {e.name for e in prof.events()}
    # and nothing more once the session is over
    _span_run(probs[1], graphs[1], rounds=SPAN_BLOCK)
    assert fresh_default.summary()["spans"]["round"]["count"] == \
        3 * SPAN_BLOCK


def test_tracer_aggregate_outlives_its_bounded_deque(probs, graphs):
    _, port = probs
    with obs_trace.use(obs_trace.Tracer(maxlen=8)) as tr:
        _span_run(port, graphs[1], eps=None, rounds=40)
    assert len(tr.spans) == 8
    spans = tr.summary()["spans"]
    assert spans["round"]["count"] == 40
    assert spans["cola.mix"]["count"] == 40


class _FakeEvent:
    """A stand-in for a recorded ``torch.cuda.Event`` at ``ms``."""

    def __init__(self, ms: float, done: bool = True):
        self.ms, self.done = ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms


def test_tracer_folds_device_event_pairs(monkeypatch):
    """Event pairs give ``device_s``: past the bound each close folds the
    oldest pair the card has passed, and ``summary()`` folds the rest
    after one synchronize; a pair still on the card waits."""
    monkeypatch.setattr(obs_trace, "_PENDING_MAX", 4)
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    tr = obs_trace.Tracer()
    for i in range(10):
        tr._close("round", 0.0, 0.25, {}, (_FakeEvent(i), _FakeEvent(i + 2)))
    assert len(tr._pending) == 4 and not syncs
    tr._close("cola.mix", 0.0, 0.5, {}, None)
    assert tr.summary()["spans"] == {
        "round": {"count": 10, "total_s": 2.5, "device_s": 0.02},
        "cola.mix": {"count": 1, "total_s": 0.5}}
    assert syncs == [1] and not tr._pending
    late = obs_trace.Tracer()
    for i in range(6):
        late._close("round", 0.0, 0.0, {},
                    (_FakeEvent(0), _FakeEvent(1, done=False)))
    assert len(late._pending) == 6


def test_spans_leave_values_bitwise(probs, graphs, fresh_default):
    """x, v and every history column with the spans off, under a scoped
    tracer and under a profiler: bitwise the same."""
    from torch.profiler import ProfilerActivity, profile
    _, port = probs
    off = _span_run(port, graphs[1])
    with obs_trace.use(obs_trace.Tracer()):
        scoped = _span_run(port, graphs[1])
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _span_run(port, graphs[1])
    for on in (scoped, profiled):
        assert torch.equal(on.state.x_parts, off.state.x_parts)
        assert torch.equal(on.state.v_stack, off.state.v_stack)
        assert on.history.keys() == off.history.keys()
        for key, val in off.history.items():
            if isinstance(val, list):
                np.testing.assert_array_equal(np.asarray(on.history[key]),
                                              np.asarray(val), err_msg=key)
            else:
                assert on.history[key] == val, key


def test_fingerprint_is_content_addressed_and_memoized(probs):
    x, y, _ = synthetic.regression(40, 12, seed=5)
    a = convert.problem_from_numpy("lasso", x, y, 1e-3, device="cpu")
    b = convert.problem_from_numpy("lasso", x, y, 1e-3, device="cpu")
    c = convert.problem_from_numpy("lasso", x, y, 2e-3, device="cpu")
    y2 = y.copy()
    y2[0] += 1.0
    d = convert.problem_from_numpy("lasso", x, y2, 1e-3, device="cpu")
    fa = texec.fingerprint(a)
    assert fa == texec.fingerprint(b)
    assert len({fa, texec.fingerprint(c), texec.fingerprint(d)}) == 3
    assert a._fingerprint_memo == fa
    assert texec.fingerprint(tcola.ColaConfig()) != texec.fingerprint(
        tcola.ColaConfig(wire="int8"))


def test_sparkline():
    rising = sparkline([float(i) for i in range(32)], width=16)
    assert len(rising) == 16
    assert rising[-1] == "█"
    assert sparkline([1.0, 1.0, 1.0], width=8)
    assert len(sparkline([2.0, 4.0], width=8, log=True)) == 2


def test_telemetry_requires_block_executor(probs, graphs):
    _, port = probs
    with pytest.raises(ValueError, match="telemetry"):
        tcola.run_cola(port, graphs[1],
                       tcola.ColaConfig(kappa=1.0, telemetry=True), ROUNDS,
                       executor="loop", device="cpu")


def test_obs_smoke_cli_subprocess(tmp_path):
    """``python -m repro_torch.obs smoke --device cpu``: two telemetry
    runs into a registry in a temporary directory, then every
    subcommand."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop(obs_report.ENV_DIR, None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--dir", str(tmp_path),
         "smoke", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "smoke: 2 telemetry runs on cpu" in out.stdout
    assert "only_telemetry: False" in out.stdout
    assert "timeline" in out.stdout
    assert len(obs_report.load_reports(str(tmp_path))) == 2
    assert not (tmp_path / ".repro_runs").exists()
