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
    assert [s["meta"] for s in tr.spans] == [
        {"start": 0, "rounds": 4}, {"start": 4, "rounds": 4},
        {"start": 8, "rounds": 2}]
    trace = json.loads(Path(tr.export(str(tmp_path / "t.json"))).read_text())
    names = [ev["name"] for ev in trace["traceEvents"]]
    assert names.count("block-dispatch") == 2
    assert "driver-cache bypass" in names
    prof = (tmp_path / "prof" / "trace.json").read_text()
    assert "block-first-dispatch" in prof


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
