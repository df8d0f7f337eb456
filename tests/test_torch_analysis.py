"""The port's contract analysis (``repro_torch.analysis``) against the JAX
reference's (``repro.analysis``), on the CPU.

The twin of ``tests/test_analysis.py``:

* ``check_comm``'s clauses on the reports the reference's own HLO analyzer
  makes of the reference's synthetic HLO: the port raises on the same
  clauses with the reference's message, word for word;
* contracts: ``CommPlan.contract()`` / ``BlockPlan.contract()`` equal field
  by field to the reference's on every ``GRAPHS`` family at K = 8 and 16,
  and ``ring_contract`` / ``certificate_contract`` / ``gather_contract``;
* the op-trace passes: clean on the ``sim`` and ``sim-robust`` blocks,
  ``dtype-drift`` on an f16 round trip, ``in-place`` on the cohort body,
  ``retrace`` on a warmed run, the executor's regions;
* every seeded violation caught — the fixtures that need ranks in the CLI
  run below, the rest in process;
* the AST lints: clean over ``src/``, and equal to the reference's on its
  seeded and clean sources and on the whole tree;
* ``render_footprints`` and every ``collective_footprint`` equal to the
  reference's;
* ``python -m repro_torch.analysis --all --selftest --device cpu --ranks
  4`` once (4 gloo ranks, ~15 s on this CPU): exit 0, ``OK``, nothing
  missed, no driver skipped.

Only the reference's cases whose own tests pass are used as the bar: its
seeded jaxpr fixtures and its CLI fail with this JAX version (ROADMAP
"Reference caveats"), so the port's selftests are held to catching their
violations, not to the reference's output.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import topo as rtopo
from repro.analysis import astlint as ref_astlint, contracts as ref_contracts
from repro.analysis import selftest as ref_selftest
from repro.core import metrics as ref_metrics
from repro.core.partition import Partition as RefPartition
from repro.launch import hlo_analysis
from repro_torch import topo as ttopo
from repro_torch.analysis import (astlint, contracts, drivers, passes,
                                  selftest)
from repro_torch.core import metrics as tmetrics
from repro_torch.core.partition import Partition
from repro_torch.launch import op_analysis

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _hlo(body: str, sig: str = "(p0: f32[64]) -> f32[64]") -> str:
    return (f"HloModule m\n\nENTRY %main {sig} {{\n"
            + textwrap.dedent(body).rstrip() + "\n}\n")


# the reference's synthetic programs (tests/test_analysis.py)
PERMUTE = _hlo("""
    %p0 = f32[64] parameter(0)
    ROOT %cp = f32[64] collective-permute(%p0), source_target_pairs={{0,1},{1,0}}
""")
GATHER = _hlo("""
    %p0 = f32[64] parameter(0)
    ROOT %ag = f32[256] all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
""", "(p0: f32[64]) -> f32[256]")
ALL_REDUCE = _hlo("""
    %p0 = f32[64] parameter(0)
    ROOT %ar = f32[64] all-reduce(%p0), replica_groups={{0,1}}
""")
NO_COLL = _hlo("""
    %p0 = f32[64] parameter(0)
    ROOT %n = f32[64] negate(%p0)
""")


def _message(check, program, contract):
    try:
        check(program, contract)
    except AssertionError as e:
        return str(e)
    return None


def _violations(hlo: str, contract):
    """The port's message on the reference analyzer's report of ``hlo``,
    and the reference's own (None: the contract holds)."""
    ref = ref_contracts.CommContract(**dataclasses.asdict(contract))
    return [_message(contracts.check_comm, hlo_analysis.analyze(hlo),
                     contract),
            _message(ref_contracts.check_comm, hlo, ref)]


# --- check_comm clauses: the reference's messages --------------------------

def test_check_comm_passes_and_returns_report():
    c = contracts.CommContract(name="t", max_collective_permute_bytes=256,
                               max_collective_permute_count=1,
                               require_collective_permute=True)
    report = contracts.check_comm(hlo_analysis.analyze(PERMUTE), c)
    assert report["collectives"]["collective-permute"] == 256
    assert report["collective_counts"]["collective-permute"] == 1
    assert _violations(PERMUTE, c) == [None, None]


@pytest.mark.parametrize("hlo,contract,match", [
    (GATHER, contracts.CommContract(name="t"), "forbidden all-gather"),
    (PERMUTE, contracts.CommContract(name="t",
                                     max_collective_permute_bytes=255),
     "bytes/device"),
    (PERMUTE, contracts.CommContract(name="t",
                                     max_collective_permute_count=0),
     "collective-permutes executed"),
    (NO_COLL, contracts.CommContract(name="t",
                                     require_collective_permute=True),
     "lost its neighbor exchange"),
    (ALL_REDUCE, contracts.CommContract(name="t", forbid=(),
                                        max_all_reduce_bytes=64),
     "allowance"),
    (ALL_REDUCE, contracts.gather_contract("t", min_all_gather_bytes=1),
     "MUST gather"),
    (PERMUTE, contracts.gather_contract("t", min_total_bytes=10_000),
     "total"),
    (PERMUTE, contracts.CommContract(name="multi",
                                     max_collective_permute_count=0,
                                     min_total_bytes=10_000),
     "executed > budget"),
], ids=["forbid", "bytes", "count", "require", "allowance", "gather-floor",
        "total", "every-clause"])
def test_check_comm_clauses_in_the_reference_words(hlo, contract, match):
    got, want = _violations(hlo, contract)
    assert got is not None and match in got
    assert got == want
    with pytest.raises(contracts.CommContractViolation, match=match):
        contracts.check_comm(hlo_analysis.analyze(hlo), contract)


def test_check_comm_allowance_and_floors_hold():
    ok = contracts.CommContract(name="t", forbid=("all-gather",),
                                max_all_reduce_bytes=2 * 64 * 4)
    contracts.check_comm(hlo_analysis.analyze(ALL_REDUCE), ok)
    contracts.check_comm(hlo_analysis.analyze(GATHER),
                         contracts.gather_contract(
                             "t", min_all_gather_bytes=1024,
                             min_total_bytes=1024))
    assert _violations(ALL_REDUCE, ok) == [None, None]


class _Axis:
    """A ``NodeAxis``'s counters without a process group."""

    def __init__(self, size, counts, sent):
        self.size, self.counts, self.sent_bytes = size, counts, sent


def test_axis_report_is_the_reference_accounting():
    """permute -> collective-permute; all-reduce bytes x2; all-gather the
    gathered result (sent x ranks); broadcast forbidden where gather is."""
    axis = _Axis(4, {"permute": 2, "all-reduce": 1, "all-gather": 1},
                 {"permute": 512, "all-reduce": 16, "all-gather": 64})
    rep = op_analysis.axis_report(axis)
    assert rep["collectives"]["collective-permute"] == 512
    assert rep["collective_counts"]["collective-permute"] == 2
    assert rep["collectives"]["all-reduce"] == 32
    assert rep["collectives"]["all-gather"] == 256
    assert rep["collectives"]["total"] == 512 + 32 + 256
    with pytest.raises(contracts.CommContractViolation,
                       match="forbidden all-gather"):
        contracts.check_comm(rep, contracts.CommContract(name="t"))
    bcast = op_analysis.axis_report(_Axis(2, {"broadcast": 1},
                                          {"broadcast": 20}))
    with pytest.raises(contracts.CommContractViolation,
                       match="forbidden broadcast"):
        contracts.check_comm(bcast, contracts.CommContract(name="t"))
    contracts.check_comm(bcast, contracts.gather_contract("t"))


def test_one_comm_contract_class():
    from repro_torch.topo import plan as tplan
    assert tplan.CommContract is contracts.CommContract
    assert ttopo.CommContract is contracts.CommContract
    c = tplan.compile_plan(ttopo.build("ring", 8)).contract(48)
    with pytest.raises(AssertionError, match="permutes"):
        c.check({"permute": 3}, {"permute": 0})


# --- contracts equal the reference's ----------------------------------------

@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("name", sorted(ttopo.GRAPHS))
def test_plan_contracts_equal_the_reference(name, k):
    try:
        want_g = rtopo.build(name, k)
    except ValueError:
        with pytest.raises(ValueError):
            ttopo.build(name, k)
        return
    got_g = ttopo.build(name, k)
    pairs = [(ttopo.compile_plan(got_g), rtopo.compile_plan(want_g))]
    for m in (2, 4):
        pairs.append((ttopo.compile_block_plan(got_g, m),
                      rtopo.compile_block_plan(want_g, m)))
    for got, want in pairs:
        for kw in ({}, {"gossip_steps": 2}, {"wire": "int8"},
                   {"wire": "fp8", "gossip_steps": 3}):
            a, b = got.contract(48, 4, **kw), want.contract(48, 4, **kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.describe() == b.describe()


@pytest.mark.parametrize("d,conn,itemsize", [(48, 1, 4), (400_000, 2, 4),
                                             (2_000, 3, 1)])
def test_runtime_contracts_equal_the_reference(d, conn, itemsize):
    pairs = [(contracts.ring_contract(d, conn, itemsize, gossip_steps=3),
              ref_contracts.ring_contract(d, conn, itemsize,
                                          gossip_steps=3)),
             (contracts.certificate_contract(d, conn, itemsize),
              ref_contracts.certificate_contract(d, conn, itemsize)),
             (contracts.gather_contract("g", min_all_gather_bytes=d,
                                        min_total_bytes=2 * d),
              ref_contracts.gather_contract("g", min_all_gather_bytes=d,
                                            min_total_bytes=2 * d))]
    for got, want in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.describe() == want.describe()
    assert contracts.FORBID_NEIGHBOR_ONLY == ref_contracts.FORBID_NEIGHBOR_ONLY


# --- the op-trace passes -----------------------------------------------------

@pytest.mark.parametrize("name", ["sim", "sim-robust", "gossip-dp",
                                  "executor-retrace"])
def test_simulator_drivers_clean(name):
    with drivers.settings(device="cpu"):
        assert drivers.DRIVER_REGISTRY[name]() == []


def test_dtype_drift_flags_f16_roundtrip():
    trace = passes.trace_ops(lambda x: x.to(torch.float16).to(torch.float32),
                             torch.zeros(4))
    found = passes.dtype_drift(trace, region=None)
    assert any("float16" in f.message for f in found)
    assert passes.dtype_drift(trace, region=None,
                              wire_dtypes=(torch.float16,)) == []


def test_in_place_accepts_the_cohort_body():
    """The cohort round (``run_cola`` over a sampled cohort) writes its
    rows in place: every round keeps every state leaf's storage."""
    from repro_torch import PROBLEMS, run_cola
    from repro_torch.core import schedule, topology
    from repro_torch.core.cola import ColaConfig
    from repro_torch.data import synthetic
    x, y, _ = synthetic.regression(64, 32, seed=0)
    prob = PROBLEMS["ridge_primal"](x, y, 1e-2, device="cpu")
    cfg = ColaConfig(kappa=1.0, participation=schedule.SampleConfig(
        k_active=2, mode="cohort"))
    trace = passes.trace_ops(run_cola, prob, topology.complete(8), cfg, 4,
                             device="cpu", block_size=4)
    assert [ip for _, ip in trace.steps] == [True]
    assert len(trace.in_place_moves) == 4
    assert passes.in_place(trace) == []
    assert passes.trace_passes(trace, in_place_body=True) == []


def test_regions_nest_and_the_stop_read_is_outside_rounds():
    """The executor's block / round regions and the trace's step region;
    the once-per-block stop-flag read lies in the block, outside every
    round, so ``host-sync-in-block`` does not see it."""
    from repro_torch import PROBLEMS, run_cola
    from repro_torch.core import topology
    from repro_torch.core.cola import ColaConfig
    from repro_torch.data import synthetic
    x, y, _ = synthetic.regression(64, 32, seed=0)
    prob = PROBLEMS["ridge_primal"](x, y, 1e-2, device="cpu")
    trace = passes.trace_ops(run_cola, prob, topology.ring(4),
                             ColaConfig(kappa=1.0), 6, eps=1e-12,
                             device="cpu", block_size=3)
    reads = [op.path for op in trace.ops
             if op.name == "aten._local_scalar_dense.default"]
    assert ("block",) in reads
    assert all("round" not in p for p in reads)
    paths = {op.path for op in trace.ops}
    assert ("block", "round", "step") in paths
    assert ("block", "round") in paths       # the recorder
    assert passes.host_sync_in_block(trace) == []


def test_retrace_counts_bypasses_per_executor_call():
    from repro_torch.core import executor
    with passes.RetraceMonitor() as mon:
        executor.run_round_blocks(lambda s, c, t: s + 1, torch.zeros(2),
                                  None, num_rounds=3, block_size=2)
        executor._cache_event(None, "bypass")
    found = passes.retrace_findings(mon)
    assert mon.runs == 1 and len(found) == 1
    assert "2 bypass event(s) for 1 block-executor" in found[0].message


def _cli_out():
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all",
         "--selftest", "--device", "cpu", "--ranks", "4"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


@pytest.fixture(scope="module")
def cli():
    return _cli_out()


@pytest.mark.parametrize("name", sorted(selftest.SELFTESTS))
def test_seeded_violation_is_caught(name, cli):
    """In process, or for the fixtures that need ranks in the CLI's run
    over 4 gloo ranks."""
    if selftest.SELFTESTS[name].ranks:
        assert f"CAUGHT {name}:" in cli.stdout, cli.stdout + cli.stderr
        return
    with drivers.settings(device="cpu"):
        [(_, caught, detail)] = selftest.run_selftests([name])
    assert caught, detail


def test_analysis_cli_all_and_selftest_subprocess(cli):
    out = cli.stdout
    assert cli.returncode == 0, out + "\n" + cli.stderr
    assert "repro_torch.analysis: OK" in out
    assert "MISSED" not in out
    assert "SKIP " not in out, out
    for name in drivers.DRIVER_REGISTRY:
        assert f"PASS {name}\n" in out
    assert "CAUGHT comm-contract:" in out
    assert "ast-lint: 0 finding(s)" in out


# --- AST lints ---------------------------------------------------------------

def _key(findings):
    return [(f.pass_name, f.message, f.where) for f in findings]


def test_repo_source_passes_port_ast_lints_like_the_reference():
    got = astlint.lint_paths([ROOT / "src"])
    assert got == [], "\n".join(str(f) for f in got)
    assert _key(got) == _key(ref_astlint.lint_paths([ROOT / "src"]))
    assert sorted(astlint.RULES) == sorted(ref_astlint.RULES)


@pytest.mark.parametrize("rule", sorted(ref_selftest._AST_VIOLATIONS))
def test_seeded_ast_sources_give_the_reference_findings(rule):
    src = textwrap.dedent(ref_selftest._AST_VIOLATIONS[rule])
    got = astlint.lint_source(src, f"selftest:{rule}")
    want = ref_astlint.lint_source(src, f"selftest:{rule}")
    assert got and _key(got) == _key(want)


def test_clean_sources_stay_clean_in_both():
    clean = textwrap.dedent("""
        def sample(key):
            a = jax.random.normal(key, (3,))
            key, sub = jax.random.split(key)
            b = jax.random.normal(key, (3,))
            return a, b

        def branchy(key, flag):
            if flag:
                x = jax.random.normal(key, (3,))
            else:
                x = jax.random.uniform(key, (3,))
            return x

        @register_scenario("x")
        @dataclasses.dataclass(frozen=True)
        class Fine:
            def apply(self, sched, ctx):
                return None
    """)
    assert astlint.lint_source(clean) == []
    assert ref_astlint.lint_source(clean) == []


def test_prng_rule_learns_the_port_streams():
    bad = textwrap.dedent("""
        def draw(key, n, dev):
            a = streams.normal(key, n, dev)
            b = streams.uniform(key, (n,), dev, offset=0)
            return a, b
    """)
    found = astlint.lint_source(bad)
    assert [f.pass_name for f in found] == ["prng-reuse"]
    assert "streams.uniform" in found[0].message
    ok = textwrap.dedent("""
        def draw(key, n, dev):
            a = streams.uniform(key, (n,), dev)
            b = streams.uniform(key, (n,), dev, offset=n)
            key = streams.fold(key, 1)
            c = streams.bits(key, (n,), dev)
            return a, b, c
    """)
    assert astlint.lint_source(ok) == []


# --- recorder footprints ------------------------------------------------------

FOOTPRINT_CASES = [(16, 2000, 25000, 4), (4, 48, 37, 4), (8, 400_000, 125, 2)]


@pytest.mark.parametrize("k,d,n_k,itemsize", FOOTPRINT_CASES)
def test_render_footprints_equal_the_reference(k, d, n_k, itemsize):
    assert tmetrics.render_footprints(k, d, n_k, itemsize) == \
        ref_metrics.render_footprints(k, d, n_k, itemsize)


@pytest.mark.parametrize("k,d,n_k,itemsize", FOOTPRINT_CASES)
@pytest.mark.parametrize("comm,conn", [("dense", 1), ("ring", 1),
                                       ("ring", 3)])
def test_collective_footprints_equal_the_reference(k, d, n_k, itemsize,
                                                   comm, conn):
    gap = tmetrics.GapRecorder(None, Partition(k, k * n_k, n_k))
    ref_gap = ref_metrics.GapRecorder(None, RefPartition(k, k * n_k, n_k))
    fn = tmetrics.FnRecorder(("probe",), lambda s: s)
    ref_fn = ref_metrics.FnRecorder(("probe",), lambda s: s)
    pairs = [
        (gap, ref_gap), (fn, ref_fn),
        (tmetrics.ComposedRecorder((gap, fn)),
         ref_metrics.ComposedRecorder((ref_gap, ref_fn)))]
    args = (k, d, n_k, itemsize, comm, conn)
    for got, want in pairs:
        assert got.collective_footprint(*args) == \
            want.collective_footprint(*args)
    assert tmetrics.CertificateRecorder.collective_footprint(
        tmetrics._FootprintOnly(), *args) == \
        ref_metrics.CertificateRecorder.collective_footprint(
            ref_metrics._FootprintOnly(), *args)
    np.testing.assert_equal(tmetrics.CERT_METRICS, ref_metrics.CERT_METRICS)
