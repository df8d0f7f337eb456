"""``repro_torch.dist.run_dist_cola`` at 2 and 4 gloo ranks, against the
port's ``run_cola`` and the JAX reference's ``run_cola``: the mixing cases.

One subprocess (``tests/_torch_dist_ranks.py``, group "mix") spawns the
ranks of each world size and runs every case; the tests read its files.
The cases and their claims are that module's ``CASES``:

* against the port's ``run_cola`` on the same inputs: the final state and
  the history bitwise (claim "bitwise": every block plan at K/M >= 2 nodes
  per rank, whose products run at the dense shape, and the dense path), or
  within rtol 1e-6 and atol 1e-6 max(1, max|value|) (claim "rtol": the
  leaver reset's node sum adds across ranks; the block plan's B sequential
  steps against ``run_cola``'s folded W^B). ``stop_round`` equal;
* against the reference's ``run_cola``: the history at
  ``tests/test_torch_cola.py``'s tolerance (rtol 1e-4, atol 1e-4
  max|primal|; certificate counts exactly), the recorded rounds and
  ``stop_round`` equal;
* collectives: a plan run gathers nothing but the gap recorder's stacks
  and the result.

A hang fails the fixture: the subprocess has a time limit, and every
collective a 120 s timeout.
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

import _torch_dist_ranks as ranks
from repro.core import metrics as jmet, problems as jprob, topology as jtopo
from repro.core.cola import (ColaConfig as JConfig, build_env as j_build_env,
                             run_cola as j_run)
from repro.core.partition import make_partition as j_make_partition

ROOT = Path(__file__).resolve().parents[1]
RTOL, SIM_RTOL = 1e-4, 1e-6
CERT_FLOAT = ("local_gap_max", "grad_disagreement_max", "consensus_residual")
CERT_COUNTS = ("cond9_nodes", "cond10_nodes", "certified",
               "certificate_violated")
GAP = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")


def run_group(tmp_path_factory, group: str, inputs: Path | None = None
              ) -> Path:
    """Run ``group``'s cases in a subprocess; ``inputs``: a directory the
    caller wrote the group's inputs into, which is then the output one."""
    out = inputs or tmp_path_factory.mktemp(f"dist_{group}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
         str(out), group], env=env, capture_output=True, text=True,
        timeout=420, cwd=ROOT)
    assert "DIST_RANKS_OK" in proc.stdout, proc.stdout + proc.stderr[-4000:]
    return out


def cases_of(group: str) -> list:
    return [(name, world) for name, c in ranks.CASES.items()
            if c["group"] == group for world in c["worlds"]]


def load(out: Path, name: str, world: int) -> dict:
    z = np.load(out / f"{world}_{name}.npz")
    res = {key: z[key] for key in z.files}
    for key in ("history", "history_sim", "counts", "history_on",
                "counts_on", "history_sim_on"):
        if key in res:
            res[key] = json.loads(str(res[key]))
    return res


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = SIM_RTOL * max(1.0, float(np.max(np.abs(b), initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=SIM_RTOL, atol=atol, err_msg=what)


def assert_matches_port(res: dict, case: dict, name: str) -> None:
    """The distributed run against the port's run_cola, per the claim."""
    h, hs = res["history"], res["history_sim"]
    assert h["round"] == hs["round"], name
    assert h["stop_round"] == hs["stop_round"], name
    assert h.get("violated_round") == hs.get("violated_round"), name
    if case["claim"] == "bitwise":
        np.testing.assert_array_equal(res["x"], res["x_sim"], err_msg=name)
        np.testing.assert_array_equal(res["v"], res["v_sim"], err_msg=name)
    else:
        _close(res["x"], res["x_sim"], f"{name}: x")
        _close(res["v"], res["v_sim"], f"{name}: v")
    for key, col in h.items():
        if not isinstance(col, list) or key == "round":
            continue
        if key in CERT_COUNTS:
            assert col == hs[key], f"{name}: {key}"
        elif case["claim"] == "bitwise" and key not in CERT_FLOAT:
            assert col == hs[key], f"{name}: {key}"
        else:
            # the certificate's Lemma-1 sums add across ranks
            _close(col, hs[key], f"{name}: {key}")


_REF = {}


def reference_history(name: str) -> dict:
    """The reference's run_cola on the case's inputs (cached per case)."""
    if name in _REF:
        return _REF[name]
    case = ranks.CASES[name]
    pname, x, y, lam, kw = ranks.data(case["data"])
    prob = jprob.PROBLEMS[pname](jnp.asarray(x), jnp.asarray(y), lam, **kw)
    gname, args = case["graph"]
    graph = getattr(jtopo, gname)(*args)
    run = dict(case["run"])
    run.pop("comm")
    if run.get("w_override") == "cycle2":
        run["w_override"] = jtopo.metropolis_weights(
            jtopo.connected_cycle(graph.num_nodes, 2))
    if "certificate" in run.get("recorder", ""):
        part = j_make_partition(prob.n, graph.num_nodes)
        env = j_build_env(prob, part)
        cert = jmet.certificate_recorder(
            prob, part, env, graph, run["eps"], sigma_k=jnp.asarray(
                ranks.exact_sigma(np.asarray(env.a_parts))))
        run["recorder"] = (cert if run["recorder"] == "certificate" else
                           jmet.ComposedRecorder(
                               (jmet.GapRecorder(prob, part), cert)))
    res = j_run(prob, graph, JConfig(**case["cfg"]), case["rounds"],
                block_size=16, **run)
    _REF[name] = res.history
    return res.history


def assert_matches_reference(got: dict, want: dict, name: str) -> None:
    assert got["round"] == want["round"], name
    assert got["stop_round"] == want["stop_round"], name
    gap_keys = [key for key in GAP if key in want]
    atol = (RTOL * max(abs(v) for v in want["primal"])
            if gap_keys else 0.0)
    for key in gap_keys:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=atol,
                                   err_msg=f"{name}: {key}")
    for key in CERT_FLOAT[:2]:
        if key in want:
            scale = RTOL * max(abs(v) for v in want[key])
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=scale, err_msg=f"{name}: {key}")
    for key in CERT_COUNTS:
        if key in want:
            assert got[key] == want[key], f"{name}: {key}"


@pytest.fixture(scope="module")
def mix_out(tmp_path_factory):
    return run_group(tmp_path_factory, "mix")


@pytest.mark.parametrize("name,world", cases_of("mix"))
def test_ranks_match_port_run_cola(mix_out, name, world):
    assert_matches_port(load(mix_out, name, world), ranks.CASES[name],
                        f"{name}@{world}")


@pytest.mark.parametrize("name,world", cases_of("mix"))
def test_ranks_match_reference_run_cola(mix_out, name, world):
    assert_matches_reference(load(mix_out, name, world)["history"],
                             reference_history(name), f"{name}@{world}")


@pytest.mark.parametrize("world", [2, 4])
def test_ring_request_dispatches_to_the_plan(mix_out, world):
    """comm="ring" on a non-circulant torus, and on a ring with fewer
    ranks than nodes, runs the block plan: the same run, bit for bit."""
    plan = load(mix_out, "plan_static", world)
    torus = load(mix_out, "ring_dispatch_torus", world)
    np.testing.assert_array_equal(torus["v"], plan["v"])
    assert torus["history"] == plan["history"]
    assert torus["counts"] == plan["counts"]
    ring = load(mix_out, "ring_dispatch_ring", world)
    assert ring["counts"]["calls"]["permute"] > 0


@pytest.mark.parametrize("name,world", [
    (n, w) for n, w in cases_of("mix")
    if ranks.CASES[n]["run"]["comm"] != "dense"])
def test_plan_runs_gather_only_records_and_result(mix_out, name, world):
    """A plan run's rounds make no all-gather: the gap recorder gathers
    the two stacks at each record and the result gathers them once."""
    res = load(mix_out, name, world)
    calls = res["counts"]["calls"]
    if ranks.CASES[name]["run"].get("record_every") == "adaptive":
        records = ranks.CASES[name]["rounds"]   # a row every round
    else:
        records = len(res["history"]["round"])
    assert calls.get("all-gather", 0) == 2 * records + 2
    if "reset" not in name:   # a reset round completes its sum by psum
        assert calls.get("all-reduce", 0) == 0
