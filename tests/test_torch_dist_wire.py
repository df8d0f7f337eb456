"""The quantized wire, robust mixing, attacks and the gossip ring over 2
and 4 gloo ranks: ``run_dist_cola`` against the port's ``run_cola`` and
the JAX reference's, and ``repro_torch.optim.gossip``'s ring against the
dense mix.

One subprocess (``tests/_torch_dist_ranks.py``, group "wire") spawns the
ranks of each world size; the fixture first writes what it replays: the
reference's threefry uniforms of each wire case and the gossip replicas
(the reference's initial state, converted). The cases and their claims are
that module's ``CASES``:

* against the port's ``run_cola`` on the same inputs: bitwise (the wire,
  trim and median, every block plan at K/M >= 2 and the dense path), rtol
  1e-6 and atol 1e-6 max(1, max|value|) (clip; one node per rank on the
  fp32 wire; the certificate's cross-rank sums), or flip-aware (one node
  per rank on the wire); ``stop_round`` and ``violated_round`` equal;
* against the reference's ``run_cola``: wire cases at
  ``tests/test_torch_quant.py``'s flip-aware tolerance (the reference's
  uniforms replayed), attack cases at rtol 1e-4 through the first
  violated row (a run the defense does not hold diverges after it);
* bytes: each round's exchanges send what the plan's ``contract(wire=)``
  allows, 1 byte an element and 4 a row; the dense oracle all-gathers the
  narrow payload and its scales; a one-round probe of each wire mix;
* each rank's env is its rows of the whole env, bitwise, at 1/M of its
  storage;
* the gossip ring (K = M nodes at Qwen3-4B's smoke width): within rtol
  1e-6 of the port's dense step, and of the reference's dense
  ``make_gossip_step`` at ``tests/test_torch_gossip.py``'s tolerance.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro import attack as jattack
from repro.configs.base import get_config as jget, smoke_variant as jsmoke
from repro.core import metrics as jmet, problems as jprob, quant as jq, \
    topology as jtopo
from repro.core.cola import ColaConfig as JConfig, run_cola as j_run
from repro.core.partition import make_partition as j_make_partition
from repro.optim import gossip as jgsp, optimizers as jopt
from repro.train import data as jdata, steps as jsteps
from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.topo import plan as tplan
from test_torch_dist_ranks import (_close, assert_matches_port, cases_of,
                                   load, run_group)
from test_torch_quant import _assert_wire_run, _ref_uniforms

RTOL = 1e-4
WIRE_CASES = [(n, w) for n, w in cases_of("wire")
              if ranks.CASES[n]["ref_draws"]]
ATTACK_CASES = [(n, w) for n, w in cases_of("wire")
                if "attacks" in ranks.CASES[n]["run"]]


def _write_draws(out, name: str, case: dict) -> None:
    """The reference's uniforms of ``run_cola(seed=)`` for every round and
    gossip step of a case: (T + 1, B, K, d)."""
    k = getattr(jtopo, case["graph"][0])(*case["graph"][1]).num_nodes
    d = _problem(case).d
    steps = case["cfg"].get("gossip_steps", 1)
    keys = jq.round_keys(case["run"]["seed"], case["rounds"] + 1)
    arr = np.stack([np.stack([_ref_uniforms(jq.step_key(keys[t], s), k, d)
                              for s in range(steps)])
                    for t in range(case["rounds"] + 1)])
    np.save(out / f"draws_{name}.npy", arr.astype(np.float32))


def _problem(case: dict):
    """The reference's problem of a case."""
    pname, x, y, lam, kw = ranks.data(case["data"])
    return jprob.PROBLEMS[pname](jnp.asarray(x), jnp.asarray(y), lam, **kw)


def _gossip_inputs():
    """(reference config, port config, the reference's initial state as
    numpy, its local step, the batch pipe), with SGD + momentum patched into
    both packages as tests/test_torch_gossip.py does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "_optimizer", lambda hp: jopt.sgd_momentum(0.9))
        cfg = jsmoke(jget("qwen3_4b"))
        hp = jsteps.TrainHParams(lr=0.05)
        state0 = jax.tree.map(np.asarray, jsteps.init_train_state(
            cfg, jax.random.PRNGKey(0), hp))
        jlocal = jsteps.make_train_step(cfg, hp)
    pipe = jdata.TokenBatches(cfg.vocab_size, 2, 16, corpus_tokens=1 << 12)
    return cfg, smoke_variant(get_config("qwen3_4b")), state0, jlocal, pipe


_GOSSIP_REF = {}


def _write_gossip(out, k: int) -> None:
    """The K replicas (the port's TrainState) and batches the ring runs
    from, and the reference's dense step on them (kept for the test)."""
    cfg, tcfg, state0, jlocal, pipe = _gossip_inputs()
    jst = jgsp.replicate_state(jax.tree.map(jnp.asarray, state0), k)
    torch.save(convert.train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst), device="cpu"),
        out / f"gossip_{k}.pt")
    batches = {key: np.stack([np.stack([pipe(t, shard=j)[key]
                                        for j in range(k)])
                              for t in range(ranks.GOSSIP_ROUNDS)])
               for key in ("tokens", "labels")}
    np.savez(out / f"gossip_{k}.npz", **batches)
    gcfg = jgsp.GossipConfig(num_nodes=k, topology="ring")
    w = jnp.asarray(gcfg.weights(), jnp.float32)
    step = jgsp.make_gossip_step(jlocal, gcfg)
    for t in range(ranks.GOSSIP_ROUNDS):
        jst, _ = step(jst, {key: jnp.asarray(b[t])
                            for key, b in batches.items()}, w,
                      jnp.ones((k,)))
    _GOSSIP_REF[k] = convert._nested_to_flat(jax.tree.map(np.asarray,
                                                          jst.params))


@pytest.fixture(scope="module")
def wire_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_wire_inputs")
    for name, case in ranks.CASES.items():
        if case["group"] == "wire" and case["ref_draws"]:
            _write_draws(out, name, case)
    for k in ranks.worlds_of("wire"):
        _write_gossip(out, k)
    return run_group(tmp_path_factory, "wire", inputs=out)


@pytest.mark.parametrize("name,world", cases_of("wire"))
def test_wire_ranks_match_port_run_cola(wire_out, name, world):
    res = load(wire_out, name, world)
    case = ranks.CASES[name]
    if case["claim"] != "flip":
        assert_matches_port(res, case, f"{name}@{world}")
        if "ef" in res:
            if case["claim"] == "bitwise":
                np.testing.assert_array_equal(res["ef"], res["ef_sim"])
            else:
                _close(res["ef"], res["ef_sim"], f"{name}: ef")
        return
    got, want = _run_of(res, ""), _run_of(res, "_sim")
    _assert_wire_run(got, want, case["cfg"]["wire"],
                     case["cfg"].get("error_feedback", True))


def _run_of(res: dict, tag: str):
    """A RunResult-like view of a saved run (``tag`` "" or "_sim")."""
    state = types.SimpleNamespace(
        x_parts=torch.as_tensor(res["x" + tag]),
        v_stack=torch.as_tensor(res["v" + tag]),
        ef=torch.as_tensor(res["ef" + tag]) if "ef" + tag in res else None)
    return types.SimpleNamespace(state=state,
                                 history=res["history" + tag])


_REF = {}


def reference_run(name: str):
    """The reference's run_cola on a case's inputs (cached per case):
    with the probe of v beside the gap row for a wire case, the exact
    sigma_k for a certificate, the case's attacks."""
    if name in _REF:
        return _REF[name]
    case = ranks.CASES[name]
    prob = _problem(case)
    graph = getattr(jtopo, case["graph"][0])(*case["graph"][1])
    k = graph.num_nodes
    run = dict(case["run"])
    run.pop("comm")
    part = j_make_partition(prob.n, k)
    if "certificate" in run.get("recorder", ""):
        from repro.core.cola import build_env as j_build_env
        env = j_build_env(prob, part)
        cert = jmet.certificate_recorder(
            prob, part, env, graph, run["eps"], sigma_k=jnp.asarray(
                ranks.exact_sigma(np.asarray(env.a_parts))))
        run["recorder"] = jmet.ComposedRecorder(
            (jmet.GapRecorder(prob, part), cert))
    if case["probe"]:
        p = jnp.asarray(ranks.probe_weights(k, prob.d))
        run["recorder"] = jmet.ComposedRecorder((
            jmet.GapRecorder(prob, part),
            jmet.FnRecorder(("probe",),
                            lambda s, p=p: jnp.sum(s.v_stack * p)[None])))
    if "attacks" in run:
        run["attacks"] = ranks.attacks_of(run["attacks"], jattack)
    _REF[name] = j_run(prob, graph, JConfig(**case["cfg"]), case["rounds"],
                       block_size=16, **run)
    return _REF[name]


@pytest.mark.parametrize("name,world", WIRE_CASES)
def test_wire_ranks_match_reference_run_cola(wire_out, name, world):
    """The reference's uniforms replayed: the flip-aware comparison."""
    res = load(wire_out, name, world)
    cfg = ranks.CASES[name]["cfg"]
    _assert_wire_run(_run_of(res, ""), reference_run(name), cfg["wire"],
                     cfg.get("error_feedback", True))


@pytest.mark.parametrize("name,world", ATTACK_CASES)
def test_attack_ranks_match_reference_run_cola(wire_out, name, world):
    got = load(wire_out, name, world)["history"]
    want = reference_run(name).history
    assert got["round"] == want["round"]
    assert got["stop_round"] == want["stop_round"]
    assert got.get("violated_round") == want.get("violated_round")
    upto = (None if want.get("violated_round") is None
            else want["round"].index(want["violated_round"]) + 1)
    for key in ("primal", "gap", "consensus_violation",
                "consensus_residual"):
        if key in want:
            scale = RTOL * max(abs(v) for v in want[key][:upto])
            np.testing.assert_allclose(got[key][:upto], want[key][:upto],
                                       rtol=RTOL, atol=scale, err_msg=key)
    for key in ("cond9_nodes", "cond10_nodes", "certified",
                "certificate_violated"):
        if key in want:
            assert got[key][:upto] == want[key][:upto], key


@pytest.mark.parametrize("name,world", [
    (n, w) for n, w in cases_of("wire")
    if ranks.CASES[n]["run"]["comm"] != "dense"
    and "wire" in ranks.CASES[n]["cfg"]])
def test_wire_run_sends_the_contracts_bytes(wire_out, name, world):
    """A wire run's exchanges (the gap and probe rows gather, they do not
    exchange): per round, the plan's ``contract(wire=)`` calls and bytes,
    every rank matched in every color of these plans."""
    res = load(wire_out, name, world)
    case = ranks.CASES[name]
    graph = getattr(jtopo, case["graph"][0])(*case["graph"][1])
    plan = tplan.compile_block_plan(graph.adjacency, world)
    d = _problem(case).d
    c = plan.contract(d, wire=case["cfg"]["wire"],
                      gossip_steps=case["cfg"].get("gossip_steps", 1))
    rounds = case["rounds"]
    assert res["counts"]["calls"]["permute"] == \
        rounds * c.max_collective_permute_count
    assert res["counts"]["sent"]["permute"] == \
        rounds * c.max_collective_permute_bytes
    ln = graph.num_nodes // world
    assert c.max_collective_permute_bytes == \
        plan.num_colors * (ln * d + 4 * ln)


@pytest.mark.parametrize("world", ranks.worlds_of("wire"))
def test_one_wire_mix_per_comm(wire_out, world):
    """One round's wire mix on each comm: the block plan sends the
    contract's calls and bytes, the dense oracle all-gathers the (K/M, d)
    payload and its (K/M, 1) scales; both bitwise the stacked mix rows
    (``qmix_steps``, or the composed trim on the dequantized stack), one
    node per rank included."""
    probe = json.loads((wire_out / f"{world}_wire_probe.json").read_text())
    assert len(probe) == (12 if world == 4 else 6)
    for key, row in probe.items():
        gname, wire, comm, robust = key.split(":")
        assert row["bitwise"], key
        if comm == "plan":
            assert row["calls"] == {"permute": row["contract_count"]}, key
            assert row["sent"]["permute"] == row["contract_bytes"], key
        else:
            assert row["calls"] == {"all-gather": 2}, key
            assert row["sent"]["all-gather"] == \
                row["ln"] * row["d"] + 4 * row["ln"], key


@pytest.mark.parametrize("world", ranks.worlds_of("wire"))
def test_rank_env_is_its_rows_of_the_whole_env(wire_out, world):
    for rank in range(world):
        env = json.loads((wire_out / f"{world}_env_{rank}.json").read_text())
        for key, row in env.items():
            if "none" in row:
                assert row["none"], key
                continue
            assert row["bitwise"], key
            assert row["storage"] * world == row["whole_storage"], key


@pytest.mark.parametrize("world", ranks.worlds_of("wire"))
def test_gossip_ring_over_ranks(wire_out, world):
    k = world
    want_ref = _GOSSIP_REF[k]
    dense = np.load(wire_out / f"{world}_gossip_0.npz")
    for rank in range(world):
        z = np.load(wire_out / f"{world}_gossip_{rank}.npz")
        for key in z.files:
            if key.startswith("ring."):
                np.testing.assert_allclose(
                    z[key], z["ring_dense." + key[5:]], rtol=1e-6,
                    atol=1e-6, err_msg=key)
            for prefix in ("step.", "runner."):
                if not key.startswith(prefix):
                    continue
                name = key[len(prefix):]
                d_row = dense["dense." + name][rank:rank + 1]
                scale = max(np.abs(d_row).max(), 1e-30)
                np.testing.assert_allclose(z[key], d_row, rtol=1e-6,
                                           atol=1e-6 * scale, err_msg=key)
                r_row = want_ref[name][rank:rank + 1]
                np.testing.assert_allclose(
                    z[key], r_row, rtol=1e-5,
                    atol=1e-6 * max(np.abs(r_row).max(), 1e-30),
                    err_msg=key)
        np.testing.assert_allclose(z["runner_distance"],
                                   dense["dense_runner_distance"],
                                   rtol=1e-4, atol=1e-9)
        calls = json.loads(str(z["ring_calls"]))
        assert calls.get("all-gather", 0) == 0


@pytest.mark.parametrize("name,world", [
    (n, w) for n, w in cases_of("wire") if ranks.CASES[n]["telemetry"]])
def test_telemetry_over_ranks(wire_out, name, world):
    """Telemetry on, over 2 and 4 ranks: the run bitwise its telemetry-off
    twin; the counted wire bytes and exchanges equal rounds x the block
    plan's ``contract(wire=)`` and what ``NodeAxis`` counted; the only
    collectives telemetry adds are the one all-reduce and the one
    all-gather that combine the ranks' counts at the end (none in a
    round); the per-sender gate counts equal the port's ``run_cola``'s."""
    res = load(wire_out, name, world)
    case = ranks.CASES[name]
    np.testing.assert_array_equal(res["x_on"], res["x"])
    np.testing.assert_array_equal(res["v_on"], res["v"])
    tel = res["history_on"].pop("telemetry")
    assert res["history_on"] == res["history"]
    rounds = case["rounds"]
    assert tel["rounds"] == rounds and tel["stop_round"] is None
    graph = getattr(jtopo, case["graph"][0])(*case["graph"][1])
    wire = case["cfg"].get("wire")
    c = tplan.compile_block_plan(graph.adjacency, world).contract(
        _problem(case).d, wire=wire)
    assert tel["wire_bytes"] == rounds * c.max_collective_permute_bytes
    assert tel["permutes"] == rounds * c.max_collective_permute_count
    assert tel["contract"] == c.describe()
    on, off = res["counts_on"], res["counts"]
    assert on["sent"]["permute"] == tel["wire_bytes"]
    assert on["calls"]["permute"] == tel["permutes"]
    added = {kind: on["calls"].get(kind, 0) - off["calls"].get(kind, 0)
             for kind in set(on["calls"]) | set(off["calls"])}
    assert added == {"permute": 0, "all-gather": 1, "all-reduce": 1,
                     "broadcast": 0}
    sim = res["history_sim_on"]["telemetry"]
    assert tel["gate_rejections"] == sim["gate_rejections"]
    if "attacks" in case["run"]:
        assert tel["dishonest_nodes"] == [1, 6]
        assert tel["gate_dishonest"] > 0
    if wire is not None:
        np.testing.assert_allclose(tel["saturation_mean"],
                                   sim["saturation_mean"], rtol=1e-5)
        np.testing.assert_allclose(tel["ef_norm"], sim["ef_norm"],
                                   rtol=1e-5)
