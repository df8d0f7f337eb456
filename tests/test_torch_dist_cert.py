"""``repro_torch.dist.run_dist_cola`` at 2, 3 and 4 gloo ranks: the
certificate cases, one node per rank, the odd complete graph in block mode,
and the collective budgets.

One subprocess (``tests/_torch_dist_ranks.py``, group "cert") runs them;
the parity tests and their tolerances are ``tests/test_torch_dist_ranks.py``'s
(the certificate's consensus_residual adds across ranks, so certificate
histories are held at rtol 1e-6 to the port's ``run_cola``; one node per
rank runs a BLAS's matrix-vector path, so those states too). In place of
the reference's HLO checks (``tests/test_dist_plan.py``,
``tests/test_certificate_dist.py``), the budgets read the ``NodeAxis``
counts of one gossip step and one certificate record: at most
``comm_budget`` exchanges and bytes per rank per gossip step, no gather or
reduction in a round, O(colors (K/M) d) bytes a certificate record.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import json

import numpy as np
import pytest

import _torch_dist_ranks as ranks
import test_torch_dist_ranks as tdr
from repro_torch.core import topology as ttopo
from repro_torch.topo import plan as tplan

GRAPHS = {"torus": lambda: ttopo.torus_2d(2, 4),
          "complete": lambda: ttopo.complete(8),
          "complete9": lambda: ttopo.complete(9),
          "node_torus": lambda: ttopo.torus_2d(2, 2)}
PROBES = [(2, "torus"), (2, "complete"), (3, "complete9"), (4, "torus"),
          (4, "complete"), (4, "node_torus")]


@pytest.fixture(scope="module")
def cert_out(tmp_path_factory):
    return tdr.run_group(tmp_path_factory, "cert")


def probe(out, world: int, graph: str) -> dict:
    with open(out / f"{world}_probe.json") as f:
        return json.load(f)[graph]


@pytest.mark.parametrize("name,world", tdr.cases_of("cert"))
def test_ranks_match_port_run_cola(cert_out, name, world):
    tdr.assert_matches_port(tdr.load(cert_out, name, world),
                            ranks.CASES[name], f"{name}@{world}")


@pytest.mark.parametrize("name,world", tdr.cases_of("cert"))
def test_ranks_match_reference_run_cola(cert_out, name, world):
    tdr.assert_matches_reference(tdr.load(cert_out, name, world)["history"],
                                 tdr.reference_history(name),
                                 f"{name}@{world}")


@pytest.mark.parametrize("world", [2, 4])
def test_certificate_stop_truncates_like_the_simulator(cert_out, world):
    """eps= stopping on the block plan: the run stops where run_cola does,
    and its state is bitwise that of a run of stop_round + 1 rounds."""
    res = tdr.load(cert_out, "cert_stop", world)
    assert res["history"]["stop_round"] is not None
    assert res["history"]["round"][-1] == res["history"]["stop_round"]
    np.testing.assert_array_equal(res["x"], res["x_trunc"])
    np.testing.assert_array_equal(res["v"], res["v_trunc"])


def _plan(world: int, graph: str):
    g = GRAPHS[graph]()
    return (tplan.compile_plan(g) if g.num_nodes == world
            else tplan.compile_block_plan(g, world))


@pytest.mark.parametrize("world,graph", PROBES)
def test_gossip_step_within_comm_budget(cert_out, world, graph):
    """Two gossip steps exchange once per color each, send at most the
    plan's bytes, and gather or reduce nothing: ``contract().check``."""
    got = probe(cert_out, world, graph)
    pl = _plan(world, graph)
    contract = pl.contract(got["d"], 4, gossip_steps=2)
    assert contract.describe() == got["contract"]
    contract.check(got["mix"]["calls"], got["mix"]["sent"])
    assert got["mix"]["calls"] == {"permute": 2 * pl.num_colors}
    assert got["mix"]["sent"]["permute"] <= got["budget"]["bytes_per_device"]


@pytest.mark.parametrize("world,graph", [p for p in PROBES
                                         if p != (4, "node_torus")])
def test_block_colors_within_vizing(cert_out, world, graph):
    """The rank-level graph's colors stay within Delta_block + 1 (K_9 over
    3 ranks: 3 exchanges a step, where the per-node plan takes 9)."""
    got = probe(cert_out, world, graph)
    assert got["colors"] <= got["delta_block"] + 1
    if graph == "complete9":
        assert got["colors"] == 3
        assert tplan.compile_plan(GRAPHS[graph]()).num_colors == 9


@pytest.mark.parametrize("world,graph", PROBES)
def test_certificate_record_is_o_colors_block_d(cert_out, world, graph):
    """A certificate record: one exchange of the (K/M, d) gradient block a
    color, scalar reductions and one (2, d) psum; no gather."""
    got = probe(cert_out, world, graph)
    calls, sent = got["cert"]["calls"], got["cert"]["sent"]
    d, ln, colors = got["d_cert"], got["ln"], got["colors"]
    assert "all-gather" not in calls
    assert calls["permute"] == colors
    assert sent["permute"] <= colors * ln * d * 4
    assert sent["all-reduce"] <= (2 * d + 64) * 4


@pytest.mark.parametrize("name,world", [
    (n, w) for n, w in tdr.cases_of("cert")
    if ranks.CASES[n]["run"]["comm"] != "dense"
    and ranks.CASES[n]["run"].get("recorder") == "certificate"])
def test_certificate_runs_gather_only_the_result(cert_out, name, world):
    calls = tdr.load(cert_out, name, world)["counts"]["calls"]
    assert calls["all-gather"] == 2
