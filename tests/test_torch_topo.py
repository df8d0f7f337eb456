"""The port's topology compiler (``repro_torch.topo``) against the JAX
reference's (``repro.topo``), on the CPU.

The twin of ``tests/test_topo_plan.py``. The compiler's host side is
deterministic numpy in both packages, so colorings, exchange pairs,
partner tables, block quotients, schedules, coverage errors, byte budgets,
contracts and render lines must be EQUAL. The executors: ``plan_mix_dense``
agrees with the reference's and with ``dense_mix`` at rtol 1e-6 (the
colors sum in another order than the product); ``block_mix_dense`` equals
the port's ``dense_mix`` bitwise (its products run at the dense shape) and
the reference's block executor at rtol 1e-6 (two frameworks' products).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import topo as rtopo
from repro.core import mixing as jmixing, topology as jtopo
from repro.topo import coloring as jcol, lowering as jlow
from repro_torch import topo as ttopo_plan
from repro_torch.core import mixing as tmixing, topology as ttopo
from repro_torch.topo import coloring as tcol, lowering as tlow

# the graphs and K of tests/test_topo_plan.py
NAMED = [("ring", 7), ("ring", 8), ("torus2d", 6), ("torus2d", 16),
         ("hypercube", 8), ("complete", 5), ("complete", 9),
         ("complete", 11), ("complete", 13), ("complete", 16),
         ("cycle2", 6), ("torus2d", 8)]


def _random_support(k: int, p: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    up = np.triu(rng.random((k, k)) < p, 1)
    adj = up | up.T
    if not adj.any():
        adj[0, 1] = adj[1, 0] = True
    return adj


def _both(name: str, k: int):
    return rtopo.build(name, k), ttopo_plan.build(name, k)


def _assert_plan_equal(got, want):
    assert got.num_nodes == want.num_nodes
    assert got.colors == want.colors
    assert got.perms == want.perms
    assert got.partners == want.partners
    np.testing.assert_array_equal(got.partner_arrays(),
                                  want.partner_arrays())


def _assert_block_equal(got, want):
    assert (got.num_nodes, got.num_devices) == (want.num_nodes,
                                                want.num_devices)
    _assert_plan_equal(got.block, want.block)
    assert got.intra_edges == want.intra_edges
    assert got.inter_edges == want.inter_edges
    np.testing.assert_array_equal(got.coverage(), want.coverage())


# ---------------------------------------------------------------------------
# graphs and colorings: equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(rtopo.GRAPHS))
def test_registry_graphs_equal_reference(name):
    assert sorted(ttopo_plan.GRAPHS) == sorted(rtopo.GRAPHS)
    want, got = _both(name, 16)
    assert got.name == want.name
    np.testing.assert_array_equal(got.adjacency, want.adjacency)


@pytest.mark.parametrize("name", sorted(rtopo.GRAPHS))
def test_registry_plans_equal_reference(name):
    """Every family at K = 16: the per-node plan and the block plan on 2, 4
    and 8 ranks are the reference's."""
    want, got = _both(name, 16)
    _assert_plan_equal(ttopo_plan.compile_plan(got),
                       rtopo.compile_plan(want))
    for m in (1, 2, 4, 8):
        _assert_block_equal(ttopo_plan.compile_block_plan(got, m),
                            rtopo.compile_block_plan(want, m))


@pytest.mark.parametrize("name,k", NAMED)
@pytest.mark.parametrize("method", ["auto", "mg", "greedy"])
def test_named_graph_colorings_equal_reference(name, k, method):
    want, got = _both(name, k)
    edges = tcol.undirected_edges(got.adjacency)
    assert edges == jcol.undirected_edges(want.adjacency)
    assert tcol.edge_coloring(edges, k, method=method) == \
        jcol.edge_coloring(edges, k, method=method)
    _assert_plan_equal(ttopo_plan.compile_plan(got, method=method),
                       rtopo.compile_plan(want, method=method))
    for m in (d for d in (2, 3, 4) if k % d == 0 and d < k):
        _assert_block_equal(
            ttopo_plan.compile_block_plan(got, m, method=method),
            rtopo.compile_block_plan(want, m, method=method))


@given(k=st.integers(3, 24), p=st.floats(0.05, 0.9), seed=st.integers(0, 99))
@settings(max_examples=40, deadline=None)
def test_random_colorings_equal_reference(k, p, seed):
    """Greedy, Misra–Gries and "auto" on random supports: the reference's
    classes, each a proper coloring within its bound."""
    adj = _random_support(k, p, seed)
    edges = tcol.undirected_edges(adj)
    delta = int(adj.sum(axis=1).max())
    for method in ("greedy", "mg", "auto"):
        got = tcol.edge_coloring(edges, k, method=method)
        assert got == jcol.edge_coloring(edges, k, method=method)
        tcol.check_coloring(got, edges, k)
    assert len(tcol.misra_gries_edge_coloring(edges, k)) <= delta + 1
    assert len(tcol.greedy_edge_coloring(edges, k)) <= max(2 * delta - 1, 1)


@pytest.mark.parametrize("k", [5, 9, 11, 13])
def test_odd_complete_greedy_exceeds_vizing(k):
    adj = ttopo.complete(k).adjacency
    edges = tcol.undirected_edges(adj)
    assert len(tcol.greedy_edge_coloring(edges, k)) > k
    assert len(tcol.misra_gries_edge_coloring(edges, k)) == k
    assert ttopo_plan.compile_plan(adj).num_colors == k


def test_coloring_errors_equal_reference():
    cases = [
        lambda c: c.edge_coloring([(0, 1)], 3, method="rainbow"),
        lambda c: c.check_coloring([[(0, 1), (1, 2)]], [(0, 1), (1, 2)], 3),
        lambda c: c.check_coloring([[(0, 1)]], [(0, 1), (1, 2)], 3),
        lambda c: c.greedy_edge_coloring([(0, 0)], 3),
        lambda c: c.misra_gries_edge_coloring([(0, 1), (1, 0)], 3)]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(jcol)
        with pytest.raises(ValueError) as got:
            case(tcol)
        assert str(got.value) == str(want.value)


def test_graph_family_errors_equal_reference():
    cases = [lambda g: g.build("moebius", 16),
             lambda g: g.hypercube(12),
             lambda g: g.random_geometric(20, radius=1e-3, seed=3),
             lambda g: g.expander(5, degree=3)]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(rtopo)
        with pytest.raises(ValueError) as got:
            case(ttopo_plan)
        assert str(got.value) == str(want.value)
    for kw in (dict(degree=4, seed=1), dict(degree=3, seed=2)):
        np.testing.assert_array_equal(
            ttopo_plan.expander(16, **kw).adjacency,
            rtopo.expander(16, **kw).adjacency)
    np.testing.assert_array_equal(
        ttopo_plan.random_geometric(20, seed=3).adjacency,
        rtopo.random_geometric(20, seed=3).adjacency)


# ---------------------------------------------------------------------------
# schedules, coefficients, coverage: equal
# ---------------------------------------------------------------------------

def _w_stack(graph, t: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = graph.num_nodes
    return np.stack([ttopo.reweight_for_active(graph, rng.random(k) < 0.8)
                     for _ in range(t)]).astype(np.float32)


@pytest.mark.parametrize("name,k", [("torus2d", 6), ("cycle2", 8),
                                    ("hypercube", 8)])
def test_plan_schedules_equal_reference(name, k):
    want_g, got_g = _both(name, k)
    w_stack = _w_stack(got_g, 5)
    got = ttopo_plan.PlanSchedule.from_w_stack(
        ttopo_plan.compile_plan(got_g), w_stack)
    want = rtopo.PlanSchedule.from_w_stack(rtopo.compile_plan(want_g),
                                           w_stack)
    for key, val in got.entries().items():
        np.testing.assert_array_equal(val, want.entries()[key])
    static = ttopo_plan.PlanSchedule.from_w_stack(
        ttopo_plan.compile_plan(got_g),
        np.broadcast_to(w_stack[0], w_stack.shape), static=True)
    assert static.coefs.base is not None
    m = 2
    got_b = ttopo_plan.BlockPlanSchedule.from_w_stack(
        ttopo_plan.compile_block_plan(got_g, m), w_stack)
    want_b = rtopo.BlockPlanSchedule.from_w_stack(
        rtopo.compile_block_plan(want_g, m), w_stack)
    np.testing.assert_array_equal(got_b.entries()["plan_w"],
                                  want_b.entries()["plan_w"])
    with pytest.raises(ValueError, match="round-invariant"):
        ttopo_plan.BlockPlanSchedule.from_w_stack(
            ttopo_plan.compile_block_plan(got_g, m), w_stack, static=True)


@given(k=st.integers(4, 20), p=st.floats(0.1, 0.9), seed=st.integers(0, 99))
@settings(max_examples=30, deadline=None)
def test_w_from_coefficients_inverts_plan_coefficients(k, p, seed):
    rng = np.random.default_rng(seed)
    graph = ttopo.Topology("rand", _random_support(k, p, seed))
    plan = ttopo_plan.compile_plan(graph)
    active = rng.random(k) >= 0.3
    if not active.any():
        active[:] = True
    for w in (ttopo.metropolis_weights(graph),
              ttopo.reweight_for_active(graph, active)):
        diag, coefs = ttopo_plan.plan_coefficients(plan, w)
        want = rtopo.plan_coefficients(rtopo.compile_plan(graph.adjacency), w)
        np.testing.assert_array_equal(diag, want[0])
        np.testing.assert_array_equal(coefs, want[1])
        np.testing.assert_array_equal(
            ttopo_plan.w_from_coefficients(plan, diag, coefs), w)
        dev = ttopo_plan.w_from_coefficients_device(
            plan, torch.as_tensor(diag), torch.as_tensor(coefs))
        np.testing.assert_array_equal(dev.numpy(), w)


def test_coverage_and_shape_errors_equal_reference():
    plan_t = ttopo_plan.compile_plan(ttopo.ring(6))
    plan_j = rtopo.compile_plan(jtopo.ring(6))
    bp_t = ttopo_plan.compile_block_plan(ttopo.ring(8), 4)
    bp_j = rtopo.compile_block_plan(jtopo.ring(8), 4)
    w_bad = ttopo.metropolis_weights(ttopo.connected_cycle(6, 2))
    w_blk = np.eye(8)
    w_blk[0, 4] = w_blk[4, 0] = 0.5
    diag, coefs = ttopo_plan.plan_coefficients(
        plan_t, ttopo.metropolis_weights(ttopo.ring(6)))
    cases = [
        (lambda m, p, b: m.check_plan_covers(p, w_bad), True),
        (lambda m, p, b: m.plan_coefficients(p, w_bad), True),
        (lambda m, p, b: m.check_plan_covers(p, np.eye(4)), True),
        (lambda m, p, b: m.check_plan_covers(b, w_blk), True),
        (lambda m, p, b: m.w_from_coefficients(p, diag[:-1], coefs), True),
        (lambda m, p, b: m.w_from_coefficients(p, diag, coefs[:-1]), True),
        (lambda m, p, b: m.compile_block_plan(ttopo.ring(8).adjacency, 3),
         True)]
    for case, _ in cases:
        with pytest.raises(ValueError) as want:
            case(rtopo, plan_j, bp_j)
        with pytest.raises(ValueError) as got:
            case(ttopo_plan, plan_t, bp_t)
        assert str(got.value) == str(want.value)
    # a block pair inside one rank is covered on 2 ranks
    ttopo_plan.check_plan_covers(
        ttopo_plan.compile_block_plan(ttopo.ring(8), 2), w_blk)


# ---------------------------------------------------------------------------
# budgets, contracts, render lines: equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,k,m", [("torus2d", 16, None),
                                      ("complete", 16, 4),
                                      ("complete", 9, 3),
                                      ("hypercube", 8, None),
                                      ("ring", 8, 2), ("rgg", 16, 4)])
@pytest.mark.parametrize("wire", [None, "int8", "fp8"])
def test_budgets_contracts_and_render_equal_reference(name, k, m, wire):
    want_g, got_g = _both(name, k)
    if m is None:
        got, want = (ttopo_plan.compile_plan(got_g),
                     rtopo.compile_plan(want_g))
    else:
        got, want = (ttopo_plan.compile_block_plan(got_g, m),
                     rtopo.compile_block_plan(want_g, m))
    d = 64
    for steps in (1, 2):
        assert tlow.comm_budget(got, d, 4, gossip_steps=steps, wire=wire) \
            == jlow.comm_budget(want, d, 4, gossip_steps=steps, wire=wire)
        c_got = got.contract(d, 4, gossip_steps=steps, wire=wire)
        c_want = want.contract(d, 4, gossip_steps=steps, wire=wire)
        for field in ("name", "forbid", "max_collective_permute_bytes",
                      "max_collective_permute_count",
                      "require_collective_permute"):
            assert getattr(c_got, field) == getattr(c_want, field), field
        assert c_got.describe() == c_want.describe()
    for meth in ("bytes_per_device_per_step", "bytes_per_link_per_step",
                 "total_bytes_per_step"):
        assert getattr(got, meth)(d, 4, wire=wire) == \
            getattr(want, meth)(d, 4, wire=wire)
    assert got.render(d=d, itemsize=4, wire=wire) == \
        want.render(d=d, itemsize=4, wire=wire)
    assert got.render() == want.render()
    assert got.cache_token() == want.cache_token()
    np.testing.assert_array_equal(got.support(), want.support())
    assert got.max_degree() == want.max_degree()


def test_contract_check_reads_axis_counts():
    plan = ttopo_plan.compile_plan(ttopo.torus_2d(4, 4))
    contract = plan.contract(64, 4)
    contract.check({"permute": 4}, {"permute": 4 * 64 * 4})
    with pytest.raises(AssertionError, match="permutes"):
        contract.check({"permute": 5}, {"permute": 0})
    with pytest.raises(AssertionError, match="permute bytes"):
        contract.check({"permute": 4}, {"permute": 4 * 64 * 4 + 1})
    with pytest.raises(AssertionError, match="all-gather"):
        contract.check({"permute": 4, "all-gather": 1}, {"permute": 0})


# ---------------------------------------------------------------------------
# executors without ranks
# ---------------------------------------------------------------------------

@given(k=st.integers(2, 16), p=st.floats(0.1, 0.9), seed=st.integers(0, 999),
       drop=st.floats(0.0, 0.5))
@settings(max_examples=40, deadline=None)
def test_plan_mix_matches_reference_and_dense_mix(k, p, seed, drop):
    """The per-node executor, for a random Metropolis W and a churn
    reweighting of it: within rtol 1e-6 of the reference's executor and
    of ``dense_mix``."""
    rng = np.random.default_rng(seed)
    adj = _random_support(k, p, seed)
    plan = ttopo_plan.compile_plan(adj)
    v = rng.standard_normal((k, 7)).astype(np.float32)
    active = rng.random(k) >= drop
    if not active.any():
        active[:] = True
    graph = ttopo.Topology("rand", adj)
    for w in (ttopo.metropolis_weights(graph),
              ttopo.reweight_for_active(graph, active)):
        got = ttopo_plan.mix_with_plan(plan, w, torch.as_tensor(v)).numpy()
        want = np.asarray(rtopo.mix_with_plan(rtopo.compile_plan(adj), w, v))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        dense = tmixing.dense_mix(torch.as_tensor(w), torch.as_tensor(v))
        np.testing.assert_allclose(got, dense.numpy(), rtol=1e-6, atol=1e-6)


@given(k=st.integers(2, 16), p=st.floats(0.1, 0.9), seed=st.integers(0, 999),
       drop=st.floats(0.0, 0.5))
@settings(max_examples=40, deadline=None)
def test_block_mix_bitwise_dense_mix(k, p, seed, drop):
    """The block executor on every M dividing K, for a random W and a
    churn reweighting: the port's ``dense_mix`` bit for bit, and the
    reference's block executor within rtol 1e-6."""
    rng = np.random.default_rng(seed)
    adj = _random_support(k, p, seed)
    graph = ttopo.Topology("rand", adj)
    v = rng.standard_normal((k, 7)).astype(np.float32)
    active = rng.random(k) >= drop
    if not active.any():
        active[:] = True
    for w in (ttopo.metropolis_weights(graph),
              ttopo.reweight_for_active(graph, active)):
        dense = tmixing.dense_mix(torch.as_tensor(w), torch.as_tensor(v))
        for m in (d for d in (1, 2, 4, k) if k % d == 0):
            bp = ttopo_plan.compile_block_plan(adj, m)
            got = ttopo_plan.mix_with_block_plan(bp, w, torch.as_tensor(v))
            assert torch.equal(got, dense), m
            want = rtopo.mix_with_block_plan(
                rtopo.compile_block_plan(adj, m), w, v)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def test_block_coverage_wider_than_edges_executes_bitwise():
    bp = ttopo_plan.compile_block_plan(ttopo.ring(8), 4)
    v = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    w_extra = ttopo.metropolis_weights(ttopo.connected_cycle(8, 2))
    ttopo_plan.check_plan_covers(bp, w_extra)
    assert torch.equal(ttopo_plan.block_mix_dense(bp, w_extra, v),
                       tmixing.dense_mix(torch.as_tensor(w_extra), v))


def test_circulant_band_checks_equal_reference():
    w = ttopo.metropolis_weights(ttopo.ring(8)).astype(np.float32)
    np.testing.assert_array_equal(
        tmixing.banded_weights(torch.as_tensor(w), 1).numpy(),
        np.asarray(jmixing.banded_weights(jnp.asarray(w), 1)))
    tmixing.check_circulant_band(w, 1)
    torus = ttopo.metropolis_weights(ttopo.torus_2d(2, 4))
    with pytest.raises(ValueError) as got:
        tmixing.check_circulant_band(torus, 1)
    with pytest.raises(ValueError) as want:
        jmixing.check_circulant_band(torus, 1)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# robust block mode without ranks
# ---------------------------------------------------------------------------

# the graphs of chip_smoke.py's topo_plan phase
ROBUST_GRAPHS = ("ring", "cycle2", "torus2d", "expander", "hypercube",
                 "complete")


@pytest.mark.parametrize("name", ROBUST_GRAPHS)
@pytest.mark.parametrize("attacked", [False, True])
def test_block_robust_mix_dense_bitwise_robust_mix_dense(name, attacked):
    """The robust block executor at M = 4 (16 nodes) is bitwise the
    port's ``robust_mix_dense`` for trim, median and clip (its products
    run at the stacked shape), with and without honest own slots under a
    sign-flipped payload, and within rtol 1e-6 of the reference's block
    executor."""
    want_g, got_g = _both(name, 16)
    got_bp = ttopo_plan.compile_block_plan(got_g, 4)
    want_bp = rtopo.compile_block_plan(want_g, 4)
    w = ttopo.metropolis_weights(got_g).astype(np.float32)
    rng = np.random.default_rng(7)
    v = (1.0 + rng.standard_normal((16, 24))).astype(np.float32)
    honest = v.copy()
    if attacked:
        v[3] *= -10.0
    self_stack = torch.as_tensor(honest) if attacked else None
    for mode in ("trim", "median", "clip"):
        got = ttopo_plan.block_robust_mix_dense(
            got_bp, w, torch.as_tensor(v), mode, self_stack=self_stack)
        assert torch.equal(got, tmixing.robust_mix_dense(
            torch.as_tensor(w), torch.as_tensor(v), mode,
            self_stack=self_stack)), mode
        want = np.asarray(rtopo.plan.block_robust_mix_dense(
            want_bp, w, jnp.asarray(v), mode,
            self_stack=jnp.asarray(honest) if attacked else None))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=mode)


def test_block_robust_mix_dense_rejects_uncovered_w():
    bp = ttopo_plan.compile_block_plan(ttopo.ring(8), 4)
    w = ttopo.metropolis_weights(ttopo.complete(8))
    with pytest.raises(ValueError):
        ttopo_plan.block_robust_mix_dense(bp, w, torch.ones((8, 3)), "trim")
