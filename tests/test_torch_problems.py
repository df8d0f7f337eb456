"""The port's problem layer against the JAX reference, on the CPU.

Same numpy inputs (seeded) into both packages. Tolerances: problem
functions rtol=1e-6 (fp32, same formulas; atol=1e-6 for values near 0);
partition, topology and synthetic data bitwise (the same numpy or the same
copy semantics).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart, problems as jprob, topology as jtopo
from repro.data import synthetic as jsyn
from repro_torch.core import partition as tpart, problems as tprob, \
    topology as ttopo
from repro_torch.data import synthetic as tsyn

RTOL, ATOL = 1e-6, 1e-6


def _data(name, seed=0, n_samples=48, n_features=20):
    x, y, _ = jsyn.regression(n_samples, n_features, seed=seed)
    if name.startswith("logistic"):
        y = (np.sign(y) + (np.sign(y) == 0)).astype(np.float32)
    return x, y


def _pair(name, lam=1e-2):
    x, y = _data(name)
    ref = jprob.PROBLEMS[name](jnp.asarray(x), jnp.asarray(y), lam)
    port = tprob.PROBLEMS[name](x, y, lam, device="cpu")
    return ref, port


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@pytest.mark.parametrize("name", sorted(jprob.PROBLEMS))
def test_problem_functions_match_reference(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(7)
    k = 3
    v = (0.3 * rng.normal(size=(k, ref.d))).astype(np.float32)
    w = (0.2 * rng.normal(size=(k, ref.d))).astype(np.float32)
    if name.startswith("logistic"):
        # f* is finite for u = -w*y in [0, 1]
        labels = _data(name)[1]
        w = (-rng.uniform(0.05, 0.95, size=(k, ref.d)) * labels) \
            .astype(np.float32)
    x = (0.5 * rng.normal(size=(ref.n,))).astype(np.float32)
    z = (rng.normal(size=(ref.n,))).astype(np.float32)
    step = np.float32(0.7)
    gp_ref, gp_port = ref.g_params(), port.g_params()
    np.testing.assert_allclose(_np(gp_port), np.asarray(gp_ref))
    tv, tw = torch.as_tensor(v), torch.as_tensor(w)
    for i in range(k):
        np.testing.assert_allclose(_np(port.f(tv)[i]), float(ref.f(v[i])),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(port.f_conj(tw)[i]),
                                   float(ref.f_conj(w[i])), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(_np(port.grad_f(tv)),
                               np.stack([ref.grad_f(vi) for vi in v]),
                               rtol=RTOL, atol=ATOL)
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    np.testing.assert_allclose(_np(port.g_el(tx, gp_port)),
                               np.asarray(ref.g_el(x, gp_ref)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(port.g_conj_el(tz, gp_port)),
                               np.asarray(ref.g_conj_el(z, gp_ref)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _np(port.prox_g_el(tz, torch.tensor(step), gp_port)),
        np.asarray(ref.prox_g_el(z, step, gp_ref)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(port.objective(tx)),
                               float(ref.objective(x)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(port.dual_objective(tw[0])),
                               float(ref.dual_objective(w[0])), rtol=RTOL,
                               atol=ATOL)
    for attr in ("tau", "mu_g", "l_bound", "d", "n"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert tuple(map(float, port.prox_spec)) == tuple(map(float,
                                                          ref.prox_spec))


def test_l1_g_is_infinite_outside_the_box():
    _, port = _pair("lasso")
    out = port.g_el(torch.tensor([0.5, -20.0]), torch.zeros(2))
    assert math.isfinite(float(out[0])) and math.isinf(float(out[1]))


@pytest.mark.parametrize("n,k", [(36, 4), (37, 4), (10, 3), (5, 8)])
def test_partition_matches_reference(n, k):
    rng = np.random.default_rng(n * k)
    a = rng.normal(size=(7, n)).astype(np.float32)
    x = rng.normal(size=(n,)).astype(np.float32)
    rp, tp = jpart.make_partition(n, k), tpart.make_partition(n, k)
    assert (rp.num_nodes, rp.n, rp.block) == (tp.num_nodes, tp.n, tp.block)
    np.testing.assert_array_equal(_np(tp.mask()), np.asarray(rp.mask()))
    np.testing.assert_array_equal(_np(tp.split_matrix(torch.as_tensor(a))),
                                  np.asarray(rp.split_matrix(jnp.asarray(a))))
    parts = tp.split_vector(torch.as_tensor(x))
    np.testing.assert_array_equal(_np(parts),
                                  np.asarray(rp.split_vector(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(tp.merge_vector(parts)), x)


@pytest.mark.parametrize("builder,args", [
    ("ring", (8,)), ("connected_cycle", (10, 2)), ("grid_2d", (3, 4)),
    ("torus_2d", (4, 4)), ("torus_2d", (1, 5)), ("complete", (6,)),
    ("star", (7,))])
def test_topology_matches_reference(builder, args):
    rg, tg = getattr(jtopo, builder)(*args), getattr(ttopo, builder)(*args)
    assert rg.name == tg.name
    np.testing.assert_array_equal(tg.adjacency, rg.adjacency)
    w_r, w_t = jtopo.metropolis_weights(rg), ttopo.metropolis_weights(tg)
    np.testing.assert_array_equal(w_t, w_r)
    assert ttopo.beta(w_t) == jtopo.beta(w_r)
    assert ttopo.spectral_gap(w_t) == jtopo.spectral_gap(w_r)
    active = np.arange(tg.num_nodes) % 3 != 1
    np.testing.assert_array_equal(ttopo.reweight_for_active(tg, active),
                                  jtopo.reweight_for_active(rg, active))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, density=0.3),
                                dict(seed=5, noise=0.0,
                                     sparsity_solution=0.5)])
def test_synthetic_bitwise(kw):
    for got, want in zip(tsyn.regression(50, 12, **kw),
                         jsyn.regression(50, 12, **kw)):
        np.testing.assert_array_equal(got, want)
    seed = kw["seed"]
    for got, want in zip(tsyn.classification(40, 9, seed=seed),
                         jsyn.classification(40, 9, seed=seed)):
        np.testing.assert_array_equal(got, want)
