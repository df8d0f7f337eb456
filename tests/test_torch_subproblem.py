"""The port's local CD solver (plain PyTorch versions of the Hopper kernels)
against the JAX reference, on the CPU.

Held against both reference functions: ``repro.core.subproblem.cd_solve_all``
(the main path's jnp solver, with step budgets and Gram blocks) and
``repro.kernels.ops.cd_solve_pallas(..., interpret=True)`` (the Pallas
kernels, run as ``tests/test_kernels.py`` runs them). Tolerance atol=1e-5,
the bar ``tests/test_kernels.py`` sets for Pallas against the jnp oracle.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import problems as jprob, subproblem as jsub
from repro.core.cola import build_env as j_build_env
from repro.core.partition import make_partition
from repro.data import synthetic
from repro.kernels.ops import cd_solve_pallas
from repro_torch.core import cola as tcola, problems as tprob, \
    subproblem as tsub
from repro_torch.kernels import cd_glm
from repro_torch.kernels.ops import cd_solve_kernel

ATOL = 1e-5
CASES = [(2, 1.0), (4, 2.0), (6, 3.0), (4, 0.45)]


def _setup(name, k, kappa, seed=0):
    x, y, _ = synthetic.regression(64, 36, seed=seed)
    if name.startswith("logistic"):
        y = (np.sign(y) + (np.sign(y) == 0)).astype(np.float32)
    ref = jprob.PROBLEMS[name](jnp.asarray(x), jnp.asarray(y), 1e-2)
    port = tprob.PROBLEMS[name](x, y, 1e-2, device="cpu")
    part = make_partition(ref.n, k)
    j_env = j_build_env(ref, part, with_gram=True)
    t_env = tcola.build_env(port, _tpart(part), with_gram=True)
    rng = np.random.default_rng(k * 100 + seed)
    x_parts = (0.1 * rng.normal(size=(k, part.block))).astype(np.float32)
    vs = (0.3 * rng.normal(size=(k, ref.d))).astype(np.float32)
    grads = np.array(jax.vmap(ref.grad_f)(jnp.asarray(vs)))
    steps = max(1, int(round(kappa * part.block)))
    budgets = rng.integers(0, steps + 1, size=k).astype(np.int32)
    budgets[0] = 0
    budgets[-1] = steps
    spec = jsub.SubproblemSpec(sigma_over_tau=k / ref.tau, inv_k=1.0 / k)
    return dict(ref=ref, port=port, j_env=j_env, t_env=t_env, x=x_parts,
                vs=vs, grads=grads, steps=steps, budgets=budgets, spec=spec)


def _tpart(part):
    from repro_torch.core.partition import Partition
    return Partition(num_nodes=part.num_nodes, n=part.n, block=part.block)


def _port_solve(s, gram, budgets=None):
    env = s["t_env"]
    t = torch.as_tensor
    return tsub.cd_solve_all(
        s["port"], tsub.SubproblemSpec(*s["spec"]), env.a_parts, t(s["x"]),
        t(s["grads"]), env.gp_parts, env.masks, s["steps"],
        step_budgets=None if budgets is None else t(budgets),
        gram_parts=env.gram_parts if gram else None).numpy()


def _ref_solve(s, gram, budgets=None):
    env = s["j_env"]
    return np.asarray(jsub.cd_solve_all(
        s["ref"], s["spec"], env.a_parts, jnp.asarray(s["x"]),
        jnp.asarray(s["grads"]), env.gp_parts, env.masks, s["steps"],
        step_budgets=None if budgets is None else jnp.asarray(budgets),
        gram_parts=env.gram_parts if gram else None))


@pytest.mark.parametrize("name", sorted(jprob.PROBLEMS))
@pytest.mark.parametrize("k,kappa", CASES)
def test_plain_cd_matches_cd_solve_all(name, k, kappa):
    s = _setup(name, k, kappa)
    for gram in (False, True):
        for budgets in (None, s["budgets"]):
            np.testing.assert_allclose(
                _port_solve(s, gram, budgets), _ref_solve(s, gram, budgets),
                atol=ATOL, err_msg=f"gram={gram} budgets={budgets}")


@pytest.mark.parametrize("name", sorted(jprob.PROBLEMS))
@pytest.mark.parametrize("k,kappa", CASES[:3])
def test_plain_cd_matches_pallas_interpret(name, k, kappa):
    s = _setup(name, k, kappa)
    env = s["j_env"]
    for mode in ("residual", "gram"):
        want = np.asarray(cd_solve_pallas(
            s["ref"], s["spec"], env.a_parts, jnp.asarray(s["x"]),
            jnp.asarray(s["grads"]), env.gp_parts, env.masks, s["steps"],
            interpret=True, cd_mode=mode))
        got = cd_solve_kernel(
            s["port"], tsub.SubproblemSpec(*s["spec"]), s["t_env"].a_parts,
            torch.as_tensor(s["x"]), torch.as_tensor(s["grads"]),
            s["t_env"].gp_parts, s["t_env"].masks, s["steps"],
            cd_mode=mode).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=mode)


def test_budget_zero_and_full_match_no_budget():
    s = _setup("lasso", 4, 2.0)
    full = _port_solve(s, gram=False)
    out = _port_solve(s, gram=False, budgets=s["budgets"])
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_array_equal(out[-1], full[-1])


def test_single_node_solvers_match_batched():
    s = _setup("elastic_net", 3, 1.5)
    env, t = s["t_env"], torch.as_tensor
    spec = tsub.SubproblemSpec(*s["spec"])
    batched = _port_solve(s, gram=False, budgets=s["budgets"])
    batched_g = _port_solve(s, gram=True, budgets=s["budgets"])
    for i in range(3):
        one = tsub.cd_solve(s["port"], spec, env.a_parts[i], t(s["x"][i]),
                            t(s["grads"][i]), env.gp_parts[i], env.masks[i],
                            s["steps"], step_budget=int(s["budgets"][i]))
        np.testing.assert_allclose(one.numpy(), batched[i], atol=1e-6)
        atg = env.a_parts[i].T @ t(s["grads"][i])
        one_g = tsub.cd_solve_gram(s["port"], spec, env.gram_parts[i], atg,
                                   t(s["x"][i]), env.gp_parts[i],
                                   env.masks[i], s["steps"],
                                   step_budget=int(s["budgets"][i]))
        np.testing.assert_allclose(one_g.numpy(), batched_g[i], atol=1e-6)


@pytest.mark.parametrize("name", ["ridge_primal", "lasso", "logistic_l2"])
def test_cd_decreases_subproblem_objective(name):
    """dx must decrease G_k (Assumption 1 with Theta < 1), for the port's
    ``eval_subproblem`` and the reference's alike."""
    s = _setup(name, 4, 1.0)
    env, t = s["t_env"], torch.as_tensor
    spec = tsub.SubproblemSpec(*s["spec"])
    dx = t(_port_solve(s, gram=True))
    for i in range(4):
        args = (env.a_parts[i], t(s["x"][i]))
        tail = (t(s["vs"][i]), t(s["grads"][i]), env.gp_parts[i],
                env.masks[i])
        g0 = tsub.eval_subproblem(s["port"], spec, *args,
                                  torch.zeros_like(dx[i]), *tail)
        g1 = tsub.eval_subproblem(s["port"], spec, *args, dx[i], *tail)
        assert float(g1) <= float(g0) + 1e-6
        je = s["j_env"]
        r1 = jsub.eval_subproblem(
            s["ref"], s["spec"], je.a_parts[i], jnp.asarray(s["x"][i]),
            jnp.asarray(dx[i].numpy()), jnp.asarray(s["vs"][i]),
            jnp.asarray(s["grads"][i]), je.gp_parts[i], je.masks[i])
        np.testing.assert_allclose(float(g1), float(r1), rtol=1e-5,
                                   atol=1e-5)


def test_block_gram_and_cols_layouts():
    s = _setup("ridge_primal", 4, 1.0)
    env = s["t_env"]
    np.testing.assert_allclose(tsub.block_gram(env.a_parts).numpy(),
                               np.asarray(jsub.block_gram(s["j_env"].a_parts)),
                               rtol=1e-5, atol=1e-6)
    cols = tsub.block_cols(env.a_parts)
    assert cols.is_contiguous()
    np.testing.assert_array_equal(cols.numpy(),
                                  env.a_parts.transpose(1, 2).numpy())


@pytest.mark.parametrize("d,n_k", [(64, 9), (64, 18), (36, 64), (400_000, 125),
                                   (2_000, 25_000), (1_000, 200)])
def test_gram_pays_agrees_with_reference_at_used_shapes(d, n_k):
    assert tsub.gram_pays(d, n_k) == jsub.gram_pays(d, n_k)


# the reference's rule at every shape: n_k < d and n_k^2 * 4 B <= 8 MiB
# (n_k <= 1,448), across the old shared-memory limit (n_k ~ 237), the
# budget's edge and the n_k < d edge
@pytest.mark.parametrize("d,n_k", [(10_000, 300), (400_000, 500),
                                   (400_000, 1_448), (400_000, 1_449),
                                   (2_000, 1_999), (2_000, 2_000),
                                   (2_000, 25_000)])
def test_gram_pays_matches_reference_rule(d, n_k):
    assert tsub.gram_pays(d, n_k) == jsub.gram_pays(d, n_k)


def test_gram_layout_limits():
    """G stays resident in shared memory up to n_k = 236 and streams above;
    the kernel takes every n_k the rule sends to it."""
    assert cd_glm.gram_fits_smem(236) and not cd_glm.gram_fits_smem(237)
    assert cd_glm.GRAM_MAX_NK >= 1_448 and tsub.gram_pays(400_000, 1_448)
    assert [cd_glm.gram_ld(n) for n in (1, 4, 125, 300, 1_447)] == \
        [4, 4, 128, 300, 1_448]


@pytest.mark.parametrize("n_k", [1, 5, 8, 125])
def test_gram_columns_hold_columns_not_rows(n_k):
    """The Gram kernel's layout: row i is column i of G, zero padded to
    ``gram_ld`` — on a non-symmetric G, where rows and columns differ."""
    rng = np.random.default_rng(n_k)
    g = torch.as_tensor(rng.normal(size=(2, n_k, n_k)).astype(np.float32))
    cols = cd_glm.gram_columns(g)
    assert cols.is_contiguous()
    assert tuple(cols.shape) == (2, n_k, cd_glm.gram_ld(n_k))
    for i in range(n_k):
        np.testing.assert_array_equal(cols[:, i, :n_k].numpy(),
                                      g[:, :, i].numpy())
    assert not cols[:, :, n_k:].any()
