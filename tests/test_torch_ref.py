"""Small leftovers of ported modules against the JAX reference, on the
CPU: ``topology.disconnected`` / ``ring_weights``,
``partition.shuffle_columns`` and the plain oracles of
``repro_torch.kernels.ref`` under the reference's names
(``repro.kernels.ref``).

Tolerances: the topology and the partition are host numpy, equal. The CD
oracles compute the reference's recurrence in fp32 in another framework:
within 1e-5 x max(1, max|reference|), the bar
``tests/test_kernels.py`` holds the Pallas kernels to; on the CPU they are
bitwise the port's ``cd_solve_all`` (which runs these plain versions
there). Attention oracles: rtol and atol 2e-5 (fp32).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart, problems as jprob, \
    subproblem as jsub, topology as jtopo
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import partition as tpart, subproblem as tsub, \
    topology as ttopo
from repro_torch.kernels import ref as tref

TOL = 1e-5


def test_disconnected_gap_zero():
    """The twin of tests/test_topology.py's use of ``disconnected``."""
    w = ttopo.metropolis_weights(ttopo.disconnected(6))
    np.testing.assert_allclose(w, np.eye(6))
    assert ttopo.spectral_gap(w) == pytest.approx(0.0, abs=1e-12)
    want = jtopo.disconnected(6)
    assert ttopo.disconnected(6).name == want.name
    np.testing.assert_array_equal(ttopo.disconnected(6).adjacency,
                                  want.adjacency)


@pytest.mark.parametrize("k", [3, 8, 16])
def test_ring_weights_equal_reference(k):
    np.testing.assert_array_equal(ttopo.ring_weights(k),
                                  np.asarray(jtopo.ring_weights(k)))
    # the reference's self_weight is never read
    np.testing.assert_array_equal(np.asarray(jtopo.ring_weights(k, 0.5)),
                                  ttopo.metropolis_weights(ttopo.ring(k)))


@pytest.mark.parametrize("seed", [0, 3])
def test_shuffle_columns_equal_reference(seed):
    a = np.arange(5 * 9, dtype=np.float32).reshape(5, 9)
    got, perm = tpart.shuffle_columns(a, seed)
    want, want_perm = jpart.shuffle_columns(a, seed)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(got, want)


def _cd_inputs(k=3, d=40, n_k=12, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(d, k * n_k)) / np.sqrt(d)).astype(np.float32)
    y = rng.normal(size=(d,)).astype(np.float32)
    ref = jprob.lasso(jnp.asarray(x), jnp.asarray(y), 5e-2, box=5.0)
    port = convert.problem_from_numpy("lasso", x, y, 5e-2, box=5.0,
                                      device="cpu")
    part = tpart.make_partition(port.n, k)
    a_parts = part.split_matrix(port.a)
    arrays = dict(
        x_parts=(0.1 * rng.normal(size=(k, n_k))).astype(np.float32),
        grads=rng.normal(size=(k, port.d)).astype(np.float32),
        gp_parts=part.split_vector(port.g_params()).numpy(),
        masks=part.mask().numpy())
    return ref, port, a_parts, arrays


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("budgets", [None, (5, 0, 12)])
def test_cd_solve_ref_matches_reference_oracle(gram, budgets):
    ref, port, a_parts, arr = _cd_inputs()
    k, n_k = arr["x_parts"].shape
    spec_t = tsub.SubproblemSpec(sigma_over_tau=2.0, inv_k=1.0 / k)
    spec_j = jsub.SubproblemSpec(sigma_over_tau=2.0, inv_k=1.0 / k)
    t = {key: torch.as_tensor(v) for key, v in arr.items()}
    j = {key: jnp.asarray(v) for key, v in arr.items()}
    tb = None if budgets is None else torch.tensor(budgets)
    jb = None if budgets is None else jnp.asarray(budgets)
    g_t = tref.block_gram(a_parts) if gram else None
    g_j = jref.block_gram(jnp.asarray(a_parts.numpy())) if gram else None
    got = tref.cd_solve_ref(port, spec_t, a_parts, t["x_parts"],
                            t["grads"], t["gp_parts"], t["masks"], 2 * n_k,
                            step_budgets=tb, gram_parts=g_t)
    want = np.asarray(jref.cd_solve_ref(
        ref, spec_j, jnp.asarray(a_parts.numpy()), j["x_parts"], j["grads"],
        j["gp_parts"], j["masks"], 2 * n_k, step_budgets=jb,
        gram_parts=g_j))
    assert float(np.abs(got.numpy() - want).max()) <= \
        TOL * max(1.0, float(np.abs(want).max()))
    # on the CPU the port's solver runs these plain versions
    assert torch.equal(got, tsub.cd_solve_all(
        port, spec_t, a_parts, t["x_parts"], t["grads"], t["gp_parts"],
        t["masks"], 2 * n_k, step_budgets=tb, gram_parts=g_t))
    if gram:
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                                   atol=1e-6)
        atg = torch.bmm(t["grads"].unsqueeze(1), a_parts).squeeze(1)
        one = tref.cd_solve_gram_ref(port, spec_t, g_t[1], atg[1],
                                     t["x_parts"][1], t["gp_parts"][1],
                                     t["masks"][1], 2 * n_k)
        one_j = np.asarray(jref.cd_solve_gram_ref(
            ref, spec_j, g_j[1], jnp.asarray(atg[1].numpy()),
            j["x_parts"][1], j["gp_parts"][1], j["masks"][1], 2 * n_k))
        assert float(np.abs(one.numpy() - one_j).max()) <= \
            TOL * max(1.0, float(np.abs(one_j).max()))


@pytest.mark.parametrize("d,n_k", [(400_000, 125), (2_000, 125),
                                   (2_000, 2_000), (100, 1_449)])
def test_gram_pays_equals_reference(d, n_k):
    assert tref.gram_pays(d, n_k) == jref.gram_pays(d, n_k)


@pytest.mark.parametrize("mode,window", [("causal", 0), ("sliding", 5),
                                         ("chunked_local", 4)])
def test_attention_oracles_match_reference(mode, window):
    rng = np.random.default_rng(1)
    b, sq, h, kvh, hd = 2, 9, 4, 2, 16
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sq, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, sq, kvh, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    t = [torch.as_tensor(a) for a in (q, k, v, pos, pos)]
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    for t_fn, j_fn, kw in (
            (tref.attention_ref, jref.attention_ref, {}),
            (tref.chunked_attention_ref, jref.chunked_attention_ref,
             {"kv_chunk": 4})):
        got = t_fn(*t, mode=mode, window=window, **kw)
        want = np.asarray(j_fn(*j, mode=mode, window=window, **kw))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5,
                                   err_msg=t_fn.__name__)
