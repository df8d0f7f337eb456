"""The port's robust mixing layer (``repro_torch.core.mixing``'s robust
section) against the JAX reference, on the CPU.

Same numpy buffers into both packages, on connected_cycle(8, 2), with and
without the honest ``self_override`` of a wire attack:

* the gate decisions (``gate_flags``) are equal;
* the trim/median center (the coordinate-wise neighborhood median, a
  selection of one input value) is bitwise the reference's, ties and
  signed zeros included;
* the outputs are within rtol 1e-6 and atol 1e-6 * max|output|: the same
  gate and the same weights, but the weighted sums are (R, K) x (K, d)
  products in the port where the reference sums an einsum over the
  (R, K, d) slots, so the terms add up in another order (a few fp32 ulps
  of the largest term; the atol covers outputs that cancel to near 0).

Port-only properties: every output depends only on the slots inside each
row's support (anything outside it changes nothing, bitwise); on a clean
neighborhood trim and median are the linear mix ``dense_mix`` within 2
ulps of max|linear| (the gate passes every edge and the rejected weight,
zero, is added to the self term; the reference's own version of this
test misses its bitwise claim by 1 ulp because its einsum sums in
another order than ``w @ buf``, a caveat of the reference listed in
ROADMAP queue 3).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix, topology as jtopo
from repro_torch.core import mixing as tmix

K, D = 8, 12
MODES = ("trim", "median", "clip")
RTOL = 1e-6


def _w(k=K):
    return jtopo.metropolis_weights(jtopo.connected_cycle(k, 2)) \
        .astype(np.float32)


def _buffers(case: int):
    """(payloads, honest states) of a neighborhood case: honest payloads
    around a common point, then attacks on the wire."""
    rng = np.random.default_rng(case)
    common = rng.standard_normal(D)
    honest = (common + 0.3 * rng.standard_normal((K, D))).astype(np.float32)
    buf = honest.copy()
    if case % 4 == 1:
        buf[3] = -10.0 * buf[3]                  # sign flip
    elif case % 4 == 2:
        buf[5] = 30.0 * buf[5] - 40.0 * common   # inflated, misaligned
    elif case % 4 == 3:
        buf[[2, 6]] = rng.standard_normal((2, D)).astype(np.float32) * 5
    return buf, honest


def _ref_center_flags(w, buf, ov, mode):
    setup = jmix._neighborhood_setup(jnp.asarray(w), jnp.asarray(buf),
                                     jnp.arange(K), ov)
    _, _, self_hot, mask, counts, _, vals = setup
    return [np.asarray(a) for a in
            jmix._gate_center_flags(vals, mask, self_hot, counts, 1)]


def _both(fn_j, fn_t, w, buf, ov, **kw):
    j = fn_j(jnp.asarray(w), jnp.asarray(buf), jnp.arange(K),
             self_override=None if ov is None else jnp.asarray(ov), **kw)
    t = fn_t(torch.as_tensor(w), torch.as_tensor(buf), torch.arange(K),
             self_override=None if ov is None else torch.as_tensor(ov), **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_robust_modes_match_reference(mode, override):
    w = _w()
    for case in range(8):
        buf, honest = _buffers(case)
        ov = honest if override else None
        jf, tf = _both(jmix.gate_flags, tmix.gate_flags, w, buf, ov,
                       mode=mode)
        np.testing.assert_array_equal(tf, jf, err_msg=f"case {case}")
        if mode != "clip":
            center, flags = _ref_center_flags(w, buf, ov, mode)
            got = tmix.robust_center(
                torch.as_tensor(w), torch.as_tensor(buf), torch.arange(K),
                self_override=None if ov is None else torch.as_tensor(ov))
            np.testing.assert_array_equal(got.numpy(), center)
            np.testing.assert_array_equal(tf, flags)
        jo, to = _both(jmix.robust_neighborhood_mix,
                       tmix.robust_neighborhood_mix, w, buf, ov, mode=mode)
        np.testing.assert_allclose(to, jo, rtol=RTOL,
                                   atol=RTOL * np.abs(jo).max(),
                                   err_msg=f"case {case}")


def test_attacks_are_flagged_and_clean_buffers_are_not():
    w = _w()
    for case in range(8):
        buf, honest = _buffers(case)
        flags = tmix.gate_flags(torch.as_tensor(w), torch.as_tensor(buf),
                                torch.arange(K), "trim",
                                self_override=torch.as_tensor(honest))
        if case % 4 == 0:
            assert not flags.any()
        elif case % 4 == 1:
            # every neighbor of the sign-flipped node rejects it, no one
            # else is rejected
            nb = (w[:, 3] != 0) & (np.arange(K) != 3)
            np.testing.assert_array_equal(flags[:, 3].numpy(), nb)
            assert not flags[:, np.arange(K) != 3].any()


def test_center_ties_and_signed_zeros_are_bitwise():
    """Equal values and +0.0 / -0.0 in one neighborhood: the selected
    slot is the reference's (a stable sort orders equal values by slot
    index, as its rank selection does)."""
    w = _w()
    buf = np.zeros((K, D), np.float32)
    buf[::2] = -0.0
    buf[:, :4] = np.float32(1.5)
    buf[1, 4:8] = -0.0
    buf[3, 8:] = np.float32(-2.0)
    for ov in (None, np.where(buf == 0, np.float32(-0.0), buf)):
        center, _ = _ref_center_flags(w, buf, ov, "median")
        got = tmix.robust_center(
            torch.as_tensor(w), torch.as_tensor(buf), torch.arange(K),
            self_override=None if ov is None else torch.as_tensor(ov))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      center.view(np.uint32))


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_robust_mix_depends_only_on_neighborhood_support(mode, override):
    """Each row's output depends only on the slots inside its support: the
    slots outside it, replaced by other values (zeros, as a block
    lowering's buffer holds, or anything else), change nothing."""
    rng = np.random.default_rng(0)
    w = _w()
    buf = rng.standard_normal((K, D)).astype(np.float32)
    ov = rng.standard_normal((K, D)).astype(np.float32) if override else None
    args = lambda b: (torch.as_tensor(w), torch.as_tensor(b),
                      torch.arange(K))
    kw = dict(self_override=None if ov is None else torch.as_tensor(ov))
    full = tmix.robust_neighborhood_mix(*args(buf), mode, **kw).numpy()
    flags = tmix.gate_flags(*args(buf), mode, **kw).numpy()
    support = (w != 0) | np.eye(K, dtype=bool)
    for i in range(K):
        for fill in (0.0, 1e3):
            other = np.where(support[i][:, None], buf,
                             np.float32(fill) * rng.standard_normal(
                                 buf.shape).astype(np.float32))
            row = tmix.robust_neighborhood_mix(*args(other), mode, **kw)
            np.testing.assert_array_equal(row.numpy()[i], full[i],
                                          err_msg=f"{mode} row {i}")
            got = tmix.gate_flags(*args(other), mode, **kw).numpy()[i]
            np.testing.assert_array_equal(got[support[i]],
                                          flags[i][support[i]])


def test_trim_and_median_are_the_linear_mix_on_clean_neighborhoods():
    rng = np.random.default_rng(1)
    w = torch.as_tensor(_w())
    common = rng.standard_normal(D)
    buf = torch.as_tensor(common + 0.05 * rng.standard_normal((K, D)),
                          dtype=torch.float32)
    linear = tmix.dense_mix(w, buf)
    ulp = np.spacing(np.float32(linear.abs().max()))
    for mode in ("trim", "median"):
        assert not tmix.gate_flags(w, buf, torch.arange(K), mode).any()
        out = tmix.robust_mix_dense(w, buf, mode)
        assert float((out - linear).abs().max()) <= 2 * ulp, mode


def test_trim_neutralizes_sign_flipped_neighbor():
    rng = np.random.default_rng(2)
    w = torch.as_tensor(_w())
    common = rng.standard_normal(D).astype(np.float32)
    buf = np.tile(common, (K, 1)) + 0.05 * rng.standard_normal(
        (K, D)).astype(np.float32)
    honest = torch.as_tensor(buf.copy())
    buf[3] = -10.0 * buf[3]
    attacked = torch.as_tensor(buf)
    out = tmix.robust_mix_dense(w, attacked, "trim", self_stack=honest)
    linear, clean = w @ attacked, w @ honest
    for i in (1, 2, 4, 5):                       # the neighbors of node 3
        assert torch.linalg.vector_norm(out[i] - clean[i]) < \
            0.2 * torch.linalg.vector_norm(linear[i] - clean[i])
    assert torch.isfinite(out[3]).all()


def test_fixed_clip_radius_and_frozen_rows_match_reference():
    """clip with a fixed radius, and a row reduced to e_k (a frozen node
    under churn), which every mode leaves at its own value."""
    w = _w()
    w[4] = 0.0
    w[:, 4] = 0.0
    w[4, 4] = 1.0
    for case in range(4):
        buf, honest = _buffers(case)
        for mode, kw in (("clip", dict(clip=0.5)), ("trim", {}),
                         ("median", {})):
            jo, to = _both(jmix.robust_neighborhood_mix,
                           tmix.robust_neighborhood_mix, w, buf, honest,
                           mode=mode, **kw)
            np.testing.assert_allclose(to, jo, rtol=RTOL,
                                       atol=RTOL * np.abs(jo).max())
            np.testing.assert_array_equal(to[4], honest[4])
            jf, tf = _both(jmix.gate_flags, tmix.gate_flags, w, buf, honest,
                           mode=mode, **kw)
            np.testing.assert_array_equal(tf, jf)


def test_robust_mix_steps_applies_wire_attack_once():
    """B robust steps: the lie exists on the first exchange only; against
    the reference's steps too."""
    rng = np.random.default_rng(4)
    w = _w()
    buf = rng.standard_normal((K, D)).astype(np.float32)
    honest = rng.standard_normal((K, D)).astype(np.float32)
    wt, bt, ht = (torch.as_tensor(a) for a in (w, buf, honest))
    two = tmix.robust_mix_steps(wt, bt, "trim", steps=2, self_stack=ht)
    first = tmix.robust_mix_dense(wt, bt, "trim", self_stack=ht)
    assert torch.equal(two, tmix.robust_mix_dense(wt, first, "trim"))
    want = jmix.robust_mix_steps(jnp.asarray(w), jnp.asarray(buf), "trim",
                                 steps=2, self_stack=jnp.asarray(honest))
    np.testing.assert_allclose(two.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want)).max())


def test_robust_mix_rejects_unknown_mode():
    w = torch.as_tensor(_w())
    buf = torch.zeros((K, D))
    for fn in (tmix.robust_mix_dense, lambda a, b, m: tmix.gate_flags(
            a, b, torch.arange(K), m)):
        with pytest.raises(ValueError, match="unknown robust mode"):
            fn(w, buf, "winsorize")


@pytest.mark.parametrize("graph", ["ring8", "torus4x4"])
@pytest.mark.parametrize("mode", MODES)
def test_non_finite_payload_reaches_only_its_neighborhood(mode, graph):
    """One ``inf`` in node 4's payload: the reference gives non-finite
    outputs only in the rows whose support holds node 4, and the port
    gives the same rows, the same NaN / inf pattern in them and the same
    finite values elsewhere (rtol 1e-5, atol 1e-6 * max|finite|). A slot
    outside a row's support never enters the row's weighted sum."""
    g = jtopo.ring(8) if graph == "ring8" else jtopo.torus_2d(4, 4)
    k = g.adjacency.shape[0]
    w = jtopo.metropolis_weights(g).astype(np.float32)
    rng = np.random.default_rng(7)
    common = rng.standard_normal(D)
    buf = (common + 0.3 * rng.standard_normal((k, D))).astype(np.float32)
    buf[4, 2] = np.inf
    want = np.asarray(jmix.robust_mix_dense(jnp.asarray(w), jnp.asarray(buf),
                                            mode))
    got = tmix.robust_mix_dense(torch.as_tensor(w), torch.as_tensor(buf),
                                mode).numpy()
    support4 = np.nonzero((w[:, 4] != 0))[0]
    bad_rows = np.nonzero(~np.isfinite(want).all(axis=1))[0]
    np.testing.assert_array_equal(bad_rows, support4)
    np.testing.assert_array_equal(
        np.nonzero(~np.isfinite(got).all(axis=1))[0], bad_rows)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * np.abs(want[fin]).max())
