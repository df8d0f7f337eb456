"""The port's decentralized baselines (DGD, DIGing, D-ADMM) against the JAX
reference, on the CPU.

The same row-partitioned problem goes into both packages (the reference's
``ConsensusProblem`` arrays carried across by
``convert.consensus_problem_from_numpy``). Tolerances: the problem's
methods rtol=1e-5, atol=1e-6 (one fp32 product or sum in another order);
runs: ``objective`` at rtol=1e-4, ``consensus`` at rtol=1e-4 with atol
1e-4 * its max, ``w_stack`` at atol 1e-4 * max|w| (fp32 rounds whose
products sum in another order, 60 rounds). The port's two executors are
compared bitwise.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl, topology as jtopo
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import baselines as tbl, topology as ttopo

K = 8
FORMS = [("square", "l2"), ("square", "l1"), ("logistic", "l2"),
         ("logistic", "l1")]


@functools.lru_cache(maxsize=None)
def _problems(loss, reg, k=K, m=200):
    x, y, _ = synthetic.regression(m, 32, seed=5)
    if loss == "logistic":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    ref = jbl.make_consensus_problem(x, y, k, loss=loss, reg=reg, lam=1e-2)
    port = convert.consensus_problem_from_numpy(
        np.asarray(ref.x_parts), np.asarray(ref.y_parts),
        np.asarray(ref.row_mask), loss=loss, reg=reg, lam=ref.lam,
        device="cpu")
    return ref, port


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("loss,reg", FORMS)
def test_consensus_problem_methods_match_reference(loss, reg):
    ref, port = _problems(loss, reg)
    rng = np.random.default_rng(0)
    w = (0.3 * rng.normal(size=(32,))).astype(np.float32)
    ws = (0.3 * rng.normal(size=(K, 32))).astype(np.float32)
    _close(port.objective(torch.as_tensor(w)).item(),
           float(ref.objective(jnp.asarray(w))))
    _close(port.smooth_grad(torch.as_tensor(ws)).numpy(),
           ref.smooth_grad(jnp.asarray(ws)))
    _close(port.prox_reg(torch.as_tensor(ws), 0.7).numpy(),
           ref.prox_reg(jnp.asarray(ws), 0.7))
    for k in (0, K - 1):
        t_slice = (port.x_parts[k], port.y_parts[k], port.row_mask[k])
        j_slice = (ref.x_parts[k], ref.y_parts[k], ref.row_mask[k])
        _close(port.local_fit(torch.as_tensor(w), t_slice).item(),
               float(ref.local_fit(jnp.asarray(w), j_slice)))


@pytest.mark.parametrize("k", [7, 8])
def test_make_consensus_problem_matches_reference(k):
    """K = 7 does not divide the 200 rows: the last block is zero-padded
    and masked. K = 8 does: a tensor's row blocks are a view of it."""
    x, y, _ = synthetic.regression(200, 32, seed=5)
    ref = jbl.make_consensus_problem(x, y, k, loss="square", reg="l2",
                                     lam=1e-2)
    for data in ((x, y), (torch.as_tensor(x), torch.as_tensor(y))):
        port = tbl.make_consensus_problem(*data, k, loss="square", reg="l2",
                                          lam=1e-2, device="cpu")
        for name in ("x_parts", "y_parts", "row_mask"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        assert (port.num_nodes, port.dim) == (ref.num_nodes, ref.dim)
    view = port.x_parts.data_ptr() == data[0].data_ptr()
    assert view == (200 % k == 0)


RUNS = {
    "dgd": (jbl.run_dgd, tbl.run_dgd, dict(step=0.3)),
    "dgd_diminishing": (jbl.run_dgd, tbl.run_dgd,
                        dict(step=0.3, diminishing=True)),
    "diging": (jbl.run_diging, tbl.run_diging, dict(step=0.1)),
    "dadmm": (jbl.run_dadmm, tbl.run_dadmm, dict(rho=1.0, inner_steps=10)),
}


@functools.lru_cache(maxsize=None)
def _reference(method, loss, reg):
    ref, _ = _problems(loss, reg)
    run, _, kw = RUNS[method]
    return run(ref, jtopo.ring(K), rounds=60, record_every=10, **kw)


@pytest.mark.parametrize("loss,reg", [("square", "l2"), ("logistic", "l1")])
@pytest.mark.parametrize("executor", ["block", "loop"])
@pytest.mark.parametrize("method", sorted(RUNS))
def test_baseline_matches_reference(method, executor, loss, reg):
    _, port = _problems(loss, reg)
    _, run, kw = RUNS[method]
    want = _reference(method, loss, reg)
    got = run(port, ttopo.ring(K), rounds=60, record_every=10,
              executor=executor, block_size=16, device="cpu", **kw)
    h, w = got.history, want.history
    assert h["round"] == w["round"] and h["stop_round"] is None
    np.testing.assert_allclose(h["objective"], w["objective"], rtol=1e-4)
    np.testing.assert_allclose(h["consensus"], w["consensus"], rtol=1e-4,
                               atol=1e-4 * max(w["consensus"]))
    w_ref = np.asarray(want.w_stack)
    np.testing.assert_allclose(got.w_stack.numpy(), w_ref, rtol=0,
                               atol=1e-4 * np.max(np.abs(w_ref)))
    assert w["objective"][-1] < w["objective"][0]


@pytest.mark.parametrize("method", sorted(RUNS))
def test_loop_and_block_executors_bitwise(method):
    _, port = _problems("logistic", "l1")
    _, run, kw = RUNS[method]
    loop, block = (run(port, ttopo.ring(K), rounds=25, record_every=4,
                       executor=ex, block_size=8, device="cpu", **kw)
                   for ex in ("loop", "block"))
    assert loop.history == block.history
    assert torch.equal(loop.w_stack, block.w_stack)


@pytest.mark.parametrize("run,kw,item", [
    (tbl.run_dgd, dict(step=0.1, robust="trim"), "item 11"),
    (tbl.run_diging, dict(step=0.1, robust="median"), "item 11"),
    (tbl.run_dgd, dict(step=0.1, telemetry=True), "item 15"),
    (tbl.run_diging, dict(step=0.1, telemetry=True), "item 15"),
    (tbl.run_dadmm, dict(rho=1.0, telemetry=True), "item 15")])
def test_unported_options_raise(run, kw, item, monkeypatch):
    """Every option is ported now. The robust aggregation (item 11):
    robust DGD and DIGing against the reference's robust runs, at the
    tolerances of ``test_baseline_matches_reference``. Telemetry (item
    15): the telemetry entry equals the reference's (the modeled wire
    bytes and exchanges, the contract line, the rounds; no registry
    written), the history at the same tolerances."""
    monkeypatch.setenv("REPRO_RUNS_DIR", "off")
    ref, port = _problems("square", "l2")
    if item == "item 11":
        j_run = {tbl.run_dgd: jbl.run_dgd,
                 tbl.run_diging: jbl.run_diging}[run]
        want = j_run(ref, jtopo.ring(K), rounds=30, record_every=5, **kw)
        got = run(port, ttopo.ring(K), rounds=30, record_every=5,
                  device="cpu", **kw)
        h, w = got.history, want.history
        assert h["round"] == w["round"]
        np.testing.assert_allclose(h["objective"], w["objective"], rtol=1e-4)
        np.testing.assert_allclose(h["consensus"], w["consensus"], rtol=1e-4,
                                   atol=1e-4 * max(w["consensus"]))
        w_ref = np.asarray(want.w_stack)
        np.testing.assert_allclose(got.w_stack.numpy(), w_ref, rtol=0,
                                   atol=1e-4 * np.max(np.abs(w_ref)))
        return
    j_run = {tbl.run_dgd: jbl.run_dgd, tbl.run_diging: jbl.run_diging,
             tbl.run_dadmm: jbl.run_dadmm}[run]
    want = j_run(ref, jtopo.ring(K), rounds=12, record_every=4, **kw)
    got = run(port, ttopo.ring(K), rounds=12, record_every=4,
              device="cpu", **kw)
    h, w = got.history, want.history
    assert h["telemetry"] == w["telemetry"]
    assert h["telemetry"]["wire_bytes"] > 0
    assert h["round"] == w["round"]
    np.testing.assert_allclose(h["objective"], w["objective"], rtol=1e-4)


def test_problem_on_another_device_raises():
    _, port = _problems("square", "l2")
    with pytest.raises(ValueError, match="problem data is on"):
        tbl.run_dgd(port, ttopo.ring(K), step=0.1, rounds=2, device="meta")
    with pytest.raises(ValueError, match="is on"):
        tbl.make_consensus_problem(torch.ones((8, 2)), torch.ones(8), 2,
                                   loss="square", reg="l2", lam=0.1,
                                   device="meta")
