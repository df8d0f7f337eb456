"""The port's recurrent blocks (``repro_torch.models.ssm``: Mamba2 / SSD,
mLSTM, sLSTM) against the JAX reference's ``repro.models.ssm`` on the
CPU.

The reference draws the weights (``*_init``); they are carried across as
numpy, and inputs come from a numpy seed. Small widths: d_model 32, SSD
state 8, head dim 8 (16 heads of Mamba2), 4 heads of xLSTM, chunk 8.
Tolerances (fp32 throughout, the same formulas summed in another order):

* outputs and carried states: atol 1e-5, rtol 1e-5;
* decode after a prefill against the forward of the whole sequence, in
  the port alone: atol 1e-5 x max|y| (the chunked scan and the one-step
  recurrence are two evaluations of the same sums);
* gradients against ``jax.grad``: atol 1e-5 x the largest magnitude of
  each gradient, rtol 1e-4, on inputs where the reference's gradients are
  finite. Where its masked ``exp`` overflows (``test_masked_exponent_*``)
  the reference's gradient is NaN and the port's is finite: there only
  the forward is held to the reference.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm

D, N, HD, H, CHUNK = 32, 8, 8, 4, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, atol=1e-5, rtol=1e-5, err=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=err)


def _close_tree(got, want, **kw):
    want = _np(want)
    assert set(got) == set(want)
    for key in want:
        _close(got[key].detach(), want[key], err=key, **kw)


def _mamba():
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), D, N, jnp.float32,
                          head_dim=HD)
    return jp, _t(jp)


def _mlstm():
    jp = jssm.mlstm_init(jax.random.PRNGKey(1), D, H, jnp.float32)
    return jp, _t(jp)


def _slstm():
    jp = jssm.slstm_init(jax.random.PRNGKey(2), D, H, jnp.float32)
    return jp, _t(jp)


# ---------------------------------------------------------------------------
# helpers and leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_reference(carried):
    x = _x((2, 7, 6), 0)
    w = _x((4, 6), 1)
    st = _x((2, 3, 6), 2) if carried else None
    yj, sj = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    yt, stt = tssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                                 None if st is None else torch.as_tensor(st))
    _close(yt, yj, atol=1e-6)
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))


def test_chunk_helpers_match_reference():
    for s, chunk in ((5, 8), (8, 8), (21, 8), (16, 8), (1, 4)):
        assert tssm._pad_len(s, chunk) == jssm._pad_len(s, chunk)
    x = _x((2, 21, 3, 2), 3)
    for value in (0.0, -1e30):
        want = jssm._pad_seq(jnp.asarray(x), 3, value=value)
        got = tssm._pad_seq(torch.as_tensor(x), 3, value=value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    padded = np.asarray(jssm._pad_seq(jnp.asarray(x), 3))
    cj = jssm._chunk(jnp.asarray(padded), 8)
    ct = tssm._chunk(torch.tensor(padded), 8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tssm._unchunk(ct).numpy(),
                                  np.asarray(jssm._unchunk(cj)))


@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_leaves_and_init_states_match_reference(block):
    """``*_leaves`` give the reference's names and shapes, its constant
    leaves exactly (``dt_bias``, ``d_skip``, ``if_bias``, ``bias``) and
    its initializer scales; ``*_init_state`` its states."""
    if block == "mamba2":
        jp, tp = _mamba()
        leaves = tssm.mamba2_leaves(D, N, head_dim=HD)
        sj = jssm.mamba2_init_state(jp, 3, N)
        st = tssm.mamba2_init_state(tp, 3, N)
    elif block == "mlstm":
        jp, tp = _mlstm()
        leaves = tssm.mlstm_leaves(D, H)
        sj = jssm.mlstm_init_state(jp, 3, H)
        st = tssm.mlstm_init_state(tp, 3, H)
    else:
        jp, tp = _slstm()
        leaves = tssm.slstm_leaves(D, H)
        sj = jssm.slstm_init_state(jp, 3, H)
        st = tssm.slstm_init_state(tp, 3, H)
    made = tcommon.init_tree(torch.Generator().manual_seed(0), leaves,
                             torch.float32, "cpu")
    assert sorted(made) == sorted(jp)
    for name, ref in _np(jp).items():
        assert tuple(made[name].shape) == ref.shape, name
        leaf = leaves[name]
        if leaf.init in ("zeros", "fill"):
            np.testing.assert_array_equal(made[name].numpy(), ref, name)
        else:   # truncated normal on [-2, 2] / sqrt(fan_in), both packages
            bound = 2.0 * leaf.fan_in ** -0.5 + 1e-7
            assert np.abs(made[name].numpy()).max() <= bound, name
            assert np.abs(ref).max() <= bound, name
    _close_tree(st, sj, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# forward, carried state, decode
# ---------------------------------------------------------------------------

def _apply(block, tp_or_jp, x, state, *, ref: bool):
    mod = jssm if ref else tssm
    if block == "mamba2":
        return mod.mamba2_apply(tp_or_jp, x, ssm_state=N, chunk=CHUNK,
                                state=state)
    if block == "mlstm":
        return mod.mlstm_apply(tp_or_jp, x, num_heads=H, chunk=CHUNK,
                               state=state)
    return mod.slstm_apply(tp_or_jp, x, num_heads=H, state=state)


def _params(block):
    return {"mamba2": _mamba, "mlstm": _mlstm, "slstm": _slstm}[block]()


@pytest.mark.parametrize("s", [CHUNK - 3, 2 * CHUNK + 5])
@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_apply_prefill_then_decode_matches_reference(block, s):
    """A prefill of S positions (S = chunk - 3 and 2 chunk + 5 pad the last
    chunk), then two decode steps carrying the state: outputs and states
    against the reference; the decode steps against the port's forward of
    all S + 2 positions."""
    jp, tp = _params(block)
    x = _x((2, s + 2, D), seed=s)
    yj, sj = _apply(block, jp, jnp.asarray(x[:, :s]), None, ref=True)
    yt, st = _apply(block, tp, torch.as_tensor(x[:, :s]), None, ref=False)
    _close(yt.detach(), yj)
    _close_tree(st, sj)
    steps = []
    for i in range(s, s + 2):
        yj, sj = _apply(block, jp, jnp.asarray(x[:, i:i + 1]), sj, ref=True)
        yt, st = _apply(block, tp, torch.as_tensor(x[:, i:i + 1]), st,
                        ref=False)
        _close(yt.detach(), yj)
        _close_tree(st, sj)
        steps.append(yt.detach())
    full, _ = _apply(block, tp, torch.as_tensor(x), None, ref=False)
    full = full.detach()
    scale = float(full.abs().max())
    _close(torch.cat(steps, 1), full[:, s:], atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("which", ["ssd", "mlstm"])
def test_chunk_scans_match_reference(which):
    """The chunk scans alone, from a random nonzero state."""
    rng = np.random.default_rng(12)
    b, s, h, p = 2, 2 * CHUNK, 3, 4
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    if which == "ssd":
        args = (f(b, s, h, p), np.abs(f(b, s, h)) * 0.3,
                -np.abs(f(h)) - 0.1, f(b, s, N), f(b, s, N), f(b, h, p, N))
        yj, hj = jssm._ssd_chunk_scan(*map(jnp.asarray, args), CHUNK)
        yt, ht = tssm._ssd_chunk_scan(*map(torch.as_tensor, args), CHUNK)
        _close(ht, hj)
    else:
        qkv = [f(b, s, h, p) for _ in range(3)]
        gates = [f(b, s, h), -np.abs(f(b, s, h))]
        state = (f(b, h, p, p), f(b, h, p), f(b, h))
        yj, sj = jssm._mlstm_chunk_scan(
            *map(jnp.asarray, qkv + gates),
            tuple(map(jnp.asarray, state)), CHUNK)
        yt, st = tssm._mlstm_chunk_scan(
            *map(torch.as_tensor, qkv + gates),
            tuple(map(torch.as_tensor, state)), CHUNK)
        for a, r in zip(st, sj):
            _close(a, r)
    _close(yt, yj)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2 * CHUNK + 5, 1])
@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_gradients_match_jax_grad(block, s):
    """From a state another call left (the chunk scans' nonzero initial
    state, the conv's carried inputs; S = 1: the decode branch): the
    outputs and new states against the reference, and d/d(x, every
    weight, the carried state) of sum(y * g + state terms) against
    ``jax.grad`` of the reference's."""
    jp, tp = _params(block)
    x = _x((2, s, D), seed=20 + s)
    _, st0 = _apply(block, jp, jnp.asarray(_x((2, 3, D), seed=7)), None,
                    ref=True)
    st0 = _np(st0)
    g = _x((2, s, D), seed=21)
    gs = {k: _x(v.shape, seed=22 + i) for i, (k, v) in
          enumerate(sorted(st0.items()))}

    def jloss(p, xx, st):
        y, new = _apply(block, p, xx, st, ref=True)
        return jnp.sum(y * g) + sum(jnp.sum(new[k] * gs[k]) for k in gs
                                    if k != "m")

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                            jax.tree.map(jnp.asarray, st0))
    tpr = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.tensor(x, requires_grad=True)
    stt = {k: torch.tensor(v, requires_grad=True) for k, v in st0.items()}
    y, new = _apply(block, tpr, xt, stt, ref=False)
    yj, newj = _apply(block, jp, jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                             st0), ref=True)
    _close(y.detach(), yj)
    _close_tree(new, newj)
    loss = torch.sum(y * torch.as_tensor(g)) + sum(
        torch.sum(new[k] * torch.as_tensor(gs[k])) for k in gs if k != "m")
    loss.backward()
    got = {**{f"p.{k}": v.grad for k, v in tpr.items()}, "x": xt.grad,
           **{f"state.{k}": v.grad for k, v in stt.items()}}
    want = {**{f"p.{k}": v for k, v in _np(jg[0]).items()},
            "x": np.asarray(jg[1]),
            **{f"state.{k}": v for k, v in _np(jg[2]).items()}}
    for name, w in want.items():
        assert np.isfinite(w).all(), name
        a = got[name]
        a = np.zeros_like(w) if a is None else a.numpy()
        _close(a, w, atol=1e-5 * max(np.abs(w).max(), 1e-30), rtol=1e-4,
               err=name)


@pytest.mark.parametrize("which", ["ssd", "mlstm"])
def test_masked_exponent_keeps_gradients_finite(which):
    """Inputs whose masked half overflows ``exp`` (a steep decay, dt 20 x
    a -2 a step, for the SSD; a large input gate late in the chunk for the
    mLSTM), differentiated through the gates: the forward equals the
    reference's, the reference's gradient is NaN (``inf * 0`` in the
    backward of ``where(causal, exp(s), 0)``), the port's finite."""
    rng = np.random.default_rng(30)
    b, s, h, p = 1, CHUNK, 2, 4
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    if which == "ssd":
        xh, a, bm, cm = f(b, s, h, p), np.full((h,), -2.0, np.float32), \
            f(b, s, N), f(b, s, N)
        h0 = np.zeros((b, h, p, N), np.float32)
        x0 = np.full((b, s, h), 20.0, np.float32)           # dt
        jfn = lambda dt: jnp.sum(jssm._ssd_chunk_scan(
            jnp.asarray(xh), dt, jnp.asarray(a), jnp.asarray(bm),
            jnp.asarray(cm), jnp.asarray(h0), CHUNK)[0])
        tfn = lambda dt: torch.sum(tssm._ssd_chunk_scan(
            torch.as_tensor(xh), dt, torch.as_tensor(a), torch.as_tensor(bm),
            torch.as_tensor(cm), torch.as_tensor(h0), CHUNK)[0])
    else:
        q, k, v = f(b, s, h, p), f(b, s, h, p), f(b, s, h, p)
        log_f = np.full((b, s, h), -0.5, np.float32)
        st = (np.zeros((b, h, p, p), np.float32),
              np.zeros((b, h, p), np.float32),
              np.full((b, h), -1e30, np.float32))
        x0 = np.zeros((b, s, h), np.float32)                # log_i
        x0[:, -1] = 120.0
        jfn = lambda li: jnp.sum(jssm._mlstm_chunk_scan(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), li,
            jnp.asarray(log_f), tuple(map(jnp.asarray, st)), CHUNK)[0])
        tfn = lambda li: torch.sum(tssm._mlstm_chunk_scan(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), li,
            torch.as_tensor(log_f), tuple(map(torch.as_tensor, st)),
            CHUNK)[0])
    xt = torch.tensor(x0, requires_grad=True)
    out = tfn(xt)
    out.backward()
    np.testing.assert_allclose(float(out.detach()),
                               float(jfn(jnp.asarray(x0))), rtol=1e-5)
    assert np.isnan(np.asarray(jax.grad(jfn)(jnp.asarray(x0)))).any()
    assert bool(torch.isfinite(xt.grad).all())
