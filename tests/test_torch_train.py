"""The port's training path against the JAX reference, on the CPU, at
Qwen3-4B's ``smoke_variant`` (2 layers, d 256, fp32); the MoE family's
remat case at dbrx's (MoE training: ``test_torch_moe_train.py``).

Both packages get the same numpy inputs from a seed; the reference's
parameters are carried across with ``convert``. Tolerances:

* cross entropy, attention values and gradients, loss and its gradients:
  rtol 1e-5 (values) and atol 1e-5 x the largest magnitude (gradients):
  the same fp32 math in another summation order;
* the train step with SGD + momentum (smooth in g) for 3 steps, with 1 and
  2 microbatches: rtol 1e-5, atol 1e-6 x max|param| on every parameter;
* AdamW and SGD on identical gradients: rtol 1e-6, atol 1e-7 (fp32
  state); bf16 moments within one bf16 ulp;
* a whole AdamW train step: AdamW's first step is lr * g / (|g| + eps) per
  coordinate, so a coordinate whose gradient is at rounding level can take
  any step up to lr; the bound is the measured spread (atol 2 * lr on a
  parameter, and 99.9 % of the coordinates within 1e-6 of the reference);
* the token pipeline and the schedules: bitwise / rtol 1e-6; checkpoints:
  exact (npz round trips).

The flash Function's gradients are held against ``jax.grad`` of the
reference's ``chunked_attention`` (the function its training
differentiates), in every mask mode, with an empty slot and a fully masked
row. On that row the kernel (and its plain version) gives 0 where
``chunked_attention`` gives the mean of V, so the cotangent is zero there
and the port's row and its dq are checked to be 0.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, smoke_variant as jsmoke
from repro.data import synthetic as jsyn
from repro.models import attention as jatt
from repro.models.blocks import DEFAULT_CTX as JCTX
from repro.models.common import softmax_cross_entropy as jce
from repro.optim import optimizers as jopt, schedules as jsched
from repro.train import checkpoint as jckpt, data as jdata, steps as jsteps
from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.blocks import DEFAULT_CTX
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.optim import optimizers as topt, schedules as tsched
from repro_torch.train import checkpoint as tckpt, data as tdata
from repro_torch.train import steps as tsteps

ARCH = "qwen3_4b"


def _cfgs(**kw):
    return (dataclasses.replace(jsmoke(jget(ARCH)), **kw),
            dataclasses.replace(smoke_variant(get_config(ARCH)), **kw))


@pytest.fixture(scope="module")
def ref_state():
    cfg, _ = _cfgs()
    st = jsteps.init_train_state(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, st)


def _tokens(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree):
    return convert._nested_to_flat(jax.tree.map(np.asarray, tree))


def _close(got, want, rtol=1e-5, atol_rel=1e-5, err=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30),
                               err_msg=err)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jce(jnp.asarray(logits), jnp.asarray(labels),
               None if mask is None else jnp.asarray(mask))
    got = softmax_cross_entropy(torch.as_tensor(logits),
                                torch.as_tensor(labels),
                                None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked:   # an all-zero mask divides by max(sum, 1) = 1: zero loss
        zero = softmax_cross_entropy(torch.as_tensor(logits),
                                     torch.as_tensor(labels),
                                     torch.zeros((3, 7)))
        assert float(zero) == 0.0


# (mode, window, positions case)
ATTN_GRAD_CASES = [("causal", 0, "plain"), ("sliding", 5, "plain"),
                   ("chunked_local", 8, "plain"), ("causal", 0, "empty"),
                   ("cross", 0, "empty")]


@pytest.mark.parametrize("mode,window,case", ATTN_GRAD_CASES)
def test_flash_function_gradients_match_jax_grad(mode, window, case):
    b, s, h, kvh, hd = 2, 24, 4, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    q_pos = np.tile(np.arange(s), (b, 1)).astype(np.int32)
    kv_pos = q_pos.copy()
    dead = np.zeros((b, s), bool)
    if case == "empty":
        kv_pos[0, 5] = -1          # an empty slot
        kv_pos[1, 0] = -1          # batch 1, query 0: no admissible key
        if mode == "cross":
            kv_pos[1, :] = -1
            kv_pos[1, 3] = 3
        else:
            dead[1, 0] = True
    do[dead] = 0.0
    kw = dict(mode=mode, window=window)
    j_out, vjp = jax.vjp(
        lambda a, b_, c: jatt.chunked_attention(
            a, b_, c, jnp.asarray(q_pos), jnp.asarray(kv_pos), kv_chunk=8,
            **kw), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.as_tensor(q_pos),
                              torch.as_tensor(kv_pos), grad_chunk=8, **kw)
    out.backward(torch.as_tensor(do))
    live = ~dead
    _close(out.detach().numpy()[live], np.asarray(j_out)[live], err="out")
    assert not out.detach().numpy()[dead].any()
    assert not tq.grad.numpy()[dead].any()
    for name, got, want in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk),
                            ("dv", tv.grad, jdv)):
        _close(got.numpy(), want, err=name)


def test_flash_function_only_with_a_gradient():
    """Serving (no grad) keeps the plain call; with a gradient the call
    goes through the Function, whose forward is the same route."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 8, 2, 8), (1, 8, 1, 8), (1, 8, 1, 8)))
    pos = torch.arange(8, dtype=torch.int32)[None]
    with torch.no_grad():
        a = tfa.flash_attention(q, k, v, pos, pos, mode="causal")
    assert a.grad_fn is None
    b = tfa.flash_attention(q.requires_grad_(), k, v, pos, pos,
                            mode="causal")
    assert type(b.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(a, b.detach())
    with pytest.raises(ValueError, match="one key source"):
        tfa.flash_attention(q, k, v, pos, pos, mode="causal", k2=k, v2=v,
                            kv_pos2=pos)


@pytest.mark.parametrize("labels", [False, True])
def test_loss_fn_value_and_grads_match_reference(ref_state, labels):
    cfg, tcfg = _cfgs()
    toks = _tokens(cfg)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks)}
    if labels:
        lab = np.roll(toks, -1, axis=1)
        jb["labels"], tb["labels"] = jnp.asarray(lab), torch.as_tensor(lab)
    (jl, (jce_, _)), jg = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg, p, jb, JCTX, 0.01), has_aux=True)(
        jax.tree.map(jnp.asarray, ref_state.params))
    params = convert.params_from_numpy(tcfg, ref_state.params, device="cpu")
    req = {n: p.requires_grad_() for n, p in params.items()}
    tl, (tce, _) = tsteps.loss_fn(tcfg, req, tb, DEFAULT_CTX, 0.01)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tce.detach()), float(jce_), rtol=1e-5)
    for name, g in _flat(jg).items():
        _close(req[name].grad.numpy(), g, err=name)


@pytest.fixture()
def sgd(monkeypatch):
    """Both packages' train steps with SGD + momentum in place of AdamW."""
    monkeypatch.setattr(jsteps, "_optimizer",
                        lambda hp: jopt.sgd_momentum(0.9))
    monkeypatch.setattr(tsteps, "_optimizer",
                        lambda hp: topt.sgd_momentum(0.9))


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(sgd, micro):
    cfg, tcfg = _cfgs()
    hp = jsteps.TrainHParams(lr=0.05, grad_clip=1.0, microbatches=micro)
    thp = tsteps.TrainHParams(lr=0.05, grad_clip=1.0, microbatches=micro)
    jst = jsteps.init_train_state(cfg, jax.random.PRNGKey(1), hp)
    tst = convert.train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(cfg, hp))
    tstep = tsteps.make_train_step(tcfg, thp)
    pipe = jdata.TokenBatches(cfg.vocab_size, 4, 16, corpus_tokens=1 << 12)
    for i in range(3):
        b = pipe(i)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b))
        tst, tm = tstep(tst, {k: torch.as_tensor(a) for k, a in b.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(tst.step) == int(jst.step) == 3
    want = _flat(jst.params)
    for name, p in tst.params.items():
        _close(p.numpy(), want[name], atol_rel=1e-6, err=name)
    for name, mu in _flat(jst.opt_state["mu"]).items():
        _close(tst.opt_state["mu"][name].numpy(), mu, err=name)


def test_adamw_train_step_within_measured_spread(ref_state):
    cfg, tcfg = _cfgs()
    hp = jsteps.TrainHParams(lr=1e-3)
    jst = jax.tree.map(jnp.asarray, ref_state)
    tst = convert.train_state_from_numpy(tcfg, ref_state, device="cpu")
    b = jdata.TokenBatches(cfg.vocab_size, 2, 16, corpus_tokens=1 << 12)(0)
    jst, _ = jax.jit(jsteps.make_train_step(cfg, hp))(
        jst, jax.tree.map(jnp.asarray, b))
    tst, _ = tsteps.make_train_step(tcfg, tsteps.TrainHParams(lr=1e-3))(
        tst, {k: torch.as_tensor(a) for k, a in b.items()})
    for name, want in _flat(jst.params).items():
        diff = np.abs(tst.params[name].numpy() - want)
        assert diff.max() <= 2 * hp.lr, name
        assert np.mean(diff <= 1e-6) >= 0.999, name


def test_remat_policies_give_the_same_gradients(ref_state):
    grads = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots"),
                          (True, "none")):
        _, tcfg = _cfgs(remat=remat, remat_policy=policy)
        params = convert.params_from_numpy(tcfg, ref_state.params,
                                           device="cpu")
        req = {n: p.requires_grad_() for n, p in params.items()}
        loss, _ = tsteps.loss_fn(tcfg, req, {"tokens": torch.as_tensor(
            _tokens(tcfg))}, DEFAULT_CTX, 0.01)
        loss.backward()
        grads[(remat, policy)] = {n: p.grad for n, p in req.items()}
    base = grads.pop((False, "full"))
    for key, g in grads.items():
        for name in base:
            torch.testing.assert_close(g[name], base[name], rtol=1e-6,
                                       atol=1e-7, msg=f"{key} {name}")


def test_remat_keeps_each_layer_aux_term(ref_state, monkeypatch):
    """A layer that emits an aux term keeps it under every remat policy:
    with each dense layer's aux set to the mean square of its output, and
    with the MoE family's own load-balance term (dbrx's smoke variant, the
    router inside the checkpointed group: its recompute routes as the
    forward did), loss, aux and gradients agree with the run without
    checkpointing (rtol 1e-6, atol 1e-7)."""
    from repro_torch.models import blocks as tblocks
    apply = tblocks.dense_layer_apply

    def with_aux(*args, **kw):
        y, cache, _ = apply(*args, **kw)
        return y, cache, torch.mean(torch.square(y.float()))

    monkeypatch.setattr(tblocks, "dense_layer_apply", with_aux)
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        _, tcfg = _cfgs(remat=remat, remat_policy=policy)
        params = convert.params_from_numpy(tcfg, ref_state.params,
                                           device="cpu")
        req = {n: p.requires_grad_() for n, p in params.items()}
        loss, (_, aux) = tsteps.loss_fn(tcfg, req, {"tokens": torch.as_tensor(
            _tokens(tcfg))}, DEFAULT_CTX, 0.01)
        loss.backward()
        runs[(remat, policy)] = (loss.detach(), aux.detach(),
                                 {n: p.grad for n, p in req.items()})
    base_loss, base_aux, base = runs.pop((False, "full"))
    assert float(base_aux) > 0.0
    for key, (loss, aux, g) in runs.items():
        torch.testing.assert_close(aux, base_aux, rtol=1e-6, atol=1e-7,
                                   msg=str(key))
        torch.testing.assert_close(loss, base_loss, rtol=1e-6, atol=1e-7,
                                   msg=str(key))
        for name in base:
            torch.testing.assert_close(g[name], base[name], rtol=1e-6,
                                       atol=1e-7, msg=f"{key} {name}")
    monkeypatch.undo()
    _check_moe_remat_aux()


def _check_moe_remat_aux():
    mcfg = jsmoke(jget("dbrx_132b"))
    state = jax.tree.map(np.asarray, jsteps.init_train_state(
        mcfg, jax.random.PRNGKey(5)))
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        tcfg = dataclasses.replace(smoke_variant(get_config("dbrx_132b")),
                                   remat=remat, remat_policy=policy)
        params = convert.params_from_numpy(tcfg, state.params, device="cpu")
        req = {n: p.requires_grad_() for n, p in params.items()}
        loss, (_, aux) = tsteps.loss_fn(tcfg, req, {"tokens": torch.as_tensor(
            _tokens(tcfg))}, DEFAULT_CTX, 0.01)
        loss.backward()
        runs[(remat, policy)] = (loss.detach(), aux.detach(),
                                 {n: p.grad for n, p in req.items()})
    base_loss, base_aux, base = runs.pop((False, "full"))
    assert float(base_aux) > 0.0
    for key, (loss, aux, g) in runs.items():
        torch.testing.assert_close(aux, base_aux, rtol=1e-6, atol=1e-7,
                                   msg=f"moe {key}")
        torch.testing.assert_close(loss, base_loss, rtol=1e-6, atol=1e-7,
                                   msg=f"moe {key}")
        for name in base:
            torch.testing.assert_close(g[name], base[name], rtol=1e-6,
                                       atol=1e-7, msg=f"moe {key} {name}")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    rng = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b": (7,)}
    p = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    jo = jopt.adamw(weight_decay=0.1, state_dtype=jnp.dtype(state_dtype))
    to = topt.adamw(weight_decay=0.1,
                    state_dtype=getattr(torch, state_dtype))
    jp = jax.tree.map(jnp.asarray, p)
    js = jo.init(jp)
    tp = {n: torch.as_tensor(a.copy()) for n, a in p.items()}
    ts = to.init(tp)
    for step in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.asarray(step, jnp.int32), 1e-2)
        to.update({n: torch.as_tensor(a) for n, a in g.items()}, ts, tp,
                  torch.tensor(step, dtype=torch.int32), 1e-2)
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
        for key in ("m", "v"):
            want = np.asarray(js[key][n], np.float32)
            got = ts[key][n].float().numpy()
            if state_dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:     # one bf16 ulp: 2^-7 relative
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=1e-30)


def test_sgd_momentum_and_commit():
    rng = np.random.default_rng(6)
    p = rng.standard_normal((4, 3)).astype(np.float32)
    g = rng.standard_normal((4, 3)).astype(np.float32)
    jo, to = jopt.sgd_momentum(0.8), topt.sgd_momentum(0.8)
    js = jo.init({"w": jnp.asarray(p)})
    jp, js = jo.update({"w": jnp.asarray(g)}, js, {"w": jnp.asarray(p)},
                       jnp.asarray(0), 0.1)
    jp, js = jo.update({"w": jnp.asarray(g)}, js, jp, jnp.asarray(1), 0.1)
    tp = {"w": torch.as_tensor(p.copy())}
    ts = to.init(tp)
    for step in range(2):
        to.update({"w": torch.as_tensor(g)}, ts, tp, torch.tensor(step),
                  0.1)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts["mu"]["w"].numpy(),
                               np.asarray(js["mu"]["w"]), rtol=1e-6)
    before = tp["w"].clone()
    to.update({"w": torch.as_tensor(g)}, ts, tp, torch.tensor(2), 0.1,
              commit=torch.tensor(False))
    assert torch.equal(tp["w"], before)


def test_clip_by_global_norm_and_schedules_match_reference():
    rng = np.random.default_rng(7)
    g = {"a": rng.standard_normal((5, 4)).astype(np.float32) * 3,
         "b": rng.standard_normal((9,)).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tg, tn = topt.clip_by_global_norm(
            {n: torch.as_tensor(a) for n, a in g.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for n in g:
            np.testing.assert_allclose(tg[n].numpy(), np.asarray(jg[n]),
                                       rtol=1e-6, atol=1e-7)
    for step in (0, 3, 9, 10, 57, 200):
        np.testing.assert_allclose(
            float(tsched.linear_warmup(step, 10, 3e-4)),
            float(jsched.linear_warmup(step, 10, 3e-4)), rtol=1e-6)
        np.testing.assert_allclose(
            float(tsched.cosine_schedule(torch.tensor(step), 10, 100, 3e-4,
                                         1e-5)),
            float(jsched.cosine_schedule(step, 10, 100, 3e-4, 1e-5)),
            rtol=1e-6)


def test_token_pipeline_is_bitwise_the_reference():
    np.testing.assert_array_equal(tsyn.token_stream(5000, 300, seed=3),
                                  jsyn.token_stream(5000, 300, seed=3))
    a = tdata.TokenBatches(512, 4, 16, corpus_tokens=1 << 12, seed=2)
    b = jdata.TokenBatches(512, 4, 16, corpus_tokens=1 << 12, seed=2)
    for step, shard in ((0, 0), (5, 0), (5, 3)):
        x, y = a(step, shard), b(step, shard)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(x[key], y[key])
            assert x[key].dtype == y[key].dtype == np.int32


def test_checkpoints_restore_across_packages(ref_state, tmp_path):
    cfg, tcfg = _cfgs()
    # reference writes params, the port restores them
    jckpt.save(str(tmp_path / "ref.npz"), ref_state.params)
    like = convert.params_from_numpy(tcfg, ref_state.params, device="cpu")
    like = {n: torch.zeros_like(p) for n, p in like.items()}
    got = tckpt.restore(str(tmp_path / "ref.npz"), like)
    for name, want in _flat(ref_state.params).items():
        np.testing.assert_array_equal(got[name].numpy(), want)
    # the port writes a whole train state, the reference restores it
    tst = convert.train_state_from_numpy(tcfg, ref_state, device="cpu")
    tst.step.fill_(7)
    tst.params["ln_f"].add_(1.0)
    tckpt.save(str(tmp_path / "port.npz"), tst)
    back = jckpt.restore(str(tmp_path / "port.npz"),
                         jax.tree.map(jnp.asarray, ref_state))
    assert int(back.step) == 7
    for name, want in tst.params.items():
        np.testing.assert_array_equal(_flat(back.params)[name],
                                      want.numpy())
    for name, want in tst.opt_state["v"].items():
        np.testing.assert_array_equal(_flat(back.opt_state["v"])[name],
                                      want.numpy())
    # and the port restores its own file; a missing leaf raises
    again = tckpt.restore(str(tmp_path / "port.npz"), tst)
    assert int(again.step) == 7
    assert torch.equal(again.params["ln_f"], tst.params["ln_f"])
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(str(tmp_path / "ref.npz"),
                      {**like, "extra": torch.zeros(2)})


def test_train_state_round_trip_and_stacked_replicas(ref_state):
    _, tcfg = _cfgs()
    tst = convert.train_state_from_numpy(tcfg, ref_state, device="cpu")
    back = convert.train_state_to_numpy(tst)
    for name, want in _flat(ref_state.params).items():
        np.testing.assert_array_equal(_flat(back["params"])[name], want)
    stacked = jax.tree.map(lambda a: np.stack([a, a + 1]), ref_state)
    sst = convert.train_state_from_numpy(tcfg, stacked, device="cpu")
    assert sst.params["embed"].shape[0] == 2
    assert tuple(sst.step.shape) == (2,)
    bad = {"params": {**ref_state.params, "embed": np.zeros((3, 3))},
           "opt_state": ref_state.opt_state, "step": ref_state.step}
    with pytest.raises(ValueError, match="embed"):
        convert.train_state_from_numpy(tcfg, bad, device="cpu")


def test_serving_steps_over_masters_match_reference(ref_state):
    cfg, tcfg = _cfgs()
    prompt = _tokens(cfg, b=2, s=8, seed=9)
    want = jsteps.greedy_generate(cfg, jax.tree.map(jnp.asarray,
                                                    ref_state.params),
                                  jnp.asarray(prompt), 4, 16)
    params = convert.params_from_numpy(tcfg, ref_state.params, device="cpu")
    got = tsteps.greedy_generate(tcfg, params, torch.as_tensor(prompt), 4,
                                 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from repro_torch.models import transformer
    cache = transformer.init_cache(tcfg, tsteps._model(tcfg, params), 2, 16)
    logits, cache = tsteps.make_prefill_step(tcfg)(
        params, {"tokens": torch.as_tensor(prompt)}, cache)
    jcache = jax.tree.map(jnp.asarray, convert.cache_to_numpy(
        transformer.init_cache(tcfg, tsteps._model(tcfg, params), 2, 16)))
    jlogits, _ = jsteps.make_prefill_step(cfg)(
        jax.tree.map(jnp.asarray, ref_state.params),
        {"tokens": jnp.asarray(prompt)}, jcache)
    _close(logits.numpy(), jlogits, atol_rel=1e-5)
    step_logits, _ = tsteps.make_decode_step(tcfg)(
        params, got[:, :1], 8, cache)
    assert step_logits.shape == (2, 1, tcfg.vocab_size)


@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_7b"])
def test_recurrent_train_state_checkpoints_restore_both_ways(arch,
                                                             tmp_path):
    """A train state of each recurrent family (Zamba2: the Mamba2 blocks a
    list per group, the shared block unstacked) written by the reference
    restores in the port, and the port's file in the reference, leaf for
    leaf; a misshapen leaf raises."""
    cfg, tcfg = jsmoke(jget(arch)), smoke_variant(get_config(arch))
    state = jax.tree.map(np.asarray, jsteps.init_train_state(
        cfg, jax.random.PRNGKey(6)))
    jckpt.save(str(tmp_path / "ref.npz"), state)
    like = convert.train_state_from_numpy(tcfg, state, device="cpu")
    zero = lambda d: {n: torch.zeros_like(p) for n, p in d.items()}
    like = tsteps.TrainState(zero(like.params),
                             {k: zero(v) for k, v in like.opt_state.items()},
                             torch.zeros_like(like.step))
    got = tckpt.restore(str(tmp_path / "ref.npz"), like)
    for name, want in _flat(state.params).items():
        np.testing.assert_array_equal(got.params[name].numpy(), want)
    for name, want in _flat(state.opt_state["m"]).items():
        np.testing.assert_array_equal(got.opt_state["m"][name].numpy(), want)
    got.step.fill_(3)
    for p in got.params.values():
        p.add_(0.5)
    tckpt.save(str(tmp_path / "port.npz"), got)
    back = jckpt.restore(str(tmp_path / "port.npz"),
                         jax.tree.map(jnp.asarray, state))
    assert int(back.step) == 3
    for name, want in got.params.items():
        np.testing.assert_array_equal(_flat(back.params)[name],
                                      want.numpy())
    name = next(iter(got.params))
    bad = got._replace(params={**got.params, name: torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path / "port.npz"), bad)
