"""MoE training (dbrx, llama4) against the JAX reference on the CPU, at the
``smoke_variant`` widths (dbrx: 4 experts top-2; llama4: 4 experts top-1
with a shared expert, a dense and an MoE layer per group), fp32. The
loss / gradient test also takes the recurrent families (xLSTM-125M,
Zamba2-7B) at their smoke widths with two groups, under remat none and
full: every leaf's gradient, Zamba2's shared attention + MLP leaves (a sum
over groups) and ``ln_attn`` / ``ln_mlp`` included, at the same bars. And
the encdec and vlm families (SeamlessM4T, InternVL2) at their smoke
widths under remat none and full, with their frontend input (frame
embeddings, patches) from numpy in the batch: the encoder's ``enc_*``,
the cross attention's ``xattn.*`` and ``patch_proj`` leaves included; a
microbatched step (the frontend input split with the tokens) and train
state checkpoints both ways for both.

The reference draws the train state; it is carried across with
``convert``, and the tokens come from numpy. Every comparison records
both packages' routers (``_torch_moe.RouteLog``): the routes are equal
and no top-k margin is within 1e-5 of a tie. Tolerances:

* loss, ce, aux: rtol 1e-5; every leaf's gradient against ``jax.grad``
  of the reference's ``loss_fn``: rtol 1e-5, atol 1e-5 x the leaf's
  largest magnitude (fp32 in another summation order), in scatter and
  dense modes, with drops (capacity factor 0.5), under remat full / dots
  / none (each policy against no remat, for the MoE family too, is also
  ``test_torch_train.py::test_remat_keeps_each_layer_aux_term``);
* the train step with SGD + momentum (smooth in g) and 2 microbatches,
  2 steps, and gossip steps over ring(4): rtol 1e-5, atol 1e-6 x
  max|param| (``test_torch_train.py``'s and ``test_torch_gossip.py``'s
  bars);
* one AdamW step: the measured spread of ``test_torch_train.py`` (atol
  2 lr, 99.9 % of coordinates within 1e-6): AdamW's first step is
  sign-sensitive at rounding-level gradients;
* checkpoints: exact (npz round trips).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moe import RouteLog, frontend_np
from repro.configs.base import get_config as jget, smoke_variant as jsmoke
from repro.models.blocks import ModelCtx as JCtx
from repro.optim import gossip as jgsp, optimizers as jopt
from repro.train import checkpoint as jckpt, data as jdata, steps as jsteps
from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.models.blocks import ModelCtx
from repro_torch.optim import gossip as tgsp, optimizers as topt
from repro_torch.train import checkpoint as tckpt, steps as tsteps

MOE = ["dbrx_132b", "llama4_maverick_400b"]
RECURRENT = ["xlstm_125m", "zamba2_7b"]
FRONTEND = ["seamless_m4t_medium", "internvl2_26b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(jsmoke(jget(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


def _ref_state(cfg, seed=0):
    return jax.tree.map(np.asarray, jsteps.init_train_state(
        cfg, jax.random.PRNGKey(seed)))


def _flat(tree):
    return convert._nested_to_flat(jax.tree.map(np.asarray, tree))


def _close(got, want, rtol=1e-5, atol_rel=1e-5, err=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30),
                               err_msg=err)


def _tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# (arch, mode, capacity factor, remat, remat_policy)
GRAD_CASES = [
    ("dbrx_132b", "scatter", 1.25, False, "full"),
    ("dbrx_132b", "dense", 1.25, False, "full"),
    ("dbrx_132b", "scatter", 0.5, False, "full"),     # drops pairs
    ("dbrx_132b", "scatter", 1.25, True, "full"),
    ("dbrx_132b", "scatter", 1.25, True, "none"),
    ("llama4_maverick_400b", "scatter", 1.25, False, "full"),
    ("llama4_maverick_400b", "dense", 1.25, False, "full"),
    ("llama4_maverick_400b", "scatter", 0.5, True, "dots"),
    # the recurrent families (no router): Zamba2's shared attention and
    # MLP leaves are read by every group, so their gradient is a sum over
    # groups, and under remat each group's recompute reads them again
    ("xlstm_125m", "scatter", 1.25, False, "full"),
    ("xlstm_125m", "scatter", 1.25, True, "full"),
    ("zamba2_7b", "scatter", 1.25, False, "full"),
    ("zamba2_7b", "scatter", 1.25, True, "full"),
    # encdec: the cross K/V enter each checkpointed decoder layer as
    # inputs, so their gradients reach xattn.wk / wv and the encoder;
    # vlm: the patches' projection, the text scored only
    ("seamless_m4t_medium", "scatter", 1.25, True, "none"),
    ("seamless_m4t_medium", "scatter", 1.25, True, "full"),
    ("internvl2_26b", "scatter", 1.25, True, "none"),
    ("internvl2_26b", "scatter", 1.25, True, "full"),
]


@pytest.mark.parametrize("arch,mode,cf,remat,policy", GRAD_CASES)
def test_loss_and_grads_match_jax_grad(arch, mode, cf, remat, policy,
                                       monkeypatch):
    # two groups for the recurrent families, so that a gradient is summed
    # over groups (the smoke widths hold one)
    kw = ({"num_layers": 2 * jsmoke(jget(arch)).num_layers}
          if arch in RECURRENT else {})
    cfg, tcfg = _cfgs(arch, moe_capacity_factor=cf, remat=remat,
                      remat_policy=policy, **kw)
    state = _ref_state(cfg)
    tokens = _tokens(cfg)
    batch = {"tokens": tokens, **frontend_np(cfg, len(tokens), 20, 5)}
    log = RouteLog(monkeypatch)
    (jl, (jce, jaux)), jg = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg, p, jax.tree.map(jnp.asarray, batch),
                                 JCtx(moe_mode=mode), 0.01),
        has_aux=True)(jax.tree.map(jnp.asarray, state.params))
    params = convert.params_from_numpy(tcfg, state.params, device="cpu")
    req = {n: p.requires_grad_() for n, p in params.items()}
    tl, (tce, taux) = tsteps.loss_fn(
        tcfg, req, {k: torch.as_tensor(a) for k, a in batch.items()},
        ModelCtx(moe_mode=mode), 0.01)
    tl.backward()
    moe = cfg.family == "moe"
    if moe:
        log.check()
    for got, want in ((tl, jl), (tce, jce), (taux, jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    assert (float(taux.detach()) > 0.0) == moe
    grads = _flat(jg)
    assert list(grads) == list(req)
    for name, g in grads.items():
        assert np.isfinite(g).all(), name
        _close(req[name].grad.numpy(), g, err=name)
    if not moe:
        assert not log.port and not log.ref
        assert cfg.family != "hybrid" or any(
            n.startswith("shared.") for n in grads)
        front = {"encdec": ("enc_in_proj", "enc_layers.attn.wq",
                            "layers.xattn.wk", "layers.xattn.wv"),
                 "vlm": ("patch_proj",)}.get(cfg.family, ())
        assert all(np.abs(grads[n]).max() > 0 for n in front), front
        assert all(g.shape[0] == 2 for n, g in grads.items()
                   if n.startswith("layers."))
        return
    # the router learns: through aux always, through the combine for k > 1
    router = [n for n in grads if n.endswith("router")]
    assert router and all(np.abs(grads[n]).max() > 0 for n in router)


@pytest.fixture()
def sgd(monkeypatch):
    monkeypatch.setattr(jsteps, "_optimizer",
                        lambda hp: jopt.sgd_momentum(0.9))
    monkeypatch.setattr(tsteps, "_optimizer",
                        lambda hp: topt.sgd_momentum(0.9))


@pytest.mark.parametrize("arch", MOE)
def test_microbatched_train_step_matches_reference(sgd, arch, monkeypatch):
    """Two microbatches, each sizing its MoE capacity from its own tokens:
    loss, ce, aux and the gradient norm each step, and the parameters and
    momenta after 2 steps."""
    cfg, tcfg = _cfgs(arch)
    hp = jsteps.TrainHParams(lr=0.05, microbatches=2)
    thp = tsteps.TrainHParams(lr=0.05, microbatches=2)
    jst = jsteps.init_train_state(cfg, jax.random.PRNGKey(1), hp)
    tst = convert.train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(cfg, hp))
    tstep = tsteps.make_train_step(tcfg, thp)
    pipe = jdata.TokenBatches(cfg.vocab_size, 4, 16, corpus_tokens=1 << 12)
    log = RouteLog(monkeypatch)
    for i in range(2):
        b = pipe(i)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b))
        tst, tm = tstep(tst, {k: torch.as_tensor(a) for k, a in b.items()})
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    log.check()
    assert int(tst.step) == 2
    for name, want in _flat(jst.params).items():
        _close(tst.params[name].numpy(), want, atol_rel=1e-6, err=name)
    for name, mu in _flat(jst.opt_state["mu"]).items():
        _close(tst.opt_state["mu"][name].numpy(), mu, err=name)


def test_adamw_train_step_within_measured_spread():
    cfg, tcfg = _cfgs("dbrx_132b")
    state = _ref_state(cfg, seed=2)
    hp = jsteps.TrainHParams(lr=1e-3)
    b = jdata.TokenBatches(cfg.vocab_size, 2, 16, corpus_tokens=1 << 12)(0)
    jst, jm = jax.jit(jsteps.make_train_step(cfg, hp))(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, b))
    tst = convert.train_state_from_numpy(tcfg, state, device="cpu")
    tst, tm = tsteps.make_train_step(tcfg, tsteps.TrainHParams(lr=1e-3))(
        tst, {k: torch.as_tensor(a) for k, a in b.items()})
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    for name, want in _flat(jst.params).items():
        diff = np.abs(tst.params[name].numpy() - want)
        assert diff.max() <= 2 * hp.lr, name
        assert np.mean(diff <= 1e-6) >= 0.999, name


@pytest.mark.parametrize("arch", MOE)
def test_one_train_step_no_nans(arch):
    """Twin of ``tests/test_archs_smoke.py::test_one_train_step_no_nans``
    for the MoE archs: the port's own init and step."""
    cfg = smoke_variant(get_config(arch))
    hp = tsteps.TrainHParams(lr=1e-3)
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(2),
                                    hp, device="cpu")
    tokens = torch.as_tensor(_tokens(cfg, 2, 16, seed=3)).long()
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    state, metrics = tsteps.make_train_step(cfg, hp)(state, batch)
    for key in ("loss", "grad_norm", "aux"):
        assert np.isfinite(float(metrics[key])), key
    assert float(metrics["aux"]) > 0.0
    for name, p in state.params.items():
        assert bool(torch.isfinite(p).all()), name


def test_train_state_checkpoint_both_ways(tmp_path):
    """A llama4 train state (a group's dense layers a list in the
    reference): the reference's file restores in the port and the port's
    in the reference, leaf for leaf, moments and step included."""
    cfg, tcfg = _cfgs("llama4_maverick_400b")
    state = _ref_state(cfg, seed=3)
    jckpt.save(str(tmp_path / "ref.npz"), state)
    like = convert.train_state_from_numpy(tcfg, state, device="cpu")
    like = tsteps.TrainState(
        {n: torch.zeros_like(p) for n, p in like.params.items()},
        {k: {n: torch.zeros_like(p) for n, p in v.items()}
         for k, v in like.opt_state.items()}, torch.zeros_like(like.step))
    got = tckpt.restore(str(tmp_path / "ref.npz"), like)
    assert list(got.params) == list(_flat(state.params))
    for name, want in _flat(state.params).items():
        np.testing.assert_array_equal(got.params[name].numpy(), want)
    for name, want in _flat(state.opt_state["v"]).items():
        np.testing.assert_array_equal(got.opt_state["v"][name].numpy(), want)
    got.step.fill_(5)
    got.params["layers.moe.moe.router"].add_(1.0)
    tckpt.save(str(tmp_path / "port.npz"), got)
    back = jckpt.restore(str(tmp_path / "port.npz"),
                         jax.tree.map(jnp.asarray, state))
    assert int(back.step) == 5
    for name, want in got.params.items():
        np.testing.assert_array_equal(_flat(back.params)[name],
                                      want.numpy())
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(str(tmp_path / "port.npz"),
                      {**got.params, "layers.moe.extra": torch.zeros(2)})


def test_gossip_training_matches_reference(sgd, monkeypatch):
    """dbrx's smoke model, K = 4 replicas on ring(4), 2 gossip steps (SGD
    + momentum local steps): every replica's parameters, the losses and
    the consensus distance against the reference's ``make_gossip_step``."""
    cfg, tcfg = _cfgs("dbrx_132b")
    k = 4
    hp = jsteps.TrainHParams(lr=0.05)
    state0 = jsteps.init_train_state(cfg, jax.random.PRNGKey(4), hp)
    jst = jgsp.replicate_state(state0, k)
    tst = convert.train_state_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                            jst),
                                         device="cpu")
    gcfg = jgsp.GossipConfig(num_nodes=k)
    jstep = jgsp.make_gossip_step(jsteps.make_train_step(cfg, hp), gcfg)
    tstep = tgsp.make_gossip_step(
        tsteps.make_train_step(tcfg, tsteps.TrainHParams(lr=0.05)),
        tgsp.GossipConfig(num_nodes=k))
    w = gcfg.weights().astype(np.float32)
    act = np.ones((k,), np.float32)
    pipe = jdata.TokenBatches(cfg.vocab_size, 2, 16, corpus_tokens=1 << 12)
    log = RouteLog(monkeypatch)
    for i in range(2):
        b = {key: np.stack([pipe(i, shard=j)[key] for j in range(k)])
             for key in ("tokens", "labels")}
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b), jnp.asarray(w),
                        jnp.asarray(act))
        tst, tm = tstep(tst, {key: torch.as_tensor(a)
                              for key, a in b.items()}, torch.as_tensor(w),
                        torch.as_tensor(act))
        for key in ("loss", "aux"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                       rtol=1e-5, err_msg=key)
    # the reference's router runs under vmap over the replicas: its
    # callback records replica by replica within each group's call, where
    # the port runs replica by replica, each through every group
    jax.effects_barrier()
    groups = cfg.num_layers
    assert len(log.ref) == len(log.port) == 2 * k * groups
    for step in range(2):
        for g in range(groups):
            for j in range(k):
                np.testing.assert_array_equal(
                    log.port[(step * k + j) * groups + g],
                    log.ref[(step * groups + g) * k + j])
    assert min(log.margins) > 1e-5
    for name, want in _flat(jst.params).items():
        _close(tst.params[name].numpy(), want, atol_rel=1e-6, err=name)
    np.testing.assert_allclose(
        float(tgsp.consensus_distance(tst.params)),
        float(jgsp.consensus_distance(jst.params)), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_microbatched_train_step_matches_reference(sgd, arch):
    """Two microbatches, each taking its rows of the tokens and of the
    frontend input: loss, ce and the gradient norm each step, and the
    parameters and momenta after 2 steps."""
    cfg, tcfg = _cfgs(arch)
    hp = jsteps.TrainHParams(lr=0.05, microbatches=2)
    thp = tsteps.TrainHParams(lr=0.05, microbatches=2)
    jst = jsteps.init_train_state(cfg, jax.random.PRNGKey(6), hp)
    tst = convert.train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(cfg, hp))
    tstep = tsteps.make_train_step(tcfg, thp)
    pipe = jdata.TokenBatches(cfg.vocab_size, 4, 16, corpus_tokens=1 << 12)
    for i in range(2):
        b = {**pipe(i), **frontend_np(cfg, 4, 12, 10 + i)}
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b))
        tst, tm = tstep(tst, {k: torch.as_tensor(a) for k, a in b.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(tst.step) == 2
    for name, want in _flat(jst.params).items():
        _close(tst.params[name].numpy(), want, atol_rel=1e-6, err=name)
    for name, mu in _flat(jst.opt_state["mu"]).items():
        _close(tst.opt_state["mu"][name].numpy(), mu, err=name)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_train_state_checkpoint_both_ways(arch, tmp_path):
    """An encdec or vlm train state: the reference's file restores in the
    port and the port's in the reference, leaf for leaf."""
    cfg, tcfg = _cfgs(arch)
    state = _ref_state(cfg, seed=7)
    jckpt.save(str(tmp_path / "ref.npz"), state)
    like = convert.train_state_from_numpy(tcfg, state, device="cpu")
    like = tsteps.TrainState(
        {n: torch.zeros_like(p) for n, p in like.params.items()},
        {k: {n: torch.zeros_like(p) for n, p in v.items()}
         for k, v in like.opt_state.items()}, torch.zeros_like(like.step))
    got = tckpt.restore(str(tmp_path / "ref.npz"), like)
    assert list(got.params) == list(_flat(state.params))
    for name, want in _flat(state.params).items():
        np.testing.assert_array_equal(got.params[name].numpy(), want)
    for name, want in _flat(state.opt_state["v"]).items():
        np.testing.assert_array_equal(got.opt_state["v"][name].numpy(),
                                      want)
    got.step.fill_(3)
    front = "enc_in_proj" if cfg.family == "encdec" else "patch_proj"
    got.params[front].add_(1.0)
    tckpt.save(str(tmp_path / "port.npz"), got)
    back = jckpt.restore(str(tmp_path / "port.npz"),
                         jax.tree.map(jnp.asarray, state))
    assert int(back.step) == 3
    for name, want in got.params.items():
        np.testing.assert_array_equal(_flat(back.params)[name],
                                      want.numpy())


@pytest.mark.parametrize("arch,key", [("seamless_m4t_medium", "enc_embeds"),
                                      ("internvl2_26b", "patches")])
def test_launcher_refuses_frontend_families(arch, key):
    """The token pipeline makes no frontend input: the port's launcher
    raises a ValueError naming it (all-reduce and gossip), where the
    reference's step fails on the pipeline's batch with a KeyError (a
    difference by design)."""
    from repro_torch.launch import train as tlaunch
    for extra in ([], ["--gossip", "2"]):
        with pytest.raises(ValueError, match=f"needs '{key}'"):
            tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "1", *extra])
    cfg, _ = _cfgs(arch)
    b = jdata.TokenBatches(cfg.vocab_size, 2, 8, corpus_tokens=1 << 10)(0)
    with pytest.raises(KeyError, match=key):
        jsteps.loss_fn(cfg, jsteps.init_train_state(
            cfg, jax.random.PRNGKey(0)).params,
            jax.tree.map(jnp.asarray, b), JCtx(), 0.01)


@pytest.mark.parametrize("arch", FRONTEND)
def test_launcher_trains_frontend_batches(sgd, arch):
    """A pipe whose batches carry the frontend input trains through the
    launcher: ``train``'s loss, ce and gradient norm each step against the
    reference's step on the same batches, and ``gossip_train`` (2 nodes,
    each shard with its own frontend rows) finite."""
    from repro_torch.launch import train as tlaunch
    cfg, tcfg = _cfgs(arch)
    hp = jsteps.TrainHParams(lr=0.05)
    thp = tsteps.TrainHParams(lr=0.05)
    jst = jsteps.init_train_state(cfg, jax.random.PRNGKey(8), hp)
    tst = convert.train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst), device="cpu")
    tokens = jdata.TokenBatches(cfg.vocab_size, 2, 16, corpus_tokens=1 << 12)

    def pipe(i, shard=0):
        return {**tokens(i, shard=shard),
                **frontend_np(cfg, 2, 12, 20 + 2 * i + shard)}

    res = tlaunch.train(tcfg, thp, pipe, 2, device="cpu", state=tst)
    jstep = jax.jit(jsteps.make_train_step(cfg, hp))
    for i, tm in enumerate(res.metrics):
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, pipe(i)))
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} step {i}")
    gres = tlaunch.gossip_train(tcfg, thp, pipe,
                                tgsp.GossipConfig(num_nodes=2), 1,
                                device="cpu")
    assert bool(torch.isfinite(gres.metrics[0]["loss"]).all())
