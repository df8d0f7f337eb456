"""The port's Mixture-of-Experts against the JAX reference on the CPU.

The reference draws the weights (``moe_init``, ``moe_layer_init``,
``moe_group_init``, ``api.init``); they are carried across as numpy, and
the inputs come from a numpy seed. Every comparison records both
packages' routers (``_torch_moe.RouteLog``): the top-k indices are equal
and no top-k margin is within 1e-5 of a tie. Tolerances:

* ``moe_apply`` (scatter, dense, grouped scatter; with and without the
  shared expert; a capacity that drops pairs), ``moe_layer_apply`` and
  ``moe_group_apply``: outputs atol 3e-5, rtol 1e-4 (fp32 products summed
  in another order); aux atol 1e-6; caches as ``test_torch_models.py``;
* the dropped (token, choice) pairs: equal, read off ``_scatter_moe_local``
  with one choice weighted at a time;
* decode against the full forward (the twin of
  ``tests/test_archs_smoke.py::test_decode_matches_forward``): dense mode,
  every expert chosen (a near-tie cannot reorder the combine), atol 2e-4.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_moe import RouteLog
from repro.configs import base as jbase
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.models import mlp as jmlp
from repro.models.blocks import ModelCtx as JCtx
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttransformer
from repro_torch.models.blocks import ModelCtx
from repro_torch.models.model import build_model as tbuild
from repro.train import checkpoint as jckpt
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import steps as tsteps
from repro.train import steps as jsteps

ATOL, RTOL = 3e-5, 1e-4
D, F, E = 32, 48, 8


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _to_torch(tree):
    """A reference tree as torch tensors (lists of layers as int keys, as
    the port nests them)."""
    tree = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)
    return tcommon.nest(tcommon.flatten(_dicts(tree)))


def _dicts(tree):
    if isinstance(tree, list):
        return {i: _dicts(sub) for i, sub in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _dicts(v) for k, v in tree.items()}
    return tree


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _moe_params(shared, seed=0):
    jp = jmlp.moe_init(jax.random.PRNGKey(seed), D, F, E, jnp.float32,
                       shared_expert=shared)
    return jp, _to_torch(jp)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode,groups,k,cf", [
    ("scatter", 0, 2, 1.25),
    ("scatter", 0, 1, 1.25),
    ("dense", 0, 2, 1.25),
    ("scatter", 2, 2, 1.25),      # token-grouped dispatch
    ("scatter", 3, 1, 2.0),
    ("scatter", 0, 2, 0.5),       # a capacity that drops pairs
    ("scatter", 2, 2, 0.5),
])
def test_moe_apply_matches_reference(mode, groups, k, cf, shared,
                                     monkeypatch):
    jp, tp = _moe_params(shared)
    log = RouteLog(monkeypatch)
    x = _x((2, 12, D), seed=k + groups)
    kw = dict(experts_per_token=k, capacity_factor=cf, mode=mode,
              dispatch_groups=groups)
    yj, auxj = jmlp.moe_apply(jp, jnp.asarray(x), **kw)
    yt, auxt = tmlp.moe_apply(tp, torch.as_tensor(x), **kw)
    assert yt.shape == x.shape and yt.dtype == torch.float32
    _close(yt, yj)
    _close(auxt, auxj, atol=1e-6, rtol=0)
    log.check(calls=1)


@pytest.mark.parametrize("groups", [1, 2])
def test_scatter_drops_the_reference_pairs(groups):
    """Under capacity factor 0.5 both packages keep and drop the same
    (token, choice) pairs: with only choice j weighted, a token's output
    is nonzero iff its pair j was kept."""
    jp, tp = _moe_params(False, seed=3)
    t, k = 24, 2
    x = _x((t, D), seed=4)
    _, idx, _ = jmlp._router(jp, jnp.asarray(x), k)
    idx = np.asarray(idx)
    cap = tmlp.moe_capacity(t // groups, k, E, 0.5)
    assert cap == max(1, int(round(t // groups * k / E * 0.5)))
    kept = {}
    for j in range(k):
        w = np.zeros((t, k), np.float32)
        w[:, j] = 1.0
        if groups == 1:
            yj = jmlp._scatter_moe_local(jp["w_gate"], jp["w_up"],
                                         jp["w_down"], jnp.asarray(x),
                                         jnp.asarray(w), jnp.asarray(idx),
                                         cap, 0, E)
        else:
            yj = jax.vmap(lambda xf, wt, ix: jmlp._scatter_moe_local(
                jp["w_gate"], jp["w_up"], jp["w_down"], xf, wt, ix, cap, 0,
                E))(*(jnp.asarray(a.reshape((groups, t // groups, -1)))
                      for a in (x, w, idx))).reshape(t, D)
        yt = tmlp._scatter_moe_local(tp["w_gate"], tp["w_up"], tp["w_down"],
                                     torch.as_tensor(x), torch.as_tensor(w),
                                     torch.tensor(idx).long(), cap, 0, E,
                                     groups=groups)
        _close(yt, yj)
        kj = np.any(np.asarray(yj) != 0, axis=1)
        np.testing.assert_array_equal(yt.numpy().any(axis=1), kj)
        kept[j] = kj
    dropped = sum(int((~kj).sum()) for kj in kept.values())
    assert 0 < dropped < t * k


def _moe_cfg(arch):
    return (jbase.smoke_variant(jbase.get_config(arch)),
            tbase.smoke_variant(tbase.get_config(arch)))


@pytest.mark.parametrize("mode", ["scatter", "dense"])
@pytest.mark.parametrize("cached", [False, True])
def test_moe_layer_apply_matches_reference(mode, cached, monkeypatch):
    jcfg, tcfg = _moe_cfg("dbrx_132b")
    jp = jblocks.moe_layer_init(jax.random.PRNGKey(5), jcfg)
    tp = _to_torch(jp)
    tp_init = tblocks.moe_layer_init(torch.Generator().manual_seed(0), tcfg,
                                     torch.float32, "cpu")
    assert {n: tuple(t.shape) for n, t in tcommon.flatten(tp_init).items()} \
        == {n: tuple(t.shape) for n, t in tcommon.flatten(tp).items()}
    log = RouteLog(monkeypatch)
    b, s = 2, 10
    x = _x((b, s, tcfg.d_model), seed=6)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    cj = ct = None
    if cached:
        cj = jblocks.init_kv_cache(jcfg, b, 16, jnp.float32)
        ct = tblocks.init_kv_cache(tcfg, b, 16, torch.float32, "cpu")
    yj, cj, auxj = jblocks.moe_layer_apply(jcfg, jp, jnp.asarray(x),
                                           jnp.asarray(pos), cj,
                                           JCtx(moe_mode=mode))
    yt, ct, auxt = tblocks.moe_layer_apply(tcfg, tp, torch.as_tensor(x),
                                           torch.as_tensor(pos), ct,
                                           ModelCtx(moe_mode=mode))
    _close(yt, yj)
    _close(auxt, auxj, atol=1e-6, rtol=0)
    log.check(calls=1)
    if cached:
        got = convert.cache_to_numpy(ct)
        want = jax.tree.map(np.asarray, cj)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])


@pytest.mark.parametrize("cached", [False, True])
def test_moe_group_apply_matches_reference(cached, monkeypatch):
    jcfg, tcfg = _moe_cfg("llama4_maverick_400b")
    jp = jblocks.moe_group_init(jax.random.PRNGKey(7), jcfg)
    tp = _to_torch(jp)
    assert tcommon.flatten(jax.tree.map(np.shape, _dicts(jp))) == {
        n: tuple(t.shape) for n, t in tcommon.flatten(
            tblocks.moe_group_init(None, tcfg, torch.float32, "cpu")).items()}
    log = RouteLog(monkeypatch)
    b, s = 2, 20      # 20 > window 16: chunked-local crosses a chunk
    x = _x((b, s, tcfg.d_model), seed=8)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    cj = ct = None
    if cached:
        cj = jblocks.moe_group_init_cache(jcfg, b, 16, jnp.float32)
        ct = [tblocks.init_kv_cache(tcfg, b, 16, torch.float32, "cpu")
              for _ in range(tcfg.moe_every)]
    yj, cj, auxj = jblocks.moe_group_apply(jcfg, jp, jnp.asarray(x),
                                           jnp.asarray(pos), cj, JCtx())
    yt, ct, auxt = tblocks.moe_group_apply(tcfg, tp, torch.as_tensor(x),
                                           torch.as_tensor(pos), ct,
                                           ModelCtx())
    _close(yt, yj)
    _close(auxt, auxj, atol=1e-6, rtol=0)
    log.check(calls=1)
    if cached:
        want = jax.tree.map(np.asarray, cj)
        for got, ref in zip(ct, list(want["dense"]) + [want["moe"]]):
            got = convert.cache_to_numpy(got)
            np.testing.assert_array_equal(got["pos"], ref["pos"])
            _close(got["k"], ref["k"])
            _close(got["v"], ref["v"])


@pytest.mark.parametrize("arch", ["dbrx_132b", "llama4_maverick_400b"])
def test_decode_matches_forward(arch):
    """Twin of ``tests/test_archs_smoke.py::test_decode_matches_forward``:
    dense MoE mode, every expert chosen, atol 2e-4."""
    _, cfg = _moe_cfg(arch)
    cfg = dataclasses.replace(cfg, experts_per_token=cfg.num_experts)
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    ctx = ModelCtx(moe_mode="dense")
    b, s = 2, 10
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(b, s)))
    full, aux = api.forward(params, {"tokens": tokens}, ctx)
    assert bool(torch.isfinite(full).all()) and bool(torch.isfinite(aux))
    cache = api.init_cache(params, b, s + 4)
    _, cache = api.prefill(params, {"tokens": tokens[:, :-1]}, cache, ctx)
    dec, _ = api.decode_step(params, tokens[:, -1:], s - 1, cache)
    _close(dec[:, 0], full[:, -1], atol=2e-4, rtol=0)


def test_init_draws_one_expert_at_a_time():
    """``init_params`` draws each expert of each group on its own from the
    truncated normal / sqrt(fan_in); the router and norms as the
    reference's leaves; ``generator=None`` gives uninitialised leaves of
    the same shapes."""
    _, cfg = _moe_cfg("llama4_maverick_400b")
    cfg = dataclasses.replace(cfg, num_experts=16, num_layers=4,
                              dtype="bfloat16")
    params = ttransformer.init_params(cfg, torch.Generator().manual_seed(1),
                                      "cpu")
    assert list(params) == ttransformer.param_paths(cfg)
    assert {t.dtype for t in params.values()} == {torch.bfloat16}
    w = params["layers.moe.moe.w_gate"].float()
    assert w.shape == (2, 16, cfg.d_model, cfg.d_ff)
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0, 0],
                                                                 w[1, 0])
    z = w * cfg.d_model ** 0.5
    assert float(z.abs().max()) <= 2.0 * (1 + 2 ** -8)
    assert abs(float(z.std()) - 0.8796) < 0.01
    assert not params["layers.moe.ln1"].any()
    empty = ttransformer.init_params(cfg, None, "meta")
    assert {n: t.shape for n, t in empty.items()} == \
        {n: t.shape for n, t in params.items()}


def test_moe_training_and_expert_parallelism_raise(tmp_path):
    """MoE training and expert parallelism are ported (the id is kept from
    when they raised): ``init_train_state`` gives fp32 masters in
    ``param_paths`` order, and one ``make_train_step`` step from the
    reference's state gives finite loss, ce and aux equal to the
    reference's (rtol 1e-5, fp32 in another summation order).
    ``ModelCtx`` takes ``mesh``, ``model_axis`` and ``act_spec``; on a
    1 x 1 ``make_host_mesh`` (one gloo rank in this process) the
    expert-parallel ``moe_apply`` and a model forward through it equal the
    path without a mesh bit for bit, gradients included (M > 1:
    ``tests/test_torch_expert_parallel.py``). An unknown mode and tokens
    that do not split into dispatch groups raise."""
    jcfg, cfg = _moe_cfg("dbrx_132b")
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    assert list(state.params) == ttransformer.param_paths(cfg)
    assert {t.dtype for t in state.params.values()} == {torch.float32}
    ref = jax.tree.map(np.asarray, jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    _, jm = jsteps.make_train_step(jcfg)(
        jax.tree.map(jnp.asarray, ref), jax.tree.map(jnp.asarray, batch))
    _, tm = tsteps.make_train_step(cfg)(
        convert.train_state_from_numpy(cfg, ref, device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("loss", "ce", "aux"):
        assert np.isfinite(float(tm[key])), key
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    _, tp = _moe_params(True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(1, 1, device="cpu")
        ctx = ModelCtx(mesh=mesh, model_axis="model",
                       act_spec=P("data", None, None))
        assert (ctx.mesh, ctx.model_axis) == (mesh, "model")
        x = torch.tensor(np.random.default_rng(3).standard_normal(
            (2, 6, D)).astype(np.float32))
        outs = []
        for kw in ({}, {"mesh": mesh, "model_axis": "model"}):
            leaves = {n: t.clone().requires_grad_()
                      for n, t in tcommon.flatten(tp).items()}
            xr = x.clone().requires_grad_()
            y, aux = tmlp.moe_apply(tcommon.nest(leaves), xr,
                                    experts_per_token=2, **kw)
            (y.square().sum() + aux).backward()
            outs.append([y, aux, xr.grad] + [leaves[n].grad
                                             for n in sorted(leaves)])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        batch = {"tokens": torch.as_tensor(tokens)}
        model = tbuild(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(1))
        with torch.no_grad():
            plain, aux_p = model.forward(params, batch)
            meshed, aux_m = model.forward(params, batch, ctx)
        assert torch.equal(plain, meshed) and torch.equal(aux_p, aux_m)
        with pytest.raises(ValueError, match="act_spec"):
            model.forward(params, batch,
                          ModelCtx(mesh=mesh, act_spec=P("pod")))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="mode"):
        tmlp.moe_apply(tp, torch.zeros((1, 2, D)), experts_per_token=1,
                       mode="sparse")
    with pytest.raises(ValueError, match="dispatch groups"):
        tmlp.moe_apply(tp, torch.zeros((1, 3, D)), experts_per_token=1,
                       dispatch_groups=2)


def test_port_checkpoint_of_a_moe_dict_restores_in_the_reference(tmp_path):
    """The port's checkpoint of a llama4-shaped parameter dict keys a
    group's dense layers as list indices (``['dense'][0]``), so the
    reference restores it into its own tree, leaf for leaf."""
    jcfg, tcfg = _moe_cfg("llama4_maverick_400b")
    params = ttransformer.init_params(tcfg, torch.Generator().manual_seed(2),
                                      "cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save(path, params)
    like = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    restored = convert._nested_to_flat(jax.tree.map(
        np.asarray, jckpt.restore(path, like)))
    assert list(restored) == list(params)
    for name, t in params.items():
        np.testing.assert_array_equal(restored[name], t.numpy(), name)
