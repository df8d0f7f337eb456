"""The port's LM sharding rules against the reference's (the twin of
``tests/test_sharding.py``), on the production mesh sizes.

The reference's trees come from ``jax.eval_shape`` (``repro.launch.specs``,
shared through a module-level cache); the port's are ``meta`` tensors
(``repro_torch.launch.specs``). Claims, all exact:

* ``param_pspecs``: the port's flat dict, zipped in ``param_paths`` order
  with the reference's leaves, has the same shape, dtype and spec leaf by
  leaf, with FSDP on and off and with ``moe_output_fsdp``;
* ``cache_pspecs`` for every decode shape (long_500k only where
  sub-quadratic), on the single- and the multi-pod axes: leaves matched
  by path; the MoE family's one stacked KV cache is held to each of the
  reference's group leaves (same rank, trailing dims and spec; its
  leading dim the groups' sum);
* ``batch_pspecs`` for every shape on both axes;
* every port spec divides its dim; FSDP + TP shards > 90 % of the bytes;
* per-rank argument bytes of ``launch.dryrun.size_pair`` equal the same
  arithmetic over the reference's trees and specs, for every (arch,
  shape, mesh). One difference by design: encdec's decode takes the
  cross K/V in ``cfg.dtype`` (the port encodes with the parameters cast
  to it), where the reference's, encoded from the fp32 masters, are fp32.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ARCHS, SHAPES, get_config as jget
from repro.dist import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import transformer as jtransformer
from repro_torch.configs.base import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, mesh as tmesh, specs
from repro_torch.models import transformer

SIZES = {"data": 16, "model": 16, "pod": 2}
AXES = {"single": (jshd.MeshAxes(), shd.MeshAxes()),
        "multi": (jshd.MeshAxes(pod="pod"), shd.MeshAxes(pod="pod"))}
FLAGS = [dict(fsdp=True), dict(fsdp=False),
         dict(fsdp=True, moe_output_fsdp=True)]
DECODE = [s for s in SHAPES.values() if s.kind == "decode"]


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    return jspecs.params_specs(jget(arch))


@functools.lru_cache(maxsize=None)
def ref_state(arch: str):
    return jspecs.state_specs(jget(arch))


@functools.lru_cache(maxsize=None)
def ref_cache(arch: str, batch: int, max_len: int):
    return jspecs.cache_specs(jget(arch), batch, max_len)


def _jleaves(specs_tree) -> list:
    return jax.tree.leaves(specs_tree, is_leaf=lambda x: isinstance(x, JP))


def _path_name(path) -> str:
    keys = []
    for e in path:
        keys.append(str(e.key) if hasattr(e, "key") else str(e.idx))
    return ".".join(keys)


def _ref_named(tree, specs_tree) -> dict:
    """{dotted path: (leaf, spec)} of a reference tree."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {_path_name(p): (leaf, spec)
            for (p, leaf), spec in zip(leaves, _jleaves(specs_tree))}


def _feasible(cfg, shape) -> bool:
    return shape.name != "long_500k" or cfg.sub_quadratic


@pytest.mark.parametrize("flags", FLAGS, ids=["fsdp", "resident", "moegrp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, flags):
    ref = ref_params(arch)
    ref_specs = jshd.param_pspecs(ref, jshd.MeshAxes(), SIZES, **flags)
    params = specs.params_specs(get_config(arch))
    ours = shd.param_pspecs(params, shd.MeshAxes(), SIZES, **flags)
    assert list(params) == transformer.param_paths(get_config(arch))
    assert len(params) == len(jax.tree.leaves(ref))
    for (name, t), leaf, spec in zip(params.items(), jax.tree.leaves(ref),
                                     _jleaves(ref_specs)):
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name, name
        assert tuple(ours[name]) == tuple(spec), (name, ours[name], spec)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, mesh):
    jaxes, taxes = AXES[mesh]
    cfg = get_config(arch)
    for shape in DECODE:
        if not _feasible(cfg, shape):
            continue
        b, s = shape.global_batch, shape.seq_len
        ref = ref_cache(arch, b, s)
        ref_named = _ref_named(ref, jshd.cache_pspecs(
            jget(arch), ref, b, jaxes, SIZES))
        cache = specs.cache_specs(cfg, b, s)
        ours = dict(dryrun._named_leaves(cache, True))
        our_specs = dict(dryrun._named_leaves(
            shd.cache_pspecs(cfg, cache, b, taxes, SIZES), True))
        if set(ours) == set(ref_named):
            for name, (leaf, spec) in ref_named.items():
                t = ours[name]
                assert tuple(t.shape) == leaf.shape, (shape.name, name)
                assert str(t.dtype).removeprefix("torch.") == \
                    leaf.dtype.name
                assert tuple(our_specs[name]) == tuple(spec), (name, spec)
            continue
        # the MoE family's one stacked cache against each group leaf
        assert cfg.family == "moe" and cfg.moe_every > 1, arch
        lead = {}
        for name, (leaf, spec) in ref_named.items():
            key = name.rsplit(".", 1)[-1]
            t = ours[key]
            assert t.dim() == len(leaf.shape), name
            assert tuple(t.shape[1:]) == leaf.shape[1:], name
            assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name
            assert tuple(our_specs[key]) == tuple(spec), (name, spec)
            lead[key] = lead.get(key, 0) + leaf.shape[0]
        assert lead == {key: t.shape[0] for key, t in ours.items()}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_reference(arch, mesh):
    jaxes, taxes = AXES[mesh]
    for shape in SHAPES.values():
        ref = jshd.batch_pspecs(jget(arch), shape, jaxes)
        ours = shd.batch_pspecs(get_config(arch), shape, taxes)
        assert set(ours) == set(ref), shape.name
        for key, spec in ref.items():
            assert tuple(ours[key]) == tuple(spec), (shape.name, key)


def _check_divisible(tree, spec_tree, tag):
    for (name, t), (_, spec) in zip(dryrun._named_leaves(tree, False),
                                    dryrun._named_leaves(spec_tree, False)):
        shd.local_shape(t.shape, spec, SIZES)   # raises where it does not
        for dim, axis in zip(t.shape, spec):
            if axis is not None:
                assert dim % shd._size(SIZES, axis) == 0, (tag, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible(arch):
    params = specs.params_specs(get_config(arch))
    _check_divisible(params, shd.param_pspecs(params, shd.MeshAxes(), SIZES),
                     arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_divisible(arch):
    cfg = get_config(arch)
    for shape in DECODE:
        if not _feasible(cfg, shape):
            continue
        cache = specs.cache_specs(cfg, shape.global_batch, shape.seq_len)
        _check_divisible(cache, shd.cache_pspecs(
            cfg, cache, shape.global_batch, shd.MeshAxes(), SIZES),
            f"{arch}:{shape.name}")


@pytest.mark.parametrize("arch", ["qwen3_4b", "llama4_maverick_400b"])
def test_large_weights_are_sharded(arch):
    """FSDP + TP takes effect: > 90 % of the parameter bytes sit on
    leaves with a non-trivial spec."""
    params = specs.params_specs(get_config(arch))
    pspecs = shd.param_pspecs(params, shd.MeshAxes(), SIZES)
    total = sharded = 0
    for name, t in params.items():
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if any(a is not None for a in pspecs[name]):
            sharded += nbytes
    assert sharded > 0.9 * total, (arch, sharded / total)


def test_local_shape_and_rank_bytes():
    spec = shd.P(("pod", "data"), None, "model")
    assert shd.local_shape((64, 3, 32), spec, SIZES) == (2, 3, 2)
    assert shd.local_shape((5,), shd.P(), SIZES) == (5,)
    with pytest.raises(ValueError, match="split"):
        shd.local_shape((10, 3), shd.P("data"), SIZES)
    tree = {"a": specs._meta((64, 3, 32), torch.float32),
            "b": [specs._meta((7,), torch.bfloat16)]}
    assert shd.rank_bytes(tree, {"a": spec, "b": [shd.P()]}, SIZES) == \
        2 * 3 * 2 * 4 + 7 * 2


# ---------------------------------------------------------------------------
# per-rank argument bytes against the reference's trees
# ---------------------------------------------------------------------------

def _ref_bytes(tree, specs_tree, sizes) -> int:
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), _jleaves(specs_tree)):
        n = 1
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        for dim, axis in zip(leaf.shape, entries):
            div = 1
            for a in (() if axis is None else
                      axis if isinstance(axis, tuple) else (axis,)):
                div *= sizes[a]
            assert dim % div == 0
            n *= dim // div
        total += n * leaf.dtype.itemsize
    return total


def _ref_argument_bytes(arch: str, shape, jaxes, sizes, *,
                        cross_kv_itemsize: int | None = None) -> int:
    """The reference dry run's arguments (``_train_artifacts``,
    ``_prefill_artifacts``, ``_decode_artifacts``), sized per rank."""
    cfg = jget(arch)
    kind = shape.kind
    flags = dict(fsdp=True, moe_output_fsdp=False)   # the baseline's
    b = shape.global_batch
    if kind == "train":
        state = ref_state(arch)
        ps = jshd.param_pspecs(state.params, jaxes, sizes, **flags)
        state_specs = state._replace(params=ps, opt_state={"m": ps, "v": ps},
                                     step=JP())
        batch = jspecs.input_specs(cfg, shape)
        return (_ref_bytes(state, state_specs, sizes)
                + _ref_bytes(batch, jshd.batch_pspecs(cfg, shape, jaxes),
                             sizes))
    params = ref_params(arch)
    total = _ref_bytes(params, jshd.param_pspecs(params, jaxes, sizes,
                                                 **flags), sizes)
    cache = ref_cache(arch, b, shape.seq_len)
    total += _ref_bytes(cache, jshd.cache_pspecs(cfg, cache, b, jaxes,
                                                 sizes), sizes)
    if kind == "prefill":
        batch = jspecs.input_specs(cfg, shape)
        return total + _ref_bytes(batch, jshd.batch_pspecs(cfg, shape,
                                                           jaxes), sizes)
    batch_ax = jaxes.batch_axes if b >= 16 else ()
    tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
    tok_spec = JP(batch_ax, None) if batch_ax else JP()
    total += _ref_bytes(tok, tok_spec, sizes) + 4
    if cfg.family == "encdec":
        enc = jax.ShapeDtypeStruct((b, shape.seq_len, cfg.frontend_dim),
                                   jnp.bfloat16)
        kv = jax.eval_shape(lambda p, e: jtransformer._enc_kv_all_layers(
            cfg, p, jtransformer.encode(cfg, p, e)[0]), params, enc)
        kv_spec = JP(None, jaxes.data if b >= 16 else None, None, None,
                     None)
        if cross_kv_itemsize is not None:
            kv = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
                l.shape, {2: jnp.bfloat16, 4: jnp.float32}[
                    cross_kv_itemsize]), kv)
        total += _ref_bytes(kv, jax.tree.map(lambda _: kv_spec, kv), sizes)
        pos = jax.ShapeDtypeStruct((b, shape.seq_len), jnp.int32)
        total += _ref_bytes(pos, JP(jaxes.batch_axes if b >= 16 else None,
                                    None), sizes)
    return total


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference(arch, mesh):
    multi = mesh == "multi"
    jaxes, _ = AXES[mesh]
    sizes = tmesh.make_production_mesh(multi_pod=multi).sizes
    cfg = get_config(arch)
    for shape in SHAPES.values():
        rep = dryrun.size_pair(arch, shape.name, multi_pod=multi,
                               trace=False)
        if not _feasible(cfg, shape):
            assert rep["status"] == "skipped"
            continue
        assert rep["status"] == "sized", rep
        assert rep["chips"] == (512 if multi else 256)
        # the port's cross K/V are in cfg.dtype (bf16): by design
        itemsize = (2 if cfg.family == "encdec" and shape.kind == "decode"
                    else None)
        want = _ref_argument_bytes(arch, shape, jaxes, sizes,
                                   cross_kv_itemsize=itemsize)
        assert rep["memory"]["argument_bytes"] == want, (shape.name, rep)


def test_argument_bytes_under_opts():
    """Resident serving, grouped experts, bf16 masters and gossip across
    pods change the sizes as the reference's rules say."""
    sizes = tmesh.make_production_mesh(multi_pod=True).sizes
    jaxes = jshd.MeshAxes(pod="pod")
    arch = "dbrx_132b"
    base = dryrun.size_pair(arch, "decode_32k", multi_pod=True,
                            trace=False)
    res = dryrun.size_pair(arch, "decode_32k", multi_pod=True, trace=False,
                           opts=dryrun.Opts(serve_resident=True))
    params = ref_params(arch)
    ref = {flag: _ref_bytes(params, jshd.param_pspecs(
        params, jaxes, sizes, fsdp=flag), sizes) for flag in (True, False)}
    assert res["memory"]["parts"]["params"] == ref[False]
    assert base["memory"]["parts"]["params"] == ref[True]
    grp = dryrun.size_pair(arch, "train_4k", multi_pod=True, trace=False,
                           opts=dryrun.Opts(moe_grouped=True))
    state = ref_state(arch)
    ps = jshd.param_pspecs(state.params, jaxes, sizes, moe_output_fsdp=True)
    assert grp["memory"]["parts"]["state"] == _ref_bytes(
        state, state._replace(params=ps, opt_state={"m": ps, "v": ps},
                              step=JP()), sizes)
    bf = dryrun.size_pair(arch, "prefill_32k", trace=False,
                          opts=dryrun.Opts(param_dtype="bfloat16"))
    jp = jspecs.params_specs(dataclasses.replace(jget(arch),
                                                 param_dtype="bfloat16"))
    ssizes = tmesh.make_production_mesh().sizes
    assert bf["memory"]["parts"]["params"] == _ref_bytes(
        jp, jshd.param_pspecs(jp, jshd.MeshAxes(), ssizes), ssizes)
    # gossip: each pod's replica, stacked on the pod axis
    gos = dryrun.size_pair("qwen3_4b", "train_4k", multi_pod=True,
                           trace=False, opts=dryrun.Opts(gossip_pod=True))
    st = ref_state("qwen3_4b")
    ps = jshd.param_pspecs(st.params, jshd.MeshAxes(), sizes)
    stacked = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
        (2,) + l.shape, l.dtype), st)
    prepend = lambda spec: JP("pod", *tuple(spec))
    sspecs = jax.tree.map(prepend, st._replace(
        params=ps, opt_state={"m": ps, "v": ps}, step=JP()),
        is_leaf=lambda x: isinstance(x, JP))
    assert gos["memory"]["parts"]["state"] == _ref_bytes(stacked, sspecs,
                                                         sizes)
