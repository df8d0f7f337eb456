"""The port's model zoo (dense, MoE, xlstm, hybrid, encdec and vlm families)
against the JAX reference on the CPU.

Weights are drawn by the reference (``api.init``) and carried across with
``convert.model_params_from_numpy``; tokens and the frontend inputs (vlm's
patches, encdec's frame embeddings) come from numpy. For the MoE
family every router call of both packages is recorded
(``_torch_moe.RouteLog``): the top-k indices are equal and no top-k margin
is within 1e-5 of a tie. Tolerances:

* configs: equal field by field;
* ``rms_norm`` / ``head_rms_norm`` / ``apply_rope``: atol 1e-6 (the same
  fp32 formula, evaluated by two libraries);
* ``forward``, ``prefill`` and ``decode_step`` logits: atol 3e-5, rtol 1e-4,
  the bar ``tests/test_pallas_backend.py`` sets between the reference's two
  attention backends; caches (k, v) the same, positions exactly (the
  reference's nested MoE-group cache converted to the port's one stacked
  entry per attention layer; the recurrent families' trees of states
  leaf for leaf, in the reference's own layout); the MoE aux loss atol
  1e-6;
* encdec's blocks one by one (``cross_kv``, ``cross_attn_apply``,
  ``encoder_layer_apply``, ``decoder_xattn_layer_apply``, ``encode`` with
  its positions exactly, ``_enc_kv_all_layers``): atol 3e-5, rtol 1e-4;
* the twins of ``tests/test_archs_smoke.py`` for the recurrent, encdec
  and vlm families: finite logits and train step, decode against the full
  forward atol 2e-4 (the reference's bar).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moe import RouteLog, frontend_np, ref_cache_to_port
from repro.configs import base as jbase
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import build_model as tbuild

ATOL, RTOL = 3e-5, 1e-4
DENSE = ["qwen3_4b", "h2o_danube3_4b", "stablelm_12b", "mistral_large_123b"]
MOE = ["dbrx_132b", "llama4_maverick_400b"]
RECURRENT = ["xlstm_125m", "zamba2_7b"]
ENCDEC = ["seamless_m4t_medium"]
VLM = ["internvl2_26b"]
FRONTEND = ENCDEC + VLM
# the families that raised before they were ported; their ids are kept
# and check the forward against the reference instead
NOT_PORTED = {"dbrx_132b": "MoE", "llama4_maverick_400b": "MoE",
              "xlstm_125m": "xLSTM", "zamba2_7b": "hybrid",
              "seamless_m4t_medium": "encdec", "internvl2_26b": "vlm"}


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _pair(arch: str, seed: int = 0):
    """(cfg, JAX api, JAX params, port api, port params) of a smoke config
    with the reference's weights in both packages."""
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    tapi = tbuild(tcfg, device="cpu")
    tparams = convert.model_params_from_numpy(tcfg, tree, device="cpu")
    return tcfg, japi, jparams, tapi, tparams


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _batches(tokens, frontend):
    """The same batch for both packages: (jax dict, torch dict)."""
    b = dict(frontend, tokens=tokens)
    return ({k: jnp.asarray(a) for k, a in b.items()},
            {k: torch.as_tensor(a) for k, a in b.items()})


def _prefix(cfg) -> int:
    return cfg.num_prefix_tokens if cfg.family == "vlm" else 0


def _enc_kw(cfg, japi, jparams, tapi, tparams, frontend):
    """Both packages' decode keywords: encdec's ``enc_kv`` and
    ``enc_pos`` from ``encode`` + ``_enc_kv_all_layers``."""
    if cfg.family != "encdec":
        return {}, {}
    enc = frontend["enc_embeds"]
    jout, jpos = japi.encode(jparams, jnp.asarray(enc))
    tout, tpos = tapi.encode(tparams, torch.as_tensor(enc))
    return ({"enc_kv": jtransformer._enc_kv_all_layers(cfg, jparams, jout),
             "enc_pos": jpos},
            {"enc_kv": ttransformer._enc_kv_all_layers(cfg, tparams, tout),
             "enc_pos": tpos})


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert tbase.ARCHS == jbase.ARCHS
    assert tbase.ALIASES == jbase.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", jbase.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(arch, smoke):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    if smoke:
        j, t = jbase.smoke_variant(j), tbase.smoke_variant(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.resolved_head_dim, t.supports_decode, t.sub_quadratic) == \
        (j.resolved_head_dim, j.supports_decode, j.sub_quadratic)


@pytest.mark.parametrize("alias", ["llama4-maverick-400b-a17b",
                                   "h2o-danube-3-4b", "qwen3-4b"])
def test_aliases_resolve_like_reference(alias):
    assert dataclasses.asdict(tbase.get_config(alias)) == \
        dataclasses.asdict(jbase.get_config(alias))


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rms_norm", "head_rms_norm"])
def test_norms_match_reference(fn):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32) * 3.0
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.1
    out_j = getattr(jcommon, fn)(jnp.asarray(x), jnp.asarray(scale))
    out_t = getattr(tcommon, fn)(torch.as_tensor(x), torch.as_tensor(scale))
    _close(out_t, out_j, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6), (120, 1e4)])
def test_apply_rope_matches_reference(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(2, 7)).astype(np.int32)
    # XLA's and PyTorch's fp32 pow may round a frequency 1 ulp apart; the
    # angle pos * freq carries that difference times the position
    fj = np.asarray(jcommon.rope_freqs(hd, theta))
    ft = tcommon.rope_freqs(hd, theta).numpy()
    _close(ft, fj, atol=0, rtol=1.2e-7)
    out_j = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out_t = tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                               theta)
    xmax = float(np.abs(x).max())
    atol = 1e-6 * xmax + xmax * float(pos.max()) * float(np.abs(ft - fj).max())
    _close(out_t, out_j, atol=atol, rtol=0)


def test_dense_init_is_seeded_truncated_normal():
    g = lambda: torch.Generator().manual_seed(3)
    a = tcommon.dense_init(g(), (512, 256), torch.float32, "cpu")
    b = tcommon.dense_init(g(), (512, 256), torch.float32, "cpu")
    assert torch.equal(a, b)
    z = a * 512 ** 0.5
    assert float(z.abs().max()) <= 2.0
    # std of a standard normal truncated to [-2, 2]
    assert abs(float(z.std()) - 0.8796) < 0.01
    e = tcommon.embed_init(g(), (64, 64), torch.bfloat16, "cpu")
    assert e.dtype == torch.bfloat16 and float(e.float().abs().max()) <= 2.0
    # the program draws its leaves through them, rounded into place
    assert torch.equal(tcommon.new_leaf(
        g(), tcommon.dense_leaf((512, 256)), torch.bfloat16, "cpu"),
        tcommon.dense_init(g(), (512, 256), torch.bfloat16, "cpu"))
    assert torch.equal(tcommon.new_leaf(
        g(), tcommon.Leaf((64, 64), "embed"), torch.bfloat16, "cpu"), e)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _forward_pair(arch, monkeypatch):
    """Both packages' forward on the same tokens (and frontend input):
    logits atol 3e-5 / rtol 1e-4, aux atol 1e-6, the MoE routes equal
    (away from ties)."""
    cfg, japi, jparams, tapi, tparams = _pair(arch)
    log = RouteLog(monkeypatch) if cfg.family == "moe" else None
    tokens = _tokens(cfg, 2, 24, seed=1)
    jb, tb = _batches(tokens, frontend_np(cfg, 2, 10, 6))
    lj, auxj = japi.forward(jparams, jb)
    lt, auxt = tapi.forward(tparams, tb)
    assert lt.shape == (2, 24 + _prefix(cfg), cfg.vocab_size)
    assert lt.dtype == torch.float32
    _close(lt, lj)
    _close(auxt, auxj, atol=1e-6, rtol=0)
    if log is not None:
        log.check(calls=ttransformer._num_groups(cfg))
        assert float(auxt) > 0.0
    else:
        assert float(auxt) == float(auxj) == 0.0
    assert tapi.param_count(tparams) == jtransformer.param_count(jparams)


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_forward_matches_reference(arch, monkeypatch):
    _forward_pair(arch, monkeypatch)


def _check_tree(got, want, path=""):
    """A recurrent family's cache, leaf for leaf (int leaves exactly)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _check_tree(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _check_tree(a, b, f"{path}[{i}]")
    elif np.issubdtype(np.asarray(want).dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got.shape == np.shape(want), path
        _close(got, want)


def _check_cache(cfg, cache_t, cache_j):
    if cfg.family in ("xlstm", "hybrid"):
        _check_tree(convert.cache_to_numpy(cache_t),
                    jax.tree.map(np.asarray, cache_j))
        return
    cj = ref_cache_to_port(cfg, cache_j)
    ct = convert.cache_to_numpy(cache_t)
    assert set(ct) == set(cj)
    np.testing.assert_array_equal(ct["pos"], cj["pos"])
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


@pytest.mark.parametrize("arch,prompt,max_len", [
    ("qwen3_4b", 12, 16),
    ("h2o_danube3_4b", 12, 16),
    ("h2o_danube3_4b", 24, 28),   # prompt > window 16: the ring wraps
    ("dbrx_132b", 12, 16),
    ("llama4_maverick_400b", 12, 16),
    ("llama4_maverick_400b", 24, 28),   # chunked-local ring of 16 wraps
    ("xlstm_125m", 37, 41),       # two chunks of 16 and a padded third
    ("zamba2_7b", 24, 28),        # two chunks; the ring of 16 wraps
    ("seamless_m4t_medium", 12, 16),   # 10 encoder frames
    ("internvl2_26b", 12, 24),    # 8 patches before the prompt
])
def test_prefill_and_decode_match_reference(arch, prompt, max_len,
                                            monkeypatch):
    cfg, japi, jparams, tapi, tparams = _pair(arch, seed=2)
    log = RouteLog(monkeypatch) if cfg.family == "moe" else None
    tokens = _tokens(cfg, 2, prompt + 4, seed=3)
    frontend = frontend_np(cfg, 2, 10, 7)
    jkw, tkw = _enc_kw(cfg, japi, jparams, tapi, tparams, frontend)
    p0 = _prefix(cfg)       # vlm: the patches' slots before the prompt
    cj = japi.init_cache(jparams, 2, max_len)
    ct = tapi.init_cache(tparams, 2, max_len)
    want_len = max_len if cfg.attention == "full" \
        else min(max_len, cfg.window)
    groups = ttransformer._num_groups(cfg)
    if cfg.family == "xlstm":   # O(1) in the sequence: no KV cache
        assert ct["mlstm"]["c"].shape[:2] == (groups, 2)
    else:
        kv = ct.get("attn", ct)
        assert kv["k"].shape == (ttransformer.num_attn_layers(cfg), 2,
                                 want_len, cfg.num_kv_heads,
                                 cfg.resolved_head_dim)
    _check_cache(cfg, ct, cj)
    jb, tb = _batches(tokens[:, :prompt], frontend)
    lj, cj = japi.prefill(jparams, jb, cj)
    lt, ct = tapi.prefill(tparams, tb, ct)
    assert lt.shape == (2, 1, cfg.vocab_size)
    _close(lt, lj)
    _check_cache(cfg, ct, cj)
    for i in range(4):
        t = prompt + i
        tok = tokens[:, t:t + 1]
        lj, cj = japi.decode_step(jparams, jnp.asarray(tok),
                                  jnp.asarray(p0 + t, jnp.int32), cj, **jkw)
        lt, ct = tapi.decode_step(tparams, torch.as_tensor(tok), p0 + t, ct,
                                  **tkw)
        _close(lt, lj)
        _check_cache(cfg, ct, cj)
    if p0:   # the patches and the text hold slots 0 .. P + prompt + 3
        pos = convert.cache_to_numpy(ct)["pos"]
        assert pos[:, :, :p0 + prompt + 4].tolist() == np.broadcast_to(
            np.arange(p0 + prompt + 4), pos[:, :, :p0 + prompt + 4].shape
        ).tolist()
    if log is not None:   # the prefill and 4 steps through every group
        log.check(calls=5 * ttransformer._num_groups(cfg))
    if prompt > cfg.window and cfg.family != "xlstm":
        # the ring holds exactly the last window slots
        pos = convert.cache_to_numpy(ct.get("attn", ct))["pos"]
        assert sorted(pos[0, 0].tolist()) == list(
            range(prompt + 4 - cfg.window, prompt + 4))


def test_decode_matches_full_forward():
    """A decode step's logits equal the full forward's at that position
    (``tests/test_pallas_backend.py::test_decode_with_pallas_backend``)."""
    cfg, _, _, tapi, tparams = _pair("h2o_danube3_4b", seed=4)
    tokens = torch.as_tensor(_tokens(cfg, 2, 12, seed=5))
    full, _ = tapi.forward(tparams, {"tokens": tokens})
    cache = tapi.init_cache(tparams, 2, 16)
    _, cache = tapi.prefill(tparams, {"tokens": tokens[:, :-1]}, cache)
    dec, _ = tapi.decode_step(tparams, tokens[:, -1:], 11, cache)
    _close(dec[:, 0], full[:, -1], atol=3e-4, rtol=0)


def test_weights_are_kept_in_cfg_dtype():
    cfg = dataclasses.replace(tbase.smoke_variant(tbase.get_config(
        "qwen3_4b")), dtype="bfloat16")
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    assert list(params) == ttransformer.param_paths(cfg)
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    cache = api.init_cache(params, 1, 8)
    assert cache["k"].dtype == torch.bfloat16
    assert cache["pos"].dtype == torch.int32
    assert bool((cache["pos"] == -1).all())
    logits, _ = api.prefill(params, {"tokens": torch.zeros((1, 4),
                                                           dtype=torch.long)},
                            cache)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_unported_families_raise(arch, monkeypatch):
    """Every family is ported now: the ids of those that raised before
    (MoE, xlstm, hybrid, encdec, vlm) check the forward against the
    reference (logits, aux, for MoE the routes; encdec's frame embeddings
    and vlm's patches fed to both) instead."""
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    assert cfg.family == {"MoE": "moe", "xLSTM": "xlstm"}.get(
        NOT_PORTED[arch], NOT_PORTED[arch])
    _forward_pair(arch, monkeypatch)


def test_unknown_family_raises():
    cfg = dataclasses.replace(tbase.smoke_variant(tbase.get_config(
        "qwen3_4b")), family="diffusion")
    with pytest.raises(ValueError, match="unknown family diffusion"):
        tbuild(cfg, device="cpu")


def test_moe_layers_raise(monkeypatch):
    """Ported: ``moe_init`` gives the reference's leaves, shapes and
    initializer scales, and ``moe_apply`` the reference's output, aux and
    routes (the id is kept from when the MoE layers raised)."""
    jp = jmlp.moe_init(jax.random.PRNGKey(0), 32, 48, 8, jnp.float32,
                       shared_expert=True)
    tp = tmlp.moe_init(torch.Generator().manual_seed(0), 32, 48, 8,
                       torch.float32, "cpu", shared_expert=True)
    want = convert._nested_to_flat(jax.tree.map(np.asarray, jp))
    got = tcommon.flatten(tp)
    assert list(got) == list(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        # truncated normal on [-2, 2] (std 0.8796) / sqrt(fan_in), fan_in
        # the matrices' input width, in both packages; the spread within
        # 0.15 (>= 256 draws: 3.4 standard errors)
        fan_in = arr.shape[-2]
        for a in (got[name].numpy(), arr):
            assert np.abs(a).max() <= 2.0 * fan_in ** -0.5 + 1e-7, name
            assert abs(a.std() * fan_in ** 0.5 - 0.8796) < 0.15, name
    log = RouteLog(monkeypatch)
    x = np.random.default_rng(1).normal(size=(2, 6, 32)).astype(np.float32)
    yj, auxj = jmlp.moe_apply(jp, jnp.asarray(x), experts_per_token=2)
    yt, auxt = tmlp.moe_apply(
        jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp),
        torch.as_tensor(x), experts_per_token=2)
    _close(yt, yj)
    _close(auxt, auxj, atol=1e-6, rtol=0)
    log.check(calls=1)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_param_paths_match_reference_flatten_order(arch, smoke):
    """The one parameter layout: ``param_paths`` is the reference's
    ``jax.tree`` flatten order and ``param_leaves`` its shapes (the
    reference's init traced abstractly, full configs included)."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    if smoke:
        jcfg, tcfg = jbase.smoke_variant(jcfg), tbase.smoke_variant(tcfg)
    shapes = jax.eval_shape(lambda k: jtransformer.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = [(".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]]
    got = [(name, leaf.shape)
           for name, leaf in ttransformer.param_leaves(tcfg).items()]
    assert got == want
    assert ttransformer.param_paths(tcfg) == [name for name, _ in want]


def test_convert_rejects_bad_trees():
    cfg, _, jparams, _, _ = _pair("qwen3_4b")
    tree = jax.tree.map(np.asarray, jparams)
    missing = dict(tree, layers=dict(tree["layers"]))
    del missing["layers"]["ln2"]
    with pytest.raises(KeyError, match="ln2"):
        convert.model_params_from_numpy(cfg, missing, device="cpu")
    bad = dict(tree, ln_f=np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(cfg, bad, device="cpu")
    extra = dict(tree, patch_proj=np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="patch_proj"):
        convert.model_params_from_numpy(cfg, extra, device="cpu")


# ---------------------------------------------------------------------------
# twins of tests/test_archs_smoke.py for the recurrent families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_shapes_and_finite(arch):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    assert list(params) == ttransformer.param_paths(cfg)
    logits, aux = api.forward(params, {"tokens": torch.as_tensor(
        _tokens(cfg, 2, 16, seed=1))})
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_one_train_step_no_nans(arch):
    from repro_torch.train import steps as tsteps
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    hp = tsteps.TrainHParams(lr=1e-3)
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(2),
                                    hp, device="cpu")
    tokens = torch.as_tensor(_tokens(cfg, 2, 16, seed=3)).long()
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    state, metrics = tsteps.make_train_step(cfg, hp)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    for name, p in state.params.items():
        assert bool(torch.isfinite(p).all()), name


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_forward(arch):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    b, s = 2, 10
    tokens = torch.as_tensor(_tokens(cfg, b, s, seed=4))
    full, _ = api.forward(params, {"tokens": tokens})
    cache = api.init_cache(params, b, s + 4)
    _, cache = api.prefill(params, {"tokens": tokens[:, :-1]}, cache)
    dec, _ = api.decode_step(params, tokens[:, -1:], s - 1, cache)
    _close(dec[:, 0], full[:, -1], atol=2e-4, rtol=0)


def test_convert_rejects_bad_recurrent_trees():
    """Zamba2's tree (Mamba2 blocks a list per group, the unstacked shared
    block): a missing, extra or misshapen leaf raises."""
    cfg, _, jparams, _, tparams = _pair("zamba2_7b")
    tree = jax.tree.map(np.asarray, jparams)
    assert "shared.attn.wq" in tparams
    assert "layers.mamba_blocks.1.mamba.dt_bias" in tparams
    missing = jax.tree.map(lambda a: a, tree)
    del missing["layers"]["mamba_blocks"][1]["mamba"]["dt_bias"]
    with pytest.raises(KeyError, match="dt_bias"):
        convert.model_params_from_numpy(cfg, missing, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["shared"]["gate"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="shared.gate"):
        convert.model_params_from_numpy(cfg, extra, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["shared"]["attn"]["wq"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(cfg, bad, device="cpu")


@pytest.mark.parametrize("block", ["xlstm_pair", "mamba_block",
                                   "hybrid_group", "hybrid_shared"])
def test_recurrent_block_inits_match_reference(block):
    """The blocks' ``*_init`` give the reference's leaves and shapes (a
    hybrid group's Mamba2 blocks int-keyed where the reference lists
    them) and its constant leaves exactly."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks as tblocks
    arch = "xlstm_125m" if block == "xlstm_pair" else "zamba2_7b"
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    ref = convert._nested_to_flat(jax.tree.map(np.asarray, getattr(
        jblocks, f"{block}_init")(jax.random.PRNGKey(0), jcfg)))
    got = tcommon.flatten(getattr(tblocks, f"{block}_init")(
        torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu"))
    assert list(got) == list(ref)
    for name, want in ref.items():
        assert tuple(got[name].shape) == want.shape, name
        if not name.endswith(("in_proj", "conv_w", "out_proj", "w_in", "r",
                              "wq", "wk", "wv", "wo", "w_if", "w_o",
                              "w_gate", "w_up", "w_down")):
            np.testing.assert_array_equal(got[name].numpy(), want, name)


# ---------------------------------------------------------------------------
# encdec's blocks one by one, and twins of tests/test_archs_smoke.py for
# the encdec and vlm families
# ---------------------------------------------------------------------------

def _layer(tree, i):
    """Layer i of a stacked (numpy) tree."""
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("block", ["cross_kv", "cross_attn_apply",
                                   "encoder_layer_apply",
                                   "decoder_xattn_layer_apply", "encode",
                                   "enc_kv_all_layers"])
def test_encdec_blocks_match_reference(block):
    """SeamlessM4T's smoke blocks on the reference's weights (layer 1 of
    each stack), fed the same numpy inputs: 10 encoder frames, 6 decoder
    positions, the last 3 frames of batch row 1 empty (position -1) in
    the cross attention."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks as tblocks
    cfg, japi, jparams, tapi, tparams = _pair("seamless_m4t_medium", seed=8)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(9)
    d, kvh, hd = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    enc = rng.normal(size=(2, 10, d)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32) + 3, (2, 1))
    enc_pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    enc_pos[1, 7:] = -1
    kv = tuple(rng.normal(size=(2, 10, kvh, hd)).astype(np.float32)
               for _ in range(2))
    j = lambda t: jax.tree.map(jnp.asarray, t)
    t = lambda t: jax.tree.map(torch.as_tensor, t)
    dec, enc_layer = _layer(tree["layers"], 1), _layer(tree["enc_layers"], 1)
    if block == "cross_kv":
        want = jblocks.cross_kv(cfg, j(dec["xattn"]), jnp.asarray(enc))
        got = tblocks.cross_kv(cfg, t(dec["xattn"]), torch.as_tensor(enc))
    elif block == "cross_attn_apply":
        want = jblocks.cross_attn_apply(cfg, j(dec["xattn"]), jnp.asarray(x),
                                        j(kv), jnp.asarray(enc_pos))
        got = tblocks.cross_attn_apply(cfg, t(dec["xattn"]),
                                       torch.as_tensor(x), t(kv),
                                       torch.as_tensor(enc_pos))
    elif block == "encoder_layer_apply":
        want = jblocks.encoder_layer_apply(cfg, j(enc_layer),
                                           jnp.asarray(enc),
                                           jnp.asarray(enc_pos.clip(0)))
        got = tblocks.encoder_layer_apply(cfg, t(enc_layer),
                                          torch.as_tensor(enc),
                                          torch.as_tensor(enc_pos.clip(0)))
    elif block == "decoder_xattn_layer_apply":
        want = jblocks.decoder_xattn_layer_apply(
            cfg, j(dec), jnp.asarray(x), jnp.asarray(pos), None, j(kv),
            jnp.asarray(enc_pos), jblocks.DEFAULT_CTX)[0]
        got = tblocks.decoder_xattn_layer_apply(
            cfg, t(dec), torch.as_tensor(x), torch.as_tensor(pos), None,
            t(kv), torch.as_tensor(enc_pos))[0]
    else:
        frames = rng.normal(size=(2, 10, cfg.frontend_dim)).astype(
            np.float32)
        jout, jpos = japi.encode(jparams, jnp.asarray(frames))
        tout, tpos = tapi.encode(tparams, torch.as_tensor(frames))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert tpos.dtype == torch.int32 and tout.shape == (2, 10, d)
        if block == "encode":
            want, got = jout, tout
        else:
            want = jtransformer._enc_kv_all_layers(cfg, jparams, jout)
            got = ttransformer._enc_kv_all_layers(cfg, tparams, tout)
            assert got[0].shape == (cfg.num_layers, 2, 10, kvh, hd)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_forward_shapes_and_finite(arch):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    assert list(params) == ttransformer.param_paths(cfg)
    _, tb = _batches(_tokens(cfg, 2, 16, seed=1),
                     frontend_np(cfg, 2, 12, 2))
    logits, aux = api.forward(params, tb)
    assert logits.shape == (2, 16 + _prefix(cfg), cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
    assert (api.encode is None) == (cfg.family != "encdec")


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_one_train_step_no_nans(arch):
    from repro_torch.train import steps as tsteps
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    hp = tsteps.TrainHParams(lr=1e-3)
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(2),
                                    hp, device="cpu")
    _, batch = _batches(_tokens(cfg, 2, 16, seed=3).astype(np.int64),
                        frontend_np(cfg, 2, 12, 4))
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    state, metrics = tsteps.make_train_step(cfg, hp)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    for name, p in state.params.items():
        assert bool(torch.isfinite(p).all()), name


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_decode_matches_forward(arch):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    api = tbuild(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    b, s, p0 = 2, 10, _prefix(cfg)
    frontend = frontend_np(cfg, b, 12, 5)
    _, batch = _batches(_tokens(cfg, b, s, seed=4), frontend)
    full, _ = api.forward(params, batch)
    cache = api.init_cache(params, b, p0 + s + 4)
    kw = {}
    if cfg.family == "encdec":
        out, pos = api.encode(params, batch["enc_embeds"])
        kw = {"enc_kv": ttransformer._enc_kv_all_layers(cfg, params, out),
              "enc_pos": pos}
    _, cache = api.prefill(params, dict(batch, tokens=batch["tokens"][:, :-1]),
                           cache)
    dec, _ = api.decode_step(params, batch["tokens"][:, -1:], p0 + s - 1,
                             cache, **kw)
    _close(dec[:, 0], full[:, -1], atol=2e-4, rtol=0)
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="enc_kv"):
            api.decode_step(params, batch["tokens"][:, -1:], s, cache)
