"""The port's model zoo (dense family) against the JAX reference on the CPU.

Weights are drawn by the reference (``api.init``) and carried across with
``convert.model_params_from_numpy``; tokens come from numpy. Tolerances:

* configs: equal field by field;
* ``rms_norm`` / ``head_rms_norm`` / ``apply_rope``: atol 1e-6 (the same
  fp32 formula, evaluated by two libraries);
* ``forward``, ``prefill`` and ``decode_step`` logits: atol 3e-5, rtol 1e-4,
  the bar ``tests/test_pallas_backend.py`` sets between the reference's two
  attention backends; caches (k, v) the same, positions exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models.model import build_model as tbuild

ATOL, RTOL = 3e-5, 1e-4
DENSE = ["qwen3_4b", "h2o_danube3_4b", "stablelm_12b", "mistral_large_123b"]
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


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    cfg, japi, jparams, tapi, tparams = _pair(arch)
    tokens = _tokens(cfg, 2, 24, seed=1)
    lj, auxj = japi.forward(jparams, {"tokens": jnp.asarray(tokens)})
    lt, auxt = tapi.forward(tparams, {"tokens": torch.as_tensor(tokens)})
    assert lt.shape == (2, 24, cfg.vocab_size) and lt.dtype == torch.float32
    _close(lt, lj)
    assert float(auxt) == float(auxj) == 0.0
    assert tapi.param_count(tparams) == jtransformer.param_count(jparams)


def _check_cache(cache_t, cache_j):
    cj = jax.tree.map(np.asarray, cache_j)
    ct = convert.cache_to_numpy(cache_t)
    assert set(ct) == set(cj)
    np.testing.assert_array_equal(ct["pos"], cj["pos"])
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


@pytest.mark.parametrize("arch,prompt,max_len", [
    ("qwen3_4b", 12, 16),
    ("h2o_danube3_4b", 12, 16),
    ("h2o_danube3_4b", 24, 28),   # prompt > window 16: the ring wraps
])
def test_prefill_and_decode_match_reference(arch, prompt, max_len):
    cfg, japi, jparams, tapi, tparams = _pair(arch, seed=2)
    tokens = _tokens(cfg, 2, prompt + 4, seed=3)
    cj = japi.init_cache(jparams, 2, max_len)
    ct = tapi.init_cache(tparams, 2, max_len)
    want_len = min(max_len, cfg.window) if cfg.attention == "sliding" \
        else max_len
    assert ct["k"].shape == (cfg.num_layers, 2, want_len, cfg.num_kv_heads,
                             cfg.resolved_head_dim)
    _check_cache(ct, cj)
    lj, cj = japi.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :prompt])},
                          cj)
    lt, ct = tapi.prefill(tparams,
                          {"tokens": torch.as_tensor(tokens[:, :prompt])}, ct)
    assert lt.shape == (2, 1, cfg.vocab_size)
    _close(lt, lj)
    _check_cache(ct, cj)
    for i in range(4):
        t = prompt + i
        tok = tokens[:, t:t + 1]
        lj, cj = japi.decode_step(jparams, jnp.asarray(tok),
                                  jnp.asarray(t, jnp.int32), cj)
        lt, ct = tapi.decode_step(tparams, torch.as_tensor(tok), t, ct)
        _close(lt, lj)
        _check_cache(ct, cj)
    if prompt > cfg.window:   # the ring holds exactly the last window slots
        pos = convert.cache_to_numpy(ct)["pos"]
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
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    cache = api.init_cache(params, 1, 8)
    assert cache["k"].dtype == torch.bfloat16
    assert cache["pos"].dtype == torch.int32
    assert bool((cache["pos"] == -1).all())
    logits, _ = api.prefill(params, {"tokens": torch.zeros((1, 4),
                                                           dtype=torch.long)},
                            cache)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_unported_families_raise(arch):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 17"):
        tbuild(cfg, device="cpu")


def test_moe_layers_raise():
    for fn in (tmlp.moe_init, tmlp.moe_apply):
        with pytest.raises(NotImplementedError, match="MoE"):
            fn()


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
