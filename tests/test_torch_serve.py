"""The port's serving driver against the JAX reference on the CPU.

``repro_torch.launch.serve.serve`` runs prefill and greedy decode; the
reference runs the same steps as a loop over ``api.prefill`` and
``api.decode_step``, fed the tokens the port chose (teacher forcing), so
the two see the same inputs at every step. The comparison is on per-step
logits — with random weights a greedy argmax can flip on rounding — at
atol 3e-5, rtol 1e-4 (the bar of ``tests/test_pallas_backend.py``).

A checkpoint written by the reference's ``repro.train.checkpoint.save`` is
served by both packages: the port reads the npz's keystr paths as strings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model import build_model as jbuild
from repro.train import checkpoint
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model as tbuild

ATOL, RTOL = 3e-5, 1e-4


def _reference_loop(japi, jparams, prompt, tokens, gen, max_len):
    """Per-step logits of the reference, fed ``tokens`` at each decode
    step."""
    cache = japi.init_cache(jparams, prompt.shape[0], max_len)
    logits, cache = japi.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 cache)
    out = [np.asarray(logits[:, -1])]
    s = prompt.shape[1]
    for i in range(gen - 1):
        logits, cache = japi.decode_step(
            jparams, jnp.asarray(tokens[:, i:i + 1]),
            jnp.asarray(s + i, jnp.int32), cache)
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, axis=1)


def _setup(arch, seed):
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tapi = tbuild(tcfg, device="cpu")
    tparams = convert.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return tcfg, japi, jparams, tapi, tparams


@pytest.mark.parametrize("arch,b,s,gen", [
    ("qwen3_4b", 2, 10, 6),
    ("h2o_danube3_4b", 2, 10, 6),
    ("h2o_danube3_4b", 3, 20, 8),   # 20 + 8 > window 16: the ring wraps
    ("mistral_large_123b", 1, 7, 4),
])
def test_serve_matches_reference_loop(arch, b, s, gen):
    cfg, japi, jparams, tapi, tparams = _setup(arch, seed=b + s)
    prompt = np.random.default_rng(s).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), gen,
                       device="cpu")
    assert res.tokens.shape == (b, gen)
    assert res.logits.shape == (b, gen, cfg.vocab_size)
    assert len(res.decode_ms) == gen - 1 and res.prefill_ms > 0
    assert torch.equal(res.tokens, torch.argmax(res.logits, dim=-1))
    want = _reference_loop(japi, jparams, prompt, res.tokens.numpy(), gen,
                           s + gen)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)


def test_serve_feed_forces_the_tokens():
    cfg, japi, jparams, tapi, tparams = _setup("qwen3_4b", seed=0)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, size=(2, 4)).astype(np.int64)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), 5,
                       device="cpu", feed=torch.as_tensor(feed))
    want = _reference_loop(japi, jparams, prompt, feed, 5, 13)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)
    assert res.cache["pos"].shape == (cfg.num_layers, 2, 13)
    assert int(res.cache["pos"].max()) == 11   # prompt 8 + 4 decode steps


def test_serve_checks_its_arguments():
    cfg, _, _, tapi, tparams = _setup("qwen3_4b", seed=0)
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="gen"):
        tserve.serve(tapi, tparams, prompt, 0, device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        tserve.serve(tapi, tparams, prompt, 2, device="meta")


@pytest.mark.parametrize("key,want", [
    ("['embed']", ("embed",)),
    ("['layers']['attn']['wq']", ("layers", "attn", "wq")),
    ("['l'][0]['x']", ("l", 0, "x")),
])
def test_parse_keystr(key, want):
    assert convert.parse_keystr(key) == want


@pytest.mark.parametrize("key", ["embed", "['a']b", "[a]", ""])
def test_parse_keystr_rejects_other_strings(key):
    with pytest.raises(ValueError, match="keystr"):
        convert.parse_keystr(key)


def test_checkpoint_served_by_both_packages(tmp_path, capsys):
    """A checkpoint saved by the reference serves the same logits in both
    packages, and the port's CLI runs from it (``--ckpt``)."""
    jcfg = jbase.smoke_variant(jbase.get_config("qwen3_4b"))
    japi = jbuild(jcfg)
    saved = japi.init(jax.random.PRNGKey(7))
    path = str(tmp_path / "ckpt" / "params.npz")
    checkpoint.save(path, saved)

    like = japi.init(jax.random.PRNGKey(0))
    jparams = checkpoint.restore(path, like)
    tcfg = tbase.smoke_variant(tbase.get_config("qwen3_4b"))
    tapi = tbuild(tcfg, device="cpu")
    tparams = convert.model_params_from_numpy(
        tcfg, convert.load_checkpoint(path), device="cpu")
    prompt = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), 4,
                       device="cpu")
    want = _reference_loop(japi, jparams, prompt, res.tokens.numpy(), 4, 13)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)

    tserve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                 "--ckpt", path, "--batch", "2", "--prompt-len", "6",
                 "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=qwen3-4b batch=2 prompt=6 gen=3 device=cpu" in out
    assert "sample tokens:" in out
