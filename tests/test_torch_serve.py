"""The port's serving driver against the JAX reference on the CPU.

``repro_torch.launch.serve.serve`` runs prefill and greedy decode; the
reference runs the same steps as a loop over ``api.prefill`` and
``api.decode_step``, fed the tokens the port chose (teacher forcing), so
the two see the same inputs at every step. The comparison is on per-step
logits — with random weights a greedy argmax can flip on rounding — at
atol 3e-5, rtol 1e-4 (the bar of ``tests/test_pallas_backend.py``).

A checkpoint written by the reference's ``repro.train.checkpoint.save`` is
served by both packages: the port reads the npz's keystr paths as strings.
The MoE smoke variants (dbrx: 4 experts top-2; llama4: 4 experts top-1, a
shared expert, a dense and an MoE layer per group, chunked-local
attention) run too, with both packages' routes recorded and held equal
(``_torch_moe.RouteLog``). The recurrent families (xLSTM: an mLSTM +
sLSTM pair; Zamba2: a hybrid group of two Mamba2 blocks and the shared
attention, whose ring of 16 slots wraps) serve a checkpoint the
reference saved, against the reference's loop. The encdec family
(SeamlessM4T: 2 encoder and 2 decoder layers) and the vlm family
(InternVL2: 8 patches before the prompt) serve with their frontend input,
drawn from numpy and fed to both packages; the reference's loop encodes
and feeds the cross K/V as the reference's CLI does, and starts vlm's
decode positions after the patches.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moe import RouteLog, frontend_np
from repro.configs import base as jbase
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro.train import checkpoint
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model as tbuild

ATOL, RTOL = 3e-5, 1e-4


def _reference_loop(japi, jparams, prompt, tokens, gen, max_len,
                    frontend=None):
    """Per-step logits of the reference, fed ``tokens`` at each decode
    step; ``frontend`` (numpy) as the reference's CLI feeds it: vlm's
    patches before the prompt (``max_len`` counts the text only), encdec's
    frames encoded once for the decode steps."""
    cfg = japi.cfg
    frontend = {k: jnp.asarray(a) for k, a in (frontend or {}).items()}
    p0 = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    kw = {}
    if cfg.family == "encdec":
        enc_out, enc_pos = japi.encode(jparams, frontend["enc_embeds"])
        kw = {"enc_kv": jtransformer._enc_kv_all_layers(cfg, jparams,
                                                        enc_out),
              "enc_pos": enc_pos}
    cache = japi.init_cache(jparams, prompt.shape[0], p0 + max_len)
    logits, cache = japi.prefill(
        jparams, {"tokens": jnp.asarray(prompt), **frontend}, cache)
    out = [np.asarray(logits[:, -1])]
    s = p0 + prompt.shape[1]
    for i in range(gen - 1):
        logits, cache = japi.decode_step(
            jparams, jnp.asarray(tokens[:, i:i + 1]),
            jnp.asarray(s + i, jnp.int32), cache, **kw)
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out, axis=1)


def _port_frontend(frontend):
    return {k: torch.as_tensor(a) for k, a in frontend.items()}


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
    ("dbrx_132b", 2, 10, 6),
    ("llama4_maverick_400b", 2, 20, 8),   # the chunked-local ring wraps
    ("seamless_m4t_medium", 2, 10, 6),   # 10 encoder frames
    ("internvl2_26b", 2, 10, 6),   # 8 patches, then the prompt
])
def test_serve_matches_reference_loop(arch, b, s, gen, monkeypatch):
    cfg, japi, jparams, tapi, tparams = _setup(arch, seed=b + s)
    log = RouteLog(monkeypatch) if cfg.family == "moe" else None
    prompt = np.random.default_rng(s).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    frontend = frontend_np(cfg, b, s, s + 1)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), gen,
                       device="cpu", frontend=_port_frontend(frontend))
    assert res.tokens.shape == (b, gen)
    assert res.logits.shape == (b, gen, cfg.vocab_size)
    assert len(res.decode_ms) == gen - 1 and res.prefill_ms > 0
    assert torch.equal(res.tokens, torch.argmax(res.logits, dim=-1))
    want = _reference_loop(japi, jparams, prompt, res.tokens.numpy(), gen,
                           s + gen, frontend)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)
    if cfg.family in ("encdec", "vlm"):   # P + S + gen slots, P = 8 / 0
        p0 = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
        assert res.cache["pos"].shape[-1] == p0 + s + gen
        assert int(res.cache["pos"].max()) == p0 + s + gen - 2
    assert (res.encode_ms is None) == (cfg.family != "encdec")
    assert set(res.decode_kw) == ({"enc_kv", "enc_pos"}
                                  if cfg.family == "encdec" else set())
    if log is not None:
        log.check(calls=gen * cfg.num_layers // max(cfg.moe_every, 1))


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
    with pytest.raises(ValueError, match="takes frontend input none"):
        tserve.serve(tapi, tparams, prompt, 2, device="cpu",
                     frontend={"patches": torch.zeros((1, 2, 8))})
    cfg, _, _, tapi, tparams = _setup("internvl2_26b", seed=0)
    with pytest.raises(ValueError, match="takes frontend input patches"):
        tserve.serve(tapi, tparams, prompt, 2, device="cpu")


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


def test_moe_checkpoint_served_by_both_packages(tmp_path, capsys,
                                                monkeypatch):
    """A llama4-shaped MoE checkpoint (a group's dense layers as a list)
    saved by the reference serves the same logits and routes in both
    packages; the port's CLI serves it too."""
    arch = "llama4_maverick_400b"
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(9))
    path = str(tmp_path / "moe.npz")
    checkpoint.save(path, jparams)
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    tapi = tbuild(tcfg, device="cpu")
    tree = convert.load_checkpoint(path)
    assert sorted(tree["layers"]["dense"]) == [0]
    tparams = convert.model_params_from_numpy(tcfg, tree, device="cpu")
    log = RouteLog(monkeypatch)
    prompt = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), 4,
                       device="cpu")
    want = _reference_loop(japi, jparams, prompt, res.tokens.numpy(), 4, 13)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)
    log.check(calls=4)

    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt",
                 path, "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=llama4-maverick-400b-a17b batch=2 prompt=6 gen=3 " \
        "device=cpu layers=2" in out


@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_7b"])
def test_recurrent_checkpoint_served_by_both_packages(arch, tmp_path,
                                                      capsys):
    """A checkpoint of a recurrent model saved by the reference (Zamba2's
    Mamba2 blocks a list per group, its unstacked shared block) serves
    the same logits in both packages; the port's CLI serves it too."""
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(11))
    path = str(tmp_path / "rec.npz")
    checkpoint.save(path, jparams)
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    tapi = tbuild(tcfg, device="cpu")
    tparams = convert.model_params_from_numpy(
        tcfg, convert.load_checkpoint(path), device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, 20)).astype(np.int32)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), 8,
                       device="cpu")
    want = _reference_loop(japi, jparams, prompt, res.tokens.numpy(), 8, 28)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt",
                 path, "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={tcfg.name} batch=2 prompt=6 gen=3 device=cpu" in out


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "internvl2_26b"])
def test_frontend_checkpoint_served_by_both_packages(arch, tmp_path,
                                                     capsys):
    """A checkpoint of an encdec or vlm model saved by the reference
    (encdec's encoder stacked over its own depth) serves the same logits
    in both packages, with the same frontend input; the port's CLI serves
    it too, drawing the frontend input in the reference CLI's shapes."""
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(13))
    path = str(tmp_path / "frontend.npz")
    checkpoint.save(path, jparams)
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    tapi = tbuild(tcfg, device="cpu")
    tree = convert.load_checkpoint(path)
    assert set(tree) >= ({"enc_layers", "enc_in_proj", "enc_ln_f"}
                         if tcfg.family == "encdec" else {"patch_proj"})
    tparams = convert.model_params_from_numpy(tcfg, tree, device="cpu")
    prompt = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    frontend = frontend_np(tcfg, 2, 9, 7)
    res = tserve.serve(tapi, tparams, torch.as_tensor(prompt), 4,
                       device="cpu", frontend=_port_frontend(frontend))
    want = _reference_loop(japi, jparams, prompt, res.tokens.numpy(), 4, 13,
                           frontend)
    np.testing.assert_allclose(res.logits.numpy(), want, atol=ATOL,
                               rtol=RTOL)
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt",
                 path, "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={tcfg.name} batch=2 prompt=6 gen=3 device=cpu" in out
    if tcfg.family == "encdec":
        assert "enc_embeds: (2, 6, 128)" in out and "encode:" in out
    else:
        assert "patches: (2, 8, 128)" in out
