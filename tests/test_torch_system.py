"""End-to-end behaviour of the port on the CPU (the twin of
``tests/test_system.py``): training reduces the loss, serving generates,
checkpoints round-trip, and the CoLA linear probe trains a readout on the
zoo's features; plus the twin of ``examples/serve_batched.py``.

Tolerances:

* training: the reference's claim (the mean of the last 5 of 30 losses
  below the first 5's mean by 0.3);
* greedy generation: deterministic, shaped, in the vocabulary, and the
  reference's tokens on ``convert``ed weights where every step's top-1
  margin is > 1e-4 (a row is compared up to its first closer margin);
* checkpoints: bitwise;
* the linear probe: features within atol 1e-4 of the reference forward's
  (fp32), the port's ``run_cola`` primal below 0.2 x the zero
  predictor's, as the reference's, and its history within rtol 1e-3 of
  the reference's ``run_cola`` on the reference's features;
* ``examples/torch_serve_batched.py``: greedy tokens as the reference
  example's loop (its ``PRNGKey(0)`` weights, ``PRNGKey(1)`` prompt) by
  the margin rule above, and the same decode state's bytes.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, smoke_variant as jsmoke
from repro.core import problems as jprob, topology as jtopo
from repro.core.cola import ColaConfig as JConfig, run_cola as j_run
from repro.models.model import build_model as jbuild
from repro.train.steps import greedy_generate as j_greedy
from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.core import topology
from repro_torch.core.cola import ColaConfig, run_cola
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint
from repro_torch.train.data import TokenBatches
from repro_torch.train.steps import (TrainHParams, greedy_generate,
                                     init_train_state, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
MARGIN = 1e-4


def _batch(pipe, i):
    return {k: torch.as_tensor(v) for k, v in pipe(i).items()}


def test_training_reduces_loss():
    cfg = smoke_variant(get_config("xlstm_125m"))
    hp = TrainHParams(lr=3e-3)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), hp,
                             device="cpu")
    step = make_train_step(cfg, hp)
    pipe = TokenBatches(cfg.vocab_size, 4, 32, corpus_tokens=1 << 13)
    losses = []
    for i in range(30):
        state, m = step(state, _batch(pipe, i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, \
        losses[:3] + losses[-3:]


def _reference_model(arch: str, seed: int = 0):
    jcfg = jsmoke(jget(arch))
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    cfg = smoke_variant(get_config(arch))
    tparams = convert.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, tparams


def _tokens_agree(ours, ref, logits) -> int:
    """Compare greedy tokens row by row up to the first step whose top-1
    margin (of ``logits`` (B, T, V)) is <= MARGIN; returns the number of
    tokens compared."""
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    compared = 0
    for row in range(ref.shape[0]):
        for t in range(ref.shape[1]):
            if margins[row, t] <= MARGIN:
                break
            assert ours[row, t] == ref[row, t], (row, t)
            compared += 1
    return compared


def test_greedy_generation_deterministic_shapes():
    jcfg, jparams, cfg, params = _reference_model("qwen3_4b")
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                          cfg.vocab_size))
    p = torch.as_tensor(prompt)
    out1 = greedy_generate(cfg, params, p, num_steps=6, max_len=16)
    out2 = greedy_generate(cfg, params, p, num_steps=6, max_len=16)
    assert tuple(out1.shape) == (2, 6)
    assert torch.equal(out1, out2)
    assert bool((out1 < cfg.vocab_size).all())
    ref = np.asarray(j_greedy(jcfg, jparams, jnp.asarray(prompt),
                              num_steps=6, max_len=16))
    # the margins of the port's own steps, teacher forced with its tokens
    api = build_model(cfg, device="cpu")
    seq = torch.cat([p, out1[:, :-1]], dim=1)
    with torch.no_grad():
        logits, _ = api.forward(params, {"tokens": seq})
    assert _tokens_agree(out1.numpy(), ref, logits[:, 7:].numpy()) > 0


def test_checkpoint_roundtrip(tmp_path):
    cfg = smoke_variant(get_config("h2o_danube3_4b"))
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, params)
    restored = checkpoint.restore(path, {n: torch.zeros_like(t)
                                         for n, t in params.items()})
    assert list(restored) == list(params)
    for name, t in params.items():
        assert torch.equal(restored[name], t), name


def test_cola_linear_probe_on_model_features():
    """The paper's convex core training a readout on the zoo's features:
    features from a smoke model's forward, a ridge probe fit over 4 nodes
    by the port's ``run_cola``, beating the zero predictor as the
    reference's does, and following the reference's run."""
    jcfg, jparams, cfg, params = _reference_model("qwen3_4b")
    pipe = TokenBatches(cfg.vocab_size, 8, 16, corpus_tokens=1 << 12)
    batch = pipe(0)
    api = build_model(cfg, device="cpu")
    with torch.no_grad():
        logits, _ = api.forward(params, {k: torch.as_tensor(v)
                                         for k, v in batch.items()})
    feats = logits.reshape(-1, cfg.vocab_size)[:, :64].numpy()
    jlogits, _ = jbuild(jcfg).forward(jparams, jax.tree.map(jnp.asarray,
                                                             batch))
    jfeats = np.asarray(jlogits.reshape(-1, cfg.vocab_size))[:, :64]
    np.testing.assert_allclose(feats, jfeats, atol=1e-4)
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=64)
    y = (feats @ w_true + 0.01 * rng.normal(size=feats.shape[0])).astype(
        np.float32)
    prob = convert.problem_from_numpy("ridge_primal", feats, y, 1e-3,
                                      device="cpu")
    res = run_cola(prob, topology.ring(4), ColaConfig(kappa=4.0),
                   rounds=100, record_every=99, device="cpu")
    zero_obj = float(prob.objective(torch.zeros(64)))
    assert res.history["primal"][-1] < 0.2 * zero_obj
    jp = jprob.ridge_primal(jnp.asarray(jfeats, jnp.float32),
                            jnp.asarray(y), 1e-3)
    jres = j_run(jp, jtopo.ring(4), JConfig(kappa=4.0), rounds=100,
                 record_every=99)
    np.testing.assert_allclose(np.asarray(res.history["primal"]),
                               np.asarray(jres.history["primal"]),
                               rtol=1e-3)


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_batched", ROOT / "examples" / "torch_serve_batched.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "xlstm_125m",
                                  "zamba2_7b"])
def test_serve_batched_example_matches_reference(arch):
    batch, prompt_len, gen = 4, 32, 16
    jcfg, jparams, cfg, params = _reference_model(arch)
    japi = jbuild(jcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (batch, prompt_len),
                                0, jcfg.vocab_size)
    # the reference example's loop
    cache = japi.init_cache(jparams, batch, prompt_len + gen)
    logits, cache = japi.prefill(jparams, {"tokens": prompt}, cache)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    ref = [tok]
    decode = jax.jit(japi.decode_step)
    for i in range(gen - 1):
        logits, cache = decode(jparams, tok,
                               jnp.asarray(prompt_len + i, jnp.int32), cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        ref.append(tok)
    ref = np.asarray(jnp.concatenate(ref, axis=1))
    ref_bytes = sum(x.size * x.dtype.itemsize
                    for x in jax.tree.leaves(cache))
    out = _example().serve_arch(arch, batch=batch, prompt_len=prompt_len,
                                gen=gen, device="cpu", params=params,
                                prompt=torch.as_tensor(np.array(prompt)))
    assert out["decode_state_bytes"] == ref_bytes
    assert _tokens_agree(out["tokens"].numpy(), ref,
                         out["logits"].numpy()) > 0
