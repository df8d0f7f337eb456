"""Gossip data-parallelism and its DP wire (``repro_torch.optim.gossip``,
``repro_torch.optim.privacy``, ``quant.wire_view_pytree``) against the
JAX reference on the CPU: the twin of ``tests/test_gossip_dp.py``.

The reference's own gossip tests train xLSTM-125M's smoke variant; so
does ``test_xlstm_gossip_training_matches_reference`` here. The others
run both packages at Qwen3-4B's ``smoke_variant`` (the dense family)
from the same parameters (the reference's draw, carried
across with ``convert``) and the same numpy batches. The local step is the
train step with SGD + momentum in both packages (smooth in the gradient;
AdamW's first step is sign-sensitive, see ``test_torch_train.py``).

Tolerances: replica parameters after gossip steps rtol 1e-5 and atol 1e-6
x max|param|; consensus histories rtol 1e-4 and atol 1e-9 (a sum of
squared differences of nearly equal replicas); the DP mix with the
reference's normals and stochastic-rounding uniforms fed in, atol 1e-5;
the accountant exactly (host float arithmetic); the port's own Gaussian
stream by its moments (mean within 5 standard errors of 0, std within
1 %), its links uncorrelated (|r| < 5 / sqrt(n)).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, smoke_variant as jsmoke
from repro.core import quant as jq, topology as jtopo
from repro.optim import gossip as jgsp, optimizers as jopt, privacy as jpriv
from repro.train import data as jdata, steps as jsteps
from repro_torch import convert
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.core import quant as tq, streams
from repro_torch.optim import gossip as tgsp, optimizers as topt, \
    privacy as tpriv
from repro_torch.train import steps as tsteps

ARCH = "qwen3_4b"
K = 4


@pytest.fixture(scope="module")
def setup():
    """(cfg, tcfg, reference state0 as numpy, reference local step, port
    local step, pipe) with SGD + momentum in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "_optimizer", lambda hp: jopt.sgd_momentum(0.9))
        mp.setattr(tsteps, "_optimizer", lambda hp: topt.sgd_momentum(0.9))
        cfg = jsmoke(jget(ARCH))
        tcfg = smoke_variant(get_config(ARCH))
        hp = jsteps.TrainHParams(lr=0.05)
        state0 = jax.tree.map(np.asarray, jsteps.init_train_state(
            cfg, jax.random.PRNGKey(0), hp))
        jlocal = jsteps.make_train_step(cfg, hp)
        tlocal = tsteps.make_train_step(tcfg, tsteps.TrainHParams(lr=0.05))
        pipe = jdata.TokenBatches(cfg.vocab_size, 2, 16,
                                  corpus_tokens=1 << 12)
        yield cfg, tcfg, state0, jlocal, tlocal, pipe


def _batches(pipe, step, k=K):
    return {key: np.stack([pipe(step, shard=j)[key] for j in range(k)])
            for key in ("tokens", "labels")}


def _states(setup, k=K):
    cfg, tcfg, state0, *_ = setup
    jst = jgsp.replicate_state(jax.tree.map(jnp.asarray, state0), k)
    tst = convert.train_state_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                            jst),
                                         device="cpu")
    return jst, tst


def _flat(tree):
    return convert._nested_to_flat(jax.tree.map(np.asarray, tree))


def _close_params(tparams, jparams, atol_rel=1e-6):
    want = _flat(jparams)
    for name, p in tparams.items():
        w = want[name]
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-5,
                                   atol=atol_rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


def _stack(rng, shapes):
    return {n: rng.standard_normal((K,) + s).astype(np.float32)
            for n, s in shapes.items()}


SHAPES = {"a": (6, 5), "b": (7,), "c": (3, 2, 4)}


def test_mixing_preserves_parameter_mean_and_matches_reference():
    rng = np.random.default_rng(0)
    stack = _stack(rng, SHAPES)
    w = jtopo.metropolis_weights(jtopo.ring(K)).astype(np.float32)
    got = tgsp.mix_pytree(torch.as_tensor(w),
                          {n: torch.as_tensor(a) for n, a in stack.items()},
                          steps=2)
    want = jgsp.mix_pytree(jnp.asarray(w), jax.tree.map(jnp.asarray, stack),
                           steps=2)
    before = tgsp.average_params({n: torch.as_tensor(a)
                                  for n, a in stack.items()})
    after = tgsp.average_params(got)
    for n in stack:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(after[n].numpy(), before[n].numpy(),
                                   atol=1e-5)


def test_gossip_step_matches_reference_and_complete_graph_agrees(setup):
    cfg, tcfg, state0, jlocal, tlocal, pipe = setup
    for topology in ("ring", "complete"):
        gcfg = jgsp.GossipConfig(num_nodes=K, topology=topology)
        tgcfg = tgsp.GossipConfig(num_nodes=K, topology=topology)
        w = (np.full((K, K), 1.0 / K, np.float32) if topology == "complete"
             else gcfg.weights().astype(np.float32))
        jst, tst = _states(setup)
        jstep = jgsp.make_gossip_step(jlocal, gcfg)
        tstep = tgsp.make_gossip_step(tlocal, tgcfg)
        act = np.ones((K,), np.float32)
        for i in range(2):
            b = _batches(pipe, i)
            jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b),
                            jnp.asarray(w), jnp.asarray(act))
            tst, tm = tstep(tst, {k: torch.as_tensor(a) for k, a in
                                  b.items()}, torch.as_tensor(w),
                            torch.as_tensor(act))
            np.testing.assert_allclose(tm["loss"].numpy(),
                                       np.asarray(jm["loss"]), rtol=1e-5)
        _close_params(tst.params, jst.params)
        if topology == "complete":
            assert float(tgsp.consensus_distance(tst.params)) < 1e-8
        np.testing.assert_allclose(
            float(tgsp.consensus_distance(tst.params)),
            float(jgsp.consensus_distance(jst.params)), rtol=1e-4,
            atol=1e-9)


def test_frozen_nodes_keep_state(setup):
    """An inactive node's local step commits nothing (gossip_steps=0
    isolates the local step); its metrics row is still the reference's."""
    cfg, tcfg, state0, jlocal, tlocal, pipe = setup
    jst, tst = _states(setup)
    before = {n: p.clone() for n, p in tst.params.items()}
    act = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    w = np.eye(K, dtype=np.float32)
    b = _batches(pipe, 2)
    jst, jm = jgsp.make_gossip_step(
        jlocal, jgsp.GossipConfig(num_nodes=K, gossip_steps=0))(
        jst, jax.tree.map(jnp.asarray, b), jnp.asarray(w), jnp.asarray(act))
    tst, tm = tgsp.make_gossip_step(
        tlocal, tgsp.GossipConfig(num_nodes=K, gossip_steps=0))(
        tst, {k: torch.as_tensor(a) for k, a in b.items()},
        torch.as_tensor(w), torch.as_tensor(act))
    for n, p in tst.params.items():
        assert torch.equal(p[1], before[n][1]) and torch.equal(
            p[3], before[n][3])
        assert not torch.equal(p[0], before[n][0])
    assert tst.step.tolist() == [1, 0, 1, 0]
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=1e-5)
    _close_params(tst.params, jst.params)


def test_gossip_b_steps_contracts_faster():
    rng = np.random.default_rng(5)
    k = 8
    w = torch.as_tensor(jtopo.metropolis_weights(jtopo.ring(k)),
                        dtype=torch.float32)
    base = {n: np.tile(rng.standard_normal(s).astype(np.float32),
                       (k,) + (1,) * len(s)) for n, s in SHAPES.items()}
    noisy = {n: torch.as_tensor(a + 0.01 * rng.standard_normal(a.shape)
                                .astype(np.float32)) for n, a in base.items()}
    d0 = float(tgsp.consensus_distance(noisy))
    d1 = float(tgsp.consensus_distance(tgsp.mix_pytree(w, noisy, steps=1)))
    d3 = float(tgsp.consensus_distance(tgsp.mix_pytree(w, noisy, steps=3)))
    assert d3 < d1 < d0


@pytest.mark.parametrize("eps", [None, 1e-6])
def test_block_runner_consensus_history_matches_reference(setup, eps):
    cfg, tcfg, state0, jlocal, tlocal, pipe = setup
    rounds = 4
    jst, tst = _states(setup)
    w = np.broadcast_to(np.full((K, K), 1.0 / K, np.float32),
                        (rounds, K, K)).copy()
    w[:2] = jgsp.GossipConfig(num_nodes=K).weights()
    act = np.ones((rounds, K), np.float32)
    act[1, 2] = 0.0
    bs = [_batches(pipe, t) for t in range(rounds)]
    batches = {key: np.stack([b[key] for b in bs]) for key in bs[0]}
    mix = jgsp.mix_schedule(rounds, 1)
    jrun = jgsp.make_gossip_block_runner(
        jlocal, jgsp.GossipConfig(num_nodes=K),
        recorder=jgsp.ConsensusRecorder(eps=eps))
    trun = tgsp.make_gossip_block_runner(
        tlocal, tgsp.GossipConfig(num_nodes=K),
        recorder=tgsp.ConsensusRecorder(eps=eps))
    jst, jm, jh = jrun(jst, jax.tree.map(jnp.asarray, batches),
                       jnp.asarray(w), jnp.asarray(act), mix, block_size=3)
    tst, tm, th = trun(tst, batches, w, act, mix, block_size=3)
    assert th["round"] == jh["round"]
    assert th["stop_round"] == jh["stop_round"]
    if eps is not None:
        assert th["stop_round"] == 2          # the first full average
    np.testing.assert_allclose(th["consensus_distance"],
                               jh["consensus_distance"], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(tm["loss"].numpy(),
                               np.asarray(jm["loss"]), rtol=1e-5)
    _close_params(tst.params, jst.params)


def test_dp_config_validation_and_accountant_match_reference():
    for bad in (dict(clip=0.0, sigma=1.0), dict(clip=1.0, sigma=-1.0)):
        with pytest.raises(ValueError, match="clip > 0"):
            tpriv.DPConfig(**bad)
    with pytest.raises(ValueError, match="delta"):
        tpriv.DPConfig(clip=1.0, sigma=1.0, delta=2.0)
    dp = tpriv.DPConfig(clip=0.5, sigma=2.0)
    assert (dp.sensitivity, dp.noise_std) == (1.0, 2.0)
    for n in (0, 1, 16, 1000):
        a = tpriv.GaussianAccountant(2.0, 1e-5).add(n)
        b = jpriv.GaussianAccountant(2.0, 1e-5).add(n)
        assert (a.releases, a.rho, a.epsilon()) == (b.releases, b.rho,
                                                    b.epsilon())
    assert tpriv.GaussianAccountant(2.0).add(10).add(6).rho == \
        tpriv.GaussianAccountant(2.0).add(16).rho
    with pytest.raises(ValueError, match="un-release"):
        tpriv.GaussianAccountant(1.0).add(-1)


@pytest.mark.parametrize("per_link", [True, False])
def test_release_counts_and_epsilon_schedule_match_reference(per_link):
    for name, k in (("ring", 8), ("torus", 16), ("complete", 5)):
        tg = tgsp.GossipConfig(num_nodes=k, topology=name).graph()
        jg = jtopo.TOPOLOGIES[name](k)
        assert tpriv.max_degree(tg) == jpriv.max_degree(jg)
        t = tpriv.DPConfig(clip=1.0, sigma=1.3, per_link=per_link)
        j = jpriv.DPConfig(clip=1.0, sigma=1.3, per_link=per_link)
        assert t.releases_per_mix_round(tg, 3) == \
            j.releases_per_mix_round(jg, 3)
        mixes = np.array([0, 1, 4, 10])
        np.testing.assert_array_equal(
            tpriv.epsilon_schedule(t, tg, 3, mixes),
            jpriv.epsilon_schedule(j, jg, 3, mixes))


def test_clip_params_matches_reference():
    rng = np.random.default_rng(0)
    stack = _stack(rng, SHAPES)
    stack["a"][1] *= 1e-3          # a node inside the ball passes through
    want = jpriv.clip_params(jax.tree.map(jnp.asarray, stack), 1.0)
    got = tpriv.clip_params({n: torch.as_tensor(a)
                             for n, a in stack.items()}, 1.0)
    for n in stack:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-7)
    flat = np.concatenate([got[n].numpy().reshape(K, -1) for n in stack], 1)
    assert np.all(np.linalg.norm(flat, axis=1) <= 1.0 + 1e-6)


def _ref_normals(key, steps, stack, per_link):
    """The reference noisy_dense_mix's normals per (step, leaf)."""
    leaves = jax.tree.leaves(jax.tree.map(jnp.asarray, stack))
    out = {}
    for s in range(steps):
        key_s = jax.random.fold_in(key, s)
        for i, p in enumerate(leaves):
            key_i = jax.random.fold_in(key_s, i)
            shape = ((K,) + p.shape) if per_link else p.shape
            out[s, i] = np.asarray(jax.random.normal(key_i, shape))
    return out


def _ref_leaf_uniforms(key_s, stack):
    """The reference's SR uniforms of wire_view_pytree under a step key:
    leaf i keyed fold_in(wire_stream(key_s), i), node rows by node key."""
    wk = jq.wire_stream(key_s)
    out = []
    for i, p in enumerate(jax.tree.leaves(stack)):
        d = int(np.prod(p.shape[1:]))
        keys = jq.node_keys(jax.random.fold_in(wk, i), jnp.arange(K))
        out.append(np.array(jax.vmap(
            lambda kk: jax.random.uniform(kk, (d,)))(keys)))
    return out


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("per_link", [True, False])
def test_noisy_dense_mix_with_reference_draws(per_link, wire):
    rng = np.random.default_rng(1)
    stack = {n: a * 3 for n, a in _stack(rng, SHAPES).items()}
    w = jtopo.metropolis_weights(jtopo.ring(K)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    steps = 2
    jdp = jpriv.DPConfig(clip=5.0, sigma=0.5, per_link=per_link)
    tdp = tpriv.DPConfig(clip=5.0, sigma=0.5, per_link=per_link)
    want = jpriv.noisy_dense_mix(jnp.asarray(w),
                                 jax.tree.map(jnp.asarray, stack), jdp, key,
                                 steps, wire_codec=wire)
    normals = _ref_normals(key, steps, stack, per_link)
    # the codec's uniforms depend on the values only through nothing: the
    # reference keys them by (step, leaf, node)
    unis = {s: _ref_leaf_uniforms(jax.random.fold_in(key, s), stack)
            for s in range(steps)}
    got = tpriv.noisy_dense_mix(
        torch.as_tensor(w), {n: torch.as_tensor(a) for n, a in stack.items()},
        tdp, 0, steps, wire_codec=wire,
        draws=lambda s, i: torch.tensor(normals[s, i]),
        wire_draws=lambda s, i: torch.as_tensor(unis[s][i]))
    for n in stack:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   atol=1e-5, err_msg=n)


def test_noisy_dense_mix_own_stream():
    """Tiny noise centers on the clipped mix; the draws are a function of
    (seed, round, step, leaf, link): the same call repeats bitwise, another
    round or broadcast noise differs."""
    rng = np.random.default_rng(2)
    stack = {"p": torch.as_tensor(rng.standard_normal((K, 12))
                                  .astype(np.float32))}
    w = torch.as_tensor(jtopo.metropolis_weights(jtopo.ring(K)),
                        dtype=torch.float32)
    tiny = tpriv.DPConfig(clip=10.0, sigma=1e-7)
    out = tpriv.noisy_dense_mix(w, stack, tiny, tiny.round_key(0))
    clean = w @ tpriv.clip_params(stack, 10.0)["p"]
    np.testing.assert_allclose(out["p"].numpy(), clean.numpy(), rtol=1e-4,
                               atol=1e-5)
    loud = tpriv.DPConfig(clip=10.0, sigma=0.5)
    a = tpriv.noisy_dense_mix(w, stack, loud, loud.round_key(4))
    b = tpriv.noisy_dense_mix(w, stack, loud, loud.round_key(4))
    c = tpriv.noisy_dense_mix(w, stack, loud, loud.round_key(5))
    d = tpriv.noisy_dense_mix(
        w, stack, tpriv.DPConfig(clip=10.0, sigma=0.5, per_link=False),
        loud.round_key(4))
    assert torch.equal(a["p"], b["p"])
    assert not torch.equal(a["p"], c["p"]) and not torch.equal(a["p"],
                                                               d["p"])
    assert torch.equal(stack["p"], torch.as_tensor(
        np.random.default_rng(2).standard_normal((K, 12)).astype(
            np.float32)))     # the functional form leaves its input alone


def test_gaussian_stream_moments_and_independent_links():
    n = 400_000
    key = tpriv.DPConfig(clip=1.0, sigma=1.0).round_key(0)
    z = streams.normal(streams.fold(key, 0, 0, 1, 0), n, "cpu").double()
    z2 = streams.normal(streams.fold(key, 0, 0, 1, 2), n, "cpu").double()
    assert abs(float(z.mean())) < 5 / np.sqrt(n)
    assert abs(float(z.std()) - 1.0) < 0.01
    assert abs(float(torch.corrcoef(torch.stack([z, z2]))[0, 1])) < \
        5 / np.sqrt(n)
    # the tails of a normal: P(|z| > 3) = 0.27 %
    assert abs(float((z.abs() > 3).double().mean()) - 0.0027) < 0.0005
    # chunking does not change the draws
    old = streams.NORMAL_CHUNK_PAIRS
    try:
        streams.NORMAL_CHUNK_PAIRS = 1000
        again = streams.normal(streams.fold(key, 0, 0, 1, 0), n, "cpu")
    finally:
        streams.NORMAL_CHUNK_PAIRS = old
    assert torch.equal(again.double(), z)


@pytest.mark.parametrize("wire", ["int8", "fp8", "fp8_e5m2"])
def test_wire_view_pytree_with_fed_uniforms(wire):
    rng = np.random.default_rng(3)
    stack = _stack(rng, SHAPES)
    key = jax.random.PRNGKey(7)
    want = jq.wire_view_pytree(jax.tree.map(jnp.asarray, stack), wire, key)
    unis = _ref_leaf_uniforms_for_key(key, stack)
    got = tq.wire_view_pytree({n: torch.as_tensor(a)
                               for n, a in stack.items()}, wire,
                              uniforms=[torch.as_tensor(u) for u in unis])
    rtn = jq.wire_view_pytree(jax.tree.map(jnp.asarray, stack), wire)
    got_rtn = tq.wire_view_pytree({n: torch.as_tensor(a)
                                   for n, a in stack.items()}, wire)
    for n in stack:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        np.testing.assert_array_equal(got_rtn[n].numpy(),
                                      np.asarray(rtn[n]))
    # the port's own draws: a function of the key, bitwise repeatable
    mine = tq.wire_view_pytree({n: torch.as_tensor(a)
                                for n, a in stack.items()}, wire, key=11)
    again = tq.wire_view_pytree({n: torch.as_tensor(a)
                                 for n, a in stack.items()}, wire, key=11)
    assert all(torch.equal(mine[n], again[n]) for n in stack)
    assert tq.wire_view_pytree(stack, "fp32") is stack


def _ref_leaf_uniforms_for_key(key, stack):
    out = []
    for i, p in enumerate(jax.tree.leaves(stack)):
        d = int(np.prod(p.shape[1:]))
        keys = jq.node_keys(jax.random.fold_in(key, i), jnp.arange(K))
        out.append(np.array(jax.vmap(
            lambda kk: jax.random.uniform(kk, (d,)))(keys)))
    return out


@pytest.mark.parametrize("mode", ["trim", "median", "clip"])
def test_robust_mix_pytree_matches_reference(mode):
    rng = np.random.default_rng(4)
    k = 8
    common = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    stack = {n: (c + 0.1 * rng.standard_normal((k,) + c.shape)).astype(
        np.float32) for n, c in common.items()}
    for n in stack:
        stack[n][3] *= -10.0               # one lying replica
    w = jtopo.metropolis_weights(jtopo.connected_cycle(k, 2)).astype(
        np.float32)
    want = jgsp.robust_mix_pytree(jnp.asarray(w),
                                  jax.tree.map(jnp.asarray, stack), mode,
                                  steps=2)
    got = tgsp.robust_mix_pytree(torch.as_tensor(w),
                                 {n: torch.as_tensor(a)
                                  for n, a in stack.items()}, mode, steps=2)
    for n in stack:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("robust,wire", [(None, "fp32"), ("trim", "fp32"),
                                         ("median", "fp32"), ("clip", "fp32"),
                                         (None, "int8"), (None, "fp8")])
def test_param_mixer_matches_reference(robust, wire):
    """The mixer both gossip drivers run (``_param_mixer``, in place)
    against the reference's, B = 2 on connected_cycle(8, 2) with one lying
    replica: dense, robust, and the round-to-nearest quantized wire
    (rtol 1e-6, atol 1e-6)."""
    rng = np.random.default_rng(5)
    k = 8
    stack = {n: (1.0 + rng.standard_normal((k,) + s)).astype(np.float32)
             for n, s in SHAPES.items()}
    for n in stack:
        stack[n][3] *= -10.0
    kw = dict(num_nodes=k, topology="cycle2", gossip_steps=2,
              robust=robust, wire=wire)
    jg, tg = jgsp.GossipConfig(**kw), tgsp.GossipConfig(**kw)
    w = jg.weights().astype(np.float32)
    want = jgsp._param_mixer(jg, None, None, None)(
        jnp.asarray(w), jax.tree.map(jnp.asarray, stack))
    got = {n: torch.as_tensor(a.copy()) for n, a in stack.items()}
    out = tgsp._param_mixer(tg, None, None, None)(torch.as_tensor(w), got)
    assert out is got
    for n in stack:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def test_rejected_combinations_and_unported_paths(setup):
    *_, tlocal, _ = setup
    dp = tpriv.DPConfig(clip=1.0, sigma=1.0)
    with pytest.raises(ValueError, match="per-link noise"):
        tgsp.make_gossip_step(tlocal, tgsp.GossipConfig(num_nodes=4,
                                                        robust="trim"), dp=dp)
    with pytest.raises(ValueError, match="robust aggregators"):
        tgsp.make_gossip_step(tlocal, tgsp.GossipConfig(
            num_nodes=4, robust="trim", wire="int8"))
    with pytest.raises(ValueError, match="dense"):
        tgsp.make_gossip_step(tlocal, tgsp.GossipConfig(num_nodes=4),
                              mesh=object(), axis="nodes", dp=dp)
    with pytest.raises(ValueError, match="dense path"):
        tgsp.make_gossip_block_runner(
            tlocal, tgsp.GossipConfig(num_nodes=4, robust="trim"),
            mesh=object(), axis="nodes")
    # the ring over ranks (ported): it needs a process group, one node
    # per rank and a circulant W (the runs: tests/test_torch_dist_wire.py)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tgsp.make_gossip_step(tlocal, tgsp.GossipConfig(num_nodes=4),
                              mesh=object(), axis="nodes")
    ring_axis = types.SimpleNamespace(size=4, index=0, permute=None)
    with pytest.raises(ValueError, match="circulant"):
        tgsp._param_mixer(tgsp.GossipConfig(num_nodes=4,
                                            topology="star"),
                          ring_axis, None, 1)
    assert tgsp.ring_mix_pytree({}, ring_axis, torch.ones(3), 1) == {}
    with pytest.raises(ValueError, match="needs a recorder"):
        tgsp.make_gossip_block_runner(tlocal,
                                      tgsp.GossipConfig(num_nodes=4),
                                      telemetry=True)
    # telemetry (ported): the entry equals the reference's on the same run
    # (the modeled bytes per mixed round, the mixed rounds, the contract
    # line; no registry written); under DP it also carries the final
    # epsilon, the reference's accountant's
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_RUNS_DIR", "off")
        cfg, _, state0, jlocal, _, pipe = setup
        rounds = 3
        jst, tst = _states(setup)
        bs = [_batches(pipe, t) for t in range(rounds)]
        batches = {key: np.stack([b[key] for b in bs]) for key in bs[0]}
        w = np.broadcast_to(tgsp.GossipConfig(num_nodes=K).weights().astype(
            np.float32), (rounds, K, K))
        act = np.ones((rounds, K), np.float32)
        mix = np.array([False, True, True])
        _, _, got = tgsp.make_gossip_block_runner(
            tlocal, tgsp.GossipConfig(num_nodes=K),
            recorder=tgsp.ConsensusRecorder(), telemetry=True)(
            tst, batches, w, act, mix, block_size=3)
        _, _, want = jgsp.make_gossip_block_runner(
            jlocal, jgsp.GossipConfig(num_nodes=K),
            recorder=jgsp.ConsensusRecorder(), telemetry=True)(
            jst, jax.tree.map(jnp.asarray, batches), jnp.asarray(w),
            jnp.asarray(act), mix, block_size=3)
        assert got["telemetry"] == want["telemetry"]
        assert got["telemetry"]["wire_bytes"] > 0
        _, tst = _states(setup)
        _, _, got_dp = tgsp.make_gossip_block_runner(
            tlocal, tgsp.GossipConfig(num_nodes=K, wire="int8"), dp=dp,
            recorder=tgsp.ConsensusRecorder(), telemetry=True)(
            tst, batches, w, act, mix, block_size=3)
    tel = got_dp["telemetry"]
    assert tel["wire_bytes"] == 2 * K * tq.payload_bytes(
        int(sum(np.prod(p.shape[1:]) for p in tst.params.values())), "int8")
    assert tel["dp_epsilon"] == float(jpriv.epsilon_schedule(
        jpriv.DPConfig(clip=1.0, sigma=1.0), jtopo.ring(K), 1,
        np.cumsum(mix))[-1])


def test_dp_block_runner_history_carries_epsilon(setup):
    """Port's own draws on the int8 wire, mixed every second round with
    B = 2: the history's epsilon curve and release count are the
    reference's accounting (4 mix rounds x 2 steps x deg 2 = 16)."""
    cfg, tcfg, state0, jlocal, tlocal, pipe = setup
    rounds = 8
    gcfg = tgsp.GossipConfig(num_nodes=K, gossip_steps=2, mix_every=2,
                             wire="int8")
    dp = tpriv.DPConfig(clip=5.0, sigma=1.0)
    _, tst = _states(setup)
    bs = [_batches(pipe, t) for t in range(rounds)]
    batches = {key: np.stack([b[key] for b in bs]) for key in bs[0]}
    w = np.broadcast_to(gcfg.weights().astype(np.float32), (rounds, K, K))
    mix = tgsp.mix_schedule(rounds, 2)
    run = tgsp.make_gossip_block_runner(tlocal, gcfg, dp=dp,
                                        recorder=tgsp.ConsensusRecorder())
    tst, _, hist = run(tst, batches, w, np.ones((rounds, K), np.float32),
                       mix, block_size=4)
    jdp = jpriv.DPConfig(clip=5.0, sigma=1.0)
    jg = jtopo.ring(K)
    want = jpriv.epsilon_schedule(jdp, jg, 2, np.cumsum(mix))
    np.testing.assert_array_equal(hist["dp_epsilon"], want)
    assert hist["dp"]["releases"] == 16
    assert hist["dp"]["epsilon"] == jpriv.GaussianAccountant(
        1.0, jdp.delta).add(16).epsilon()
    assert all(np.isfinite(hist["consensus_distance"]))
    # clipped emissions: every replica ends near the clip ball
    flat = torch.cat([p.reshape(K, -1) for p in tst.params.values()], 1)
    assert bool(torch.isfinite(flat).all())


def test_xlstm_gossip_training_matches_reference(setup, monkeypatch):
    """xLSTM-125M's smoke variant (the reference's gossip model), K = 4
    replicas on ring(4), 3 gossip steps with SGD + momentum local steps:
    losses, every replica's parameters and the consensus distance against
    the reference's ``make_gossip_step``. The parameters at atol 1e-5 x
    max|param| (the gradient bar of ``test_torch_ssm.py``), not 1e-6: the
    norm gains start at 0, so their max after 3 steps is the size of 3
    updates, of which the sLSTM's recurrence carries fp32 rounding of a
    few 1e-6 (measured 2e-6 on ``layers.ln_m``)."""
    monkeypatch.setattr(jsteps, "_optimizer",
                        lambda hp: jopt.sgd_momentum(0.9))
    monkeypatch.setattr(tsteps, "_optimizer",
                        lambda hp: topt.sgd_momentum(0.9))
    *_, pipe = setup
    cfg = jsmoke(jget("xlstm_125m"))
    tcfg = smoke_variant(get_config("xlstm_125m"))
    hp = jsteps.TrainHParams(lr=0.05)
    jst = jgsp.replicate_state(jsteps.init_train_state(
        cfg, jax.random.PRNGKey(3), hp), K)
    tst = convert.train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst), device="cpu")
    gcfg = jgsp.GossipConfig(num_nodes=K)
    jstep = jgsp.make_gossip_step(jsteps.make_train_step(cfg, hp), gcfg)
    tstep = tgsp.make_gossip_step(
        tsteps.make_train_step(tcfg, tsteps.TrainHParams(lr=0.05)),
        tgsp.GossipConfig(num_nodes=K))
    w = gcfg.weights().astype(np.float32)
    act = np.ones((K,), np.float32)
    for i in range(3):
        b = _batches(pipe, i)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b), jnp.asarray(w),
                        jnp.asarray(act))
        tst, tm = tstep(tst, {k: torch.as_tensor(a) for k, a in b.items()},
                        torch.as_tensor(w), torch.as_tensor(act))
        np.testing.assert_allclose(tm["loss"].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5)
    _close_params(tst.params, jst.params, atol_rel=1e-5)
    np.testing.assert_allclose(
        float(tgsp.consensus_distance(tst.params)),
        float(jgsp.consensus_distance(jst.params)), rtol=1e-4, atol=1e-9)
