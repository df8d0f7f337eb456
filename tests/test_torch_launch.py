"""The port's launch layer on ``meta`` against the reference (the twin of
``tests/test_launch_specs.py`` without its HLO-only ``_replica_groups`` /
``_spans_pods``, and of ``tests/test_archs_smoke.py``'s parameter
counts), and the dry run. All claims exact:

* ``input_specs`` equals the reference's for every (arch, shape): keys,
  shapes and dtypes (int32 tokens and labels, bf16 frontend inputs);
* the long_500k decode state of the four sub-quadratic archs is < 3 GB;
* ``Opts().tag()`` as the reference's;
* parameter counts of all ten full configs equal the reference's
  ``eval_shape`` counts and sit in the reference's ranges;
* ``render_plan``'s params / batch / cache sections list the reference's
  specs in its leaf order;
* the flash wrappers on ``meta`` give the CPU's output shapes and dtypes
  for every mask mode and route (prefill, split + combine, two sources);
* the traced flops of a smoke step on ``meta`` equal the same trace on
  CPU tensors, for one arch of each family (prefill, decode, train);
* ``size_pair`` sizes all 80 (arch x shape x mesh) pairs without a trace:
  no "failed", "skipped" only where the reference skips; ``temp_bytes``
  and ``collectives`` are ``None`` with a note (no partitioner);
* the recorders' ``init_spec()`` and ``obs.counters.render_footprint``
  against the reference's.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCHS, SHAPES, get_config as jget
from repro.dist import sharding as jshd
from repro.launch import specs as jspecs
from repro_torch.configs.base import InputShape, get_config, smoke_variant
from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, mesh as tmesh, op_analysis, specs
from repro_torch.models import transformer
from repro_torch.train import steps

SIZES = {"data": 16, "model": 16}
FAMILY_ARCHS = ["qwen3_4b", "dbrx_132b", "xlstm_125m", "zamba2_7b",
                "seamless_m4t_medium", "internvl2_26b"]


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes(arch, shape_name):
    shape = SHAPES[shape_name]
    ref = jspecs.input_specs(jget(arch), shape)
    batch = specs.input_specs(get_config(arch), shape)
    assert list(batch) == list(ref)
    for key, leaf in ref.items():
        assert batch[key].device.type == "meta"
        assert tuple(batch[key].shape) == leaf.shape, key
        assert _dtype(batch[key]) == leaf.dtype.name, key
    b = shape.global_batch
    assert batch["tokens"].dtype == torch.int32
    assert batch["tokens"].shape[0] == b
    if shape.kind == "decode":
        assert tuple(batch["tokens"].shape) == (b, 1)
    if shape.kind == "train":
        assert batch["labels"].shape == batch["tokens"].shape


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "llama4_maverick_400b",
                                  "zamba2_7b", "xlstm_125m"])
def test_decode_cache_is_bounded_for_subquadratic(arch):
    """long_500k decode state must not scale with the 524,288-token
    context; its bytes are the reference's."""
    cache = specs.cache_specs(get_config(arch), 1,
                              SHAPES["long_500k"].seq_len)
    total = specs.param_bytes(cache)
    ref = jspecs.cache_specs(jget(arch), 1, SHAPES["long_500k"].seq_len)
    assert total == jspecs.param_bytes(ref)
    assert total < 3e9, f"{arch}: decode state {total / 1e9:.1f} GB"


def test_opts_tag():
    assert dryrun.Opts().tag() == "baseline"
    t = dryrun.Opts(attn_bf16=True, microbatches=4, moe_grouped=True).tag()
    assert "attnbf16" in t and "mb4" in t and "moegrp" in t
    assert dryrun.Opts(remat_policy="dots", swa_window=4096,
                       serve_resident=True).tag() == \
        "remat-dots+resident+swa4096"


def test_param_counts_match_full_config_order():
    """Full configs instantiate on meta with the reference's exact
    parameter counts, in its plausible ranges."""
    expect = {
        "qwen3_4b": (3, 6), "stablelm_12b": (9, 15),
        "xlstm_125m": (0.1, 0.3), "h2o_danube3_4b": (3, 6),
        "llama4_maverick_400b": (350, 480), "dbrx_132b": (110, 160),
        "mistral_large_123b": (100, 140),
        "seamless_m4t_medium": (0.5, 2.0), "internvl2_26b": (19, 30),
        "zamba2_7b": (4, 10),
    }
    for arch, (lo, hi) in expect.items():
        params = specs.params_specs(get_config(arch))
        n = transformer.param_count(params)
        ref = sum(l.size for l in jax.tree.leaves(
            jspecs.params_specs(jget(arch))))
        assert n == ref, (arch, n, ref)
        assert lo * 1e9 <= n <= hi * 1e9, (arch, n / 1e9)
        assert specs.param_bytes(params) == jspecs.param_bytes(
            jspecs.params_specs(jget(arch)))


def _sections(text: str) -> dict:
    out, cur = {}, None
    for line in text.splitlines()[1:]:
        if line.startswith("["):
            cur = out.setdefault(line.strip("[]"), [])
        else:
            name, rest = line.split(None, 1)
            shape, spec = rest.split(")", 1)
            cur.append((name, shape + ")", spec.strip()))
    return out


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen3_4b", "decode_32k"), ("llama4_maverick_400b", "prefill_32k"),
    ("zamba2_7b", "long_500k"), ("seamless_m4t_medium", "train_4k"),
    ("internvl2_26b", "prefill_32k"), ("xlstm_125m", "decode_32k")])
def test_render_plan_lists_reference_specs(arch, shape_name):
    shape = SHAPES[shape_name]
    sec = _sections(dryrun.render_plan(arch, shape_name))
    jcfg = jget(arch)
    jaxes = jshd.MeshAxes()
    ref_p = jspecs.params_specs(jcfg)
    want = {"params": (ref_p, jshd.param_pspecs(ref_p, jaxes, SIZES)),
            "batch": (jspecs.input_specs(jcfg, shape),
                      jshd.batch_pspecs(jcfg, shape, jaxes))}
    if shape.kind != "train":
        cache = jspecs.cache_specs(jcfg, shape.global_batch, shape.seq_len)
        want["cache"] = (cache, jshd.cache_pspecs(
            jcfg, cache, shape.global_batch, jaxes, SIZES))
    assert list(sec) == list(want)
    for title, (tree, spec_tree) in want.items():
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding
                                                    .PartitionSpec))
        if title == "cache" and len(leaves) != len(sec[title]):
            continue    # the MoE family's stacked cache: test_torch_sharding
        assert len(sec[title]) == len(leaves), title
        for (name, shp, spec), leaf, ref in zip(sec[title], leaves,
                                                 spec_leaves):
            assert shp == str(tuple(leaf.shape)), (title, name)
            assert spec == repr(shd.P(*tuple(ref))), (title, name)


# ---------------------------------------------------------------------------
# meta: the flash wrappers and traced steps
# ---------------------------------------------------------------------------

def _qkv(device, b=2, sq=5, skv=9, h=4, kvh=2, hd=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((b, sq, h, hd), generator=g).to(dtype)
    k = torch.randn((b, skv, kvh, hd), generator=g).to(dtype)
    v = torch.randn((b, skv, kvh, hd), generator=g).to(dtype)
    q_pos = (torch.arange(sq, dtype=torch.int32) + skv - sq).repeat(b, 1)
    kv_pos = torch.arange(skv, dtype=torch.int32).repeat(b, 1)
    return [t.to(device) for t in (q, k, v, q_pos, kv_pos)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [5, 1])
@pytest.mark.parametrize("mode", list(fa.MODES))
def test_meta_flash_matches_cpu_shapes(mode, sq, dtype):
    outs = {}
    for dev in ("cpu", "meta"):
        q, k, v, qp, kp = _qkv(dev, sq=sq, dtype=dtype)
        main = fa.flash_attention(q, k, v, qp, kp, mode=mode, window=4)
        two = fa.flash_attention(q, k[:, :6], v[:, :6], qp, kp[:, :6],
                                 mode=mode, window=4, k2=k[:, 6:],
                                 v2=v[:, 6:], kv_pos2=kp[:, 6:])
        parts = fa.flash_split(q, k, v, qp, kp, mode=mode, window=4,
                               splits=3)
        comb = fa.flash_combine(*parts, sq=sq, dtype=dtype)
        qg = q.clone().requires_grad_()
        grad = torch.autograd.grad(fa.flash_attention(
            qg, k, v, qp, kp, mode=mode, window=4).float().sum(), qg)[0]
        outs[dev] = [main, two, *parts, comb, grad]
    for a, b in zip(outs["cpu"], outs["meta"]):
        assert b.device.type == "meta"
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)


def _step_args(cfg, kind: str, device: str):
    """Masters and batch of a smoke step on ``device``: the meta
    stand-ins, or CPU tensors drawn from a seed (a decode step's batch is
    the prompt's, for encdec's frames)."""
    shape = InputShape("smoke", 24, 2, "prefill" if kind == "decode"
                       else kind)
    if device == "meta":
        state = specs.state_specs(cfg)
        batch = specs.input_specs(cfg, shape)
    else:
        state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
        rng = np.random.default_rng(0)
        batch = {}
        for key, t in specs.input_specs(cfg, shape).items():
            if t.dtype == torch.int32:
                batch[key] = torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, tuple(t.shape)).astype(np.int32))
            else:
                batch[key] = torch.as_tensor(rng.standard_normal(
                    tuple(t.shape)).astype(np.float32)).to(t.dtype)
    return state, batch, shape


def _traced_flops(cfg, kind: str, device: str) -> tuple:
    state, batch, shape = _step_args(cfg, kind, device)
    if kind == "train":
        rep = op_analysis.analyze(steps.make_train_step(cfg), state, batch)
        return rep["flops"], rep["ops"]
    cache = transformer.init_cache(cfg, state.params, 2, 40)
    if kind == "prefill":
        rep = op_analysis.analyze(steps.make_prefill_step(cfg),
                                  state.params, batch, cache)
        return rep["flops"], rep["ops"]
    kw = {}
    if cfg.family == "encdec":
        model = steps._model(cfg, state.params)
        with torch.no_grad():
            enc_out, enc_pos = transformer.encode(cfg, model,
                                                  batch["enc_embeds"])
            kw = {"enc_kv": transformer._enc_kv_all_layers(cfg, model,
                                                           enc_out),
                  "enc_pos": enc_pos}
    tokens = batch["tokens"][:, :1]
    rep = op_analysis.analyze(steps.make_decode_step(cfg), state.params,
                              tokens, 30, cache, **kw)
    return rep["flops"], rep["ops"]


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_trace_flops_match_cpu(arch, kind):
    cfg = smoke_variant(get_config(arch))
    meta = _traced_flops(cfg, kind, "meta")
    cpu = _traced_flops(cfg, kind, "cpu")
    assert meta == cpu and meta[0] > 0, (meta, cpu)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_size_pair_sizes_every_pair(arch, multi_pod):
    for shape_name in SHAPES:
        rep = dryrun.size_pair(arch, shape_name, multi_pod=multi_pod,
                               trace=False)
        skip = (shape_name == "long_500k"
                and not jget(arch).sub_quadratic)
        assert rep["status"] == ("skipped" if skip else "sized"), rep
        if skip:
            continue
        mem = rep["memory"]
        assert mem["argument_bytes"] == sum(mem["parts"].values()) > 0
        assert mem["output_bytes"] > 0
        # no partitioner: by design
        assert mem["temp_bytes"] is None and rep["collectives"] is None
        assert "no partitioner" in rep["note"]


def test_size_pair_traces_flops_and_keeps_sweeping(tmp_path, capsys):
    """A traced pair reports its flops and the ideal split; the CLI writes
    one report per pair and records a failure without stopping."""
    cfg = dataclasses.replace(get_config("qwen3_4b"), num_layers=1)
    shape = InputShape("tiny", 64, 16, "prefill")
    rep = dryrun.size_pair("qwen3_4b", shape, cfg=cfg)
    assert rep["flops"] > 0
    assert rep["flops_per_device"] == rep["flops"] / 256
    one = dryrun.size_pair("qwen3_4b", shape, cfg=cfg,
                           mesh=tmesh.MeshSpec(("data", "model"), (1, 1)))
    assert one["chips"] == 1 and one["flops"] == rep["flops"]
    assert one["memory"]["parts"]["params"] == specs.param_bytes(
        specs.params_specs(cfg))
    dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                 "--no-trace", "--out", str(tmp_path)])
    rep = json.loads((tmp_path / "qwen3_4b__decode_32k__single.json")
                     .read_text())
    assert rep["status"] == "sized" and "flops" not in rep
    dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--no-trace",
                 "--gossip-pod", "--out", str(tmp_path)])
    rep = json.loads((tmp_path / "qwen3_4b__train_4k__single__gossip.json")
                     .read_text())
    assert rep["status"] == "failed" and "multi-pod" in rep["error"]
    dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--plan",
                 "--cola-m", "4", "--wire", "int8", "--active", "4",
                 "--topo", "ring"])
    out = capsys.readouterr().out
    for part in ("# sharding plan", "[cola recorder footprint]",
                 "[obs counters]", "[topology program] ring"):
        assert part in out, part


def test_counters_footprint_matches_reference():
    from repro.obs import counters as jcounters
    from repro_torch.obs import counters
    ours = counters.render_footprint(16).splitlines()
    ref = jcounters.render_footprint(16).splitlines()
    assert len(ours) == len(ref)
    for a, b in zip(ours[1:-1], ref[1:-1]):
        assert a.split("pspec=")[0] == b.split("pspec=")[0]
        spec = a.split("pspec=")[1]
        assert spec == ("P('nodes')" if a.startswith("  gate") else "P()")
    assert ours[-1].split("B")[0] == ref[-1].split("B")[0]


def test_recorders_init_spec_match_reference():
    from repro.core import metrics as jmet, partition as jpart, \
        problems as jprob, topology as jtopo
    from repro.core.cola import build_env as jbuild
    from repro.optim import gossip as jgossip
    from repro_torch import convert
    from repro_torch.core import cola, metrics, partition, topology
    from repro_torch.data import synthetic
    from repro_torch.dist.runtime import _DistRecorder
    from repro_torch.optim import gossip
    x, y, _ = synthetic.regression(60, 24, seed=1)
    k = 4
    jp = jprob.lasso(jnp.asarray(x), jnp.asarray(y), 0.05, box=5.0)
    jpt = jpart.make_partition(jp.n, k)
    jenv = jbuild(jp, jpt)
    jcert = jmet.certificate_recorder(jp, jpt, jenv, jtopo.ring(k), 1e-2)
    tp = convert.problem_from_numpy("lasso", x, y, 0.05, device="cpu",
                                    box=5.0)
    tpt = partition.make_partition(tp.n, k)
    tenv = cola.build_env(tp, tpt)
    tcert = metrics.certificate_recorder(tp, tpt, tenv, topology.ring(k),
                                         1e-2)
    ref, ours = jcert.init_spec(), tcert.init_spec()
    assert list(ours) == list(ref) == ["sigma_k", "neigh_mask"]
    np.testing.assert_allclose(ours["sigma_k"].numpy(), ref["sigma_k"],
                               rtol=1e-5)
    np.testing.assert_array_equal(ours["neigh_mask"].numpy(),
                                  np.asarray(ref["neigh_mask"]))
    gap = metrics.GapRecorder(problem=tp, part=tpt)
    composed = metrics.ComposedRecorder((gap, tcert))
    assert gap.init_spec() == {} == jmet.GapRecorder(jp, jpt).init_spec()
    assert list(composed.init_spec()) == ["part0", "part1"]
    assert metrics.FnRecorder(("a",), lambda s: s).init_spec() == {}
    assert gossip.ConsensusRecorder().init_spec() == \
        jgossip.ConsensusRecorder().init_spec() == {}
    assert _DistRecorder(tcert, None).init_spec()["sigma_k"] is \
        tcert.sigma_k
    placed = shd.cola_recorder_pspecs("nodes", composed.init_spec())
    assert placed == {"part0": {}, "part1": {"sigma_k": shd.P("nodes"),
                                             "neigh_mask": shd.P("nodes")}}
    cts = shd.cola_counters_pspecs("nodes")
    assert tuple(cts.gate) == ("nodes",) and cts.rounds == shd.P()
