"""Multi-pod dry run: size every (arch x shape x mesh) step per rank
(counterpart of ``repro.launch.dryrun``).

The reference proves its distribution layout coherent by AOT-lowering and
compiling every step on 512 placeholder CPU devices. The port has no
partitioner to compile against, so it sizes instead: every input, state
and cache is a ``meta`` tensor (``launch.specs``: nothing is allocated,
nothing drawn), every leaf gets the reference's divisibility-guarded spec
(``dist.sharding``), and a rank's bytes follow from ``local_shape``. With
tracing on, the step itself runs once on ``meta`` at the global shape
under ``op_analysis.analyze`` for its flops.

Difference by design: without a partitioner there are no temporaries and
no collective schedule to read, so ``temp_bytes`` and ``collectives`` are
``None``, with a ``note`` saying why; ``flops_per_device`` is the global
flops over the ranks (an ideal split).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--no-trace] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape decode_32k --plan
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs.base import (ARCHS, SHAPES, InputShape,
                                      ModelConfig, get_config)
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import transformer
from repro_torch.models.blocks import ModelCtx
from repro_torch.train.steps import (TrainHParams, _model, make_decode_step,
                                     make_prefill_step, make_train_step)

NOTE = ("no partitioner: temp_bytes and collectives are not known without "
        "one (the reference reads them off XLA's compiled SPMD program); "
        "flops_per_device is flops / chips, an ideal split")


@dataclasses.dataclass(frozen=True)
class Opts:
    """Perf-hillclimb knobs (the reference's). Defaults = baseline."""

    attn_bf16: bool = False        # bf16 score/PV operands (f32 accum)
    remat_policy: str = "full"     # full | dots | none
    microbatches: int = 1
    act_constraint: bool = False   # pin layer-boundary activation sharding
    param_dtype: str | None = None  # e.g. "bfloat16" master params
    state_dtype: str = "float32"   # optimizer moment dtype
    gossip_pod: bool = False       # CoLA gossip-DP across pods (train only)
    moe_grouped: bool = False      # token-grouped MoE dispatch
    serve_resident: bool = False   # serving: no FSDP, weights resident
    swa_window: int = 0            # >0: force sliding-window attention

    def apply_cfg(self, cfg: ModelConfig) -> ModelConfig:
        updates = {}
        if self.attn_bf16:
            updates["attn_compute_dtype"] = "bfloat16"
        if self.remat_policy != "full":
            updates["remat_policy"] = self.remat_policy
        if self.param_dtype:
            updates["param_dtype"] = self.param_dtype
        if self.swa_window and cfg.attention == "full":
            updates["attention"] = "sliding"
            updates["window"] = self.swa_window
        return dataclasses.replace(cfg, **updates) if updates else cfg

    def tag(self) -> str:
        bits = []
        if self.attn_bf16: bits.append("attnbf16")
        if self.remat_policy != "full": bits.append(f"remat-{self.remat_policy}")
        if self.microbatches > 1: bits.append(f"mb{self.microbatches}")
        if self.act_constraint: bits.append("actspec")
        if self.param_dtype: bits.append(f"p-{self.param_dtype}")
        if self.state_dtype != "float32": bits.append(f"s-{self.state_dtype}")
        if self.gossip_pod: bits.append("gossip")
        if self.moe_grouped: bits.append("moegrp")
        if self.serve_resident: bits.append("resident")
        if self.swa_window: bits.append(f"swa{self.swa_window}")
        return "+".join(bits) or "baseline"


BASELINE = Opts()


def model_ctx(mesh) -> ModelCtx:
    """MoE dispatch in global scatter mode, as the reference's dry run
    lowers it (its manual expert-parallel path is for executed runs)."""
    return ModelCtx(mesh=None, model_axis=None, moe_mode="scatter")


def model_ctx_opt(mesh, axes, opts: Opts) -> ModelCtx:
    groups = 1
    if opts.moe_grouped:
        sizes = _mesh_sizes(mesh)
        groups = sizes[axes.data] * (sizes.get("pod", 1)
                                     if axes.pod else 1)
    if not opts.act_constraint and groups <= 1:
        return model_ctx(mesh)
    return ModelCtx(mesh=mesh if opts.act_constraint else None,
                    model_axis=None, moe_mode="scatter",
                    act_spec=(P(axes.batch_axes, None, None)
                              if opts.act_constraint else None),
                    dispatch_groups=groups)


def _mesh_sizes(mesh) -> dict:
    return dict(mesh.sizes)


def _param_flags(kind: str, opts: Opts) -> dict:
    """param_pspecs kwargs per shape kind, shared by the sizing and
    ``render_plan``: training always runs FSDP (+ expert grouping with
    --moe-grouped); serving may keep weights resident (--serve-resident)
    and never groups experts."""
    if kind == "train":
        return dict(fsdp=True, moe_output_fsdp=opts.moe_grouped)
    return dict(fsdp=not opts.serve_resident, moe_output_fsdp=False)


def _shape_infeasible(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k decode needs bounded state — the one (arch, shape)
    combination the sweep and the plan both skip."""
    return shape_name == "long_500k" and not cfg.sub_quadratic


def _state_pspecs(state, pspecs):
    return state._replace(params=pspecs,
                          opt_state={"m": pspecs, "v": pspecs}, step=P())


def _logits_bytes(b: int, s: int, cfg, axes, sizes) -> int:
    """fp32 logits (B, s, V), the batch over the batch axes where it
    divides."""
    ax = axes.batch_axes
    n = shd._size(sizes, ax) if b % shd._size(sizes, ax) == 0 else 1
    return b // n * s * cfg.vocab_size * 4


def _train_sizes(cfg, shape, axes, sizes, hp, opts):
    state = specs_lib.state_specs(cfg, hp)
    batch = specs_lib.input_specs(cfg, shape)
    pspecs = shd.param_pspecs(state.params, axes, sizes,
                              **_param_flags("train", opts))
    parts = {"state": shd.rank_bytes(state, _state_pspecs(state, pspecs),
                                     sizes),
             "batch": shd.rank_bytes(batch, shd.batch_pspecs(cfg, shape,
                                                             axes), sizes)}
    # the state, laid out as its input, and three fp32 metrics
    out = parts["state"] + 3 * 4
    return parts, out, (state, batch)


def _prefill_sizes(cfg, shape, axes, sizes, opts):
    params = specs_lib.params_specs(cfg)
    batch = specs_lib.input_specs(cfg, shape)
    cache = specs_lib.cache_specs(cfg, shape.global_batch, shape.seq_len)
    cspecs = shd.cache_pspecs(cfg, cache, shape.global_batch, axes, sizes)
    parts = {"params": shd.rank_bytes(params, shd.param_pspecs(
                 params, axes, sizes, **_param_flags("prefill", opts)),
                 sizes),
             "batch": shd.rank_bytes(batch, shd.batch_pspecs(cfg, shape,
                                                             axes), sizes),
             "cache": shd.rank_bytes(cache, cspecs, sizes)}
    out = parts["cache"] + _logits_bytes(shape.global_batch, 1, cfg, axes,
                                         sizes)
    return parts, out, (params, batch, cache)


def _enc_kv(cfg, params, b: int, s: int):
    """encdec's cross K/V of a decode step on ``meta``: the port encodes
    with the parameters cast to ``cfg.dtype``, so they are in it."""
    model = _model(cfg, params)
    enc = torch.empty((b, s, cfg.frontend_dim), dtype=torch.bfloat16,
                      device="meta")
    with torch.no_grad():
        enc_out, enc_pos = transformer.encode(cfg, model, enc)
        return transformer._enc_kv_all_layers(cfg, model, enc_out), enc_pos


def _decode_sizes(cfg, shape, axes, sizes, opts):
    b = shape.global_batch
    params = specs_lib.params_specs(cfg)
    cache = specs_lib.cache_specs(cfg, b, shape.seq_len)
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    batch_ax = axes.batch_axes if b >= 16 else ()
    tok_spec = P(batch_ax, None) if batch_ax else P()
    parts = {"params": shd.rank_bytes(params, shd.param_pspecs(
                 params, axes, sizes, **_param_flags("decode", opts)),
                 sizes),
             "tokens": shd.rank_bytes(tokens, tok_spec, sizes),
             "t": 4,
             "cache": shd.rank_bytes(cache, shd.cache_pspecs(
                 cfg, cache, b, axes, sizes), sizes)}
    extra = {}
    if cfg.family == "encdec":
        (k, v), enc_pos = _enc_kv(cfg, params, b, shape.seq_len)
        kv_spec = P(None, axes.data if b >= 16 else None, None, None, None)
        parts["enc_kv"] = shd.rank_bytes((k, v), (kv_spec, kv_spec), sizes)
        parts["enc_pos"] = shd.rank_bytes(
            enc_pos, P(axes.batch_axes if b >= 16 else None, None), sizes)
        extra = {"enc_kv": (k, v), "enc_pos": enc_pos}
    out = parts["cache"] + _logits_bytes(b, 1, cfg, axes, sizes)
    return parts, out, (params, tokens, cache, extra)


def _gossip_sizes(cfg, shape, axes, sizes, hp, opts):
    """CoLA gossip-DP across pods: each pod holds its own replica (sharded
    over data / model within the pod) and its B / pods rows of the
    batch; the spec of every stacked leaf is ``P("pod", *within-pod)``."""
    n_pods = sizes["pod"]
    state = specs_lib.state_specs(cfg, hp)
    pod_axes = shd.MeshAxes()
    pspecs = shd.param_pspecs(state.params, pod_axes, sizes)
    prepend = lambda spec: P("pod", *spec)
    stacked = shd.tree_map(
        lambda t: torch.empty((n_pods,) + tuple(t.shape), dtype=t.dtype,
                              device="meta"), state)
    sspecs = shd.tree_map(prepend, _state_pspecs(state, pspecs))
    local = dataclasses.replace(shape, global_batch=shape.global_batch
                                // n_pods)
    batch = specs_lib.input_specs(cfg, local)
    sbatch = {key: torch.empty((n_pods,) + tuple(t.shape), dtype=t.dtype,
                               device="meta") for key, t in batch.items()}
    bspecs = {key: prepend(spec) for key, spec in
              shd.batch_pspecs(cfg, local, pod_axes).items()}
    parts = {"state": shd.rank_bytes(stacked, sspecs, sizes),
             "batch": shd.rank_bytes(sbatch, bspecs, sizes)}
    return parts, parts["state"] + 3 * 4, (state, batch, local)


def _trace_flops(cfg, shape, kind, args, hp, ctx, n_pods: int = 1) -> float:
    """Flops of one step on ``meta`` at the global shape
    (``op_analysis.analyze``)."""
    from repro_torch.launch import op_analysis
    if kind == "train":
        state, batch = args[:2]
        step = make_train_step(cfg, hp, ctx)
        flops = op_analysis.analyze(step, state, batch)["flops"]
        if n_pods > 1:
            # each pod's local step, then one pairwise mix of its replica
            # with its neighbour's, as the reference's gossip step mixes
            mix = lambda ps: {n: (0.5 * p.float() + 0.5 * p.float()).to(
                p.dtype) for n, p in ps.items()}
            flops = n_pods * (flops + op_analysis.analyze(
                mix, state.params)["flops"])
        return flops
    if kind == "prefill":
        params, batch, cache = args
        step = make_prefill_step(cfg, ctx)
        return op_analysis.analyze(step, params, batch, cache)["flops"]
    params, tokens, cache, extra = args
    step = make_decode_step(cfg, ctx)
    t = torch.empty((), dtype=torch.int32, device="meta")
    return op_analysis.analyze(step, params, tokens, t, cache,
                               **extra)["flops"]


def size_pair(arch: str, shape, *, multi_pod: bool = False,
              hp: TrainHParams | None = None, trace: bool = True,
              opts: Opts = BASELINE, mesh=None,
              cfg: ModelConfig | None = None) -> dict:
    """Size one (arch, shape, mesh) combination; return the report
    (the reference's ``lower_pair`` keys where the port can fill them).

    ``shape``: a name of ``SHAPES`` or an ``InputShape``; ``mesh``: a
    ``launch.mesh.MeshSpec`` (default the production mesh); ``cfg``:
    overrides ``get_config(arch)`` (a depth cut). ``memory.argument_bytes``
    is per rank, exact from the specs: the state and the batch (train),
    params + batch + cache (prefill), params + tokens + t + cache, and
    encdec's cross K/V and positions (decode); ``memory.parts`` splits
    it. ``output_bytes``: the state (train) or the cache laid out as
    its input, and the last position's fp32 logits."""
    cfg = opts.apply_cfg(cfg or get_config(arch))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    if _shape_infeasible(cfg, shape.name):
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full quadratic attention; see DESIGN.md"}
    hp = hp or TrainHParams(microbatches=opts.microbatches,
                            state_dtype=opts.state_dtype)
    axes = (mesh_lib.mesh_axes(multi_pod) if "pod" in mesh.sizes
            else shd.MeshAxes())
    sizes = _mesh_sizes(mesh)
    t0 = time.time()
    n_pods = 1
    if shape.kind == "train":
        if opts.gossip_pod:
            if not multi_pod:
                raise ValueError("--gossip-pod needs the multi-pod mesh")
            parts, out, (state, batch, local) = _gossip_sizes(
                cfg, shape, axes, sizes, hp, opts)
            args, n_pods = (state, batch), sizes["pod"]
            ctx = model_ctx_opt(mesh, shd.MeshAxes(), opts)
        else:
            parts, out, args = _train_sizes(cfg, shape, axes, sizes, hp,
                                            opts)
            ctx = model_ctx_opt(mesh, axes, opts)
    elif shape.kind == "prefill":
        parts, out, args = _prefill_sizes(cfg, shape, axes, sizes, opts)
        ctx = model_ctx_opt(mesh, axes, opts)
    else:
        parts, out, args = _decode_sizes(cfg, shape, axes, sizes, opts)
        ctx = model_ctx_opt(mesh, axes, opts)
    report = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "status": "sized", "chips": mesh.size,
        "opts": opts.tag(),
        "memory": {"argument_bytes": sum(parts.values()),
                   "output_bytes": out, "temp_bytes": None,
                   "alias_bytes": None, "parts": parts},
        "collectives": None, "note": NOTE,
    }
    if trace:
        flops = _trace_flops(cfg, shape, shape.kind, args, hp, ctx, n_pods)
        report["flops"] = flops
        report["flops_per_device"] = flops / mesh.size
        report["flops_split"] = "ideal: flops / chips"
    report["size_s"] = round(time.time() - t0, 2)
    return report


def _named_leaves(tree, sort: bool) -> list:
    """(dotted name, leaf) pairs: the flat parameter dict in its order;
    nested trees (caches) in the reference's flatten order (sorted keys,
    list items by index)."""
    out = []

    def walk(prefix, sub):
        if isinstance(sub, dict):
            keys = sorted(sub, key=str) if sort else list(sub)
            for key in keys:
                walk(f"{prefix}{key}.", sub[key])
        elif isinstance(sub, (list, tuple)) and not isinstance(sub, P):
            for i, item in enumerate(sub):
                walk(f"{prefix}{i}.", item)
        else:
            out.append((prefix[:-1], sub))
    walk("", tree)
    return out


def render_plan(arch: str, shape_name: str, *, multi_pod: bool = False,
                opts: Opts = BASELINE) -> str:
    """Human-readable sharding plan: every state leaf by its dotted name,
    its shape and the spec the rules assign it (nothing allocated)."""
    cfg = opts.apply_cfg(get_config(arch))
    shape = SHAPES[shape_name]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    axes = mesh_lib.mesh_axes(multi_pod)
    sizes = _mesh_sizes(mesh)
    lines = [f"# sharding plan: {arch} x {shape_name} on "
             f"{'x'.join(str(s) for s in mesh.shape)} "
             f"({', '.join(mesh.axis_names)})"]

    def section(title, tree, specs, sort):
        lines.append(f"[{title}]")
        for (name, leaf), (_, spec) in zip(_named_leaves(tree, sort),
                                           _named_leaves(specs, sort)):
            lines.append(f"  {name:<60} {str(tuple(leaf.shape)):<24} "
                         f"{spec}")

    params = specs_lib.params_specs(cfg)
    section("params", params,
            shd.param_pspecs(params, axes, sizes,
                             **_param_flags(shape.kind, opts)), False)
    section("batch", specs_lib.input_specs(cfg, shape),
            shd.batch_pspecs(cfg, shape, axes), True)
    if shape.kind in ("prefill", "decode") and not _shape_infeasible(
            cfg, shape_name):
        cache = specs_lib.cache_specs(cfg, shape.global_batch,
                                      shape.seq_len)
        section("cache", cache,
                shd.cache_pspecs(cfg, cache, shape.global_batch, axes,
                                 sizes), True)
    return "\n".join(lines)


def _render_cola(args) -> None:
    """The CoLA sections of ``--plan``: the recorders' footprints, the
    telemetry counters, streamed participation, the topology programs."""
    from repro_torch.core import metrics as cola_metrics
    from repro_torch.obs import counters as obs_counters
    k_nodes = 2 * 256 if args.multi_pod else 16
    print(cola_metrics.render_footprints(k=k_nodes, d=args.cola_d,
                                         n_k=args.cola_n // k_nodes),
          flush=True)
    print(obs_counters.render_footprint(k_nodes), flush=True)
    from repro_torch.core import schedule as cola_schedule
    if args.active is not None:
        print(cola_schedule.render_stream_footprint(
            args.cola_k, args.active, args.rounds, args.cola_d), flush=True)
    if args.topo == "none":
        return
    from repro_torch import topo as topo_programs
    from repro_torch.core import topology as cola_topo
    wire = None if args.wire in (None, "fp32") else args.wire
    if args.cola_k > cola_schedule.DENSE_MAX_NODES:
        print(f"[topology program] skipped: K={args.cola_k:,} > "
              f"{cola_schedule.DENSE_MAX_NODES:,} "
              "(dense adjacency/coloring does not materialize at "
              "this population; sampled runs use the implicit "
              "complete graph + streamed cohort schedule)", flush=True)
        return
    for name in args.topo.split(","):
        graph = topo_programs.build(name.strip(), args.cola_k)
        plan = topo_programs.compile_plan(graph)
        beta = cola_topo.beta(cola_topo.metropolis_weights(graph))
        print(f"[topology program] {name.strip()} "
              f"(graph={graph.name}, beta={beta:.4f})", flush=True)
        print("  " + plan.contract(args.cola_d, wire=wire).describe(),
              flush=True)
        print(plan.render(d=args.cola_d, wire=wire), flush=True)
        if args.cola_m and args.cola_m < args.cola_k:
            bplan = topo_programs.compile_block_plan(graph, args.cola_m)
            print("  " + bplan.contract(args.cola_d, wire=wire).describe(),
                  flush=True)
            print(bplan.render(d=args.cola_d, wire=wire), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-trace", action="store_true",
                    help="size only: skip the step's trace on meta (the "
                         "reference's --no-compile)")
    ap.add_argument("--plan", action="store_true",
                    help="print the sharding plan (specs per leaf) instead "
                         "of sizing")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true",
                    help="re-run pairs whose report file already exists")
    ap.add_argument("--attn-bf16", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--act-constraint", action="store_true")
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--state-dtype", default="float32")
    ap.add_argument("--gossip-pod", action="store_true")
    ap.add_argument("--moe-grouped", action="store_true")
    ap.add_argument("--serve-resident", action="store_true")
    ap.add_argument("--swa-window", type=int, default=0)
    ap.add_argument("--cola-d", type=int, default=1 << 20,
                    help="--plan: CoLA problem dimension d")
    ap.add_argument("--cola-n", type=int, default=1 << 24,
                    help="--plan: CoLA coordinate count n (n_k = n / K)")
    ap.add_argument("--cola-k", type=int, default=16,
                    help="--plan: node count of the topology programs")
    ap.add_argument("--cola-m", type=int, default=None,
                    help="--plan: also each topology's block plan for K "
                         "nodes on M < K ranks")
    ap.add_argument("--wire", default=None,
                    choices=["fp32", "fp8", "fp8_e5m2", "int8"],
                    help="--plan: gossip wire codec of the byte budgets")
    ap.add_argument("--active", type=int, default=None,
                    help="--plan: also the streamed participation "
                         "footprint for K'=ACTIVE of --cola-k nodes")
    ap.add_argument("--rounds", type=int, default=1000,
                    help="--plan --active: round count T")
    ap.add_argument("--topo", default="ring,torus2d,expander,complete",
                    help="--plan: comma-separated topology names "
                         "(repro_torch.topo.GRAPHS); 'none' skips")
    args = ap.parse_args(argv)
    if args.cola_m is not None and (
            args.cola_m < 1 or args.cola_k % args.cola_m != 0):
        ap.error(f"--cola-m {args.cola_m} must divide --cola-k "
                 f"{args.cola_k} (contiguous node blocks per rank)")
    opts = Opts(attn_bf16=args.attn_bf16, remat_policy=args.remat_policy,
                microbatches=args.microbatches,
                act_constraint=args.act_constraint,
                param_dtype=args.param_dtype, state_dtype=args.state_dtype,
                gossip_pod=args.gossip_pod, moe_grouped=args.moe_grouped,
                serve_resident=args.serve_resident,
                swa_window=args.swa_window)
    archs = ARCHS if args.all or args.arch is None else [
        args.arch.replace("-", "_")]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]

    if args.plan:
        for a, s in pairs:
            print(render_plan(a, s, multi_pod=args.multi_pod, opts=opts),
                  flush=True)
        _render_cola(args)
        return

    os.makedirs(args.out, exist_ok=True)
    for a, s in pairs:
        tag = "multi" if args.multi_pod else "single"
        suffix = "" if opts.tag() == "baseline" else f"__{opts.tag()}"
        path = os.path.join(args.out, f"{a}__{s}__{tag}{suffix}.json")
        if os.path.exists(path) and not args.force:
            print(f"=== {a} x {s} [{tag}-pod] cached ===", flush=True)
            continue
        print(f"=== {a} x {s} [{tag}-pod] ===", flush=True)
        try:
            rep = size_pair(a, s, multi_pod=args.multi_pod,
                            trace=not args.no_trace, opts=opts)
        except Exception as e:  # record the failure, keep sweeping
            rep = {"arch": a, "shape": s, "mesh": tag, "status": "failed",
                   "error": f"{type(e).__name__}: {e}"[:500]}
        print(json.dumps(rep, indent=1), flush=True)
        with open(path, "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main()
