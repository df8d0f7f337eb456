#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before printing any result. Phases, each printing one JSON
line:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — builds the kernels from ``src/repro_torch/kernels/csrc/``.
3. kernel  — each kernel against its plain PyTorch version on the card, at
   the main path's shapes (Gram: K=16, n_k=125; residual: K=16, d=2,000,
   n_k=25,000), with and without a step budget, and timed.
4. small   — reduced runs on the card against the same runs on the CPU
   (the plain versions), for both kernels.
5. run_a   — lasso at the LIBSVM epsilon dataset's shape (synthetic
   400,000 x 2,000, ring(16)) through the Gram kernel.
6. run_b   — ridge through its dual mapping at the same shape through the
   residual kernel.
   Both print the history, the launches, ms per round of the round body
   and a profiler breakdown of it (device ms by kernel, idle share).
7. kernels — one line listing every kernel with its launches on the main
   path, error, times and bound.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero. TF32 is off: the JAX reference computes in
full fp32.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside
# the tensor cores, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# kernel vs plain version: max|kernel - plain| <= KERNEL_TOL * max(1, max|plain|)
# (fp32 reassociation of the per-step dot products, accumulated over the
# recurrence)
KERNEL_TOL = 1e-4
# card vs CPU history, reduced runs: rtol, and atol relative to max|primal|
SMALL_RTOL = 1e-4

EPS_SAMPLES, EPS_FEATURES, NODES = 400_000, 2_000, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def budget_vector(torch, k: int, steps: int):
    """Per-node budgets cycling through 0, a partial budget and the full."""
    pattern = [0, steps // 3, steps, steps // 2]
    return torch.tensor([pattern[i % 4] for i in range(k)],
                        dtype=torch.int32, device="cuda")


def check_kernel(torch, name, kernel_fn, plain_fn, args, kw, steps,
                 budgets, cost) -> dict:
    """One kernel config against its plain version: error and times."""
    kw = dict(kw, num_steps=steps, budgets=budgets)
    out = kernel_fn(*args, **kw)
    ref = plain_fn(*args, **kw)  # also the plain version's warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_fn(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not math.isfinite(err) or err > KERNEL_TOL * max(1.0, scale):
        fail(f"{name} disagrees with its plain version: max abs err {err} "
             f"(max |dx| {scale}, tolerance {KERNEL_TOL} * max(1, max|dx|))")
    ms = cuda_ms(torch, lambda: kernel_fn(*args, **kw), reps=3)
    live = (steps if budgets is None
            else int(budgets.clamp(0, steps).sum()) / budgets.numel())
    bound_ms, bound_by = bound(*cost(live))
    row = {"phase": "kernel", "name": name, "steps": steps,
           "budgets": None if budgets is None else budgets.tolist(),
           "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
           "tolerance": KERNEL_TOL * max(1.0, scale), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    return row


def kernel_phase(torch, cd_glm) -> dict:
    """Both kernels against their plain versions at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    k = NODES
    results = {}

    # Gram kernel, lasso prox: K=16, n_k=125 (epsilon features over 16 nodes)
    n_k = EPS_FEATURES // NODES
    a = torch.randn((k, 4_000, n_k), generator=gen, device=dev) / 4_000 ** 0.5
    gram = torch.bmm(a.transpose(1, 2), a)
    x = 0.1 * torch.randn((k, n_k), generator=gen, device=dev)
    atg = 0.1 * torch.randn((k, n_k), generator=gen, device=dev)
    lin = torch.zeros((k, n_k), device=dev)
    mask = torch.ones((k, n_k), device=dev)
    kw = dict(sigma_over_tau=float(k), l1=0.05, l2=0.0, box=10.0)

    def gram_cost(live):
        nbytes = 4 * (k * n_k * n_k + 4 * k * n_k + k) + 4 * k * n_k
        return nbytes, k * live * (2 * n_k + 12)

    rows = []
    for steps in (n_k, 8 * n_k):
        for budgets in (None, budget_vector(torch, k, steps)):
            rows.append(check_kernel(
                torch, "cd_gram", cd_glm.cd_solve_blocks_gram,
                cd_glm.cd_gram_plain, (gram, x, atg, lin, mask), kw, steps,
                budgets, gram_cost))
    results["cd_gram"] = rows
    del a, gram

    # residual kernel, ridge-dual prox: K=16, d=2,000, n_k=25,000 (epsilon
    # samples over 16 nodes; columns are samples scaled 1/sqrt(400,000))
    d, n_k = EPS_FEATURES, EPS_SAMPLES // NODES
    lam = 1e-2
    a_cols = torch.randn((k, n_k, d), generator=gen, device=dev) \
        / EPS_SAMPLES ** 0.5
    x = 0.1 * torch.randn((k, n_k), generator=gen, device=dev)
    grads = torch.randn((k, d), generator=gen, device=dev) / lam * 0.01
    lin = torch.randn((k, n_k), generator=gen, device=dev)
    mask = torch.ones((k, n_k), device=dev)
    kw = dict(sigma_over_tau=k / lam, l1=0.0, l2=1.0, box=math.inf)

    def residual_cost(live):
        nbytes = 4 * (k * n_k * d + 3 * k * n_k + k * d + k) + 4 * k * n_k
        return nbytes, k * (live * 4 * d + 2 * n_k * d)

    rows = []
    for budgets in (None, budget_vector(torch, k, n_k)):
        rows.append(check_kernel(
            torch, "cd_residual", cd_glm.cd_solve_blocks,
            cd_glm.cd_residual_plain, (a_cols, x, grads, lin, mask), kw, n_k,
            budgets, residual_cost))
    results["cd_residual"] = rows
    return results


def small_phase(torch, rt, topo, synthetic) -> None:
    """Reduced runs: the card (kernels) against the CPU (plain versions)."""
    import numpy as np
    cases = (("ridge_primal", 200, 64, "cd_gram"),
             ("ridge_dual", 200, 16, "cd_residual"))
    for name, n_samples, n_features, kernel in cases:
        x, y, _ = synthetic.regression(n_samples, n_features, seed=0)
        hist = {}
        for dev in ("cuda", "cpu"):
            prob = rt.PROBLEMS[name](x, y, 1e-2, device=dev)
            res = rt.run_cola(prob, topo.ring(8), rt.ColaConfig(kappa=2.0),
                              20, record_every=5, device=dev, block_size=8)
            hist[dev] = res.history
        atol = SMALL_RTOL * max(abs(v) for v in hist["cpu"]["primal"])
        worst = 0.0
        for key in ("primal", "dual", "gap", "consensus_violation"):
            a, b = np.asarray(hist["cuda"][key]), np.asarray(hist["cpu"][key])
            if not np.allclose(a, b, rtol=SMALL_RTOL, atol=atol):
                fail(f"small {name}: card and CPU disagree on {key}: "
                     f"{a.tolist()} vs {b.tolist()}")
            worst = max(worst, float(np.max(np.abs(a - b))))
        emit({"phase": "small", "problem": name, "kernel": kernel,
              "max_abs_diff": worst, "rtol": SMALL_RTOL, "atol": atol})


def regression_on_device(torch, n_samples, n_features, *, seed, noise=0.1,
                         sparsity_solution=0.1):
    """The synthetic.regression recipe drawn on the card: normal entries
    scaled 1/sqrt(n_samples), a sparse normal ground truth, normal noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n_samples, n_features), generator=gen, device="cuda")
    x /= math.sqrt(n_samples)
    nnz = max(1, int(sparsity_solution * n_features))
    idx = torch.randperm(n_features, generator=gen, device="cuda")[:nnz]
    w = torch.zeros((n_features,), device="cuda")
    w[idx] = torch.randn((nnz,), generator=gen, device="cuda")
    y = x @ w + noise * torch.randn((n_samples,), generator=gen,
                                    device="cuda")
    return x, y


def round_profile(torch, prob, graph, cfg, rounds: int) -> dict:
    """The round body alone: host-clock ms per round (synchronised), then a
    ``torch.profiler`` window over the same rounds — device ms per round by
    kernel and the device's idle share of the round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import cola, partition, topology
    part = partition.make_partition(prob.n, graph.num_nodes)
    env = cola.build_env(prob, part)
    state = cola.init_state(prob, part)
    body = cola.make_round(prob, part, cfg)
    w = torch.as_tensor(topology.metropolis_weights(graph),
                        dtype=torch.float32, device="cuda")
    active = torch.ones((graph.num_nodes,), device="cuda")
    state = body(state, env, w, active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        state = body(state, env, w, active)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            state = body(state, env, w, active)
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        kernels.append((ev.key[:60], dev_us / rounds / 1e3,
                        ev.count / rounds))
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    return {"ms_per_round": host_ms, "device_ms_per_round": device_ms,
            "device_idle_share": (1.0 - device_ms / host_ms
                                  if device_ms else None),
            "top_kernels": [{"name": n, "ms_per_round": m,
                             "calls_per_round": c} for n, m, c in kernels[:6]]}


def main_run(torch, rt, cd_glm, name, prob, graph, cfg, rounds, *, kernel,
             other, **kw) -> dict:
    """Drive run_cola once with the launch counts zeroed just before and
    read just after; check launches and the history."""
    cd_glm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.run_cola(prob, graph, cfg, rounds, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cd_glm.LAUNCHES)
    h = res.history
    block = kw["block_size"]
    if h["stop_round"] is None:
        executed = rounds
    else:
        executed = min(rounds, -(-(h["stop_round"] + 1) // block) * block)
    if launches[kernel] != executed:
        fail(f"{name}: {kernel} launched {launches[kernel]} times, want one "
             f"per executed round ({executed})")
    if launches[other] != 0:
        fail(f"{name}: {other} launched {launches[other]} times, want 0")
    rows = [[h[key][i] for key in h if isinstance(h[key], list)
             and key != "round"] for i in range(len(h["round"]))]
    if not all(math.isfinite(v) for row in rows for v in row):
        fail(f"{name}: non-finite history row")
    if not h["gap"][-1] < h["gap"][0]:
        fail(f"{name}: gap did not decrease ({h['gap'][0]} -> {h['gap'][-1]})")
    x_fin = bool(torch.isfinite(res.state.x_parts).all()
                 and torch.isfinite(res.state.v_stack).all())
    if not x_fin:
        fail(f"{name}: non-finite final state")
    timing = round_profile(torch, prob, graph, cfg, rounds=3)
    out = {"phase": name, "problem": prob.name, "d": prob.d, "n": prob.n,
           "nodes": graph.num_nodes, "rounds": rounds,
           "stop_round": h["stop_round"], "executed_rounds": executed,
           "launches": launches, "wall_s_incl_setup": wall,
           **timing,
           "columns": [key for key in h if isinstance(h[key], list)
                       and key != "round"],
           "history": {"round": h["round"], "rows": rows}}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card "
              "only", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    import repro_torch as rt
    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, cd_glm

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    nvcc_s = build.build_all()
    ptxas = [ln.strip() for log in build.LAST_BUILD_LOG.values()
             for ln in log.splitlines() if "Used" in ln or "Function" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": nvcc_s, "ptxas": ptxas})

    checks = kernel_phase(torch, cd_glm)
    small_phase(torch, rt, topology, synthetic)

    ring = topology.ring(NODES)
    x, y = regression_on_device(torch, EPS_SAMPLES, EPS_FEATURES, seed=0)
    lasso = rt.PROBLEMS["lasso"](x, y, 0.05, box=10.0, device="cuda")
    run_a = main_run(torch, rt, cd_glm, "run_a", lasso, ring,
                     rt.ColaConfig(kappa=1.0), 20, kernel="cd_gram",
                     other="cd_residual", recorder="gap+certificate",
                     eps=1e-3, record_every=1, executor="block",
                     block_size=8)
    del lasso
    torch.cuda.empty_cache()
    ridge = rt.PROBLEMS["ridge_dual"](x, y, 1e-2, device="cuda")
    run_b = main_run(torch, rt, cd_glm, "run_b", ridge, ring,
                     rt.ColaConfig(kappa=1.0), 5, kernel="cd_residual",
                     other="cd_gram", recorder="gap", record_every=1,
                     executor="block", block_size=8)
    del ridge, x, y
    torch.cuda.empty_cache()

    src = "src/repro_torch/kernels/csrc/cd_glm.cu"
    kernels = []
    for name, replaces, run in (
            ("cd_gram", "src/repro/kernels/cd_glm.py:82", run_a),
            ("cd_residual", "src/repro/kernels/cd_glm.py:49", run_b)):
        main_cfg = checks[name][0]  # kappa * n_k steps, no budget
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "ms": main_cfg["ms"], "plain_ms": main_cfg["plain_ms"],
            "bound_ms": main_cfg["bound_ms"],
            "bound_by": main_cfg["bound_by"], "library_ms": None,
            "steps": main_cfg["steps"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
