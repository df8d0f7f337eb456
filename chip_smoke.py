#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before printing any result. Phases, each printing one JSON
line:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — builds the kernels from ``src/repro_torch/kernels/csrc/``.
3. kernel  — each kernel against its plain PyTorch version on the card, at
   the main path's shapes (Gram: K=16, n_k=125 with G resident in shared
   memory, K=4, n_k=500 and K=2, n_k=1,000 with G streamed; residual:
   K=16, d=2,000, n_k=25,000), with and without a step budget, and timed.
   gram_vs_residual — at K=4, d=400,000, n_k=500 (run_c's shape), the
   Gram path per round (the c = A^T grad product plus the Gram kernel)
   against the residual kernel forced on a_cols: the measurement behind
   ``subproblem.gram_pays``.
4. attn_kernel — the flash kernels against their plain version at the
   serving runs' shapes (Qwen3-4B prefill and decode, a wrapped sliding
   ring, chunked-local, cross; the decode and sliding shapes also as a
   cache and a fresh chunk in separate tensors), bf16 and fp32, timed
   beside SDPA; each row names its route and, at decode, its splits. fp32
   inputs with more than 8 rows take the 3xTF32 tensor-core route.
   split_combine — the split-KV kernel and the combine kernel each against
   its plain version on the same inputs, and timed alone.
5. small   — reduced runs on the card against the same runs on the CPU
   (the plain versions), for both CD kernels and for a lasso with
   n_k=300 (Gram kernel, G streamed); churned lasso runs (nodes leave and
   reset, straggler budgets, the dynamic certificate with eps) through the
   Gram kernel and through the residual kernel; DGD, DIGing and D-ADMM.
6. run_a   — lasso at the LIBSVM epsilon dataset's shape (synthetic
   400,000 x 2,000, ring(16)) through the Gram kernel.
7. run_b   — ridge through its dual mapping at the same shape through the
   residual kernel.
7b. run_c  — lasso at the same shape on ring(4) (n_k=500): cd_mode="auto"
   picks the Gram kernel with G streamed.
   Each prints the history, the launches, ms per round of the round body
   and a profiler breakdown of it (device ms by kernel, idle share).
7c. run_d  — run_a's lasso on Fig. 4's graph (connected_cycle(16, 2)) under
   churn: each node stays with p = 0.8 per round, straggler budgets,
   leavers freeze, the dynamic certificate with eps = 1e-3.
7d. run_e  — run_d with leave_mode="reset"; checks the Lemma-1 invariant
   (consensus_residual) in every row.
   Both print ms per round of the churned rounds (resets included), device
   ms and idle share, and the ms of a round with leavers beside one
   without.
7e. baselines — DGD, DIGing and D-ADMM at the same 400,000 x 2,000 data
   split by rows over ring(16): ms per round, device idle share, bytes
   bound per round.
8. serve_a — Qwen3-4B at full width and depth in bf16 through
   ``launch.serve.serve``: 8 prompts of 1,024 tokens, 32 greedy tokens.
9. serve_b — H2O-Danube3-4B at full width, 4 layers: 2 prompts of 4,608
   tokens (longer than the 4,096-slot ring), 16 tokens.
   Both check the launches of every flash kernel (the tensor-core kernel
   at prefill, split-KV + combine at decode), finite logits and the last
   step against a full forward, and profile the prefill and one decode
   step.
10. serve_small — Qwen3-4B width, 2 layers, fp32: the card against the CPU.
11. total   — the script's seconds so far.
12. kernels — one line listing every kernel with its launches on the main
   path, error, times and bound.

Every kernel time ``ms`` is CUDA events around back-to-back eager calls
after a warm-up, so it includes the host's launch cost where that exceeds
the device time; ``device_ms`` beside it is CUDA events around the same
calls queued behind a sleep kernel, so the host's launch cost is left out
(``device_ms``, the function).

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero. TF32 is off for PyTorch's own products
(cuBLAS, cuDNN): the JAX reference computes in full fp32. The fp32 flash
route issues TF32 products by hand, three per product, and is held to the
fp32 bar.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores, dense bf16 and TF32 tensor-core FLOP/s, at the 700 W power
# limit. A kernel's bound takes the peak of the units that can do its work
# at its accuracy: bf16 attention on the bf16 tensor cores; fp32 attention
# as three TF32 products (3xTF32 meets the fp32 bar, one TF32 product does
# not), so 3x its FLOPs at the TF32 peak; the CD kernels' scalar chains on
# the fp32 CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 494.7e12
# kernel vs plain version: max|kernel - plain| <= KERNEL_TOL * max(1, max|plain|)
# (fp32 reassociation of the per-step dot products and, in the Gram
# kernel, the prox's multiplications by precomputed reciprocals where the
# plain version divides, accumulated over the recurrence)
KERNEL_TOL = 1e-4
# card vs CPU history, reduced runs: rtol, and atol relative to max|primal|
SMALL_RTOL = 1e-4
# serving, bf16: the last decode step's logits against a full forward over
# the same tokens, max|diff| <= FWD_TOL * max|logits|. The two paths round
# differently shaped matrix products (M = batch against M = batch x tokens)
# to bf16 and the differences grow over the layers: measured 1.7 % of
# max|logits| for Qwen3-4B (36 layers) and 0.8 % for Danube3 (4 layers) on
# an H100; 5 % leaves room for that and fails a wrong cache or mask, which
# moves logits by their own size.
FWD_TOL = 0.05

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


def device_ms(torch, fn, reps: int) -> float:
    """Device ms per call: CUDA events around ``reps`` calls queued behind
    a sleep kernel (``torch.cuda._sleep``) that outlasts the host's
    enqueueing, so the card runs them back to back and the host's launch
    cost is left out. ``cuda_ms`` (the ``ms`` of every row) counts it where
    it exceeds the device time, as it does for eager calls of a short
    kernel. ``fn`` must not synchronise with the host. Unlike
    ``torch.profiler`` (``device_profile``), which has dropped kernels of
    some calls inside this script, it cannot miss a kernel;
    ``round_profile`` reports the two side by side."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = 2.0 + 4.0 * reps * host_ms
    for _ in range(6):
        # cycles for sleep_ms at 2 GHz: the H100's SM clock is at most
        # 1.98 GHz, so the sleep lasts at least sleep_ms
        torch.cuda._sleep(int(sleep_ms * 2e6))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()   # still sleeping once all are queued
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        sleep_ms *= 4
    fail("device_ms: could not queue the calls behind the sleep kernel")


def bound(nbytes: float, flops: float,
          peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def budget_vector(torch, k: int, steps: int):
    """Per-node budgets cycling through 0, a partial budget and the full."""
    pattern = [0, steps // 3, steps, steps // 2]
    return torch.tensor([pattern[i % 4] for i in range(k)],
                        dtype=torch.int32, device="cuda")


def check_kernel(torch, name, kernel_fn, plain_fn, args, kw, steps,
                 budgets, cost, extra=None) -> dict:
    """One kernel config against its plain version: error, times (events
    and device) and bound; ``extra`` keys go into the row."""
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
    # short kernels: 20 queued calls, so that the gaps between launches
    # weigh little
    dev_ms = device_ms(torch, lambda: kernel_fn(*args, **kw),
                       reps=20 if ms < 1.0 else 3)
    live = (steps if budgets is None
            else int(budgets.clamp(0, steps).sum()) / budgets.numel())
    bound_ms, bound_by = bound(*cost(live))
    row = {"phase": "kernel", "name": name, **(extra or {}), "steps": steps,
           "budgets": None if budgets is None else budgets.tolist(),
           "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
           "tolerance": KERNEL_TOL * max(1.0, scale), "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(row)
    return row


def kernel_phase(torch, cd_glm) -> dict:
    """Both kernels against their plain versions at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    k = NODES
    results = {}

    # Gram kernel, lasso prox: K=16, n_k=125 (epsilon features over 16
    # nodes; G resident), K=4, n_k=500 (over 4 nodes, run_c) and K=2,
    # n_k=1,000 (G streamed through the ring)
    kw = dict(l1=0.05, l2=0.0, box=10.0)
    rows = []
    for kg, n_k, step_counts in ((k, EPS_FEATURES // k, (125, 1000)),
                                 (4, 500, (500,)), (2, 1000, (1000,))):
        a = torch.randn((kg, 4_000, n_k), generator=gen, device=dev) \
            / 4_000 ** 0.5
        gram = torch.bmm(a.transpose(1, 2), a)
        x = 0.1 * torch.randn((kg, n_k), generator=gen, device=dev)
        atg = 0.1 * torch.randn((kg, n_k), generator=gen, device=dev)
        lin = torch.zeros((kg, n_k), device=dev)
        mask = torch.ones((kg, n_k), device=dev)
        layout = "resident" if cd_glm.gram_fits_smem(n_k) else "streamed"
        # the main path's call: G's column layout built once (the env's)
        gram_cols = cd_glm.gram_columns(gram)
        kernel_fn = lambda *a, gram_cols=gram_cols, **kw_: \
            cd_glm.cd_solve_blocks_gram(*a, gram_cols=gram_cols, **kw_)

        def gram_cost(live, kg=kg, n_k=n_k):
            nbytes = 4 * (kg * n_k * n_k + 4 * kg * n_k + kg) + 4 * kg * n_k
            return nbytes, kg * live * (2 * n_k + 12)

        for steps in step_counts:
            for budgets in (None, budget_vector(torch, kg, steps)):
                rows.append(check_kernel(
                    torch, "cd_gram", kernel_fn,
                    cd_glm.cd_gram_plain, (gram, x, atg, lin, mask),
                    dict(kw, sigma_over_tau=float(kg)), steps, budgets,
                    gram_cost, {"K": kg, "n_k": n_k, "layout": layout}))
        del a, gram, gram_cols
    results["cd_gram"] = rows

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
    args = (a_cols, x, grads, lin, mask)
    for budgets in (None, budget_vector(torch, k, n_k)):
        rows.append(check_kernel(
            torch, "cd_residual", cd_glm.cd_solve_blocks,
            cd_glm.cd_residual_plain, args, kw, n_k, budgets, residual_cost))
    results["cd_residual"] = rows
    # the block size, chosen by measurement: each thread count against the
    # default's output (itself held against the plain version above)
    main_kw = dict(kw, num_steps=n_k, budgets=None)
    base = cd_glm.cd_solve_blocks(*args, **main_kw)
    sweep = []
    for threads in (64, 128, 256):
        run = lambda: cd_glm._residual_launch(*args, threads, **main_kw)
        err = float((run() - base).abs().max())
        if not err <= KERNEL_TOL * max(1.0, float(base.abs().max())):
            fail(f"cd_residual at {threads} threads disagrees with the "
                 f"default: max abs err {err}")
        sweep.append({"threads": threads, "ms": cuda_ms(torch, run, reps=3),
                      "layout": cd_glm.residual_layout(d, threads),
                      "max_abs_err_vs_default": err})
    emit({"phase": "kernel", "name": "cd_residual_threads",
          "default_threads": cd_glm.RESIDUAL_THREADS, "steps": n_k,
          "sweep": sweep})
    return results


def gram_vs_residual_phase(torch, cd_glm, subproblem) -> dict:
    """run_c's local solve both ways at K=4, d=400,000, n_k=500: the Gram
    path per round (c = A^T grad, then the Gram kernel on G's columns)
    against the residual kernel forced on a_cols (a second copy of A).
    Both give the same dx up to fp32 rounding; the row says which is
    faster and what ``gram_pays`` picks there."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    k, d, n_k = 4, EPS_SAMPLES, EPS_FEATURES // 4
    a = torch.randn((k, d, n_k), generator=gen, device="cuda") / d ** 0.5
    a_cols = subproblem.block_cols(a)
    gram = subproblem.block_gram(a)
    gram_cols = cd_glm.gram_columns(gram)
    grads = torch.randn((k, d), generator=gen, device="cuda")
    x = 0.1 * torch.randn((k, n_k), generator=gen, device="cuda")
    lin = torch.zeros((k, n_k), device="cuda")
    mask = torch.ones((k, n_k), device="cuda")
    kw = dict(num_steps=n_k, sigma_over_tau=float(k), l1=0.05, l2=0.0,
              box=10.0)
    atg_fn = lambda: torch.bmm(grads.unsqueeze(1), a).squeeze(1)
    atg = atg_fn()
    gram_fn = lambda: cd_glm.cd_solve_blocks_gram(
        gram, x, atg_fn(), lin, mask, gram_cols=gram_cols, **kw)
    kernel_fn = lambda: cd_glm.cd_solve_blocks_gram(
        gram, x, atg, lin, mask, gram_cols=gram_cols, **kw)
    res_fn = lambda: cd_glm.cd_solve_blocks(a_cols, x, grads, lin, mask,
                                            **kw)
    dx_g, dx_r = gram_fn(), res_fn()
    torch.cuda.synchronize()
    diff = float((dx_g - dx_r).abs().max())
    scale = float(dx_r.abs().max())
    if not diff <= KERNEL_TOL * max(1.0, scale):
        fail(f"gram_vs_residual: the two formulations disagree: max abs "
             f"diff {diff} (max |dx| {scale})")
    row = {"phase": "gram_vs_residual", "K": k, "d": d, "n_k": n_k,
           "steps": n_k, "gram_pays": subproblem.gram_pays(d, n_k),
           "gram_layout": ("resident" if cd_glm.gram_fits_smem(n_k)
                           else "streamed"),
           "residual_layout": cd_glm.residual_layout(d),
           "max_abs_diff": diff, "max_abs_dx": scale}
    for name, fn in (("gram_path", gram_fn), ("atg", atg_fn),
                     ("gram_kernel", kernel_fn), ("residual_kernel", res_fn)):
        row[f"{name}_ms"] = cuda_ms(torch, fn, reps=3)
        row[f"{name}_device_ms"] = device_ms(
            torch, fn, reps=20 if row[f"{name}_ms"] < 10.0 else 3)
    row["faster"] = ("gram" if row["gram_path_ms"] < row["residual_kernel_ms"]
                     else "residual")
    emit(row)
    del a, a_cols, gram, gram_cols, grads
    torch.cuda.empty_cache()
    return row


def small_phase(torch, rt, topo, synthetic, cd_glm) -> None:
    """Reduced runs: the card (kernels) against the CPU (plain versions)."""
    import numpy as np
    # (problem, samples, features, kernel, nodes, lambda): ridge_primal has
    # n_k = 8 (G resident), ridge_dual n_k = 25 > d (residual), lasso
    # n_k = 300 (G streamed)
    cases = (("ridge_primal", 200, 64, "cd_gram", 8, 1e-2),
             ("ridge_dual", 200, 16, "cd_residual", 8, 1e-2),
             ("lasso", 400, 600, "cd_gram", 2, 5e-2))
    for name, n_samples, n_features, kernel, nodes, lam in cases:
        x, y, _ = synthetic.regression(n_samples, n_features, seed=0)
        hist = {}
        for dev in ("cuda", "cpu"):
            prob = rt.PROBLEMS[name](x, y, lam, device=dev)
            cd_glm.reset_launches()
            res = rt.run_cola(prob, topo.ring(nodes), rt.ColaConfig(kappa=2.0),
                              20, record_every=5, device=dev, block_size=8)
            if dev == "cuda" and not cd_glm.LAUNCHES[kernel] > 0:
                fail(f"small {name}: {kernel} was not launched "
                     f"({cd_glm.LAUNCHES})")
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
              "n_k": -(-n_features // nodes) if name != "ridge_dual"
              else -(-n_samples // nodes),
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
    """The round body alone: host-clock ms per round (synchronised), device
    ms per round (``device_ms``: rounds queued behind a sleep kernel) and
    the device's idle share of the round, then a ``torch.profiler`` window
    over the same rounds for device ms by kernel; ``profiler_coverage`` is
    the profiler's device total over the queued one."""
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

    def one():
        nonlocal state
        state = body(state, env, w, active)

    dev_ms = device_ms(torch, one, rounds)

    def window():
        for _ in range(rounds):
            one()

    prof = device_profile(torch, window, host_ms * rounds, top=6)
    return {"ms_per_round": host_ms,
            "device_ms_per_round": dev_ms,
            "device_idle_share": 1.0 - dev_ms / host_ms,
            "profiler_device_ms_per_round": prof["device_ms"] / rounds,
            "profiler_coverage": prof["device_ms"] / rounds / dev_ms,
            "top_kernels": [{"name": r["name"],
                             "ms_per_round": r["ms"] / rounds,
                             "calls_per_round": r["calls"] / rounds}
                            for r in prof["top_kernels"]]}


def device_profile(torch, fn, host_ms: float, top: int = 8) -> dict:
    """``fn`` once under ``torch.profiler``: device ms by kernel (summed
    over the window), and the device's idle share of ``host_ms`` (the
    window's synchronised host-clock time, measured outside the
    profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        kernels.append((ev.key[:60], dev_us / 1e3, ev.count))
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    cat_calls = sum(c for n, _, c in kernels if "CatArray" in n)
    cat_ms = sum(m for n, m, _ in kernels if "CatArray" in n)
    flash = {}
    for n, ms, c in kernels:
        for kernel in ("flash_mma", "flash_split", "flash_combine",
                       "flash_tf32"):
            if kernel in n:
                ms0, c0 = flash.get(kernel, (0.0, 0))
                flash[kernel] = (ms0 + ms, c0 + c)
    return {"host_ms": host_ms, "device_ms": device_ms,
            "cat_kernel_calls": cat_calls, "cat_kernel_ms": cat_ms,
            "flash_device_ms": {k: {"ms": v[0], "calls": v[1]}
                                for k, v in flash.items()},
            "device_idle_share": (1.0 - device_ms / host_ms
                                  if device_ms and host_ms else None),
            "top_kernels": [{"name": n, "ms": m, "calls": c}
                            for n, m, c in kernels[:top]]}


def main_run(torch, rt, cd_glm, name, prob, graph, cfg, rounds, *, kernel,
             other, profile=None, check_gap=True, **kw) -> dict:
    """Drive run_cola once with the launch counts zeroed just before and
    read just after; check launches and the history (the gap must fall
    unless ``check_gap`` is off). ``profile()`` gives the timing keys
    (default: ``round_profile`` of the static round body)."""
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
    if check_gap and not h["gap"][-1] < h["gap"][0]:
        fail(f"{name}: gap did not decrease ({h['gap'][0]} -> {h['gap'][-1]})")
    x_fin = bool(torch.isfinite(res.state.x_parts).all()
                 and torch.isfinite(res.state.v_stack).all())
    if not x_fin:
        fail(f"{name}: non-finite final state")
    timing = (profile() if profile is not None
              else round_profile(torch, prob, graph, cfg, rounds=3))
    out = {"phase": name, "problem": prob.name, "d": prob.d, "n": prob.n,
           "nodes": graph.num_nodes, "rounds": rounds,
           "stop_round": h["stop_round"], "executed_rounds": executed,
           "launches": launches, "wall_s_incl_setup": wall,
           **timing,
           "columns": [key for key in h if isinstance(h[key], list)
                       and key != "round"],
           "history": {"round": h["round"], "rows": rows}}
    emit(out)
    out["raw_history"] = h
    return out


# ---------------------------------------------------------------------------
# elasticity (node churn, resets, straggler budgets) and the baselines
# ---------------------------------------------------------------------------

def stay_masks(rounds: int, k: int, p_stay: float, seed: int = 0):
    """(T, K) bool: node k takes part in round t with probability p_stay,
    one ``rng.random(k)`` draw per round (the recipe of
    ``benchmarks/fig4_fault.py``'s ``_stay_masks``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(k) < p_stay for _ in range(rounds)])


def straggler_budgets(rounds: int, k: int, full: int, seed: int = 1):
    """(T, K) int32: each round each node straggles at a quarter of the CD
    budget with probability 1/2 (the recipe of ``fig4_fault``'s
    ``_straggler_budgets``). Seed 1: with the stay masks' seed 0 the same
    draws would make every straggler an active node."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = np.full((rounds, k), full, np.int32)
    for t in range(rounds):
        out[t, rng.random(k) < 0.5] = max(full // 4, 1)
    return out


def churn_schedule(graph, active, budgets, leave_mode: str) -> dict:
    """The port's own materialized schedule for these (T, K) arrays, as
    ``run_cola`` builds it."""
    import numpy as np
    from repro_torch.core import cola, topology
    rounds, k = active.shape
    return cola._materialize_schedule(
        graph, rounds, cola._as_schedule_fn(active, rounds, k, "active"),
        cola._as_schedule_fn(budgets, rounds, k, "budgets"), leave_mode, 0,
        topology.metropolis_weights(graph), np.float32)


def compare_histories(name, hist, keys, scale_key=None) -> dict:
    """Card against CPU: the same recorded rounds and stop round, each
    column within rtol ``SMALL_RTOL`` and atol ``SMALL_RTOL`` * max |value|
    of the CPU's ``scale_key`` column (default: of the column itself)."""
    import numpy as np
    if (hist["cuda"]["round"] != hist["cpu"]["round"]
            or hist["cuda"]["stop_round"] != hist["cpu"]["stop_round"]):
        fail(f"{name}: card and CPU record other rounds or stop elsewhere: "
             f"{hist['cuda']['round']} / {hist['cuda']['stop_round']} vs "
             f"{hist['cpu']['round']} / {hist['cpu']['stop_round']}")
    worst = {}
    for key in keys:
        a, b = np.asarray(hist["cuda"][key]), np.asarray(hist["cpu"][key])
        ref = np.asarray(hist["cpu"][scale_key or key])
        atol = SMALL_RTOL * max(float(np.max(np.abs(ref))), 1e-30)
        if not np.allclose(a, b, rtol=SMALL_RTOL, atol=atol):
            fail(f"{name}: card and CPU disagree on {key}: {a.tolist()} vs "
                 f"{b.tolist()}")
        worst[key] = float(np.max(np.abs(a - b)))
    return worst


def small_churn_phase(torch, rt, topo, synthetic, cd_glm) -> None:
    """Churned lasso runs, the card against the CPU: nodes stay with
    p = 0.8, leavers reset, straggler budgets, gap+certificate with eps
    (the dynamic certificate); once through each CD kernel."""
    rounds = 20
    # (kernel, samples, features, nodes): n_k = 8 < d (Gram kernel),
    # n_k = 50 > d = 40 (residual kernel)
    for kernel, n_samples, n_features, nodes in (
            ("cd_gram", 200, 64, 8), ("cd_residual", 40, 200, 4)):
        x, y, _ = synthetic.regression(n_samples, n_features, seed=0,
                                       sparsity_solution=0.2)
        n_k = -(-n_features // nodes)
        active = stay_masks(rounds, nodes, 0.8)
        budgets = straggler_budgets(rounds, nodes, 2 * n_k)
        hist, launches = {}, {}
        for dev in ("cuda", "cpu"):
            prob = rt.PROBLEMS["lasso"](x, y, 5e-2, box=5.0, device=dev)
            cd_glm.reset_launches()
            res = rt.run_cola(prob, topo.ring(nodes), rt.ColaConfig(kappa=2.0),
                              rounds, record_every=5,
                              recorder="gap+certificate", eps=0.2,
                              active_schedule=active, budget_schedule=budgets,
                              leave_mode="reset", device=dev, block_size=8)
            launches[dev] = dict(cd_glm.LAUNCHES)
            hist[dev] = res.history
        if launches["cuda"][kernel] != rounds or launches["cpu"][kernel]:
            fail(f"small churn {kernel}: launches {launches}, want {rounds} "
                 "on the card and none on the CPU")
        sched = churn_schedule(topo.ring(nodes), active, budgets, "reset")
        # as the runs above: atol relative to max |primal|
        worst = compare_histories(
            f"small churn {kernel}", hist,
            ("primal", "dual", "gap", "consensus_violation"),
            scale_key="primal")
        resid = max(hist["cuda"]["consensus_residual"])
        if not resid <= 1e-2:   # CertificateRecorder.cons_tol
            fail(f"small churn {kernel}: the reset broke the Lemma-1 "
                 f"invariant on the card (consensus_residual {resid})")
        emit({"phase": "small", "problem": "lasso", "churn": True,
              "kernel": kernel, "n_k": n_k, "nodes": nodes, "p_stay": 0.8,
              "leave_mode": "reset", "recorder": "gap+certificate",
              "eps": 0.2, "reset_rounds": int(sched["reset_any"].sum()),
              "stop_round": hist["cuda"]["stop_round"],
              "launches": launches["cuda"], "max_abs_diff": worst,
              "max_consensus_residual": resid, "rtol": SMALL_RTOL,
              "atol": "rtol * max|primal|"})


def smooth_lipschitz(torch, x, lam: float, iters: int = 30) -> float:
    """L = ||X||_2^2 + lam, the Lipschitz constant of the gradient of the
    ridge objective's smooth part sum_k F_k (power iteration on X^T X)."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    v = torch.randn((x.shape[1],), generator=gen, device=x.device)
    for _ in range(iters):
        v = x.T @ (x @ v)
        v = v / torch.linalg.vector_norm(v)
    return float(torch.linalg.vector_norm(x @ v) ** 2) + lam


def small_baselines_phase(torch, bl, topo, synthetic) -> None:
    """DGD, DIGing and D-ADMM at a reduced size, the card against the CPU
    (the same numpy data; step 1/L)."""
    x, y, _ = synthetic.regression(800, 64, seed=5)
    lam = 1e-2
    step = 1.0 / smooth_lipschitz(torch, torch.as_tensor(x), lam)
    graph = topo.ring(8)
    runs = (("dgd", bl.run_dgd, dict(step=step)),
            ("diging", bl.run_diging, dict(step=step)),
            ("dadmm", bl.run_dadmm, dict(rho=1.0, inner_steps=10)))
    for name, run, kw in runs:
        hist, w_stack = {}, {}
        for dev in ("cuda", "cpu"):
            prob = bl.make_consensus_problem(x, y, 8, loss="square",
                                             reg="l2", lam=lam, device=dev)
            res = run(prob, graph, rounds=30, record_every=5, device=dev,
                      block_size=8, **kw)
            hist[dev], w_stack[dev] = res.history, res.w_stack.cpu()
        worst = compare_histories(f"small {name}", hist,
                                  ("objective", "consensus"))
        w_err = float((w_stack["cuda"] - w_stack["cpu"]).abs().max())
        w_scale = float(w_stack["cpu"].abs().max())
        if not w_err <= SMALL_RTOL * max(w_scale, 1e-30):
            fail(f"small {name}: card and CPU iterates disagree: max abs "
                 f"diff {w_err} (max |w| {w_scale})")
        emit({"phase": "small", "baseline": name, "nodes": 8,
              "rows_per_node": 100, "d": 64, **kw,
              "max_abs_diff": {**worst, "w_stack": w_err},
              "rtol": SMALL_RTOL, "atol": "rtol * max|column|"})


def timed_rounds(torch, one, rounds: int) -> dict:
    """``rounds`` calls of ``one`` (one round each): host-clock ms per
    round around synchronised rounds, device ms per round (``device_ms``)
    and the device's idle share of the round."""
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / rounds
    dev_ms = device_ms(torch, one, rounds)
    return {"ms_per_round": host_ms, "device_ms_per_round": dev_ms,
            "device_idle_share": 1.0 - dev_ms / host_ms}


def churn_profile(torch, prob, graph, cfg, sched) -> dict:
    """The churned rounds as the drivers run them (the leaver reset, then
    the round body with the round's W_t, active mask and budgets), cycling
    through ``sched``: ``timed_rounds`` over all of them, each round alone
    (synchronised) split by whether it reset leavers, and the device ms of
    the reset and of the body alone."""
    from repro_torch.core import cola, partition
    part = partition.make_partition(prob.n, graph.num_nodes)
    env = cola.build_env(prob, part)
    body = cola.make_round(prob, part, cfg)
    rounds = sched["w"].shape[0]
    on_card = lambda key: [torch.as_tensor(a, device="cuda")
                           for a in sched[key]]
    w, active = on_card("w"), on_card("active")
    budgets = on_card("budgets") if "budgets" in sched else [None] * rounds
    reset_any = sched.get("reset_any", [False] * rounds)
    leavers = on_card("leavers") if "leavers" in sched else None
    state = cola.init_state(prob, part)
    t_next = 0

    def one():
        nonlocal state, t_next
        t = t_next % rounds
        if reset_any[t]:
            state = cola._reset_leavers(state, env, leavers[t])
        state = body(state, env, w[t], active[t], budgets[t])
        t_next += 1

    out = timed_rounds(torch, one, rounds)
    by_kind = {True: [], False: []}
    for _ in range(rounds):
        reset = bool(reset_any[t_next % rounds])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        by_kind[reset].append((time.perf_counter() - t0) * 1e3)
    # a round without leavers runs the body alone: time it on its own too,
    # since few rounds of a p = 0.8 schedule over 16 nodes lack a leaver
    body_alone = lambda: body(state, env, w[0], active[0], budgets[0])
    body_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        body_alone()
        torch.cuda.synchronize()
        body_ms.append((time.perf_counter() - t0) * 1e3)
    mean = lambda v: sum(v) / len(v) if v else None
    out.update(
        ms_round_with_reset=mean(by_kind[True]),
        ms_round_without_reset=mean(by_kind[False]),
        rounds_with_reset=len(by_kind[True]),
        rounds_without_reset=len(by_kind[False]),
        ms_body_alone=mean(body_ms),
        body_device_ms=device_ms(torch, body_alone, 5))
    if leavers is not None:
        t_reset = next(t for t in range(rounds) if reset_any[t])
        out["reset_device_ms"] = device_ms(
            torch, lambda: cola._reset_leavers(state, env, leavers[t_reset]),
            5)
    del env
    return out


def churn_run(torch, rt, cd_glm, name, prob, *, leave_mode: str,
              rounds: int = 20) -> dict:
    """run_a's lasso on connected_cycle(16, 2) under churn (p_stay 0.8,
    straggler budgets), the dynamic certificate with eps = 1e-3, block 8:
    the Gram kernel once per executed round, no residual launch, finite
    rows and at least one round with a node dropped (and, under reset, at
    least one reset)."""
    from repro_torch.core import topology
    graph = topology.connected_cycle(NODES, 2)
    cfg = rt.ColaConfig(kappa=1.0)
    active = stay_masks(rounds, NODES, 0.8, seed=0)
    budgets = straggler_budgets(rounds, NODES, EPS_FEATURES // NODES)
    sched = churn_schedule(graph, active, budgets, leave_mode)
    dropped = int((sched["active"] < 1).any(axis=1).sum())
    resets = int(sched["reset_any"].sum()) if "reset_any" in sched else 0
    if not dropped > 0:
        fail(f"{name}: no round dropped a node")
    if leave_mode == "reset" and not resets > 0:
        fail(f"{name}: no round reset a leaver")
    run = main_run(torch, rt, cd_glm, name, prob, graph, cfg, rounds,
                   kernel="cd_gram", other="cd_residual",
                   profile=lambda: churn_profile(torch, prob, graph, cfg,
                                                 sched),
                   check_gap=leave_mode == "freeze",
                   recorder="gap+certificate", eps=1e-3, record_every=1,
                   executor="block", block_size=8, active_schedule=active,
                   budget_schedule=budgets, leave_mode=leave_mode)
    h = run["raw_history"]
    cons_tol = 1e-2   # CertificateRecorder.cons_tol
    if leave_mode == "reset" and not max(h["consensus_residual"]) <= cons_tol:
        fail(f"{name}: the reset broke the Lemma-1 invariant: "
             f"consensus_residual up to {max(h['consensus_residual'])} "
             f"> {cons_tol}")
    row = {"phase": name + "_churn", "graph": graph.name, "p_stay": 0.8,
           "leave_mode": leave_mode, "rounds_with_a_dropped_node": dropped,
           "reset_rounds": resets, "straggler_budget": max(
               EPS_FEATURES // NODES // 4, 1),
           "max_consensus_residual": max(h["consensus_residual"])}
    emit(row)
    return run


def baselines_phase(torch, bl, topology, x, y) -> dict:
    """DGD, DIGing and D-ADMM (inner_steps 10) on the 400,000 x 2,000 data
    split by rows over ring(16), ridge (square loss, l2, lam = 1e-4), 20
    rounds each: the objective must fall and every row be finite. Step
    1/L with L = ||X||_2^2 + lam (``smooth_lipschitz``); D-ADMM rho = 1
    and the reference's inner step rule. The bytes bound counts the reads
    of X a round needs: two per gradient (X_k w, then X_k^T r), one
    gradient for DGD and DIGing, ``inner_steps`` for D-ADMM."""
    lam, rounds, inner = 1e-4, 20, 10
    prob = bl.make_consensus_problem(x, y, NODES, loss="square", reg="l2",
                                     lam=lam, device="cuda")
    if prob.x_parts.data_ptr() != x.data_ptr():
        fail("baselines: the row blocks are not a view of the data")
    step = 1.0 / smooth_lipschitz(torch, x, lam)
    graph = topology.ring(NODES)
    x_bytes = x.numel() * x.element_size()
    out = {}
    for name, run, make, kw, reads in (
            ("dgd", bl.run_dgd, bl.dgd_round, dict(step=step), 2),
            ("diging", bl.run_diging, bl.diging_round, dict(step=step), 2),
            ("dadmm", bl.run_dadmm, bl.dadmm_round,
             dict(rho=1.0, inner_steps=inner), 2 * inner)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(prob, graph, rounds=rounds, record_every=1, device="cuda",
                  block_size=8, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = res.history
        rows = list(zip(h["objective"], h["consensus"]))
        if not all(math.isfinite(v) for r in rows for v in r) or not bool(
                torch.isfinite(res.w_stack).all()):
            fail(f"baselines {name}: non-finite rows or iterates")
        if not h["objective"][-1] < h["objective"][0]:
            fail(f"baselines {name}: objective did not decrease "
                 f"({h['objective'][0]} -> {h['objective'][-1]})")
        round_fn, carry = make(prob, graph, **kw)

        def one():
            nonlocal carry
            carry = round_fn(carry)

        timing = timed_rounds(torch, one, 5)
        bound_ms = reads * x_bytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"phase": "baselines", "method": name, "nodes": NODES,
                     "rows_per_node": x.shape[0] // NODES, "d": x.shape[1],
                     "loss": "square", "reg": "l2", "lam": lam,
                     **{k: v for k, v in kw.items()}, "rounds": rounds,
                     "wall_s_incl_setup": wall, **timing,
                     "reads_of_x_per_round": reads,
                     "bytes_bound_ms_per_round": bound_ms,
                     "bound_share": bound_ms / timing["device_ms_per_round"],
                     "objective_first_last": [h["objective"][0],
                                              h["objective"][-1]],
                     "consensus_last": h["consensus"][-1]}
        emit(out[name])
        del carry
    del prob
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# flash attention and the LM zoo's serving path
# ---------------------------------------------------------------------------

def attn_within_tolerance(torch, out, ref) -> tuple[bool, float]:
    """fp32: |out - plain| <= 2e-5 + 2e-5 |plain| (the bar of
    tests/test_kernels.py). bf16: <= 2 bf16 ulps of |plain| + 1e-6 — both
    compute in fp32 and round once to bf16. Returns (ok, worst excess)."""
    o, r = out.float(), ref.float()
    if ref.dtype == torch.float32:
        limit = 2e-5 + 2e-5 * r.abs()
    else:
        _, e = torch.frexp(r)
        limit = 2 * torch.ldexp(torch.ones_like(r), e - 8) + 1e-6
    excess = float(((o - r).abs() - limit).max())
    return excess <= 0.0, excess


def attn_cases(torch):
    """The serving runs' attention shapes: (name, B, H, KV, hd, mode,
    window, q_pos, kv_pos, cut), positions as CPU int32 tensors. ``cut``:
    the keys are two sources, slots [0, cut) a cache and [cut, Skv) the
    fresh chunk, as ``attn_apply`` passes them (None: one source)."""
    def rows(b, pos):
        return torch.tensor(pos, dtype=torch.int32).repeat(b, 1)

    cases = []
    # Qwen3-4B prefill: empty cache of 1,056 slots ++ 1,024 fresh keys
    cases.append(("prefill", 8, 32, 8, 128, "causal", 0,
                  rows(8, range(1024)),
                  rows(8, [-1] * 1056 + list(range(1024))), None))
    # Qwen3-4B, the last decode step: 1,054 cached keys, 2 empty slots,
    # the fresh key at 1,054; once as one source, once as cache ++ fresh
    decode_kv = rows(8, list(range(1054)) + [-1, -1, 1054])
    cases.append(("decode", 8, 32, 8, 128, "causal", 0, rows(8, [1054]),
                  decode_kv, None))
    cases.append(("decode_2src", 8, 32, 8, 128, "causal", 0,
                  rows(8, [1054]), decode_kv, 1056))
    # H2O-Danube3-4B: a 256-token chunk at 4,600 against a wrapped ring of
    # 4,096 slots (slot j holds the last position = j mod 4,096 before
    # 4,600); in batch row 1 the first 512 slots are empty
    ring = [4599 - ((4599 - j) % 4096) for j in range(4096)]
    fresh = list(range(4600, 4856))
    kv = rows(2, ring + fresh)
    kv[1, :512] = -1
    cases.append(("sliding", 2, 32, 8, 120, "sliding", 4096,
                  rows(2, fresh), kv, None))
    cases.append(("sliding_2src", 2, 32, 8, 120, "sliding", 4096,
                  rows(2, fresh), kv, 4096))
    # Danube3's decode: one token at 4,856 against the ring ++ itself
    ring_d = [4855 - ((4855 - j) % 4096) for j in range(4096)]
    cases.append(("decode_sliding_2src", 2, 32, 8, 120, "sliding", 4096,
                  rows(2, [4856]), rows(2, ring_d + [4856]), 4096))
    # Llama-4-style chunked-local (window 8,192, G = 5): queries 7,900 ..
    # 8,411 straddle a chunk boundary
    cases.append(("chunked_local", 2, 40, 8, 128, "chunked_local", 8192,
                  rows(2, range(7900, 8412)),
                  rows(2, list(range(6876, 7900)) + list(range(7900, 8412))),
                  None))
    # SeamlessM4T-style cross attention (16 / 16 heads, hd 64) over 1,500
    # encoder slots, the last 100 of batch row 1 padding
    kv = rows(4, range(1500))
    kv[1, 1400:] = -1
    cases.append(("cross", 4, 16, 16, 64, "cross", 0,
                  torch.zeros((4, 256), dtype=torch.int32), kv, None))
    return cases


def attn_bound(torch, q, skv, kvh, pairs, n_pos) -> tuple[float, str]:
    """Least time for one attention call: q, k, v read once, out written
    once, positions read once; 4 hd FLOPs per admissible (query head, key)
    pair at the bf16 tensor-core peak for bf16, and three times as many at
    the TF32 peak for fp32 (3xTF32 is the cheapest product that meets the
    fp32 bar). Returns (ms, bound_by, ms on the fp32 CUDA-core peak)."""
    b, sq, h, hd = q.shape
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * b * skv * kvh * hd) + 4 * n_pos
    flops = 4 * hd * pairs * h
    fp32_ms = bound(nbytes, flops, FP32_FLOPS)[0]
    if q.dtype == torch.bfloat16:
        return (*bound(nbytes, flops, BF16_TC_FLOPS), fp32_ms)
    return (*bound(nbytes, 3 * flops, TF32_TC_FLOPS), fp32_ms)


def attn_kernel_phase(torch, fa, mask_fn) -> list:
    """The flash kernels against their plain version on the card at the
    serving runs' shapes, in bf16 and fp32; times of the kernels, the plain
    version and SDPA (the library yardstick, never called by the port)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for (name, b, h, kvh, hd, mode, window, q_pos, kv_pos,
         cut) in attn_cases(torch):
        q_pos, kv_pos = q_pos.cuda(), kv_pos.cuda()
        sq, skv = q_pos.shape[1], kv_pos.shape[1]
        mask = mask_fn(mode, q_pos, kv_pos, window)          # (B, Sq, Skv)
        if not bool(mask.any(dim=-1).all()):
            fail(f"attn_kernel {name}: a query row has no admissible key")
        pairs = int(mask.sum())                 # (b, query, key) admissible
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, sq, h, hd), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((b, skv, kvh, hd), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((b, skv, kvh, hd), generator=gen, device="cuda"
                            ).to(dtype)
            kw = dict(mode=mode, window=window)
            if cut is None:
                args, src = (q, k, v, q_pos, kv_pos), {}
            else:   # separate tensors, as the cache and the fresh chunk are
                args = (q, k[:, :cut].contiguous(), v[:, :cut].contiguous(),
                        q_pos, kv_pos[:, :cut].contiguous())
                src = dict(k2=k[:, cut:].contiguous(),
                           v2=v[:, cut:].contiguous(),
                           kv_pos2=kv_pos[:, cut:].contiguous())
            route = fa.select_route(dtype, sq, h // kvh)
            splits = (fa.default_splits(b, kvh, skv) if route == "split"
                      else None)
            before = dict(fa.LAUNCHES)
            out = fa.flash_attention(*args, **kw, **src)
            launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES
                        if fa.LAUNCHES[n] != before[n]}
            ref = fa.flash_attention_plain(q, k, v, q_pos, kv_pos, **kw)
            torch.cuda.synchronize()
            ok, excess = attn_within_tolerance(torch, out, ref)
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            if not ok or not math.isfinite(err):
                fail(f"attn_kernel {name} {dtype}: kernel disagrees with its "
                     f"plain version (max abs err {err}, worst excess over "
                     f"the tolerance {excess})")
            reps = 20 if sq == 1 else 5
            call = lambda: fa.flash_attention(*args, **kw, **src)
            ms = cuda_ms(torch, call, reps)
            dev_ms = device_ms(torch, call, reps)
            plain_ms = cuda_ms(torch,
                               lambda: fa.flash_attention_plain(
                                   *args, **kw, **src), reps)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            m4 = mask[:, None]
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m4, enable_gqa=True)
            lib_err = float((lib().transpose(1, 2).float()
                             - ref.float()).abs().max())
            library_ms = cuda_ms(torch, lib, reps)
            library_device_ms = device_ms(torch, lib, reps)
            bound_ms, bound_by, fp32_bound_ms = attn_bound(
                torch, q, skv, kvh, pairs, q_pos.numel() + kv_pos.numel())
            row = {"phase": "attn_kernel", "case": name,
                   "dtype": str(dtype).replace("torch.", ""),
                   "B": b, "Sq": sq, "Skv": skv, "H": h, "KV": kvh, "hd": hd,
                   "mode": mode, "window": window,
                   "sources": 1 if cut is None else 2, "cache_slots": cut,
                   "route": route, "splits": splits, "launched": launched,
                   "admissible_pairs": pairs, "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30),
                   "tolerance": ("2e-5 + 2e-5|plain|"
                                 if dtype == torch.float32
                                 else "2 bf16 ulps of |plain| + 1e-6"),
                   "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "library_device_ms": library_device_ms,
                   "library": "scaled_dot_product_attention(bool mask, "
                              "enable_gqa)",
                   "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_fp32_cuda_cores_ms": fp32_bound_ms}
            emit(row)
            rows.append(row)
            del q, k, v, out, ref, qt, kt, vt
        del mask
        torch.cuda.empty_cache()
    return rows


def split_combine_phase(torch, fa, mask_fn) -> dict:
    """The split-KV kernel and the combine kernel each against its plain
    version on the same inputs, at Qwen3-4B's decode shape in bf16: the
    split kernel's partials against ``flash_split_plain``, the combine
    kernel against ``flash_combine_plain`` on the kernel's partials."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    _, b, h, kvh, hd, mode, window, q_pos, kv_pos, _ = attn_cases(torch)[1]
    q_pos, kv_pos = q_pos.cuda(), kv_pos.cuda()
    sq, skv = q_pos.shape[1], kv_pos.shape[1]
    pairs = int(mask_fn(mode, q_pos, kv_pos, window).sum())
    q, k, v = (torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
               for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                             (b, skv, kvh, hd)))
    splits = fa.default_splits(b, kvh, skv)
    kw = dict(mode=mode, window=window, splits=splits)
    args = (q, k, v, q_pos, kv_pos)
    parts = fa.flash_split(*args, **kw)
    ref_parts = fa.flash_split_plain(*args, **kw)
    torch.cuda.synchronize()
    # fp32 partials: reassociated sums over <= 128 keys per split
    split_err = max(float(((a - r).abs() / (1 + r.abs())).max())
                    for a, r in zip(parts, ref_parts))
    if not split_err <= 1e-5:
        fail(f"flash_split disagrees with its plain version: max err "
             f"{split_err} relative to 1 + |plain| (tolerance 1e-5)")
    out = fa.flash_combine(*parts, sq=sq, dtype=torch.bfloat16)
    ref = fa.flash_combine_plain(*parts, sq=sq, dtype=torch.bfloat16)
    out32 = fa.flash_combine(*parts, sq=sq, dtype=torch.float32)
    ref32 = fa.flash_combine_plain(*parts, sq=sq, dtype=torch.float32)
    torch.cuda.synchronize()
    ok, excess = attn_within_tolerance(torch, out, ref)
    comb_err = float((out32 - ref32).abs().max())
    if not ok or not comb_err <= 1e-6 * (1 + float(ref32.abs().max())):
        fail(f"flash_combine disagrees with its plain version: fp32 max abs "
             f"err {comb_err}, bf16 worst excess {excess}")
    reps = 20
    rows_ = sq * (h // kvh)
    part_bytes = 4 * b * kvh * splits * rows_ * (2 + hd)
    split_bound = bound(2 * q.numel() + 2 * 2 * k.numel() + part_bytes
                        + 4 * (q_pos.numel() + kv_pos.numel()),
                        4 * hd * pairs * h, BF16_TC_FLOPS)
    comb_bound = bound(part_bytes + 2 * q.numel(),
                       3 * b * kvh * splits * rows_ * hd)
    split_call = lambda: fa.flash_split(*args, **kw)
    comb_call = lambda: fa.flash_combine(*parts, sq=sq, dtype=torch.bfloat16)
    res = {
        "flash_split": {
            "ms": cuda_ms(torch, split_call, reps),
            "device_ms": device_ms(torch, split_call, reps),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_split_plain(
                *args, **kw), reps),
            "bound_ms": split_bound[0], "bound_by": split_bound[1],
            "max_abs_err": max(float((a - r).abs().max())
                               for a, r in zip(parts, ref_parts)),
            "library_ms": None},
        "flash_combine": {
            "ms": cuda_ms(torch, comb_call, reps),
            "device_ms": device_ms(torch, comb_call, reps),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_combine_plain(
                *parts, sq=sq, dtype=torch.bfloat16), reps),
            "bound_ms": comb_bound[0], "bound_by": comb_bound[1],
            "max_abs_err": max(comb_err, float(
                (out.float() - ref.float()).abs().max())),
            "library_ms": None}}
    emit({"phase": "split_combine", "shape": "decode, bf16 (B=8, Sq=1, "
          f"Skv={skv}, 32/8 heads, hd 128)", "splits": splits,
          "split_max_rel_err": split_err, **res})
    return res


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def want_flash_launches(torch, fa, cfg, prompt_len: int, gen: int) -> dict:
    """Launches of each flash kernel in one ``serve``: the prefill's route
    once per layer, the decode steps' route (split + combine) once per
    layer and step."""
    g = cfg.num_heads // cfg.num_kv_heads
    dtype = getattr(torch, cfg.dtype)
    want = {name: 0 for name in fa.LAUNCHES}
    for sq, calls in ((prompt_len, 1), (1, gen - 1)):
        route = fa.select_route(dtype, sq, g)
        for kernel in (("flash_split", "flash_combine") if route == "split"
                       else (f"flash_{route}",)):
            want[kernel] += cfg.num_layers * calls
    return want


def serve_phase(torch, rt, fa, serve_mod, name, cfg, *, batch, prompt_len,
                gen, fwd_tol, cut=None) -> dict:
    """Serve ``cfg`` once through ``launch.serve.serve`` with the flash
    count zeroed just before and read just after; check the launches, the
    logits' finiteness, the last step against a full ``forward``, and
    profile one decode step and the prefill."""
    api = rt.build_model(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = api.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device="cuda")
    serve_mod.serve(api, params, prompt, 2, device="cuda")   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    res = serve_mod.serve(api, params, prompt, gen, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = want_flash_launches(torch, fa, cfg, prompt_len, gen)
    if launches != want:
        fail(f"{name}: flash launches {launches}, want {want} (one per "
             f"layer for the prefill, one split and one combine per layer "
             f"for each of the {gen - 1} decode steps)")
    if not bool(torch.isfinite(res.logits).all()):
        fail(f"{name}: non-finite logits")
    # the last decode step against a full forward over the same tokens
    tokens = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": tokens})
    last_fwd = full[:, -1].float()
    del full
    last_dec = res.logits[:, -1]
    diff = float((last_dec - last_fwd).abs().max())
    scale = float(last_fwd.abs().max())
    rel_l2 = float((last_dec - last_fwd).norm() / last_fwd.norm())
    argmax_agree = float((last_dec.argmax(-1) == last_fwd.argmax(-1))
                         .float().mean())
    if not diff <= fwd_tol * scale:
        fail(f"{name}: last decode step disagrees with forward: max abs "
             f"diff {diff} > {fwd_tol} * max|logits| ({scale})")
    if cfg.attention == "sliding" and prompt_len + gen > cfg.window:
        pos = res.cache["pos"][0, 0]
        total = prompt_len + gen - 1
        if sorted(pos.tolist()) != list(range(total - cfg.window, total)):
            fail(f"{name}: the ring does not hold the last {cfg.window} "
                 "positions")
    # profiler windows: the prefill, and one decode step on the final cache
    # (one free slot is left: the cache holds prompt + gen slots)
    with torch.no_grad():
        cache = api.init_cache(params, batch, prompt_len + gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(params, {"tokens": prompt}, cache)
        torch.cuda.synchronize()
        prefill_host = (time.perf_counter() - t0) * 1e3
        cache = api.init_cache(params, batch, prompt_len + gen)
        prof_prefill = device_profile(
            torch, lambda: api.prefill(params, {"tokens": prompt}, cache),
            prefill_host)
        tok = res.tokens[:, -1:]
        t_pos = prompt_len + gen - 1
        step = lambda: api.decode_step(params, tok, t_pos, res.cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_host = (time.perf_counter() - t0) * 1e3
        prof_decode = device_profile(torch, step, step_host)
    steps = len(res.decode_ms)
    decode_ms = sum(res.decode_ms) / steps
    out = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "cut": cut, "d_model": cfg.d_model, "dtype": cfg.dtype,
           "batch": batch, "prompt": prompt_len, "gen": gen,
           "cache_slots": int(res.cache["k"].shape[2]),
           "params": api.param_count(params), "init_s": init_s,
           "launches": launches,
           "prefill_ms": res.prefill_ms,
           "prefill_tok_s": batch * prompt_len / res.prefill_ms * 1e3,
           "decode_ms_per_step": decode_ms,
           "decode_ms_min": min(res.decode_ms),
           "decode_ms_max": max(res.decode_ms),
           "decode_tok_s": batch / decode_ms * 1e3,
           "kv_cache_bytes": cache_bytes(res.cache),
           "peak_memory_bytes": peak,
           "logits_finite": True,
           "forward_check": {"max_abs_diff": diff, "max_abs_logit": scale,
                             "rel_l2": rel_l2, "argmax_agree": argmax_agree,
                             "tolerance": f"{fwd_tol} * max|logits|"},
           "profile_prefill": prof_prefill,
           "profile_decode_step": prof_decode}
    emit(out)
    del params, res, cache
    torch.cuda.empty_cache()
    return out


def serve_small_phase(torch, rt, fa, serve_mod, transformer, cfg) -> dict:
    """The card (kernel) against the CPU (plain version) in fp32, teacher
    forced with the card's tokens: per-step logits at rtol 1e-4 and atol
    1e-4 * max|logits|."""
    api = rt.build_model(cfg, device="cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    api_cpu = rt.build_model(cfg, device="cpu")
    params_cpu = transformer.init_params(cfg, None, torch.device("cpu"))
    params_cpu.load_state_dict(params.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    gen = 5
    fa.reset_launches()
    res = serve_mod.serve(api, params, prompt, gen, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    res_cpu = serve_mod.serve(api_cpu, params_cpu, prompt, gen,
                              device="cpu", feed=res.tokens.cpu())
    want = want_flash_launches(torch, fa, cfg, 64, gen)
    if launches != want or fa.LAUNCHES != launches:
        fail(f"serve_small: launches on the card {launches} (want {want}), "
             f"and the CPU run must launch none ({fa.LAUNCHES})")
    a, b = res.logits.cpu(), res_cpu.logits
    atol = 1e-4 * float(b.abs().max())
    diff = float((a - b).abs().max())
    if not torch.allclose(a, b, rtol=1e-4, atol=atol):
        fail(f"serve_small: card and CPU logits disagree: max abs diff "
             f"{diff} (rtol 1e-4, atol {atol})")
    out = {"phase": "serve_small", "model": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": 2,
           "prompt": 64, "decode_steps": gen - 1,
           "launches": launches,
           "max_abs_diff": diff, "max_abs_logit": float(b.abs().max()),
           "rtol": 1e-4, "atol": atol}
    emit(out)
    del params, params_cpu
    torch.cuda.empty_cache()
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    from repro_torch.core import baselines as bl, subproblem, topology
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, cd_glm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention, transformer

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
    attn = attn_kernel_phase(torch, fa, attention._mode_mask)
    split_comb = split_combine_phase(torch, fa, attention._mode_mask)
    gvr = gram_vs_residual_phase(torch, cd_glm, subproblem)
    small_phase(torch, rt, topology, synthetic, cd_glm)
    small_churn_phase(torch, rt, topology, synthetic, cd_glm)
    small_baselines_phase(torch, bl, topology, synthetic)

    ring = topology.ring(NODES)
    x, y = regression_on_device(torch, EPS_SAMPLES, EPS_FEATURES, seed=0)
    lasso = rt.PROBLEMS["lasso"](x, y, 0.05, box=10.0, device="cuda")
    run_a = main_run(torch, rt, cd_glm, "run_a", lasso, ring,
                     rt.ColaConfig(kappa=1.0), 20, kernel="cd_gram",
                     other="cd_residual", recorder="gap+certificate",
                     eps=1e-3, record_every=1, executor="block",
                     block_size=8)
    # the same lasso over 4 nodes: n_k = 500, G streamed
    run_c = main_run(torch, rt, cd_glm, "run_c", lasso, topology.ring(4),
                     rt.ColaConfig(kappa=1.0, cd_mode="auto"), 20,
                     kernel="cd_gram", other="cd_residual",
                     recorder="gap+certificate", eps=1e-3, record_every=1,
                     executor="block", block_size=8)
    # the same lasso under churn on Fig. 4's graph: leavers freeze, reset
    run_d = churn_run(torch, rt, cd_glm, "run_d", lasso, leave_mode="freeze")
    run_e = churn_run(torch, rt, cd_glm, "run_e", lasso, leave_mode="reset")
    del lasso
    torch.cuda.empty_cache()
    ridge = rt.PROBLEMS["ridge_dual"](x, y, 1e-2, device="cuda")
    run_b = main_run(torch, rt, cd_glm, "run_b", ridge, ring,
                     rt.ColaConfig(kappa=1.0), 5, kernel="cd_residual",
                     other="cd_gram", recorder="gap", record_every=1,
                     executor="block", block_size=8)
    del ridge
    torch.cuda.empty_cache()
    baselines_phase(torch, bl, topology, x, y)
    del x, y
    torch.cuda.empty_cache()

    serve_a = serve_phase(torch, rt, fa, serve_mod, "serve_a",
                          rt.get_config("qwen3_4b"), batch=8,
                          prompt_len=1024, gen=32, fwd_tol=FWD_TOL)
    danube = dataclasses.replace(rt.get_config("h2o_danube3_4b"),
                                 num_layers=4)
    serve_phase(torch, rt, fa, serve_mod, "serve_b", danube, batch=2,
                prompt_len=4608, gen=16, fwd_tol=FWD_TOL,
                cut="depth 24 -> 4 layers (full width)")
    small_cfg = dataclasses.replace(rt.get_config("qwen3_4b"), num_layers=2,
                                    dtype="float32")
    small = serve_small_phase(torch, rt, fa, serve_mod, transformer,
                              small_cfg)

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
            "ms": main_cfg["ms"], "device_ms": main_cfg["device_ms"],
            "plain_ms": main_cfg["plain_ms"],
            "bound_ms": main_cfg["bound_ms"],
            "bound_by": main_cfg["bound_by"], "library_ms": None,
            "steps": main_cfg["steps"]})
    gram_at = lambda n_k: {key: r[key] for r in checks["cd_gram"]
                           if r["n_k"] == n_k and r["budgets"] is None
                           and r["steps"] == n_k
                           for key in ("K", "n_k", "layout", "steps", "ms",
                                       "device_ms", "plain_ms", "bound_ms")}
    kernels[0].update(
        launches_run_c=run_c["launches"]["cd_gram"],
        launches_run_d=run_d["launches"]["cd_gram"],
        launches_run_e=run_e["launches"]["cd_gram"],
        shape="K=16, n_k=125 (G resident), 125 steps",
        n_k_500=gram_at(500), n_k_1000=gram_at(1000),
        gram_vs_residual={key: gvr[key] for key in (
            "gram_path_ms", "gram_kernel_device_ms", "residual_kernel_ms",
            "faster")})
    by_case = {(r["case"], r["dtype"]): r for r in attn}
    timing = lambda r: {key: r.get(key) for key in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_device_ms")}
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    flash_replaces = "src/repro/kernels/flash_attention.py:48"
    err_of = lambda route, dtype: max(
        [r["max_abs_err"] for r in attn
         if r["route"] == route and r["dtype"] == dtype] or [0.0])
    decode = by_case[("decode_2src", "bfloat16")]
    kernels.append({
        "name": "flash_mma", "route": "cuda", "source": flash_src,
        "replaces": flash_replaces,
        "launches": serve_a["launches"]["flash_mma"],
        "max_abs_err": err_of("mma", "bfloat16"),
        **timing(by_case[("prefill", "bfloat16")]),
        "shape": "prefill, bf16 (B=8, Sq=1024, Skv=2080, 32/8 heads, "
                 "hd 128)"})
    kernels.append({
        "name": "flash_split", "route": "cuda", "source": flash_src,
        "replaces": flash_replaces,
        "launches": serve_a["launches"]["flash_split"],
        "max_abs_err": max(split_comb["flash_split"]["max_abs_err"],
                           err_of("split", "bfloat16")),
        **timing(split_comb["flash_split"]),
        "with_combine": {**timing(decode), "splits": decode["splits"],
                         "shape": "decode, bf16, cache ++ fresh key "
                                  "(B=8, Sq=1, Skv=1056+1)"},
        "shape": f"decode, bf16 (B=8, Sq=1, Skv=1057), "
                 f"{decode['splits']} splits; with_combine is the whole "
                 "decode call (one launcher call starts both kernels)"})
    kernels.append({
        "name": "flash_combine", "route": "cuda", "source": flash_src,
        "replaces": flash_replaces,
        "launches": serve_a["launches"]["flash_combine"],
        "max_abs_err": split_comb["flash_combine"]["max_abs_err"],
        **timing(split_comb["flash_combine"]),
        "shape": f"decode partials, {decode['splits']} splits of "
                 "(8, 8, 4 rows, 128)"})
    prefill32 = by_case[("prefill", "float32")]
    kernels.append({
        "name": "flash_tf32", "route": "cuda", "source": flash_src,
        "replaces": flash_replaces,
        "launches": small["launches"]["flash_tf32"],
        "launches_in": "serve_small (fp32: its route at prefill)",
        "max_abs_err": err_of("tf32", "float32"),
        **timing(prefill32),
        "bound_peak": "3 x FLOPs at the TF32 tensor-core peak",
        "bound_fp32_cuda_cores_ms": prefill32["bound_fp32_cuda_cores_ms"],
        "shape": "prefill, fp32 (B=8, Sq=1024, Skv=2080, 32/8 heads, "
                 "hd 128)"})
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        fail(f"kernels not launched on their main path: {idle}")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
