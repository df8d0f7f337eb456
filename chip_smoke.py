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
   memory, K=4, n_k=500 and K=2, n_k=1,000 with G streamed, K=1,000,
   n_k=2 for run_cohort's cohort; residual: K=16, d=2,000, n_k=25,000),
   with and without a step budget, and timed.
   gram_vs_residual — at K=4, d=400,000, n_k=500 (run_c's shape), the
   Gram path per round (the c = A^T grad product plus the Gram kernel)
   against the residual kernel forced on a_cols: the measurement behind
   ``subproblem.gram_pays``.
4. attn_kernel — the flash kernels against their plain version at the
   serving runs' shapes (Qwen3-4B prefill and decode, a wrapped sliding
   ring, chunked-local, cross; SeamlessM4T's encoder self attention,
   mode cross at Sq = Skv = 1,500, and its cross decode step, one query
   against 1,500 keys, split route; the decode and sliding shapes also as a
   cache and a fresh chunk in separate tensors), bf16 and fp32, timed
   beside SDPA; each row names its route and, at decode, its splits. fp32
   inputs with more than 8 rows take the 3xTF32 tensor-core route.
   split_combine — the split-KV kernel and the combine kernel each against
   its plain version on the same inputs, and timed alone.
5. small   — reduced runs on the card against the same runs on the CPU
   (the plain versions), for both CD kernels and for a lasso with
   n_k=300 (Gram kernel, G streamed); churned lasso runs (nodes leave and
   reset, straggler budgets, the dynamic certificate with eps) through the
   Gram kernel and through the residual kernel; the quantized wire (int8
   with EF and the pipeline through each CD kernel, fp8_e5m2 under churn
   and reset; the same draws on both sides, ``compare_wire_runs``); client
   sampling (dense with the dynamic certificate, cohort at K=64 with the
   cohort certificate); DGD, DIGing and D-ADMM; attacks and defenses
   (``small_attack``: trim / median / clip crossed with a Byzantine sign
   flip and random payloads, with a stale free rider, an identity link
   corruption and an eavesdropper, on connected_cycle(8, 2) through each
   CD kernel; int8 with EF and trim under a sign flip; DGD and DIGing
   with trim).
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
7f. run_q8 / run_f8p — run_a on the int8 wire with EF, and on the fp8 wire
   with EF and the pipeline (held bitwise to the unpipelined fp8 run);
   each with a ``_wire`` row: the codec's draws, encode and mix in device
   ms against the encode's bytes bound, rounds and last gap beside run_a's.
7g. run_part — run_a's lasso over complete(16), K'=8 sampled per round
   (dense, streamed, dynamic certificate); the sampler's device ms.
7h. run_cohort — 1,000,000 clients, 1,000 per round, ridge through its
   dual at d=2,000 (2 samples per client), data drawn on the card: ms per
   round, device ms, idle share, the sampler and the cohort write-back in
   device ms, peak device memory (K halves on out-of-memory, and a
   ``run_cohort_cut`` row says so).
7i. run_atk_* — run_a's lasso on torus_2d(4, 4) (the reference's attack
   graph) with two nodes sending -10x their state from round 5: clean,
   undefended (with an eavesdropper on nodes 0 and 3, whose taps are
   held bitwise to the replayed pre-round payloads), trim, median, clip,
   trim on a clean run (its final state against the clean run's) and
   trim on the int8 wire with EF. Each ``<name>_attack`` row: ms per
   round, device ms and idle share of the replayed rounds, the mix's
   device ms per gossip step against the bytes bound of one read and one
   write of the (16, 400,000) stack, peak device memory, the edges the
   gate rejects per round, violated and stop rounds, the last Lemma-1
   residual. gate_step — one full-width robust step per mode on the
   attacked stack, the card against the CPU (flags equal, center
   bitwise, output within rtol 1e-5 and atol 1e-6 max|v|), and the
   center's sort against a stable sort and the reference's comparison
   count.
7j. baselines_robust — DGD and DIGing with trim on the baselines' data,
   ms per round beside the plain runs'.
7k. topo_plan — the topology compiler's executors without ranks at
   (16, 400,000) fp32, per graph family (ring, cycle2, torus2d, expander,
   hypercube, complete): ``plan_mix_dense`` against ``dense_mix`` at rtol
   1e-6, ``block_mix_dense`` over 4 ranks bitwise; colors, budget bytes
   and device ms of each beside ``dense_mix``'s.
7l. dist1_a / dist1_d — ``run_dist_cola`` in an NCCL group of one rank
   (made here, destroyed at the end; no other backend is tried) on run_a's
   and on run_d's (freeze) and run_e's (reset) configurations, through
   ``comm="plan"`` (the block plan at one rank) and ``comm="dense"``: the
   Gram kernel once per executed round, the state and the history held to
   the ``run_cola`` run bitwise (or rtol 1e-6, said in the row); ms per
   round of the distributed round body beside run_a's, device ms, idle
   share, the collectives' device ms and calls.
7m. dist1_q8 / dist1_f8p / dist1_atk / dist1_rq8 — the same group of one
   rank on the quantized wire, robust mixing and attacks: run_q8's int8 +
   EF and run_f8p's fp8 + EF + pipeline on ring(16); run_atk_trim's,
   run_atk_median's and run_atk_clip's attacked, defended runs on
   torus_2d(4, 4); trim on the int8 wire with EF without an attack (the
   composed lowering; its ``run_cola`` run is made in the phase). Both
   comms; bitwise the ``run_cola`` run (clip: within rtol 1e-6), equal
   violated and stop rounds; the Gram kernel once per executed round;
   each row: the rank's ms per round beside the ``run_cola`` run's, and
   one round's collective calls and bytes against the plan's
   ``contract(wire=)`` (the int8 dense all-gather: 16 x 400,000 x 1 +
   16 x 4 = 6,400,064 B).
7n. obs — telemetry (``repro_torch.obs``): the content fingerprint of the
   lasso (a 3.2 GB copy to the host and a SHA-256) in seconds; run_a,
   run_q8 and run_atk_trim with telemetry off and on in turns (off, on,
   on, off): the on run bitwise the off run (state, EF residual, every
   history column, stop round), 20 ``cd_gram`` launches, the counted
   bytes and exchanges against the compiled plan's ``contract(wire=)``,
   run_q8's saturation in [0, 1) and EF norm > 0, run_atk_trim's
   rejections on the two attackers' columns only and equal to the
   replayed gate's; ms per round of the round body off and on (host
   clock; device ms and idle share, CUDA events behind a sleep kernel)
   and of the run's block spans (``obs.trace``); trim on the clean run
   rejects nothing; dist1_a / dist1_q8 at one NCCL rank, plan and dense,
   on bitwise off, 0 bytes on the plan and 20 x 6,400,064 on the int8
   dense comm, and ``NodeAxis``'s calls only one all-reduce and one
   all-gather more (the end-of-run combine); DGD's modeled bytes; a
   tracer over run_a (span summary, Chrome trace size, CUDA events at
   the block spans) and the same run under ``obs.trace.torch_profile``:
   the kernels inside the block spans against the events' device ms
   (``obs_profiler_coverage``); a registry in a temporary directory
   holding these runs, the CLI's list / show / diff / timeline, run_a's
   off / on twin diffed as telemetry only.
8. serve_a — Qwen3-4B at full width and depth in bf16 through
   ``launch.serve.serve``: 8 prompts of 1,024 tokens, 32 greedy tokens.
9. serve_b — H2O-Danube3-4B at full width, 4 layers: 2 prompts of 4,608
   tokens (longer than the 4,096-slot ring), 16 tokens.
   Both check the launches of every flash kernel (the tensor-core kernel
   at prefill, split-KV + combine at decode), finite logits and the last
   step against a full forward, and profile the prefill and one decode
   step.
10. serve_small — Qwen3-4B width, 2 layers, fp32: the card against the CPU.
10b. serve_moe_a — Llama-4-Maverick at full width, 2 of 48 layers (one
   group: a dense layer, then the MoE layer with 128 experts top-1 and the
   shared expert), chunked-local attention (window 8,192), bf16, scatter
   dispatch at capacity factor 1.25: 4 prompts of 2,048 tokens, 16 greedy
   tokens through ``launch.serve.serve``. Checks the flash launches (2
   ``flash_mma`` at the prefill, 2 ``flash_split`` + 2 ``flash_combine``
   a decode step), finite logits, the forward under scatter with C >= T
   against the forward under ``moe_mode="dense"`` on a 2 x 512 prefix,
   and a dense decode step after a 511-token prefill against the dense
   forward's last position (routes compared; a row whose route flips at
   a near-tie is left out and shown). Reports parameters, init seconds
   and peak, prefill and decode times, peak memory, and the MoE layer's
   device ms in the prefill and in one decode step (profiler ranges)
   against its bytes bound with all 128 experts read (the batched
   product reads them all) and with the experts the call used.
10c. serve_moe_small — a dbrx shape (16 experts top-4) and a llama4 shape
   (128 experts top-1, shared expert, dense + MoE groups, chunked-local
   window 64) at d_model 512, 2 groups, fp32: the card against the CPU,
   teacher forced, 2 prompts of 120 tokens and 16 tokens; every router
   call's routes compared (a flip allowed only at a CPU margin below
   1e-4, its batch row then left out).
10d. serve_hybrid_a — Zamba2-7B at full width and depth (81 blocks: 27
   groups of 2 Mamba2 blocks and the shared attention + MLP, sliding
   window 4,096), bf16, 2 prompts of 4,096 tokens and 16 tokens: as
   serve_a; then decode after a 511-token prefill against the forward in
   bf16, and both decode checks in fp32 (serve_hybrid_a_decode_checks).
10e. ssm_small — xLSTM's and Zamba2's smoke variants (fp32), the card
   against the CPU: the forward, a prefill then 4 decode steps (logits
   and states), every gradient.
10f. serve_encdec_a — SeamlessM4T-medium at full width and depth (12
   encoder + 12 decoder layers), bf16: 8 utterances of 1,500 frames, a
   32-token prompt, 64 tokens: encode ms, then as serve_a; the flash
   launches also by mask mode (the encoder's mma in mode cross twice,
   the decoder's causal and cross mma, split + combine for each at every
   step).
10g. serve_vlm_a — InternVL2-26B at full width and depth (48 layers,
   19.88 B parameters): 4 requests of 256 patches + 1,024 tokens, 16
   tokens, as serve_a; decode against the bytes one step reads
   (``decode_step_bound``: the decoder's weights and the KV cache).
10h. zoo_small — SeamlessM4T's and InternVL2's smoke variants (fp32),
   the card against the CPU, as ssm_small, with their frontend input.
11. attn_grad — the flash kernel with a gradient (``FlashAttention``) at
   the training shape (B=2, S=1,024, 32/8 heads, hd 128, causal): dq, dk,
   dv against autograd of the plain version on the card, bf16 and fp32;
   the forward, the backward, the plain forward + backward and SDPA's
   forward + backward timed; and at Zamba2's (B=4, 32/32 heads, hd 112,
   sliding), bf16.
12. train_small — Qwen3-4B's smoke variant (fp32: ``flash_tf32``), the
   card against the CPU from the same weights: the loss and every
   gradient leaf, 3 AdamW steps, 3 gossip rounds over ring(4) plain, with
   trim and with DP on the int8 wire.
13. train_a — Qwen3-4B at full width, 8 of 36 layers, through
   ``launch.train.train``: bf16 compute, fp32 masters and AdamW moments,
   remat full, B=4 x S=1,024, 6 steps: ms per step, tokens/s, MFU, the
   flash launches per step, a profiled step (device ms, idle), peak
   memory, the loss per step.
14. train_gossip / train_gossip_dp — the same width at 2 layers, 4
   replicas on ring(4), B=2 x S=1,024 per node, 4 rounds through
   ``launch.train.gossip_train``: local steps and mix ms per round,
   consensus distance, peak memory; with DP (per-link noise, int8 wire)
   the draws', the codec's and the DP mix's ms per gossip step and the
   final epsilon against the accountant's closed form. At 1 layer on
   out-of-memory (a ``_cut`` row).
14b. train_moe_small — serve_moe_small's two shapes in training (fp32),
   the card against the CPU: loss, ce, aux, every gradient, every route.
14c. train_moe_a / train_hybrid_a / train_xlstm_a — through
   ``launch.train.train`` as train_a: dbrx at full width, 1 layer, 8 of
   16 experts top-4 (the MoE layer's forward and backward device ms in
   profiler ranges of the profiled step against their bounds); Zamba2-7B
   at full width, 9 of 27 groups; xLSTM-125M whole at B=8 (the sLSTM
   blocks' host share of the profiled step, the idle share from the
   device's kernels alone).
14d. train_encdec_a / train_vlm_a — SeamlessM4T-medium whole (B=4 x
   1,024 frames + 1,024 tokens) and InternVL2-26B at full width, 4 of 48
   layers (B=4 x (256 patches + 1,024 tokens)), through
   ``launch.train.train`` on a pipe whose batches carry the frontend
   input (``frontend_pipe``), as train_moe_a: ms per step, tokens/s, MFU
   over every position's products (``frontend_train_flops``), the
   launches per step, peak memory; then train_vlm_a_fp32, the same run in
   fp32 compute (``flash_tf32``), the witness of train_vlm_a's loss
   curve.
14e. launch and sharding — ep_moe_a (inside serve_moe_a, on its
   Llama-4-Maverick group and prompts): prefill and 15 decode steps
   through the expert-parallel MoE branch over the script's one NCCL rank
   (``ModelCtx(mesh=make_host_mesh(1, 1), model_axis="model")``), logits
   and cache bitwise those without the mesh, the flash launches, the
   axis's all-reduces, the MoE layer's device ms with and without the
   mesh and the all-reduce's; ep_train_small (after train_moe_small):
   the two small MoE shapes' loss and every gradient through the branch
   at M = 1, bitwise those without it; dryrun_card (after train_a):
   ``launch.dryrun.size_pair``'s per-rank bytes on a 1 x 1 mesh against
   the ``torch.cuda.memory_allocated()`` deltas of serve_vlm_a (params,
   then the cache) and train_a (the state), within 0.5 %, and one traced
   full-config pair's flops beside ``model_flops``; serve_batched — the
   three smoke archs of ``examples/torch_serve_batched.py`` on the card
   against the CPU (greedy tokens where the top-1 margin is > 1e-4).
15. total   — the script's seconds so far.
16. kernels — one line listing every kernel with its launches on the main
   path, error, times and bound (``flash_mma`` also with its launches in
   the training phases and the gradient's times).

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

import contextlib
import dataclasses
import json
import math
import statistics
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
# HBM_BYTES_PER_S (HBM_BW) and BF16_TC_FLOPS (PEAK_FLOPS_BF16) are
# ``repro_torch.launch.mesh``'s, read by ``main`` once src/ is importable.
HBM_BYTES_PER_S = None
FP32_FLOPS = 67e12
BF16_TC_FLOPS = None
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
# the same check after a long prompt through a deep recurrent stack:
# Zamba2-7B's last decode step after a 4,096-token prefill and 15 steps,
# 81 blocks in bf16. serve_hybrid_a's fp32 twin holds the same decode path
# to HYBRID_FP32_TOL (measured 3.1e-5 relative on an H100 80GB HBM3 at
# 700 W), so what bf16 adds is rounding, which grows with depth and
# length: measured 6.7 % of max|logits| there (2.4 % after a 511-token
# prefill, which FWD_TOL holds). A wrong state or ring moves logits by
# their own size.
FWD_TOL_DEEP = 0.1
HYBRID_FP32_TOL = 1e-3
# quantized wire, card vs CPU: |probe difference| above which a rounding
# decision flipped between the two (fp32 noise keeps the probes ~1e-5
# apart at the small runs' sizes, one flipped int8/fp8 step moves them
# ~1e-3)
PROBE_TOL = 1e-4

# training, card vs CPU at the smoke width (fp32, flash_tf32 held to the
# fp32 bar, PyTorch's products with TF32 off): losses and gradients within
# rtol, with an atol of rtol x the leaf's largest gradient
TRAIN_RTOL = 1e-4
# a run of AdamW steps (or a DP run) card vs CPU: the share of each leaf's
# coordinates within TRAIN_RTOL x max|p|. A first AdamW step moves a
# coordinate whose gradient is at rounding level by +-lr whichever side of
# 0 it rounds to, and a stochastic-rounding decision on the int8 wire may
# flip where the two devices' normals differ in the last bits.
AGREE_SHARE = 0.999
# the flash backward against autograd of the plain version on the card:
# |g - ref| <= tol |ref| + tol max|ref|. bf16: the gradients are rounded
# to bf16 (2^-8 relative) and the Function's rowsum(dO * O) reads the
# kernel's bf16 output where autograd differentiates the fp32 one; fp32:
# the 3xTF32 forward is held to 2e-5.
ATTN_GRAD_TOL = 2e-2
ATTN_GRAD_TOL_FP32 = 1e-4

EPS_SAMPLES, EPS_FEATURES, NODES = 400_000, 2_000, 16
COHORT_CLIENTS = 1_000_000


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
    # nodes; G resident), K=4, n_k=500 (over 4 nodes, run_c), K=2,
    # n_k=1,000 (G streamed through the ring) and K=1,000, n_k=2 (run_cohort's
    # gathered cohort: 1,000 clients of 2 samples each)
    kw = dict(l1=0.05, l2=0.0, box=10.0)
    rows = []
    for kg, n_k, step_counts in ((k, EPS_FEATURES // k, (125, 1000)),
                                 (4, 500, (500,)), (2, 1000, (1000,)),
                                 (1000, 2, (2,))):
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


def round_profile(torch, prob, graph, cfg, rounds: int,
                  make_body=None, atk=None, axis=None) -> dict:
    """The round body alone: host-clock ms per round (synchronised), device
    ms per round (``device_ms``: rounds queued behind a sleep kernel) and
    the device's idle share of the round, then a ``torch.profiler`` window
    over the same rounds for device ms by kernel; ``profiler_coverage`` is
    the profiler's device total over the queued one. On a quantized wire
    the body runs as the drivers run it: EF state armed, each round with
    its own draws of the port's stream (seed 0), the draws included.
    ``make_body(prob, part)``: another round body taking the same
    arguments (the distributed runtime's at world size 1). ``atk``: the
    attack entries every round runs with. ``axis``: a ``NodeAxis`` whose
    counts are read over one more round (``round_collective_calls`` /
    ``round_sent_bytes``)."""
    from repro_torch.core import cola, partition, quant, topology
    part = partition.make_partition(prob.n, graph.num_nodes)
    env = cola.build_env(prob, part)
    state = cola.init_state(prob, part)
    body = (make_body(prob, part) if make_body is not None
            else cola.make_round(prob, part, cfg))
    w = torch.as_tensor(topology.metropolis_weights(graph),
                        dtype=torch.float32, device="cuda")
    active = torch.ones((graph.num_nodes,), device="cuda")
    draws = None
    if quant.is_quantized(cfg.wire):
        draws = quant.wire_uniforms(0, graph.num_nodes, prob.d, "cuda")
        state = cola._arm_wire_state(state, cfg, draws)
    t_next = 0

    def one():
        nonlocal state, t_next
        state = body(state, env, w, active, None, atk=atk,
                     **cola._round_draws(draws, t_next))
        t_next += 1

    one()
    coll = {}
    if axis is not None:
        axis.reset_counts()
        one()
        coll = {"round_collective_calls": dict(axis.counts),
                "round_sent_bytes": dict(axis.sent_bytes)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / rounds

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
                            for r in prof["top_kernels"]], **coll}


def device_profile(torch, fn, host_ms: float, top: int = 8,
                   ranges: tuple = ()) -> dict:
    """``fn`` once under ``torch.profiler``: device ms by kernel (summed
    over the window), and the device's idle share of ``host_ms`` (the
    window's synchronised host-clock time, measured outside the
    profiler); with ``ranges``, the calls, device ms and host ms of each
    ``record_function`` range of that name opened in the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        # a range is also recorded on the device (its span, not a kernel)
        if "CUDA" not in str(ev.device_type) or ev.key in ranges:
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
                            for n, m, c in kernels[:top]],
            **({"ranges": {name: range_times(prof, name, DeviceType.CPU)
                           for name in ranges}} if ranges else {})}


def range_times(prof, name: str, cpu) -> dict:
    """The calls, summed device ms and host ms of the ``record_function``
    ranges called ``name`` in ``prof``."""
    evs = [e for e in prof.events() if e.name == name and e.device_type == cpu]
    dev = lambda e: getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)
    return {"calls": len(evs), "device_ms": sum(dev(e) for e in evs) / 1e3,
            "host_ms": sum(e.time_range.elapsed_us() for e in evs) / 1e3}


def executed_rounds(h, rounds: int, block: int) -> int:
    """Rounds the block executor ran: all, or up to the end of the block
    holding the stop round."""
    if h["stop_round"] is None:
        return rounds
    return min(rounds, -(-(h["stop_round"] + 1) // block) * block)


def main_run(torch, rt, cd_glm, name, prob, graph, cfg, rounds, *, kernel,
             other, profile=None, check_gap=True, keep_state=False,
             finite=True, extra=None, **kw) -> dict:
    """Drive run_cola once with the launch counts zeroed just before and
    read just after; check launches and the history (the gap must fall
    unless ``check_gap`` is off; rows and the final state must be finite
    unless ``finite`` is off, for a run that may diverge). ``profile()``
    gives the timing keys (default: ``round_profile`` of the static round
    body); ``extra`` keys go into the row; ``keep_state`` returns the
    final state (and the eavesdropper's taps) too."""
    cd_glm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.run_cola(prob, graph, cfg, rounds, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cd_glm.LAUNCHES)
    h = res.history
    executed = executed_rounds(h, rounds, kw["block_size"])
    if launches[kernel] != executed:
        fail(f"{name}: {kernel} launched {launches[kernel]} times, want one "
             f"per executed round ({executed})")
    if launches[other] != 0:
        fail(f"{name}: {other} launched {launches[other]} times, want 0")
    rows = [[h[key][i] for key in h if isinstance(h[key], list)
             and key != "round"] for i in range(len(h["round"]))]
    if finite and not all(math.isfinite(v) for row in rows for v in row):
        fail(f"{name}: non-finite history row")
    if check_gap and not h["gap"][-1] < h["gap"][0]:
        fail(f"{name}: gap did not decrease ({h['gap'][0]} -> {h['gap'][-1]})")
    x_fin = bool(torch.isfinite(res.state.x_parts).all()
                 and torch.isfinite(res.state.v_stack).all())
    if finite and not x_fin:
        fail(f"{name}: non-finite final state")
    timing = (profile() if profile is not None
              else round_profile(torch, prob, graph, cfg, rounds=3))
    out = {"phase": name, "problem": prob.name, "d": prob.d, "n": prob.n,
           "nodes": graph.num_nodes, "rounds": rounds, **(extra or {}),
           "stop_round": h["stop_round"], "executed_rounds": executed,
           "launches": launches, "wall_s_incl_setup": wall,
           **timing,
           "columns": [key for key in h if isinstance(h[key], list)
                       and key != "round"],
           "history": {"round": h["round"], "rows": rows}}
    emit(out)
    out["raw_history"] = h
    if keep_state:
        out["state"] = res.state
        out["taps"] = res.taps
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


def timed_rounds(torch, one, rounds: int, device_reps: int | None = None
                 ) -> dict:
    """``rounds`` calls of ``one`` (one round each): host-clock ms per
    round around synchronised rounds, device ms per round (``device_ms``
    over ``device_reps`` rounds, default ``rounds``: a round of a few
    hundred launches must stay under the card's queue of pending
    launches while they wait behind the sleep kernel) and the device's
    idle share of the round."""
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / rounds
    dev_ms = device_ms(torch, one, device_reps or rounds)
    return {"ms_per_round": host_ms, "device_ms_per_round": dev_ms,
            "device_idle_share": 1.0 - dev_ms / host_ms}


def churn_profile(torch, prob, graph, cfg, sched, make_body=None,
                  reset_total=None) -> dict:
    """The churned rounds as the drivers run them (the leaver reset, then
    the round body with the round's W_t, active mask and budgets), cycling
    through ``sched``: ``timed_rounds`` over all of them, each round alone
    (synchronised) split by whether it reset leavers, and the device ms of
    the reset and of the body alone. ``make_body`` / ``reset_total``: the
    distributed runtime's round body and the reset's cross-rank sum."""
    from repro_torch.core import cola, partition
    part = partition.make_partition(prob.n, graph.num_nodes)
    env = cola.build_env(prob, part)
    body = (make_body(prob, part) if make_body is not None
            else cola.make_round(prob, part, cfg))
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
            state = cola._reset_leavers(state, env, leavers[t],
                                        total_fn=reset_total)
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
            torch, lambda: cola._reset_leavers(state, env, leavers[t_reset],
                                               total_fn=reset_total), 5)
    del env
    return out


def churn_inputs(rounds: int = 20):
    """run_d's graph, config and (T, K) schedules: p_stay 0.8 (seed 0),
    straggler budgets (seed 1)."""
    from repro_torch.core import cola, topology
    return (topology.connected_cycle(NODES, 2), cola.ColaConfig(kappa=1.0),
            stay_masks(rounds, NODES, 0.8, seed=0),
            straggler_budgets(rounds, NODES, EPS_FEATURES // NODES))


def churn_run(torch, rt, cd_glm, name, prob, *, leave_mode: str,
              rounds: int = 20) -> dict:
    """run_a's lasso on connected_cycle(16, 2) under churn (p_stay 0.8,
    straggler budgets), the dynamic certificate with eps = 1e-3, block 8:
    the Gram kernel once per executed round, no residual launch, finite
    rows and at least one round with a node dropped (and, under reset, at
    least one reset)."""
    graph, cfg, active, budgets = churn_inputs(rounds)
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
                   check_gap=leave_mode == "freeze", keep_state=True,
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
# the quantized wire and client sampling
# ---------------------------------------------------------------------------

def wire_probe(torch, tmet, k: int, d: int, device):
    """A recorder column: a fixed random projection of v (drawn on the
    CPU from seed 99, so that the card and the CPU project alike). Where
    the two runs' probes part by more than ``PROBE_TOL``, a rounding
    decision of the codec has flipped between them."""
    p = torch.randn((k, d), generator=torch.Generator().manual_seed(99))
    p = p.to(device)
    return tmet.FnRecorder(("probe",),
                           lambda s: torch.sum(s.v_stack * p)[None])


def grid_step(wire: str, v):
    """(K, 1) numpy: the coarsest grid step of each row of v on ``wire``
    (absmax / 127 for int8, absmax * 2^-mantissa bits for fp8)."""
    import numpy as np
    am = np.abs(v).max(axis=1, keepdims=True)
    if wire == "int8":
        return am / 127.0
    return am * 2.0 ** -{"fp8": 3, "fp8_e5m2": 2}[wire]


def compare_wire_runs(name, res, wire: str, ef: bool) -> dict:
    """Card against CPU on a quantized wire, both with the same draws (the
    port's counter stream is the same on both). The runs compute the codec
    on fp32 states that differ in the last bits, so a value may land on
    the other side of a rounding boundary: rows before the first row whose
    probes part (``PROBE_TOL``) are held to ``SMALL_RTOL`` (atol relative
    to max |primal|), as the other ``small`` rows; the final v, x and EF
    residual to ``SMALL_RTOL`` noise and, after a flip, one grid step of
    their row with error feedback (which takes a flipped step back), two
    without."""
    import numpy as np
    g, w = res["cuda"].history, res["cpu"].history
    if g["round"] != w["round"] or g["stop_round"] != w["stop_round"]:
        fail(f"{name}: card and CPU record other rounds or stop elsewhere")
    parted = np.abs(np.asarray(g["probe"]) - np.asarray(w["probe"])) \
        > PROBE_TOL
    first = int(np.argmax(parted)) if parted.any() else len(w["round"])
    atol = SMALL_RTOL * max(abs(v) for v in w["primal"])
    worst = {}
    for key in ("primal", "dual", "gap", "consensus_violation"):
        a, b = np.asarray(g[key][:first]), np.asarray(w[key][:first])
        if not np.allclose(a, b, rtol=SMALL_RTOL, atol=atol):
            fail(f"{name}: card and CPU disagree on {key} before any "
                 f"rounding flipped: {a.tolist()} vs {b.tolist()}")
        worst[key] = float(np.max(np.abs(a - b))) if a.size else 0.0
    sc, sp = res["cuda"].state, res["cpu"].state
    v_ref = sp.v_stack.numpy()
    steps = 0.0 if first == len(w["round"]) else (1.0 if ef else 2.0)
    step = steps * grid_step(wire, v_ref)
    v_noise = SMALL_RTOL * float(np.abs(v_ref).max())
    x_ref = sp.x_parts.numpy()
    pairs = [("v", sc.v_stack, v_ref, v_noise, step),
             ("x", sc.x_parts, x_ref,
              SMALL_RTOL * float(np.abs(x_ref).max()), step.max())]
    if ef:
        pairs.append(("ef", sc.ef, sp.ef.numpy(), v_noise, step))
    for key, a, b, noise, s in pairs:
        diff = np.abs(a.cpu().numpy() - b)
        if not np.all(diff <= noise + s):
            fail(f"{name}: card and CPU final {key} differ by up to "
                 f"{diff.max()} (fp32 noise {noise}, grid steps {steps})")
        worst[key] = float(diff.max())
    return {"max_abs_diff": worst, "rows_before_a_flip": first,
            "rows": len(w["round"]), "grid_steps_allowed_at_the_end": steps}


def small_wire_phase(torch, rt, topo, synthetic, cd_glm, tmet) -> None:
    """Quantized runs, the card against the CPU with the same draws: int8
    with EF and the pipeline through each CD kernel (n_k 8 on the Gram
    kernel, 50 on the residual kernel), and fp8_e5m2 with churn (p_stay
    0.8) and leavers that reset."""
    from repro_torch.core.partition import make_partition
    rounds = 20
    cases = (("int8", "cd_gram", 200, 64, 8, dict(pipeline=True), {}),
             ("int8", "cd_residual", 40, 200, 4, dict(pipeline=True), {}),
             ("fp8_e5m2", "cd_gram", 200, 64, 8, {},
              dict(active_schedule=stay_masks(rounds, 8, 0.8),
                   leave_mode="reset")))
    for wire, kernel, n_samples, n_features, nodes, cfg_kw, kw in cases:
        x, y, _ = synthetic.regression(n_samples, n_features, seed=0,
                                       sparsity_solution=0.2)
        res, launches = {}, {}
        for dev in ("cuda", "cpu"):
            prob = rt.PROBLEMS["lasso"](x, y, 5e-2, box=5.0, device=dev)
            part = make_partition(prob.n, nodes)
            rec = tmet.ComposedRecorder((
                tmet.GapRecorder(prob, part),
                wire_probe(torch, tmet, nodes, prob.d, dev)))
            cd_glm.reset_launches()
            res[dev] = rt.run_cola(
                prob, topo.ring(nodes),
                rt.ColaConfig(kappa=2.0, wire=wire, **cfg_kw), rounds,
                record_every=2, recorder=rec, seed=3, device=dev,
                block_size=8, **kw)
            launches[dev] = dict(cd_glm.LAUNCHES)
        if launches["cuda"][kernel] != rounds or launches["cpu"][kernel]:
            fail(f"small wire {wire} {kernel}: launches {launches}, want "
                 f"{rounds} on the card and none on the CPU")
        cmp = compare_wire_runs(f"small wire {wire} {kernel}", res,
                                wire, True)
        emit({"phase": "small", "problem": "lasso", "wire": wire,
              "error_feedback": True, "kernel": kernel,
              "n_k": -(-n_features // nodes), "nodes": nodes, **cfg_kw,
              **({"p_stay": 0.8, "leave_mode": "reset"} if kw else {}),
              "launches": launches["cuda"], **cmp, "rtol": SMALL_RTOL,
              "atol": "rtol * max|primal|"})


def small_participation_phase(torch, rt, topo, synthetic, cd_glm, tmet,
                              schedule) -> None:
    """Client sampling, the card against the CPU with the same draws (the
    sampler's counter stream is the same on both): dense mode over
    complete(8) (K' = 4) with the dynamic certificate, and cohort mode at
    K = 64 (K' = 16, n_k = 2) with the cohort certificate; both
    certificates take the exact sigma_k (computed once on the CPU)."""
    from repro_torch.core.partition import make_partition
    rounds = 20
    x, y, _ = synthetic.regression(200, 128, seed=0, sparsity_solution=0.2)
    for mode, k, k_active in (("dense", 8, 4), ("cohort", 64, 16)):
        sample = schedule.SampleConfig(k_active=k_active, mode=mode)
        graph = topo.complete(k) if mode == "dense" \
            else topo.implicit_complete(k)
        hist, launches = {}, {}
        sigma = None
        for dev in ("cpu", "cuda"):
            prob = rt.PROBLEMS["lasso"](x, y, 5e-2, box=5.0, device=dev)
            part = make_partition(prob.n, k)
            env = rt.build_env(prob, part)
            if sigma is None:
                sigma = torch.linalg.matrix_norm(env.a_parts, ord=2) ** 2
            cert = (tmet.cohort_certificate_recorder(
                prob, part, env, 0.2, sigma_k=sigma) if mode == "cohort"
                else tmet.certificate_recorder(prob, part, env, graph, 0.2,
                                               sigma_k=sigma))
            rec = tmet.ComposedRecorder((tmet.GapRecorder(prob, part), cert))
            cd_glm.reset_launches()
            res = rt.run_cola(prob, graph, rt.ColaConfig(
                kappa=2.0, participation=sample), rounds, record_every=2,
                recorder=rec, eps=0.2, seed=5, device=dev, block_size=8)
            launches[dev] = dict(cd_glm.LAUNCHES)
            hist[dev] = res.history
        if launches["cuda"]["cd_gram"] != rounds or launches["cpu"]["cd_gram"]:
            fail(f"small participation {mode}: launches {launches}, want "
                 f"{rounds} Gram launches on the card and none on the CPU")
        worst = compare_histories(
            f"small participation {mode}", hist,
            ("primal", "dual", "gap", "consensus_violation",
             "local_gap_max", "grad_disagreement_max", "cond9_nodes",
             "cond10_nodes"), scale_key="primal")
        emit({"phase": "small", "problem": "lasso", "participation": mode,
              "nodes": k, "k_active": k_active, "n_k": -(-128 // k),
              "recorder": "gap+certificate (exact sigma_k)", "eps": 0.2,
              "stop_round": hist["cuda"]["stop_round"],
              "launches": launches["cuda"], "max_abs_diff": worst,
              "rtol": SMALL_RTOL, "atol": "rtol * max|primal|"})


def codec_profile(torch, quant, mixing, wire: str, k: int, d: int) -> dict:
    """The codec of one gossip step at (K, d) on the card: the draws
    (``quant.wire_uniforms``), the EF encode (quantize, dequantize, new
    residual) and the mix of the dequantized stack (W @ deq, ring(K)),
    each in device ms, beside the bytes bound of the encode: it reads v
    and ef and writes the dequantized stack and ef (4 K d fp32)."""
    from repro_torch.core import topology
    gen = torch.Generator(device="cuda").manual_seed(4)
    v = torch.randn((k, d), generator=gen, device="cuda")
    ef = 0.01 * torch.randn((k, d), generator=gen, device="cuda")
    w = torch.as_tensor(topology.metropolis_weights(topology.ring(k)),
                        dtype=torch.float32, device="cuda")
    draws = quant.wire_uniforms(0, k, d, "cuda")
    u = draws(0, 0)
    step = lambda: mixing.qmix_steps(w, v, ef, 1, wire, lambda s: u)
    out = {}
    for key, fn in (("draws", lambda: draws(1, 0)),
                    ("encode", lambda: quant.encode(v, wire, u, ef)),
                    ("mix", lambda: mixing.dense_mix(w, v)),
                    ("encode_and_mix", step)):
        out[f"{key}_device_ms"] = device_ms(torch, fn, 10)
    out["encode_bytes"] = 4 * 4 * k * d
    out["encode_bound_ms"] = out["encode_bytes"] / HBM_BYTES_PER_S * 1e3
    out["draws_bound_ms"] = 4 * k * d / HBM_BYTES_PER_S * 1e3
    out["payload_bytes_per_step"] = quant.payload_bytes(d, wire, k)
    out["fp32_payload_bytes_per_step"] = quant.payload_bytes(d, "fp32", k)
    return out


def wire_run(torch, rt, cd_glm, quant, mixing, name, prob, graph, wire,
             run_a, pipeline=False) -> dict:
    """run_a's lasso on a quantized wire with EF (and the pipeline): the
    run itself (``main_run``: launches, history, the round body's timing
    with its draws), then the codec of one gossip step at this shape
    (``codec_profile``) and the run's rounds and last gap beside run_a's.
    A pipelined run is held bitwise to the unpipelined run on the card: x
    and v equal, and its payload and residual what the unpipelined run
    would encode next."""
    cfg = rt.ColaConfig(kappa=1.0, wire=wire, pipeline=pipeline)
    kw = dict(recorder="gap+certificate", eps=1e-3, record_every=1,
              executor="block", block_size=8)
    run = main_run(torch, rt, cd_glm, name, prob, graph, cfg, 20,
                   kernel="cd_gram", other="cd_residual", keep_state=True,
                   extra={"wire": wire, "error_feedback": True,
                          "pipeline": pipeline}, **kw)
    state = run.pop("state")
    h, ha = run["raw_history"], run_a["raw_history"]
    row = {"phase": name + "_wire", "wire": wire, "pipeline": pipeline,
           "shape": f"K={graph.num_nodes}, d={prob.d}",
           **codec_profile(torch, quant, mixing, wire, graph.num_nodes,
                           prob.d),
           "recorded_rounds": len(h["round"]), "stop_round": h["stop_round"],
           "gap_last": h["gap"][-1],
           "run_a_recorded_rounds": len(ha["round"]),
           "run_a_stop_round": ha["stop_round"],
           "run_a_gap_last": ha["gap"][-1],
           "ms_per_round": run["ms_per_round"],
           "device_ms_per_round": run["device_ms_per_round"],
           "run_a_ms_per_round": run_a["ms_per_round"],
           "run_a_device_ms_per_round": run_a["device_ms_per_round"]}
    if pipeline:
        twin = rt.run_cola(prob, graph, rt.ColaConfig(kappa=1.0, wire=wire),
                           20, device="cuda", **kw)
        same = lambda a, b: torch.equal(
            a.view(torch.uint8) if a.element_size() == 1 else a,
            b.view(torch.uint8) if b.element_size() == 1 else b)
        t_next = 20 if h["stop_round"] is None else h["stop_round"] + 1
        u = quant.wire_uniforms(0, graph.num_nodes, prob.d, "cuda")(t_next,
                                                                    0)
        q, s, _, ef = quant.encode(twin.state.v_stack, wire, u, twin.state.ef)
        checks = {"x": same(state.x_parts, twin.state.x_parts),
                  "v": same(state.v_stack, twin.state.v_stack),
                  "history": twin.history == h,
                  "payload": same(state.buf[0], q),
                  "scale": same(state.buf[1], s),
                  "ef": same(state.ef, ef)}
        if not all(checks.values()):
            fail(f"{name}: the pipelined run is not bitwise the unpipelined "
                 f"one: {checks}")
        row["bitwise_vs_unpipelined"] = checks
        del twin
    emit(row)
    run["state"] = state
    return run


def participation_profile(torch, rt, schedule, prob, graph, cfg,
                          rounds: int) -> dict:
    """A dense participation round as the block driver runs it: the
    sampler's generator for round t (active mask, W, the certificate's
    mask and threshold), then the round body; ``timed_rounds`` over
    ``rounds`` rounds, and the sampler alone in device ms."""
    from repro_torch.core import cola, metrics, partition
    k = graph.num_nodes
    part = partition.make_partition(prob.n, k)
    env = cola.build_env(prob, part)
    body = cola.make_round(prob, part, cfg)
    cert = metrics.certificate_recorder(prob, part, env, graph, 1e-3)
    stream = schedule.ScheduleProgram(parts=schedule.participation_parts(
        k, cfg.participation, dtype=torch.float32, run_seed=0, device="cuda",
        cert=cert)).stream_fn()
    state = cola.init_state(prob, part)
    t_next = 0

    def one():
        nonlocal state, t_next
        s_t = stream(t_next)
        state = body(state, env, s_t["w"], s_t["active"])
        t_next += 1

    out = timed_rounds(torch, one, rounds)
    out["sampler_device_ms"] = device_ms(torch, lambda: stream(0), 10)
    del env
    return out


def cohort_profile(torch, schedule, prob, graph, cfg, rounds: int) -> dict:
    """The cohort round as ``_run_cola_cohort`` runs it: the sampler's
    generator (K-hash, top-K', sort, mask), then the gather / local solve
    / in-place scatter round body; ``timed_rounds``, and the sampler alone
    in device ms."""
    from repro_torch.core import cola, partition
    k = graph.num_nodes
    part = partition.make_partition(prob.n, k)
    env = cola.build_env(prob, part)
    step = cola._cohort_round(prob, part, cfg, env)
    stream = schedule.ScheduleProgram(parts=schedule.cohort_parts(
        k, cfg.participation, dtype=torch.float32, run_seed=0,
        device="cuda")).stream_fn()
    state = cola.init_state(prob, part)
    t_next = 0

    def one():
        nonlocal t_next
        step(state, env, stream(t_next), None)
        t_next += 1

    out = timed_rounds(torch, one, rounds)
    s_t = stream(0)
    idx = s_t["cohort_idx"]
    rows = state.v_stack.index_select(0, idx)
    out["sampler_device_ms"] = device_ms(torch, lambda: stream(0), 10)
    # the round's write-back of the cohort's v rows, in place (what the
    # body does) and out of place (a new (K, d) tensor, as an eager
    # ``.at[idx].set`` would make it)
    out["scatter_in_place_device_ms"] = device_ms(
        torch, lambda: state.v_stack.index_copy_(0, idx, rows), 10)
    out["scatter_out_of_place_device_ms"] = device_ms(
        torch, lambda: state.v_stack.index_copy(0, idx, rows), 3)
    out["scatter_bound_ms"] = 2 * rows.numel() * 4 / HBM_BYTES_PER_S * 1e3
    del env, state, rows
    torch.cuda.empty_cache()
    return out


def cohort_run(torch, rt, cd_glm, schedule, topology, k: int) -> dict:
    """run_cohort at K clients: ridge through its dual mapping at the
    epsilon dataset's feature width (d = 2,000), 2 samples per client
    (n = 2K), lambda = 0.01, K' = 1,000 sampled per round over
    implicit_complete(K), the gap recorder every 5 rounds, 20 rounds, no
    eps; the data drawn on the card. Peak device memory beside it."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = regression_on_device(torch, 2 * k, EPS_FEATURES, seed=1)
    prob = rt.PROBLEMS["ridge_dual"](x, y, 1e-2, device="cuda")
    graph = topology.implicit_complete(k)
    cfg = rt.ColaConfig(kappa=1.0,
                        participation=schedule.SampleConfig(k_active=1_000))
    if cfg.participation.resolve_mode(k) != "cohort":
        fail(f"run_cohort: K={k} does not resolve to cohort mode")
    peak = {}

    def profile():
        # the run's peak, read before the profile allocates its own env
        peak["run"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return cohort_profile(torch, schedule, prob, graph, cfg, 5)

    run = main_run(torch, rt, cd_glm, "run_cohort", prob, graph, cfg, 20,
                   kernel="cd_gram", other="cd_residual", profile=profile,
                   check_gap=False, recorder="gap", record_every=5,
                   executor="block", block_size=8, keep_state=True,
                   extra={"k_active": 1_000, "samples_per_client": 2,
                          "lam": 1e-2, "graph": "implicit_complete"})
    state = run.pop("state")
    touched = int((state.x_parts != 0).any(dim=1).sum())
    if not 1_000 <= touched <= 20 * 1_000:
        fail(f"run_cohort: {touched} clients moved, want between one "
             "cohort (1,000) and 20 cohorts")
    row = {"phase": "run_cohort_memory", "clients": k,
           "max_memory_allocated_bytes": peak["run"],
           "profile_max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated(),
           "clients_updated": touched,
           "gap_first_last": [run["raw_history"]["gap"][0],
                              run["raw_history"]["gap"][-1]]}
    emit(row)
    del prob, x, y, state
    torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# attacks and robust mixing
# ---------------------------------------------------------------------------

# the full-width Byzantine: the reference's attack on its torus
# (benchmarks/attack_smoke.py), two of 16 nodes sending -10x their state
# from round 5 on
FULL_BYZANTINE = dict(nodes=(0, 10), mode="sign_flip", scale=10.0, start=5,
                      seed=1)
ROBUST_MODES = ("trim", "median", "clip")
# a full-width robust gossip step, card against CPU: the output within
# GATE_RTOL and GATE_ATOL * max|v| (the same gate, fp32 products summed in
# another order); the flags equal and the center bitwise
GATE_RTOL, GATE_ATOL = 1e-5, 1e-6


def small_attack_phase(torch, rt, topo, synthetic, cd_glm, tmet, attack,
                       bl) -> None:
    """Attacked and defended runs, the card against the CPU, on
    connected_cycle(8, 2), lasso, gap+certificate with eps 0.5 (the honest
    cohort's certificate): each robust mode crossed with a Byzantine sign
    flip and random payloads, each run also holding a stale free rider,
    an identity link corruption and an eavesdropper, through each CD
    kernel (n_k = 8 on the Gram kernel, n_k = 300 > d = 200 on the
    residual kernel); int8 with EF and trim under a sign flip
    (``compare_wire_runs``); DGD and DIGing with trim."""
    import numpy as np
    from repro_torch.core.partition import make_partition
    rounds, nodes, block = 20, 8, 8
    graph = topo.connected_cycle(nodes, 2)

    def scenarios(byz_mode):
        return [attack.Byzantine(nodes=(1, 6), mode=byz_mode,
                                 scale=3.0 if byz_mode == "sign_flip"
                                 else 0.5, start=4, seed=2),
                attack.FreeRider(nodes=(3,), stale=True, start=8),
                attack.LinkCorruption(edges=((0, 1),), scale=1.0),
                attack.Eavesdropper(nodes=(1, 2))]

    cert_keys = ("primal", "dual", "gap", "consensus_violation",
                 "local_gap_max", "grad_disagreement_max", "cond9_nodes",
                 "cond10_nodes", "consensus_residual")
    for kernel, n_samples, n_features, kappa in (
            ("cd_gram", 200, 64, 2.0), ("cd_residual", 200, 2400, 1.0)):
        x, y, _ = synthetic.regression(n_samples, n_features, seed=0,
                                       sparsity_solution=0.2)
        for mode in ROBUST_MODES:
            for byz_mode in ("sign_flip", "random"):
                name = f"small attack {mode} {byz_mode} {kernel}"
                hist, taps, launches = {}, {}, {}
                for dev in ("cuda", "cpu"):
                    prob = rt.PROBLEMS["lasso"](x, y, 5e-2, box=5.0,
                                                device=dev)
                    cd_glm.reset_launches()
                    res = rt.run_cola(
                        prob, graph, rt.ColaConfig(kappa=kappa, robust=mode),
                        rounds, record_every=2, recorder="gap+certificate",
                        eps=0.5, attacks=scenarios(byz_mode), device=dev,
                        block_size=block)
                    launches[dev] = dict(cd_glm.LAUNCHES)
                    hist[dev], taps[dev] = res.history, res.taps.cpu()
                executed = executed_rounds(hist["cuda"], rounds, block)
                if launches["cuda"][kernel] != executed or \
                        launches["cpu"][kernel]:
                    fail(f"{name}: launches {launches}, want {executed} on "
                         "the card and none on the CPU")
                worst = compare_histories(name, hist, cert_keys,
                                          scale_key="primal")
                if hist["cuda"]["violated_round"] != \
                        hist["cpu"]["violated_round"]:
                    fail(f"{name}: violated rounds differ")
                t_err = float((taps["cuda"] - taps["cpu"]).abs().max())
                t_scale = float(taps["cpu"].abs().max())
                if not t_err <= SMALL_RTOL * max(t_scale, 1e-30):
                    fail(f"{name}: card and CPU taps differ by {t_err}")
                emit({"phase": "small", "problem": "lasso", "robust": mode,
                      "byzantine": byz_mode, "kernel": kernel,
                      "n_k": -(-n_features // nodes), "nodes": nodes,
                      "graph": graph.name,
                      "attacks": "Byzantine(1, 6), stale FreeRider(3), "
                                 "identity LinkCorruption(0->1), "
                                 "Eavesdropper(1, 2)",
                      "stop_round": hist["cuda"]["stop_round"],
                      "violated_round": hist["cuda"]["violated_round"],
                      "launches": launches["cuda"],
                      "max_abs_diff": {**worst, "taps": t_err},
                      "rtol": SMALL_RTOL, "atol": "rtol * max|primal|"})
    # the quantized wire composed with the attack and the defense
    x, y, _ = synthetic.regression(200, 64, seed=0, sparsity_solution=0.2)
    res, launches = {}, {}
    for dev in ("cuda", "cpu"):
        prob = rt.PROBLEMS["lasso"](x, y, 5e-2, box=5.0, device=dev)
        part = make_partition(prob.n, nodes)
        rec = tmet.ComposedRecorder((
            tmet.GapRecorder(prob, part),
            wire_probe(torch, tmet, nodes, prob.d, dev)))
        cd_glm.reset_launches()
        res[dev] = rt.run_cola(
            prob, graph, rt.ColaConfig(kappa=2.0, wire="int8",
                                       robust="trim"), rounds,
            record_every=2, recorder=rec, seed=3, device=dev,
            block_size=block,
            attacks=[attack.Byzantine(nodes=(1, 6), scale=3.0, start=4)])
        launches[dev] = dict(cd_glm.LAUNCHES)
    if launches["cuda"]["cd_gram"] != rounds or launches["cpu"]["cd_gram"]:
        fail(f"small attack int8: launches {launches}")
    cmp = compare_wire_runs("small attack int8 trim", res, "int8", True)
    emit({"phase": "small", "problem": "lasso", "wire": "int8",
          "error_feedback": True, "robust": "trim",
          "byzantine": "sign_flip", "kernel": "cd_gram", "n_k": 8,
          "nodes": nodes, "graph": graph.name,
          "launches": launches["cuda"], **cmp, "rtol": SMALL_RTOL,
          "atol": "rtol * max|primal|"})
    # the baselines' robust mixing
    x, y, _ = synthetic.regression(800, 64, seed=5)
    lam = 1e-2
    step = 1.0 / smooth_lipschitz(torch, torch.as_tensor(x), lam)
    for name, run in (("dgd", bl.run_dgd), ("diging", bl.run_diging)):
        hist, w_stack = {}, {}
        for dev in ("cuda", "cpu"):
            prob = bl.make_consensus_problem(x, y, nodes, loss="square",
                                             reg="l2", lam=lam, device=dev)
            r = run(prob, graph, step=step, rounds=30, record_every=5,
                    robust="trim", device=dev, block_size=8)
            hist[dev], w_stack[dev] = r.history, r.w_stack.cpu()
        worst = compare_histories(f"small {name} trim", hist,
                                  ("objective", "consensus"))
        w_err = float((w_stack["cuda"] - w_stack["cpu"]).abs().max())
        if not w_err <= SMALL_RTOL * max(float(w_stack["cpu"].abs().max()),
                                         1e-30):
            fail(f"small {name} trim: card and CPU iterates differ by "
                 f"{w_err}")
        emit({"phase": "small", "baseline": name, "robust": "trim",
              "nodes": nodes, "graph": graph.name, "d": 64,
              "max_abs_diff": {**worst, "w_stack": w_err},
              "rtol": SMALL_RTOL, "atol": "rtol * max|column|"})


def attack_schedule(graph, rounds: int, attacks, d: int) -> tuple:
    """The port's materialized schedule of a run on ``graph`` without churn,
    transformed by ``attacks`` as ``run_cola`` does: ``(sched, info)``."""
    import numpy as np
    from repro_torch import attack
    from repro_torch.core import cola, topology
    sched = cola._materialize_schedule(
        graph, rounds, None, None, "freeze", 0,
        topology.metropolis_weights(graph), np.float32)
    if not attacks:
        return sched, None
    ctx = attack.AttackContext(graph=graph, rounds=rounds,
                               k=graph.num_nodes, d=d, dtype=np.float32,
                               seed=0, device="cuda")
    return attack.apply_attacks(sched, attacks, ctx)


def attack_profile(torch, mixing, quant, prob, graph, cfg, attacks,
                   rounds: int, side: dict) -> dict:
    """A run's rounds replayed on the card as the block driver runs them
    (the round's W and attack entries, then the round body), from the
    initial state:

    * round by round: the edges the gate rejects (``gate_flags`` on the
      round's wire payloads: for a defended run its own mode, for an
      undefended run what trim would reject; on a quantized wire the
      dequantized payloads, as the body mixes them), and the tapped
      nodes' pre-round payloads ``_apply_payload_attack(v_t)[taps]``
      (``side["taps"]``, held bitwise against the run's taps);
    * ``timed_rounds`` over the same rounds (device ms over 4 of them:
      a defended round is ~250 launches);
    * one gossip step (the robust mix, or the linear mix when undefended)
      on the last round's payloads in device ms and its peak device
      memory above what was allocated before it, beside the bytes bound
      of one read and one write of the (K, d) stack, and for a defended
      run its device ms by kernel (``device_profile``).

    ``side`` also gets the last round's honest stack ``v`` and payloads
    ``v_send`` for ``gate_step_check``."""
    import numpy as np
    from repro_torch.core import cola, partition
    k = graph.num_nodes
    part = partition.make_partition(prob.n, k)
    env = cola.build_env(prob, part)
    body = cola.make_round(prob, part, cfg)
    sched, info = attack_schedule(graph, rounds, attacks, prob.d)
    names = tuple(n for n in (info.entry_names if info else ())
                  if n not in ("dishonest", "bias"))
    if info is not None and "bias" in info.entry_names:
        fail("attack_profile: random payloads are not replayed here")
    on_card = lambda a: torch.as_tensor(np.array(a), device="cuda")
    w = [on_card(sched["w"][t]) for t in range(rounds)]
    active = on_card(sched["active"][0])
    atk = [{n: on_card(sched["atk_" + n][t]) for n in names} or None
           for t in range(rounds)]
    taps = info.tap_nodes if info else ()
    ids = torch.arange(k, device="cuda")
    gate_mode = cfg.robust or "trim"
    quantized = quant.is_quantized(cfg.wire)
    draws = quant.wire_uniforms(0, k, prob.d, "cuda") if quantized else None
    state = cola.init_state(prob, part)
    if quantized:
        state = cola._arm_wire_state(state, cfg, draws)
    rejected, tap_rows = [], []
    for t in range(rounds):
        v_send = cola._apply_payload_attack(state.v_stack, atk[t])
        honest = None if v_send is state.v_stack else state.v_stack
        g_send, g_self = v_send, honest
        if quantized:
            u0 = draws(t, 0)
            _, _, g_self, _ = quant.encode(state.v_stack, cfg.wire, u0,
                                           state.ef)
            g_send = g_self if honest is None else quant.dequantize(
                *quant.quantize_rows(v_send + state.ef, cfg.wire, u0))
            if honest is None:
                g_self = None
        flags = mixing.gate_flags(w[t], g_send, ids, gate_mode,
                                  trim=cfg.robust_trim, clip=cfg.robust_clip,
                                  self_override=g_self)
        rejected.append(int(flags.sum()))
        if taps:
            tap_rows.append(v_send[list(taps)])
        side["v"], side["v_send"] = state.v_stack, v_send
        state = body(state, env, w[t], active, None, atk=atk[t],
                     **cola._round_draws(draws, t))
    side["taps"] = torch.stack(tap_rows) if taps else None
    side["w"] = w[-1]
    t_next = 0

    def one():
        nonlocal state, t_next
        t = t_next % rounds
        state = body(state, env, w[t], active, None, atk=atk[t],
                     **cola._round_draws(draws, t))
        t_next += 1

    out = timed_rounds(torch, one, rounds, device_reps=4)
    v, v_send = side["v"], side["v_send"]
    self_stack = None if v_send is v else v
    if cfg.robust is not None:
        step = lambda: mixing.robust_mix_dense(
            w[-1], v_send, cfg.robust, trim=cfg.robust_trim,
            clip=cfg.robust_clip, self_stack=self_stack)
    else:
        step = lambda: mixing.mix_power_wire(w[-1], v_send, self_stack, 1)
    out["mix_device_ms_per_step"] = device_ms(torch, step, 3)
    if cfg.robust is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof = device_profile(torch, step, (time.perf_counter() - t0) * 1e3,
                              top=8)
        out["mix_top_kernels"] = prof["top_kernels"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    out["mix_peak_bytes_above_live"] = \
        torch.cuda.max_memory_allocated() - before
    out["mix_bytes_bound_ms"] = 2 * v.numel() * 4 / HBM_BYTES_PER_S * 1e3
    out["mix_kind"] = cfg.robust or "linear"
    out["gate_mode_counted"] = gate_mode
    out["rejected_edges_per_round"] = rejected
    del env
    return out


def attack_run(torch, rt, cd_glm, mixing, quant, attack, name, prob, graph,
               *, robust, attacked, wire="fp32", eavesdrop=False) -> dict:
    """run_a's lasso on torus_2d(4, 4) with ``FULL_BYZANTINE`` (or clean),
    ``robust``, gap+certificate with eps 1e-3, 20 rounds in blocks of 8:
    ``main_run`` (launches, history; the gap must fall in a clean run, and
    the rows stay finite unless the attack meets no defense or only
    clipping), then a ``<name>_attack`` row: ``attack_profile``'s
    replay (rejected edges per round, the mix's device ms per gossip step
    against its bound, ms per round), the run's peak device memory,
    ``violated_round``, ``stop_round`` and the last Lemma-1 residual. With
    an eavesdropper on nodes (0, 3) the run's taps must equal, bitwise,
    ``_apply_payload_attack`` of the tapped rows of each round's
    pre-round state, taken from the replay."""
    cfg = rt.ColaConfig(kappa=1.0, robust=robust, wire=wire)
    attacks = ([attack.Byzantine(**FULL_BYZANTINE)] if attacked else []) \
        + ([attack.Eavesdropper(nodes=(0, 3))] if eavesdrop else [])
    side, peak = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()

    def profile():
        peak["run"] = torch.cuda.max_memory_allocated()
        return attack_profile(torch, mixing, quant, prob, graph, cfg,
                              attacks, 20, side)

    run = main_run(torch, rt, cd_glm, name, prob, graph, cfg, 20,
                   kernel="cd_gram", other="cd_residual", profile=profile,
                   check_gap=not attacked,
                   finite=not attacked or robust in ("trim", "median"),
                   keep_state=True, recorder="gap+certificate", eps=1e-3,
                   record_every=1, executor="block", block_size=8,
                   attacks=attacks or None,
                   extra={"graph": graph.name, "robust": robust,
                          "wire": wire, "attack": FULL_BYZANTINE
                          if attacked else None,
                          "eavesdropper": [0, 3] if eavesdrop else None})
    h = run["raw_history"]
    row = {"phase": name + "_attack", "robust": robust, "wire": wire,
           "attacked": attacked,
           "ms_per_round": run["ms_per_round"],
           "device_ms_per_round": run["device_ms_per_round"],
           "device_idle_share": run["device_idle_share"],
           "mix_kind": run["mix_kind"],
           "mix_top_kernels": run.get("mix_top_kernels"),
           "mix_device_ms_per_step": run["mix_device_ms_per_step"],
           "mix_bytes_bound_ms": run["mix_bytes_bound_ms"],
           "mix_over_bound": run["mix_device_ms_per_step"]
           / run["mix_bytes_bound_ms"],
           "mix_peak_bytes_above_live": run["mix_peak_bytes_above_live"],
           "run_peak_bytes": peak["run"], "run_peak_bytes_above_live":
           peak["run"] - live,
           "violated_round": h.get("violated_round"),
           "stop_round": h["stop_round"],
           "consensus_residual_last": h["consensus_residual"][-1],
           "gap_last": h["gap"][-1],
           "gate_counted": run["gate_mode_counted"],
           "rejected_edges_per_round": run["rejected_edges_per_round"]}
    if eavesdrop:
        got, want = run["taps"], side["taps"]
        if got is None or tuple(got.shape) != tuple(want.shape) \
                or not torch.equal(got, want):
            fail(f"{name}: the taps are not the tapped rows' wire payloads "
                 "of the replayed pre-round states")
        row["taps_checked"] = {"shape": list(got.shape), "bitwise": True,
                               "from": "attack_profile's replay"}
    emit(row)
    run["side"] = side
    return run


def stable_sort_center(torch, w, v_send, v):
    """The gate's center as the port computes it, but with a stable sort
    (PyTorch's radix sort per coordinate at 16 slots) where the port's
    ``mixing._center`` sorts unstably (bitonic)."""
    k, d = v.shape
    ids = torch.arange(k, device=v.device)
    mask = (w != 0) | (ids[None, :] == ids[:, None])
    counts = torch.sum(mask.to(torch.int64), dim=1)
    guarded = torch.where(mask[:, None, :], v_send.T.contiguous()[None],
                          torch.finfo(v.dtype).max)
    guarded[ids, :, ids] = v
    srt = torch.sort(guarded, dim=-1, stable=True).values
    target = (counts - 1) // 2
    return srt.gather(-1, target[:, None, None].expand(k, d, 1))[..., 0] + 0.0


def rank_count_center(torch, w, v_send, v):
    """The reference's K <= 32 formulation of the gate's center: the
    (counts-1)//2-th order statistic by an O(K^2) comparison count over
    (R, K, K, d) boolean temporaries (``src/repro/core/mixing.py``'s
    ``_gate_center_flags``), for comparison with the port's sort."""
    k = v.shape[0]
    ids = torch.arange(k, device=v.device)
    self_hot = ids[None, :] == ids[:, None]
    mask = (w != 0) | self_hot
    counts = torch.sum(mask.to(torch.int64), dim=1)
    guarded = torch.where(mask[:, :, None], v_send[None],
                          torch.finfo(v.dtype).max)
    guarded[ids, ids] = v
    lt = guarded[:, :, None, :] < guarded[:, None, :, :]
    eq = guarded[:, :, None, :] == guarded[:, None, :, :]
    ilt = (ids[:, None] < ids[None, :])[None, :, :, None]
    rank = torch.sum(lt | (eq & ilt), dim=1)
    del lt, eq
    sel = rank == ((counts - 1) // 2)[:, None, None]
    return torch.sum(torch.where(sel, guarded, 0.0), dim=1)


def gate_step_check(torch, mixing, w, v, v_send) -> dict:
    """One full-width robust gossip step per mode on the attacked (K, d)
    stack (run_atk_trim's last round: the honest states ``v``, the
    payloads ``v_send`` with two nodes at -10x), on the card against the
    same functions' plain run on the CPU: the gate flags equal, the
    trim/median center bitwise, the output within ``GATE_RTOL`` and
    ``GATE_ATOL`` * max|v|. Then the center's formulations on the card:
    the port's sort, the same with a stable sort (``stable_sort_center``)
    and the reference's comparison count (``rank_count_center``), each in
    device ms with its peak memory, held bitwise to each other."""
    k = v.shape[0]
    ids = torch.arange(k, device="cuda")
    c = lambda t: t.cpu()
    out = {"phase": "gate_step", "shape": f"K={k}, d={v.shape[1]}",
           "rtol": GATE_RTOL, "atol": f"{GATE_ATOL} * max|v|"}
    center = mixing.robust_center(w, v_send, ids, self_override=v)
    center_cpu = mixing.robust_center(c(w), c(v_send), c(ids),
                                      self_override=c(v))
    if not torch.equal(center.cpu(), center_cpu):
        fail("gate_step: the card's center is not the CPU's bitwise")
    atol = GATE_ATOL * float(v_send.abs().max())
    for mode in ROBUST_MODES:
        flags = mixing.gate_flags(w, v_send, ids, mode, self_override=v)
        flags_cpu = mixing.gate_flags(c(w), c(v_send), c(ids), mode,
                                      self_override=c(v))
        if not torch.equal(flags.cpu(), flags_cpu):
            fail(f"gate_step {mode}: card and CPU gate flags differ")
        mixed = mixing.robust_mix_dense(w, v_send, mode, self_stack=v).cpu()
        mixed_cpu = mixing.robust_mix_dense(c(w), c(v_send), mode,
                                            self_stack=c(v))
        err = (mixed - mixed_cpu).abs()
        if not bool((err <= atol + GATE_RTOL * mixed_cpu.abs()).all()):
            fail(f"gate_step {mode}: card and CPU outputs differ by up to "
                 f"{float(err.max())}")
        out[mode] = {"rejected_edges": int(flags.sum()),
                     "max_abs_diff": float(err.max())}
    out["center_bitwise"] = True
    for key, fn in (("sort", lambda: mixing.robust_center(
            w, v_send, ids, self_override=v)),
                    ("stable_sort", lambda: stable_sort_center(
                        torch, w, v_send, v)),
                    ("rank_count", lambda: rank_count_center(
                        torch, w, v_send, v))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        if not torch.equal(got, center):
            fail(f"gate_step: the {key} center is not the port's bitwise")
        del got
        out[f"center_{key}"] = {"device_ms": device_ms(torch, fn, 3),
                                "peak_bytes_above_live": peak}
    emit(out)
    return out


def baselines_robust_phase(torch, bl, topology, x, y, plain: dict) -> dict:
    """DGD and DIGing with robust="trim" on the baselines' row split
    (``baselines_phase``'s problem, step and graph), 20 rounds: the
    objective must fall and every row be finite; ms per round beside the
    plain runs' of this script's ``baselines`` phase."""
    lam, rounds = 1e-4, 20
    prob = bl.make_consensus_problem(x, y, NODES, loss="square", reg="l2",
                                     lam=lam, device="cuda")
    step = 1.0 / smooth_lipschitz(torch, x, lam)
    graph = topology.ring(NODES)
    out = {}
    for name, run, make in (("dgd", bl.run_dgd, bl.dgd_round),
                            ("diging", bl.run_diging, bl.diging_round)):
        res = run(prob, graph, step=step, rounds=rounds, record_every=1,
                  robust="trim", device="cuda", block_size=8)
        h = res.history
        if not all(math.isfinite(v) for v in h["objective"] + h["consensus"]):
            fail(f"baselines_robust {name}: non-finite rows")
        if not h["objective"][-1] < h["objective"][0]:
            fail(f"baselines_robust {name}: objective did not decrease")
        round_fn, carry = make(prob, graph, step=step, robust="trim")

        def one():
            nonlocal carry
            carry = round_fn(carry)

        # 3 rounds behind the sleep kernel: a DIGing round with trim is
        # two robust mixes, ~250 launches
        timing = timed_rounds(torch, one, 5, device_reps=3)
        out[name] = {"phase": "baselines_robust", "method": name,
                     "robust": "trim", "nodes": NODES, "rounds": rounds,
                     **timing,
                     "plain_ms_per_round": plain[name]["ms_per_round"],
                     "plain_device_ms_per_round":
                         plain[name]["device_ms_per_round"],
                     "objective_first_last": [h["objective"][0],
                                              h["objective"][-1]]}
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
    # Zamba2-7B's shared attention (32 / 32 heads, G = 1, hd 112, padded
    # to 128 inside the kernel), sliding window 4,096: the same wrapped
    # ring and chunk, and its decode
    cases.append(("sliding_hd112", 2, 32, 32, 112, "sliding", 4096,
                  rows(2, fresh), kv, None))
    cases.append(("sliding_hd112_2src", 2, 32, 32, 112, "sliding", 4096,
                  rows(2, fresh), kv, 4096))
    cases.append(("decode_sliding_hd112_2src", 2, 32, 32, 112, "sliding",
                  4096, rows(2, [4856]), rows(2, ring_d + [4856]), 4096))
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
    # SeamlessM4T-medium's encoder self attention (serve_encdec_a): 1,500
    # frames, bidirectional (mode cross, q_pos = kv_pos = 0 .. 1,499)
    frames = rows(8, range(1500))
    cases.append(("encoder", 8, 16, 16, 64, "cross", 0, frames, frames,
                  None))
    # its decoder's cross attention at a decode step: one query (position
    # 0) against the 1,500 encoder keys, a range that is not a multiple of
    # the split kernel's tile
    cases.append(("decode_cross", 8, 16, 16, 64, "cross", 0,
                  torch.zeros((8, 1), dtype=torch.int32), frames, None))
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
        # (B, Sq, Skv); mode cross's mask is (B, 1, Skv), the same for
        # every query
        mask = mask_fn(mode, q_pos, kv_pos, window).expand(b, sq, skv)
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


def split_combine_phase(torch, fa, mask_fn, case: str = "decode") -> dict:
    """The split-KV kernel and the combine kernel each against its plain
    version on the same inputs, at a decode shape of ``attn_cases`` in
    bf16 (Qwen3-4B's by default; keys as one source): the split kernel's
    partials against ``flash_split_plain``, the combine kernel against
    ``flash_combine_plain`` on the kernel's partials."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    _, b, h, kvh, hd, mode, window, q_pos, kv_pos, _ = next(
        c for c in attn_cases(torch) if c[0] == case)
    q_pos, kv_pos = q_pos.cuda(), kv_pos.cuda()
    sq, skv = q_pos.shape[1], kv_pos.shape[1]
    pairs = int(mask_fn(mode, q_pos, kv_pos, window).expand(b, sq, skv).sum())
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
    emit({"phase": "split_combine", "case": case,
          "shape": f"decode, bf16 (B={b}, Sq=1, Skv={skv}, {h}/{kvh} heads, "
                   f"hd {hd}, {mode})", "splits": splits,
          "split_max_rel_err": split_err, **res})
    return res


def cache_bytes(cache) -> int:
    """Bytes of a cache: a KV cache, or a recurrent family's nested tree."""
    if isinstance(cache, dict):
        return sum(cache_bytes(t) for t in cache.values())
    if isinstance(cache, list):
        return sum(cache_bytes(t) for t in cache)
    return cache.numel() * cache.element_size()


def want_flash_modes(torch, fa, cfg, prompt_len: int, gen: int, *,
                     enc_len: int = 0, prefix: int = 0) -> dict:
    """Launches of each flash kernel in one ``serve``, by kernel and mask
    mode ("kernel/mode"): the prefill's route once per attention layer (a
    MoE group's dense layers and its MoE layer) over the ``prefix`` +
    ``prompt_len`` positions, the decode steps' route (split + combine)
    once per attention layer and step. encdec: the encoder's layers (mode
    cross, Sq = enc_len) twice (``serve`` encodes once for the decode
    steps and ``prefill`` once more), and each decoder layer's cross
    attention once more at the prefill and at each decode step."""
    from repro_torch.models.blocks import _attn_mode
    from repro_torch.models.transformer import num_attn_layers
    g = cfg.num_heads // cfg.num_kv_heads
    dtype = getattr(torch, cfg.dtype)
    calls = [(prefix + prompt_len, _attn_mode(cfg), num_attn_layers(cfg)),
             (1, _attn_mode(cfg), num_attn_layers(cfg) * (gen - 1))]
    if cfg.family == "encdec":
        calls += [(enc_len, "cross", 2 * cfg.encoder_layers),
                  (prompt_len, "cross", cfg.num_layers),
                  (1, "cross", cfg.num_layers * (gen - 1))]
    want = {}
    for sq, mode, n in calls:
        route = fa.select_route(dtype, sq, g)
        for kernel in (("flash_split", "flash_combine") if route == "split"
                       else (f"flash_{route}",)):
            key = f"{kernel}/{mode}"
            want[key] = want.get(key, 0) + n
    return want


def want_flash_launches(torch, fa, cfg, prompt_len: int, gen: int,
                        **kw) -> dict:
    """``want_flash_modes`` summed over the modes, by kernel."""
    want = {name: 0 for name in fa.LAUNCHES}
    for key, n in want_flash_modes(torch, fa, cfg, prompt_len, gen,
                                   **kw).items():
        want[key.split("/")[0]] += n
    return want


@contextlib.contextmanager
def flash_modes(fa):
    """While open, tallies the flash kernels' launches by kernel and mask
    mode ("kernel/mode") in the yielded dict, from the wrapper's own
    launch function (``LAUNCHES`` counts by kernel only)."""
    tally, launch = {}, fa._launch

    def counted(route, q, kv, pos, out, mode, *args, **kw):
        before = dict(fa.LAUNCHES)
        launch(route, q, kv, pos, out, mode, *args, **kw)
        for name, n in fa.LAUNCHES.items():
            if n != before[name]:
                key = f"{name}/{mode}"
                tally[key] = tally.get(key, 0) + n - before[name]

    fa._launch = counted
    try:
        yield tally
    finally:
        fa._launch = launch


def decode_vs_forward(torch, api, params, tokens, prompt: int) -> dict:
    """The decode steps after a prefill of ``prompt`` tokens (teacher
    forced with ``tokens``) against the forward over all of ``tokens``:
    the last position's logits."""
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": tokens})
        cache = api.init_cache(params, tokens.shape[0], tokens.shape[1])
        _, cache = api.prefill(params, {"tokens": tokens[:, :prompt]}, cache)
        for t in range(prompt, tokens.shape[1]):
            dec, cache = api.decode_step(params, tokens[:, t:t + 1], t,
                                         cache)
    a, b = dec[:, 0].float(), full[:, -1].float()
    return {"prompt": prompt, "decode_steps": tokens.shape[1] - prompt,
            "max_abs_diff": float((a - b).abs().max()),
            "max_abs_logit": float(b.abs().max()),
            "rel_l2": float((a - b).norm() / b.norm())}


def decode_step_bound(torch, cfg, params, cache, decode_kw, batch: int,
                      s0: int, gen: int) -> dict:
    """The least time of one decode step (``bound``), the mean over the
    run's gen - 1 steps at positions s0 .. s0 + gen - 2. Bytes: the
    weights the step multiplies by (the decoder's layers, the hybrid's
    shared block, ``ln_f``, ``unembed``; not the embed table, of which it
    gathers B rows, nor encdec's encoder or vlm's patch projection, which
    it does not run), the KV cache's slots up to the step's position (a
    ring: at most its slots), a recurrent state read and written whole,
    and encdec's cross K/V. Operations: 2 per weight and sequence, and 4
    hd per head and (query, key) pair."""
    from repro_torch.models.transformer import num_attn_layers
    read = {n: t for n, t in params.items()
            if n != "embed" and not n.startswith(("enc_", "patch_proj"))}
    w_bytes = sum(t.numel() * t.element_size() for t in read.values())
    w_count = sum(t.numel() for n, t in read.items() if t.dim() >= 2)
    kv = cache.get("attn", cache)
    slots = kv["k"].shape[-3]
    keys = statistics.fmean(min(s0 + i + 1, slots) for i in range(gen - 1))
    kv_bytes = cache_bytes(kv) * keys / slots
    state_bytes = 2 * (cache_bytes(cache) - cache_bytes(kv))
    cross = decode_kw.get("enc_kv", ())
    cross_bytes = cache_bytes(list(cross))
    cross_keys = cross[0].shape[2] * cfg.num_layers if cross else 0
    pairs = batch * (keys * num_attn_layers(cfg) + cross_keys)
    nbytes = w_bytes + kv_bytes + state_bytes + cross_bytes
    flops = 2.0 * w_count * batch \
        + 4.0 * cfg.resolved_head_dim * cfg.num_heads * pairs
    ms, by = bound(nbytes, flops, BF16_TC_FLOPS)
    return {"decode_bound_ms": ms, "decode_bound_by": by,
            "decode_bound_bytes": {"weights": w_bytes, "kv_cache": kv_bytes,
                                   "recurrent_state": state_bytes,
                                   "cross_kv": cross_bytes},
            "decode_bound_of": "one decode step's reads (mean over the "
                               "run's steps), bf16 tensor-core peak"}


def serve_phase(torch, rt, fa, serve_mod, name, cfg, *, batch, prompt_len,
                gen, fwd_tol, cut=None, enc_len: int = 0,
                users: str | None = None) -> dict:
    """Serve ``cfg`` once through ``launch.serve.serve`` with the flash
    count zeroed just before and read just after; check the launches (by
    kernel and by mask mode), the logits' finiteness, the last step
    against a full ``forward``, and profile one decode step and the
    prefill. A hybrid model's KV cache is its cache's "attn". The
    frontend input (vlm's patches, encdec's ``enc_len`` frames) is drawn
    from the phase's generator and fed to every call."""
    api = rt.build_model(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = api.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    params_alloc = torch.cuda.memory_allocated() - m0
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device="cuda")
    front = serve_mod.frontend_inputs(cfg, batch, enc_len, g, "cuda")
    p0 = rt.models.transformer.prefix_len(cfg, front)
    serve_mod.serve(api, params, prompt, 2, device="cuda",
                    frontend=front)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with flash_modes(fa) as modes:
        res = serve_mod.serve(api, params, prompt, gen, device="cuda",
                              frontend=front)
        torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    kw = dict(enc_len=enc_len, prefix=p0)
    want = want_flash_launches(torch, fa, cfg, prompt_len, gen, **kw)
    want_modes = want_flash_modes(torch, fa, cfg, prompt_len, gen, **kw)
    if launches != want or modes != want_modes:
        fail(f"{name}: flash launches {launches} ({modes} by mode), want "
             f"{want} ({want_modes}): one per attention layer for the "
             f"prefill, one split and one combine per layer for each of "
             f"the {gen - 1} decode steps, and encdec's encoder and cross "
             "attention")
    if not bool(torch.isfinite(res.logits).all()):
        fail(f"{name}: non-finite logits")
    # the last decode step against a full forward over the same tokens
    tokens = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": tokens, **front})
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
    kv = res.cache.get("attn", res.cache)
    if cfg.attention == "sliding" and prompt_len + gen > cfg.window:
        pos = kv["pos"][0, 0]
        total = prompt_len + gen - 1
        if sorted(pos.tolist()) != list(range(total - cfg.window, total)):
            fail(f"{name}: the ring does not hold the last {cfg.window} "
                 "positions")
    # profiler windows: the prefill, and one decode step on the final cache
    # (one free slot is left: the cache holds prompt + gen slots)
    pre_batch = {"tokens": prompt, **front}
    with torch.no_grad():
        m0 = torch.cuda.memory_allocated()
        cache = api.init_cache(params, batch, p0 + prompt_len + gen)
        cache_alloc = torch.cuda.memory_allocated() - m0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(params, pre_batch, cache)
        torch.cuda.synchronize()
        prefill_host = (time.perf_counter() - t0) * 1e3
        cache = api.init_cache(params, batch, p0 + prompt_len + gen)
        prof_prefill = device_profile(
            torch, lambda: api.prefill(params, pre_batch, cache),
            prefill_host)
        tok = res.tokens[:, -1:]
        t_pos = p0 + prompt_len + gen - 1
        step = lambda: api.decode_step(params, tok, t_pos, res.cache,
                                       **res.decode_kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_host = (time.perf_counter() - t0) * 1e3
        prof_decode = device_profile(torch, step, step_host)
    steps = len(res.decode_ms)
    decode_ms = sum(res.decode_ms) / steps
    n_params = api.param_count(params)
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    step_bound = decode_step_bound(torch, cfg, params, res.cache,
                                   res.decode_kw, batch, p0 + prompt_len,
                                   gen)
    out = {"phase": name, "model": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "cut": cut, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "users": users,
           "batch": batch, "prompt": prompt_len, "gen": gen,
           "prefix_positions": p0, "encoder_frames": enc_len or None,
           "encoder_layers": cfg.encoder_layers or None,
           "cache_slots": int(kv["k"].shape[2]),
           "params": n_params, "weight_bytes": weight_bytes,
           "params_bytes_allocated": params_alloc,
           "cache_bytes_allocated": cache_alloc,
           "init_s": init_s,
           "init_peak_memory_bytes": init_peak, "launches": launches,
           "launches_by_mode": modes,
           "encode_ms": res.encode_ms,
           "prefill_ms": res.prefill_ms,
           "prefill_tok_s": batch * prompt_len / res.prefill_ms * 1e3,
           "prefill_positions_per_s":
               batch * (p0 + prompt_len) / res.prefill_ms * 1e3,
           **step_bound,
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


def serve_small_phase(torch, rt, fa, serve_mod, cfg) -> dict:
    """The card (kernel) against the CPU (plain version) in fp32, teacher
    forced with the card's tokens: per-step logits at rtol 1e-4 and atol
    1e-4 * max|logits|."""
    api = rt.build_model(cfg, device="cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    api_cpu = rt.build_model(cfg, device="cpu")
    params_cpu = {name: t.cpu() for name, t in params.items()}
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


# ---------------------------------------------------------------------------
# MoE serving: Llama-4-Maverick at full width, card vs CPU at small widths
# ---------------------------------------------------------------------------

# serve_moe_a, bf16: the forward under scatter dispatch with C >= T
# (nothing dropped) against the forward under moe_mode="dense", max|diff|
# <= MOE_MODE_TOL * max|logits|. Both route identical inputs (the MoE
# layer is the last of the one group) and run each expert on the same
# rows through batched products of one shape; the combines add one
# weighted term (top-1) in fp32. 1 % leaves room for a product the
# library tiles differently and fails a wrong slot, which moves a token's
# logits by their own size.
MOE_MODE_TOL = 1e-2
# serve_moe_small, fp32: a routing flip between the card and the CPU is
# allowed only where the CPU's top-k margin (k-th minus (k+1)-th
# probability) is below this, and that batch row is then left out of the
# logits comparison; fp32 noise moves probabilities by ~1e-7
FLIP_MARGIN = 1e-4
# serve_moe_a: decode after a 511-token prefill against the forward's last
# position, both dense, may route a token differently where bf16 rounding
# moves the router's input across a near-tie (the paths round differently
# shaped products, as FWD_TOL says); such a row is left out, and only
# where the forward's top-1 margin is below this
FLIP_MARGIN_BF16 = 2e-3


class RouteTap:
    """Records every ``mlp._router`` call while entered: the top-k indices
    and the margin between the k-th and (k+1)-th probability of each
    token, as host tensors (a sync per call: never inside a timed run)."""

    def __init__(self, torch, mlp_mod):
        self.torch, self.mlp, self.calls = torch, mlp_mod, []

    def __enter__(self):
        torch, orig = self.torch, self.mlp._router
        self.orig = orig

        def tapped(p, x_flat, k):
            w, idx, aux = orig(p, x_flat, k)
            probs = torch.softmax(x_flat.float() @ p["router"].float(), -1)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls.append((idx.cpu(), (top[:, k - 1] - top[:, k]).cpu()))
            return w, idx, aux

        self.mlp._router = tapped
        return self

    def __exit__(self, *exc):
        self.mlp._router = self.orig


def route_flips(card: RouteTap, cpu: RouteTap, rows_of, margin: float,
                name: str) -> tuple[list, list]:
    """Token rows routed differently by the two taps (call by call):
    (flips as dicts, the batch rows to leave out). A flip whose margin on
    the ``cpu`` side is not below ``margin`` fails ``name``."""
    if len(card.calls) != len(cpu.calls):
        fail(f"{name}: {len(card.calls)} router calls against "
             f"{len(cpu.calls)}")
    flips, rows = [], set()
    for i, ((ia, _), (ib, mb)) in enumerate(zip(card.calls, cpu.calls)):
        for r in (ia != ib).any(dim=1).nonzero()[:, 0].tolist():
            flip = {"call": i, "token_row": r, "batch_row": rows_of(i, r),
                    "margin": float(mb[r])}
            flips.append(flip)
            if not flip["margin"] < margin:
                fail(f"{name}: routing flip at a margin of "
                     f"{flip['margin']} (allowed below {margin}): {flip}")
            rows.add(flip["batch_row"])
    return flips, sorted(rows)


def moe_profile(torch, mlp_mod, fn, host_ms: float) -> dict:
    """``fn`` once under ``torch.profiler`` with every ``moe_apply`` call
    inside a ``record_function`` range: the device ms of the kernels
    launched in those ranges (the MoE layer), of all kernels, and the
    idle share of ``host_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    orig = mlp_mod.moe_apply

    def annotated(*args, **kw):
        with record_function("moe_apply"):
            return orig(*args, **kw)

    mlp_mod.moe_apply = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        mlp_mod.moe_apply = orig
    dev = lambda e: getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)
    events = prof.events()
    moe_cpu = [e for e in events
               if e.name == "moe_apply" and e.device_type == DeviceType.CPU]
    moe_span = [e for e in events
                if e.name == "moe_apply" and e.device_type != DeviceType.CPU]
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and e.key != "moe_apply"]
    device_ms = sum(dev(e) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -dev(e))[:6]
    return {"host_ms": host_ms, "device_ms": device_ms,
            "device_idle_share": (1.0 - device_ms / host_ms
                                  if device_ms and host_ms else None),
            "moe_calls": len(moe_cpu),
            "moe_device_ms": sum(dev(e) for e in moe_cpu) / 1e3,
            "moe_span_ms": (sum(e.time_range.elapsed_us() for e in moe_span)
                            / 1e3 if moe_span else None),
            "top_kernels": [{"name": e.key[:60], "ms": dev(e) / 1e3,
                             "calls": e.count} for e in top]}


def moe_bytes(cfg, tokens: int, experts: int) -> float:
    """Bytes one MoE layer must move when ``experts`` of its experts are
    read: their three (d, f) matrices, the shared expert's, the router,
    and the layer's input and output rows (bf16)."""
    item = 2
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return item * (3 * d * f * (experts + int(cfg.moe_shared_expert))
                   + d * e + 2 * tokens * d)


def serve_moe_a_phase(torch, rt, fa, serve_mod, mlp_mod, *, batch=4,
                      prompt_len=2048, gen=16, ep_mesh=None) -> dict:
    """Llama-4-Maverick at full width, one group (a dense layer, then the
    MoE layer: 128 experts top-1 and the shared expert), chunked-local
    attention, bf16, scatter dispatch at capacity factor 1.25, through
    ``launch.serve.serve``. Checks the flash launches, finite logits,
    scatter (C >= T) against dense, and decode against forward; reports
    init, memory, prefill and decode times, the MoE layer's device ms in
    the prefill and in one decode step (profiler) against its bytes
    bound."""
    from repro_torch.models.blocks import ModelCtx
    name = "serve_moe_a"
    cfg = dataclasses.replace(rt.get_config("llama4_maverick_400b"),
                              num_layers=2)
    api = rt.build_model(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in params.values())
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
        fail(f"{name}: flash launches {launches}, want {want}")
    if not bool(torch.isfinite(res.logits).all()):
        fail(f"{name}: non-finite logits")

    # scatter with C >= T (capacity factor E / k) against dense, and decode
    # against forward, on a B = 2 x prefix
    dense = ModelCtx(moe_mode="dense")
    prefix = min(512, prompt_len)
    nodrop = rt.build_model(dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token),
        device="cuda")
    x = prompt[:2, :prefix].contiguous()
    with torch.no_grad(), RouteTap(torch, mlp_mod) as tap_s:
        f_scatter, _ = nodrop.forward(params, {"tokens": x})
    with torch.no_grad(), RouteTap(torch, mlp_mod) as tap_d:
        f_dense, _ = api.forward(params, {"tokens": x}, dense)
    route_flips(tap_s, tap_d, lambda i, r: r // prefix, 0.0,
                f"{name} scatter vs dense")
    scale = float(f_dense.abs().max())
    mode_diff = float((f_scatter - f_dense).abs().max())
    del f_scatter
    if not mode_diff <= MOE_MODE_TOL * scale:
        fail(f"{name}: scatter (nothing dropped) and dense disagree: max "
             f"abs diff {mode_diff} > {MOE_MODE_TOL} * {scale}")
    with torch.no_grad(), RouteTap(torch, mlp_mod) as tap_dec:
        cache = api.init_cache(params, 2, prefix)
        _, cache = api.prefill(params, {"tokens": x[:, :-1]}, cache, dense)
        tap_dec.calls.clear()
        dec, _ = api.decode_step(params, x[:, -1:], prefix - 1, cache,
                                 ctx=dense)
    # the forward's routes of the last position, as a decode step's call
    last = RouteTap(torch, mlp_mod)
    idx_f, margin_f = tap_d.calls[0]
    last.calls = [(idx_f[prefix - 1::prefix],
                   margin_f[prefix - 1::prefix])]
    flips, left_out = route_flips(tap_dec, last, lambda i, r: r,
                                  FLIP_MARGIN_BF16, f"{name} decode")
    keep = [r for r in range(2) if r not in left_out]
    dec_last, fwd_last = dec[keep, 0].float(), f_dense[keep, -1].float()
    dec_diff = float((dec_last - fwd_last).abs().max()) if keep else None
    dec_scale = float(fwd_last.abs().max()) if keep else None
    if keep and not dec_diff <= FWD_TOL * dec_scale:
        fail(f"{name}: decode disagrees with forward: max abs diff "
             f"{dec_diff} > {FWD_TOL} * {dec_scale}")
    del f_dense, dec, cache

    # the MoE layer in the prefill and in one decode step: profiler, and
    # the experts the step reads
    with torch.no_grad():
        cache = api.init_cache(params, batch, prompt_len + gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(params, {"tokens": prompt}, cache)
        torch.cuda.synchronize()
        prefill_host = (time.perf_counter() - t0) * 1e3
        cache = api.init_cache(params, batch, prompt_len + gen)
        prof_prefill = moe_profile(
            torch, mlp_mod,
            lambda: api.prefill(params, {"tokens": prompt}, cache),
            prefill_host)
        with RouteTap(torch, mlp_mod) as tap_pf:
            api.prefill(params, {"tokens": prompt}, cache)
        tok = res.tokens[:, -1:]
        t_pos = prompt_len + gen - 1
        step = lambda: api.decode_step(params, tok, t_pos, res.cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_host = (time.perf_counter() - t0) * 1e3
        prof_decode = moe_profile(torch, mlp_mod, step, step_host)
        with RouteTap(torch, mlp_mod) as tap_st:
            step()
    used_prefill = int(tap_pf.calls[0][0].unique().numel())
    used_decode = int(tap_st.calls[0][0].unique().numel())
    rows = lambda tokens, used: {
        "tokens": tokens, "experts_read_by_product": cfg.num_experts,
        "experts_used": used,
        "bytes_all_experts": moe_bytes(cfg, tokens, cfg.num_experts),
        "bound_ms_all_experts": moe_bytes(cfg, tokens, cfg.num_experts)
        / HBM_BYTES_PER_S * 1e3,
        "bytes_used_experts": moe_bytes(cfg, tokens, used),
        "bound_ms_used_experts": moe_bytes(cfg, tokens, used)
        / HBM_BYTES_PER_S * 1e3}
    steps = len(res.decode_ms)
    decode_ms = sum(res.decode_ms) / steps
    out = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "cut": "depth 48 -> 2 layers (one group: dense + MoE), full "
                  "width", "d_model": cfg.d_model, "dtype": cfg.dtype,
           "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
           "capacity_factor": cfg.moe_capacity_factor,
           "attention": f"{cfg.attention} {cfg.window}",
           "batch": batch, "prompt": prompt_len, "gen": gen,
           "cache_slots": int(res.cache["k"].shape[2]),
           "params": api.param_count(params), "weight_bytes": weight_bytes,
           "init_s": init_s, "init_peak_memory_bytes": init_peak,
           "launches": launches,
           "prefill_ms": res.prefill_ms,
           "prefill_tok_s": batch * prompt_len / res.prefill_ms * 1e3,
           "decode_ms_per_step": decode_ms,
           "decode_ms_min": min(res.decode_ms),
           "decode_ms_max": max(res.decode_ms),
           "decode_tok_s": batch / decode_ms * 1e3,
           "kv_cache_bytes": cache_bytes(res.cache),
           "peak_memory_bytes": peak, "logits_finite": True,
           "scatter_vs_dense": {"max_abs_diff": mode_diff,
                                "max_abs_logit": scale,
                                "tolerance": f"{MOE_MODE_TOL} * "
                                             "max|logits|",
                                "prefix": f"2 x {prefix}",
                                "capacity": 2 * prefix},
           "decode_vs_forward": {"max_abs_diff": dec_diff,
                                 "max_abs_logit": dec_scale,
                                 "tolerance": f"{FWD_TOL} * max|logits|",
                                 "route_flips": flips,
                                 "rows_left_out": left_out},
           "moe_prefill": {**rows(batch * prompt_len, used_prefill),
                           "device_ms": prof_prefill["moe_device_ms"],
                           "span_ms": prof_prefill["moe_span_ms"]},
           "moe_decode_step": {**rows(batch, used_decode),
                               "device_ms": prof_decode["moe_device_ms"],
                               "span_ms": prof_decode["moe_span_ms"]},
           "profile_prefill": prof_prefill,
           "profile_decode_step": prof_decode}
    emit(out)
    del res, cache
    if ep_mesh is not None:
        out["ep_moe_a"] = ep_moe_a_phase(torch, fa, mlp_mod, api, params,
                                         prompt, gen, ep_mesh)
    del params
    torch.cuda.empty_cache()
    return out


def moe_small_configs(rt) -> list:
    """Two MoE shapes at d_model 512, d_ff 1,024, 2 groups, fp32: dbrx's
    (16 experts top-4, G = 6) and llama4's (128 experts top-1, the shared
    expert, a dense and an MoE layer per group, chunked-local attention
    with window 64, G = 5)."""
    small = dict(d_model=512, d_ff=1024, head_dim=64, num_kv_heads=2,
                 vocab_size=32768, dtype="float32")
    return [dataclasses.replace(rt.get_config("dbrx_132b"), num_layers=2,
                                num_heads=12, num_experts=16, **small),
            dataclasses.replace(rt.get_config("llama4_maverick_400b"),
                                num_layers=4, num_heads=10, window=64,
                                **small)]


def serve_moe_small_phase(torch, rt, fa, serve_mod, mlp_mod, *, batch=2,
                          prompt_len=120, gen=16) -> list:
    """Each small MoE shape on the card (kernels) against the CPU (plain
    versions) in fp32, teacher forced with the card's tokens: per-step
    logits at rtol 1e-4 and atol 1e-4 * max|logits| (as serve_small), the
    routes of every router call compared, a flip allowed only below
    FLIP_MARGIN on the CPU and its batch row then left out."""
    rows = []
    for cfg in moe_small_configs(rt):
        api = rt.build_model(cfg, device="cuda")
        params = api.init(torch.Generator(device="cuda").manual_seed(0))
        api_cpu = rt.build_model(cfg, device="cpu")
        params_cpu = {n: t.cpu() for n, t in params.items()}
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=torch.Generator().manual_seed(0))
        fa.reset_launches()
        with RouteTap(torch, mlp_mod) as tap:
            res = serve_mod.serve(api, params, prompt, gen, device="cuda")
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        with RouteTap(torch, mlp_mod) as tap_cpu:
            res_cpu = serve_mod.serve(api_cpu, params_cpu, prompt, gen,
                                      device="cpu", feed=res.tokens.cpu())
        want = want_flash_launches(torch, fa, cfg, prompt_len, gen)
        if launches != want or fa.LAUNCHES != launches:
            fail(f"serve_moe_small {cfg.name}: launches on the card "
                 f"{launches} (want {want}), and the CPU run must launch "
                 f"none ({fa.LAUNCHES})")
        moe_calls = len(tap.calls) // gen      # MoE layers per forward
        flips, left_out = route_flips(
            tap, tap_cpu,
            lambda i, r: r // prompt_len if i < moe_calls else r,
            FLIP_MARGIN, f"serve_moe_small {cfg.name}")
        keep = [r for r in range(batch) if r not in left_out]
        a, b = res.logits.cpu()[keep], res_cpu.logits[keep]
        atol = 1e-4 * float(b.abs().max())
        diff = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=1e-4, atol=atol):
            fail(f"serve_moe_small {cfg.name}: card and CPU logits "
                 f"disagree: max abs diff {diff} (rtol 1e-4, atol {atol})")
        margins = torch.cat([m for _, m in tap_cpu.calls])
        row = {"phase": "serve_moe_small", "model": cfg.name,
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
               "shared_expert": cfg.moe_shared_expert,
               "moe_every": cfg.moe_every,
               "attention": f"{cfg.attention} {cfg.window}",
               "dtype": cfg.dtype, "batch": batch, "prompt": prompt_len,
               "decode_steps": gen - 1, "launches": launches,
               "router_calls": len(tap.calls), "route_flips": flips,
               "rows_left_out": left_out,
               "min_cpu_margin": float(margins.min()),
               "max_abs_diff": diff, "max_abs_logit": float(b.abs().max()),
               "rtol": 1e-4, "atol": atol}
        emit(row)
        rows.append(row)
        del params, params_cpu
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: the flash Function's gradient, card vs CPU, full width
# ---------------------------------------------------------------------------

def step_device_ms(torch, fn):
    """One call of ``fn`` queued behind a sleep kernel (``device_ms``'s
    method, one try): (device ms, None), or (None, the reason) when the
    call has more launches than the card's queue of pending launches
    holds, so that the host waits for the device before it has queued the
    call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 + 4.0 * host_ms) * 2e6))
    start.record()
    fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    if queued:
        return start.elapsed_time(end), None
    return None, ("the call did not fit behind the sleep kernel (its "
                  "launches exceed the queue of pending launches)")


def grads_close(a, b, rtol) -> tuple[bool, float]:
    """|a - b| <= rtol |b| + rtol max|b|; returns (ok, max|a - b| / max|b|)."""
    a, b = a.float().cpu(), b.float().cpu()
    scale = max(float(b.abs().max()), 1e-30)
    ok = bool(((a - b).abs() <= rtol * b.abs() + rtol * scale).all())
    return ok, float((a - b).abs().max()) / scale


def agree_share(a, b, rtol) -> tuple[float, float]:
    """Share of coordinates with |a - b| <= rtol max|b|, and max|a - b|."""
    a, b = a.float().cpu(), b.float().cpu()
    diff = (a - b).abs()
    tol = rtol * max(float(b.abs().max()), 1e-30)
    return float((diff <= tol).float().mean()), float(diff.max())


def dp_config(privacy, norm: float, n: int, **kw):
    """The gossip DP wire of the training phases: clip at twice the
    replicas' initial norm (clipping seldom bites), noise std 1 % of the
    RMS coordinate (sigma = 0.01 / (4 sqrt(n)): std = 2 sigma clip). The
    noise scale is chosen so that training survives it, not for a useful
    privacy budget: at full width its epsilon is ~1e14, which protects
    nothing. It exercises the mechanism's work, which does not depend on
    sigma."""
    return privacy.DPConfig(clip=2.0 * norm, sigma=0.01 / (4 * math.sqrt(n)),
                            per_link=True, **kw)


def params_norm(torch, params) -> float:
    return math.sqrt(sum(float(torch.sum(p.float() ** 2))
                         for p in params.values()))


def attn_grad_phase(torch, fa) -> dict:
    """The flash Function at the training shape (B=2, S=1,024, 32/8 heads,
    hd 128, causal): dq, dk, dv on the card against autograd of the plain
    version on the card, in bf16 (forward ``flash_mma``) and fp32
    (``flash_tf32``); times of the forward (the kernel), the backward
    (``flash_attention_backward``), the plain version's forward + backward
    and SDPA's forward + backward (the library yardstick)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, kvh, hd, chunk = 2, 1024, 32, 8, 128, 256
    pos = torch.arange(s, dtype=torch.int32, device="cuda").repeat(b, 1)
    kw = dict(mode="causal", window=0)
    out_rows = {}
    for dtype, tol, route in ((torch.bfloat16, ATTN_GRAD_TOL, "flash_mma"),
                              (torch.float32, ATTN_GRAD_TOL_FP32,
                               "flash_tf32")):
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                   for sh in ((b, s, h, hd), (b, s, kvh, hd),
                              (b, s, kvh, hd)))
        dout = torch.randn((b, s, h, hd), generator=gen, device="cuda"
                           ).to(dtype)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        before = dict(fa.LAUNCHES)
        out = fa.flash_attention(qr, kr, vr, pos, pos, grad_chunk=chunk,
                                 **kw)
        grads = torch.autograd.grad(out, (qr, kr, vr), dout)
        launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES
                    if fa.LAUNCHES[n] != before[n]}
        if launched != {route: 1}:
            fail(f"attn_grad {dtype}: launches {launched}, want one "
                 f"{route} (the backward launches no kernel)")
        qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
        ref_out = fa.flash_attention_plain(qp, kp, vp, pos, pos, **kw)
        ref = torch.autograd.grad(ref_out, (qp, kp, vp), dout)
        errs = {}
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            ok, rel = grads_close(g, r, tol)
            errs[name] = {"max_abs_err": float((g.float() - r.float())
                                               .abs().max()),
                          "max_err_over_max_ref": rel}
            if not ok or not math.isfinite(rel):
                fail(f"attn_grad {dtype} {name}: the Function's gradient "
                     f"disagrees with autograd of the plain version "
                     f"(max err {rel} of max|ref|, tolerance {tol})")
        row = {"dtype": str(dtype).replace("torch.", ""), "route": route,
               "tolerance": f"|g - ref| <= {tol} |ref| + {tol} max|ref|",
               "errors": errs}
        if dtype == torch.bfloat16:
            qd, kd, vd = q, k, v
            fwd = lambda: fa.flash_attention(qd, kd, vd, pos, pos, **kw)
            bwd = lambda: fa.flash_attention_backward(
                qd, kd, vd, pos, pos, out.detach(), dout, kv_chunk=chunk,
                **kw)

            def plain_fb():
                o = fa.flash_attention_plain(qp, kp, vp, pos, pos, **kw)
                torch.autograd.grad(o, (qp, kp, vp), dout)

            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                          for t in (q, k, v))
            dt = dout.transpose(1, 2)

            def sdpa_fb():
                o = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True)
                torch.autograd.grad(o, (qt, kt, vt), dt)

            with torch.no_grad():
                fwd_ms = cuda_ms(torch, fwd, 5)
                fwd_dev = device_ms(torch, fwd, 5)
                bwd_ms = cuda_ms(torch, bwd, 3)
                bwd_dev, why = step_device_ms(torch, bwd)
            pairs = b * s * (s + 1) // 2
            item = q.element_size()
            nbytes = item * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()
                             + 2 * k.numel()) + 4 * 2 * pos.numel()
            # the backward's least work: S recomputed, dP, dV, dQ, dK
            bwd_bound = bound(nbytes, 5 * 2 * hd * pairs * h, BF16_TC_FLOPS)
            row.update({
                "forward_ms": fwd_ms, "forward_device_ms": fwd_dev,
                "backward_ms": bwd_ms, "backward_device_ms": bwd_dev,
                "backward_device_ms_note": why,
                "backward_bound_ms": bwd_bound[0],
                "backward_bound_by": bwd_bound[1],
                "plain_fwd_bwd_ms": cuda_ms(torch, plain_fb, 2),
                "sdpa_fwd_bwd_ms": cuda_ms(torch, sdpa_fb, 5),
                "sdpa": "scaled_dot_product_attention(is_causal, "
                        "enable_gqa), forward + autograd backward"})
        out_rows[row["dtype"]] = row
        del q, k, v, qr, kr, vr, qp, kp, vp, out, ref_out, grads, ref
        torch.cuda.empty_cache()
    out_rows["bfloat16_hd112"] = attn_grad_hd112(torch, fa, gen, chunk)
    res = {"phase": "attn_grad", "shape": "B=2, S=1024, 32/8 heads, hd 128, "
           "causal", "grad_chunk": chunk, **out_rows}
    emit(res)
    return res


def attn_grad_hd112(torch, fa, gen, chunk: int) -> dict:
    """Zamba2-7B's shared attention at train_hybrid_a's shape (B=4,
    S=1,024, 32/32 heads, hd 112, sliding window 4,096), bf16: the
    Function's forward (``flash_mma``, hd padded to 128 in the kernel)
    and gradient against autograd of the plain version on the card, and
    the forward's device ms."""
    b, s, h, kvh, hd = 4, 1024, 32, 32, 112
    kw = dict(mode="sliding", window=4096)
    pos = torch.arange(s, dtype=torch.int32, device="cuda").repeat(b, 1)
    q, k, v, dout = (torch.randn(sh, generator=gen, device="cuda"
                                 ).to(torch.bfloat16)
                     for sh in ((b, s, h, hd), (b, s, kvh, hd),
                                (b, s, kvh, hd), (b, s, h, hd)))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(qr, kr, vr, pos, pos, grad_chunk=chunk, **kw)
    grads = torch.autograd.grad(out, (qr, kr, vr), dout)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES
                if fa.LAUNCHES[n] != before[n]}
    if launched != {"flash_mma": 1}:
        fail(f"attn_grad hd 112: launches {launched}, want one flash_mma")
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    ref_out = fa.flash_attention_plain(qp, kp, vp, pos, pos, **kw)
    ref = torch.autograd.grad(ref_out, (qp, kp, vp), dout)
    ok_out, excess = attn_within_tolerance(torch, out.detach(),
                                           ref_out.detach())
    if not ok_out:
        fail(f"attn_grad hd 112: forward disagrees with the plain version "
             f"(worst excess {excess})")
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        ok, rel = grads_close(g, r, ATTN_GRAD_TOL)
        errs[name] = {"max_abs_err": float((g.float() - r.float())
                                           .abs().max()),
                      "max_err_over_max_ref": rel}
        if not ok or not math.isfinite(rel):
            fail(f"attn_grad hd 112 {name}: the Function's gradient "
                 f"disagrees with autograd of the plain version (max err "
                 f"{rel} of max|ref|, tolerance {ATTN_GRAD_TOL})")
    with torch.no_grad():
        fwd = lambda: fa.flash_attention(q, k, v, pos, pos, **kw)
        fwd_dev = device_ms(torch, fwd, 5)
    pairs = b * s * (s + 1) // 2
    fwd_bound = bound(2 * (2 * q.numel() + 2 * k.numel()) + 8 * pos.numel(),
                      4 * hd * pairs * h, BF16_TC_FLOPS)
    row = {"dtype": "bfloat16", "route": "flash_mma",
           "shape": "B=4, S=1024, 32/32 heads, hd 112, sliding 4096",
           "tolerance": f"|g - ref| <= {ATTN_GRAD_TOL} |ref| + "
                        f"{ATTN_GRAD_TOL} max|ref|; forward 2 bf16 ulps",
           "errors": errs, "forward_device_ms": fwd_dev,
           "forward_bound_ms": fwd_bound[0],
           "forward_bound_by": fwd_bound[1]}
    del q, k, v, dout, qr, kr, vr, qp, kp, vp, out, ref_out, grads, ref
    torch.cuda.empty_cache()
    return row


def train_small_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                      gossip_mod, privacy) -> dict:
    """Qwen3-4B's smoke variant (fp32: the forward takes ``flash_tf32``),
    the card against the CPU from the same weights: the loss and every
    gradient leaf; 3 AdamW train steps; 3 gossip rounds at K=4 on ring(4),
    plain, robust trim, and DP on the int8 wire."""
    from repro_torch.models.blocks import DEFAULT_CTX
    cfg = rt.smoke_variant(rt.get_config("qwen3_4b"))
    hp = steps_mod.TrainHParams()
    pipe = data_mod.TokenBatches(cfg.vocab_size, 2, 64, seed=0)
    state = steps_mod.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), hp,
        device="cuda")
    to_cpu = lambda tree: {n: t.to("cpu", copy=True)
                           for n, t in tree.items()}
    cpu_state = lambda st: steps_mod.TrainState(
        to_cpu(st.params), {k: to_cpu(v) for k, v in st.opt_state.items()},
        st.step.to("cpu", copy=True))
    out = {"phase": "train_small", "model": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "rtol": TRAIN_RTOL,
           "agree_share_min": AGREE_SHARE}
    # the loss and its gradients
    grads, losses, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe(0).items()}
        req = {n: p.detach().to(dev).clone().requires_grad_()
               for n, p in state.params.items()}
        fa.reset_launches()
        loss, _ = steps_mod.loss_fn(cfg, req, batch, DEFAULT_CTX, 0.01)
        loss.backward()
        launches[dev] = dict(fa.LAUNCHES)
        grads[dev] = {n: p.grad for n, p in req.items()}
        losses[dev] = float(loss.detach())
    want = {n: 0 for n in fa.LAUNCHES}
    if launches["cpu"] != want or launches["cuda"] != dict(
            want, flash_tf32=cfg.num_layers):
        fail(f"train_small: launches {launches}, want one flash_tf32 per "
             "layer on the card and none on the CPU")
    worst = 0.0
    for n in grads["cpu"]:
        ok, rel = grads_close(grads["cuda"][n], grads["cpu"][n], TRAIN_RTOL)
        worst = max(worst, rel)
        if not ok:
            fail(f"train_small: gradient {n} card vs CPU: max err {rel} of "
                 f"max|g| (rtol {TRAIN_RTOL})")
    if not abs(losses["cuda"] - losses["cpu"]) <= TRAIN_RTOL * abs(
            losses["cpu"]):
        fail(f"train_small: loss {losses}")
    out["loss"] = losses
    out["grad_max_err_over_max"] = worst
    out["launches_cuda"] = launches["cuda"]
    # 3 AdamW steps
    st_cpu = cpu_state(state)
    a = train_mod.train(cfg, hp, pipe, 3, device="cuda", state=state)
    c = train_mod.train(cfg, hp, pipe, 3, device="cpu", state=st_cpu)
    # AdamW moves a coordinate by about lr a step: 2 lr a step bounds a
    # flipped one
    bound3 = 2 * hp.lr * 3
    out["steps"] = compare_train(torch, "train_small steps",
                                 a.state.params, c.state.params,
                                 [m["loss"] for m in a.metrics],
                                 [m["loss"] for m in c.metrics], bound3)
    # gossip at K=4: plain, trim, DP on int8
    norm = params_norm(torch, a.state.params)
    n = sum(p.numel() for p in a.state.params.values())
    for name, gkw, dp in (
            ("gossip", {}, None), ("gossip_trim", {"robust": "trim"}, None),
            ("gossip_dp_int8", {"wire": "int8"},
             dp_config(privacy, norm, n))):
        gcfg = gossip_mod.GossipConfig(num_nodes=4, topology="ring", **gkw)
        states = gossip_mod.replicate_state(a.state, 4)
        start = {"cuda": states, "cpu": cpu_state(states)}  # before any run
        runs = {dev: train_mod.gossip_train(cfg, hp, pipe, gcfg, 3,
                                            device=dev, dp=dp, states=st)
                for dev, st in start.items()}
        g, h = runs["cuda"], runs["cpu"]
        row = compare_train(
            torch, f"train_small {name}", g.states.params, h.states.params,
            [m["loss"] for m in g.metrics], [m["loss"] for m in h.metrics],
            None if dp else 2 * bound3)
        row["consensus"] = [[float(x) for x in r.consensus]
                            for r in (g, h)]
        out[name] = row
    emit(out)
    return out


def compare_train(torch, name, params, params_ref, losses, losses_ref,
                  max_diff: float | None) -> dict:
    """Card (``params``, ``losses``) against CPU: losses within
    TRAIN_RTOL; at least AGREE_SHARE of all coordinates within TRAIN_RTOL
    max|p| of their leaf (a first AdamW step moves a coordinate whose
    gradient is at rounding level by about lr, whichever side of 0 it
    rounds to; a stochastic-rounding decision may flip); every difference
    at most ``max_diff`` where given; everything finite."""
    la = torch.stack([torch.as_tensor(x).float().cpu() for x in losses])
    lb = torch.stack([torch.as_tensor(x).float().cpu()
                      for x in losses_ref])
    if not bool(torch.isfinite(la).all()) or not torch.allclose(
            la, lb, rtol=TRAIN_RTOL, atol=0.0):
        fail(f"{name}: losses {la.tolist()} vs {lb.tolist()}")
    agree, total, worst = 0, 0, 0.0
    for n, p in params.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"{name}: non-finite parameter {n}")
        share, diff = agree_share(p, params_ref[n], TRAIN_RTOL)
        agree += share * p.numel()
        total += p.numel()
        worst = max(worst, diff)
    if agree / total < AGREE_SHARE or (max_diff is not None
                                       and worst > max_diff):
        fail(f"{name}: {agree / total} of the coordinates agree within "
             f"{TRAIN_RTOL} max|p| (want {AGREE_SHARE}); max|diff| {worst}"
             f" (bound {max_diff})")
    return {"losses": la.tolist(), "losses_cpu": lb.tolist(),
            "agree_share": agree / total, "max_abs_diff": worst,
            "max_abs_diff_bound": max_diff}


def model_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one train step (no recompute): 3 x the forward's
    2 N_mm tokens (N_mm: the matrix-product weights, unembed included,
    embed excluded) plus 4 hd H per admissible causal (query, key) pair
    per layer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, ff, v, layers = (cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
                            cfg.vocab_size, cfg.num_layers)
    n_mm = d * v + layers * (2 * d * h * hd + 2 * d * kv * hd + 3 * d * ff)
    pairs = b * s * (s + 1) // 2
    return 3.0 * (2.0 * n_mm * b * s + layers * 4.0 * hd * h * pairs)


def train_a_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                  layers: int = 8, steps: int = 6) -> dict:
    """Qwen3-4B at full width, ``layers`` of 36 layers, through
    ``launch.train.train`` (the all-reduce path): bf16 compute, fp32
    masters and AdamW moments, remat full, B=4 x S=1,024 from
    ``TokenBatches``. The flash counts are zeroed just before the run and
    read just after; remat runs each layer's forward twice (the forward
    and the recompute in the backward)."""
    cfg = dataclasses.replace(rt.get_config("qwen3_4b"), num_layers=layers)
    hp = steps_mod.TrainHParams()
    b, s = 4, 1024
    pipe = data_mod.TokenBatches(cfg.vocab_size, b, s, seed=0)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = steps_mod.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), hp,
        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_alloc = torch.cuda.memory_allocated() - m0
    n_params = sum(p.numel() for p in state.params.values())
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    res = train_mod.train(cfg, hp, pipe, steps, device="cuda", state=state)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict({n: 0 for n in fa.LAUNCHES},
                flash_mma=2 * layers * steps)
    if launches != want:
        fail(f"train_a: flash launches {launches}, want {want} (one "
             "flash_mma per layer in the forward and one in the recompute)")
    losses = [float(m["loss"]) for m in res.metrics]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] <             losses[0]:
        fail(f"train_a: losses {losses} (want finite and falling)")
    ms_step = float(statistics.median(res.step_ms[1:]))
    flops = model_flops(cfg, b, s)
    # one more step: the profiler's device ms by kernel, and the sleep
    # kernel's device ms where the step fits the queue
    batch = train_mod.to_device(pipe(steps), torch.device("cuda"))
    step_fn = steps_mod.make_train_step(cfg, hp)
    one = lambda: step_fn(res.state, batch)
    dev_ms, why = step_device_ms(torch, one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(torch, one, host_ms, top=10)
    out = {"phase": "train_a", "model": cfg.name, "layers": layers,
           "cut": "depth 36 -> 8 layers (full width)", "d_model": cfg.d_model,
           "heads": f"{cfg.num_heads}/{cfg.num_kv_heads}", "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat_policy,
           "optimizer": "AdamW, fp32 moments", "batch": b, "seq": s,
           "steps": steps, "params": n_params, "init_s": init_s,
           "state_bytes_allocated": state_alloc,
           "loss_per_step": losses, "step_ms": res.step_ms,
           "ms_per_step": ms_step, "ms_per_step_of": "median of steps 2-6",
           "tokens_per_s": b * s / ms_step * 1e3,
           "model_flops_per_step": flops,
           "mfu_bf16_dense_peak": flops / (ms_step / 1e3) / BF16_TC_FLOPS,
           "launches": launches,
           "flash_mma_per_step": launches["flash_mma"] / steps,
           "peak_memory_bytes": peak,
           "sleep_kernel_device_ms": dev_ms, "sleep_kernel_note": why,
           "profile_step": prof}
    emit(out)
    del res, state, batch
    torch.cuda.empty_cache()
    return out


def train_gossip_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                       gossip_mod, privacy, name: str, layers: int, *,
                       dp: bool = False) -> dict:
    """Gossip data-parallelism at Qwen3-4B's width, ``layers`` layers,
    K=4 replicas on ring(4), B=2 x S=1,024 per node, 4 rounds mixed every
    round, through ``launch.train.gossip_train``: ms per round as the
    local steps and the mix, the consensus distance per round, peak
    memory. ``dp``: the DP wire (per-link noise, ``dp_config``) on the
    int8 codec, with the draws' and the codec's ms per gossip step and
    the final epsilon against the accountant's closed form."""
    from repro_torch.core import quant, streams
    cfg = dataclasses.replace(rt.get_config("qwen3_4b"), num_layers=layers)
    hp = steps_mod.TrainHParams()
    k, rounds = 4, 4
    pipe = data_mod.TokenBatches(cfg.vocab_size, 2, 1024, seed=0)
    gcfg = gossip_mod.GossipConfig(num_nodes=k, topology="ring",
                                   wire="int8" if dp else "fp32")
    state0 = steps_mod.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), hp,
        device="cuda")
    n = sum(p.numel() for p in state0.params.values())
    dpc = dp_config(privacy, params_norm(torch, state0.params), n) if dp \
        else None
    states = gossip_mod.replicate_state(state0, k)
    del state0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    res = train_mod.gossip_train(cfg, hp, pipe, gcfg, rounds, device="cuda",
                                 dp=dpc, states=states)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict({m: 0 for m in fa.LAUNCHES},
                flash_mma=2 * layers * k * rounds)
    if launches != want:
        fail(f"{name}: flash launches {launches}, want {want}")
    cons = [float(c) for c in res.consensus]
    losses = [m["loss"].tolist() for m in res.metrics]
    if not all(math.isfinite(x) for x in cons + sum(losses, [])):
        fail(f"{name}: non-finite loss or consensus ({losses}, {cons})")
    out = {"phase": name, "model": cfg.name, "layers": layers,
           "cut": f"depth 36 -> {layers} layers (full width)",
           "replicas": k, "graph": "ring(4)", "batch_per_node": 2,
           "seq": 1024, "rounds": rounds, "mix_every": 1,
           "wire": gcfg.wire, "params_per_replica": n,
           "local_ms_per_round": res.local_ms, "mix_ms_per_round":
           res.mix_ms, "ms_per_round": [a + b for a, b in
                                        zip(res.local_ms, res.mix_ms)],
           "consensus_distance": cons, "loss_per_round": losses,
           "launches": launches, "peak_memory_bytes": peak}
    if dp:
        graph = gcfg.graph()
        mixed = rounds
        eps = float(privacy.epsilon_schedule(dpc, graph, 1, [mixed])[-1])
        releases = mixed * dpc.releases_per_mix_round(graph, 1)
        rho = releases / (2.0 * dpc.sigma ** 2)
        closed = rho + 2.0 * math.sqrt(rho * math.log(1.0 / dpc.delta))
        if not abs(eps - closed) <= 1e-12 * closed:
            fail(f"{name}: epsilon {eps} != the closed form {closed}")
        params = res.states.params
        links = privacy.graph_links(gcfg.weights())
        key = dpc.round_key(rounds)
        buf = torch.empty((max(p[0].numel() for p in params.values()),),
                          dtype=torch.float32, device="cuda")

        def draws():
            for i, p in enumerate(params.values()):
                for (r, l) in links:
                    streams.normal(streams.fold(key, 0, i, r, l),
                                   p[0].numel(), "cuda",
                                   out=buf[:p[0].numel()])

        def codec():
            wkey = streams.fold(key, 0, quant._WIRE_STREAM)
            for i, p in enumerate(params.values()):
                quant.wire_view_leaf_(p, "int8", quant.leaf_key(wkey, i))

        w = torch.tensor(gcfg.weights(), dtype=torch.float32, device="cuda")
        mixer = gossip_mod._param_mixer(gcfg, None, None, None, dpc)
        mix = lambda: mixer(w, params, rounds)
        draw_ms = cuda_ms(torch, draws, 1)
        codec_ms = cuda_ms(torch, codec, 1)
        mix_ms = cuda_ms(torch, mix, 1)
        uniforms = 2 * (-(-sum(p[0].numel() for p in params.values())
                          // 2)) * len(links)
        out.update({
            "dp": {"clip": dpc.clip, "sigma": dpc.sigma,
                   "delta": dpc.delta, "per_link": True,
                   "releases": releases, "epsilon": eps,
                   "epsilon_closed_form": closed},
            "draws_ms_per_gossip_step": draw_ms,
            "draws_normals_per_gossip_step": uniforms,
            "codec_ms_per_gossip_step": codec_ms,
            "dp_mix_ms_per_gossip_step": mix_ms,
            "timing_note": "CUDA events around one warmed call (host "
                           "launches included; each op is >= tens of MB)"})
    emit(out)
    del res, states
    torch.cuda.empty_cache()
    return out


def gossip_phase_or_cut(torch, *args, name: str, layers: int, **kw) -> dict:
    """``train_gossip_phase``, at one layer if ``layers`` runs out of
    device memory (a ``<name>_cut`` row says so)."""
    try:
        return train_gossip_phase(torch, *args, name=name, layers=layers,
                                  **kw)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        emit({"phase": f"{name}_cut", "layers": layers, "cut_to": 1,
              "reason": "out of device memory"})
        return train_gossip_phase(torch, *args, name=name, layers=1, **kw)


# ---------------------------------------------------------------------------
# MoE training and the recurrent families (xLSTM-125M, Zamba2-7B)
# ---------------------------------------------------------------------------

def active_mm_params(cfg) -> int:
    """Matrix-product weights a token passes through in one forward: the
    unembed (not the embed), attention and MLP projections, a MoE layer's
    router and its k experts (and the shared one), an xLSTM pair's and a
    Mamba2 block's projections, the hybrid's shared block once per
    group, an encdec decoder layer's cross Q and O projections."""
    d, hd, v = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size
    attn = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
    mlp = 3 * d * cfg.d_ff
    if cfg.family == "xlstm":
        h = cfg.num_heads
        pair = (5 * d * d + 2 * h * d          # mLSTM: q k v o out, gates
                + 4 * d * d + 4 * d * d // h + d * d)   # sLSTM: in, r, out
        return d * v + (cfg.num_layers // 2) * pair
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        heads = di // cfg.ssm_head_dim
        mamba = d * (2 * di + 2 * cfg.ssm_state + heads) + di * d
        groups = cfg.num_layers // (cfg.blocks_per_attn + 1)
        return d * v + groups * (cfg.blocks_per_attn * mamba + attn + mlp)
    if cfg.family == "moe":
        moe = (cfg.experts_per_token + int(cfg.moe_shared_expert)) * mlp \
            + d * cfg.num_experts
        per = max(cfg.moe_every, 1)
        groups = cfg.num_layers // per
        return d * v + groups * ((per - 1) * (attn + mlp) + attn + moe)
    if cfg.family == "encdec":   # a decoder token: self attention, the
        # cross attention's Q and O (its K and V run per encoder frame,
        # frontend_train_flops), MLP
        return d * v + cfg.num_layers * (attn + 2 * d * cfg.num_heads * hd
                                         + mlp)
    return d * v + cfg.num_layers * (attn + mlp)


def train_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one train step, no recompute counted: 3 x (2 x the
    active matrix-product weights x tokens + 4 hd H per admissible (query,
    key) pair per attention layer). The SSM scans are not counted."""
    from repro_torch.models.transformer import num_attn_layers
    span = s if cfg.attention == "full" else min(s, cfg.window)
    pairs = b * sum(min(i + 1, span) for i in range(s))
    attn = num_attn_layers(cfg) * 4.0 * cfg.resolved_head_dim \
        * cfg.num_heads * pairs
    return 3.0 * (2.0 * active_mm_params(cfg) * b * s + attn)


def kernel_busy_ms(torch, fn) -> tuple[float, int, float]:
    """``fn`` once under ``torch.profiler`` with device activity only
    (cheap where a step launches hundreds of thousands of kernels): the
    summed device ms of its kernels, copies and fills, their count, and
    the window's synchronised host ms (profiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    total_ns, count = 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            total_ns += ev.duration_ns()
            count += 1
    return total_ns / 1e6, count, host_ms


@contextlib.contextmanager
def moe_ranges(torch, mlp_mod):
    """While open, each MoE layer's forward runs in a ``moe_forward``
    ``record_function`` range and its backward in a ``moe_backward`` one,
    opened by a hook on the layer's output gradient and closed by one on
    its input gradient (the autograd thread). With remat the forward runs
    twice (the forward and the recompute)."""
    from torch.autograd.profiler import record_function
    orig = mlp_mod.moe_apply

    def annotated(p, x, **kw):
        with record_function("moe_forward"):
            y, aux = orig(p, x, **kw)
        if torch.is_grad_enabled() and y.requires_grad and x.requires_grad:
            rng = record_function("moe_backward")

            def opened(g):
                rng.__enter__()
                return g

            def closed(g):
                rng.__exit__(None, None, None)
                return g

            y.register_hook(opened)
            x.register_hook(closed)
        return y, aux

    mlp_mod.moe_apply = annotated
    try:
        yield {}
    finally:
        mlp_mod.moe_apply = orig


def moe_train_bounds(cfg, tokens: int) -> dict:
    """The MoE layer's least time in training, bf16: the forward reads the
    used experts' matrices, the router and the rows in and out once, and
    does 2 x tokens x k x 3 d f operations; the backward reads the
    matrices and the rows' gradients and writes the matrices' gradients
    (twice the forward's bytes) for twice its operations."""
    e_used = min(cfg.num_experts, tokens * cfg.experts_per_token)
    nbytes = moe_bytes(cfg, tokens, e_used)
    ops = 2.0 * tokens * cfg.experts_per_token * 3 * cfg.d_model * cfg.d_ff
    fwd, bwd = (bound(nbytes, ops, BF16_TC_FLOPS),
                bound(2 * nbytes, 2 * ops, BF16_TC_FLOPS))
    return {"forward_bytes": nbytes, "forward_bytes_ms":
            nbytes / HBM_BYTES_PER_S * 1e3, "forward_bound_ms": fwd[0],
            "forward_bound_by": fwd[1], "backward_bytes": 2 * nbytes,
            "backward_bytes_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "backward_bound_ms": bwd[0], "backward_bound_by": bwd[1]}


@contextlib.contextmanager
def slstm_clock(torch, ssm_mod):
    """While open, the host-clock ms of the sLSTM blocks in the step: each
    block's forward (``slstm_apply``) and its backward window, from a hook
    on its output gradient to one on its input gradient (the autograd
    thread). Under remat the window also holds the group's recompute
    (mLSTM, then sLSTM, which may stop early once the backward has what it
    needs): the mLSTM's part is timed and left out. The loop is
    host-bound, so its host time is the time it holds the step."""
    origs = {kind: getattr(ssm_mod, f"{kind}_apply")
             for kind in ("slstm", "mlstm")}
    out = {"forward_calls": 0, "forward_ms": 0.0, "backward_calls": 0,
           "backward_window_ms": 0.0, "slstm_recompute_calls": 0,
           "mlstm_recompute_calls": 0, "mlstm_recompute_ms": 0.0}
    start = []                     # the open backward window (at most one)

    def opened(g):
        start.append(time.perf_counter())
        return g

    def closed(g):
        out["backward_window_ms"] += (time.perf_counter()
                                      - start.pop()) * 1e3
        out["backward_calls"] += 1
        return g

    def timed(kind):
        def call(p, x, **kw):
            recompute = bool(start)
            t0 = time.perf_counter()
            try:
                y, state = origs[kind](p, x, **kw)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                if recompute:
                    out[f"{kind}_recompute_calls"] += 1
                    if kind == "mlstm":
                        out["mlstm_recompute_ms"] += ms
                elif kind == "slstm":
                    out["forward_calls"] += 1
                    out["forward_ms"] += ms
            if kind == "slstm" and not recompute and \
                    torch.is_grad_enabled() and y.requires_grad and \
                    x.requires_grad:
                y.register_hook(opened)
                x.register_hook(closed)
            return y, state
        return call

    for kind in origs:
        setattr(ssm_mod, f"{kind}_apply", timed(kind))
    try:
        yield out
    finally:
        for kind, fn in origs.items():
            setattr(ssm_mod, f"{kind}_apply", fn)
    out["loop_ms"] = (out["forward_ms"] + out["backward_window_ms"]
                      - out["mlstm_recompute_ms"])


def frontend_pipe(cfg, tokens, b: int, n: int, steps: int, seed: int):
    """``tokens``' batches beside the family's frontend input (vlm's
    patches, encdec's n frames), a fresh standard normal host array for
    each of ``steps`` + 1 steps, drawn in bulk from ``seed`` before the
    run, so each step copies its own input to the card as a data loader
    would."""
    import numpy as np
    from repro_torch.models.transformer import FRONTENDS
    front = FRONTENDS[cfg.family]
    n = cfg.num_prefix_tokens if front.prefix else n
    bank = np.random.default_rng(seed).standard_normal(
        (steps + 1, b, n, cfg.frontend_dim), dtype=np.float32)
    return lambda i, shard=0: {**tokens(i, shard=shard),
                               front.key: bank[i]}


def frontend_train_flops(cfg, b: int, s: int, n_front: int) -> float:
    """``train_flops`` of a batch of B x S text tokens beside n_front
    frontend positions per sequence. vlm: every position (patches and
    text) runs the decoder, the unembed included (the logits cover them
    all), and the patches the projection (frontend_dim x d). encdec: the
    decoder's S tokens as ``train_flops`` counts them (cross Q and O
    projections in ``active_mm_params``) plus, per frame, the input
    projection, the encoder's layers and every decoder layer's cross K and
    V products, plus 4 hd H per (query, key) pair of the encoder's
    bidirectional attention and of the decoder's cross attention."""
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    if cfg.family == "vlm":
        return train_flops(cfg, b, n_front + s) \
            + 3.0 * 2.0 * cfg.frontend_dim * d * b * n_front
    attn = 2 * d * h * hd + 2 * d * cfg.num_kv_heads * hd
    per_frame = (cfg.frontend_dim * d
                 + cfg.encoder_layers * (attn + 3 * d * cfg.d_ff)
                 + cfg.num_layers * 2 * d * cfg.num_kv_heads * hd)
    pairs = b * n_front * (cfg.encoder_layers * n_front
                           + cfg.num_layers * s)
    return train_flops(cfg, b, s) + 3.0 * (
        2.0 * per_frame * b * n_front + 4.0 * hd * h * pairs)


def train_family_phase(torch, rt, fa, train_mod, steps_mod, data_mod, name,
                       cfg, *, b: int, s: int, cut: str, flash_per_step: int,
                       steps: int = 6, profile: str = "full",
                       annotate=None, ranges: tuple = (),
                       extra=None, enc_len: int = 0,
                       users: str | None = None) -> dict:
    """``cfg`` through ``launch.train.train`` (the all-reduce path): bf16
    compute (or ``cfg.dtype``), fp32 masters and AdamW moments, remat
    full, B x S from ``TokenBatches``, lr 3e-4; an encdec or vlm batch
    also carries its frontend input (``frontend_pipe``: vlm's patches,
    encdec's ``enc_len`` frames), and MFU comes from
    ``frontend_train_flops``. The flash counts are zeroed just before the
    run and read just after: ``flash_per_step`` launches of the route that
    ``cfg.dtype`` takes at S (remat runs each attention layer's forward
    twice). Reports ms per step (CUDA events, the median of
    steps 2-6), tokens/s, MFU (``train_flops`` over the bf16 dense peak),
    init and step peak memory, loss, ce and aux per step (all finite),
    and one more step profiled: by kernel (``profile="full"``, with the
    ``record_function`` ``ranges``) or as the kernels' summed device time
    only (``"busy"``), each against the timed steps' median. That step
    runs inside ``annotate()`` where given; ``extra(probe, prof,
    ms_step)`` adds rows from what the context yielded and the profile."""
    from repro_torch.models.transformer import FRONTENDS
    hp = steps_mod.TrainHParams(lr=3e-4)
    pipe = data_mod.TokenBatches(cfg.vocab_size, b, s, seed=0)
    if cfg.family in FRONTENDS:
        pipe = frontend_pipe(cfg, pipe, b, enc_len, steps, seed=1)
    front = {k: list(v.shape) for k, v in pipe(0).items()
             if k not in ("tokens", "labels")}
    n_front = next((shape[1] for shape in front.values()), 0)
    route = fa.select_route(getattr(torch, cfg.dtype), s,
                            cfg.num_heads // cfg.num_kv_heads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = steps_mod.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), hp,
        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.values())
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with flash_modes(fa) as modes:
        res = train_mod.train(cfg, hp, pipe, steps, device="cuda",
                              state=state)
        torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in fa.LAUNCHES}
    want[f"flash_{route}"] = flash_per_step * steps
    if launches != want:
        fail(f"{name}: flash launches {launches}, want {want} (the "
             "forward and the recompute of each attention layer)")
    curves = {key: [float(m[key]) for m in res.metrics]
              for key in ("loss", "ce", "aux", "grad_norm")}
    if not all(math.isfinite(x) for xs in curves.values() for x in xs):
        fail(f"{name}: non-finite metrics {curves}")
    ms_step = float(statistics.median(res.step_ms[1:]))
    flops = (frontend_train_flops(cfg, b, s, n_front) if front
             else train_flops(cfg, b, s))
    batch = train_mod.to_device(pipe(steps), torch.device("cuda"))
    step_fn = steps_mod.make_train_step(cfg, hp)
    one = lambda: step_fn(res.state, batch)
    with (annotate() if annotate else contextlib.nullcontext({})) as probe:
        if profile == "full":
            prof = device_profile(torch, one, ms_step, top=10,
                                  ranges=ranges)
        else:
            busy, count, prof_ms = kernel_busy_ms(torch, one)
            prof = {"host_ms": ms_step, "device_ms": busy, "kernels": count,
                    "device_idle_share": 1.0 - busy / ms_step,
                    "profiled_step_host_ms": prof_ms,
                    "method": "torch.profiler, device activity only: summed "
                              "durations of one more step's kernels, "
                              "copies and fills against the median of the "
                              "timed steps"}
    out = {"phase": name, "model": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "cut": cut, "d_model": cfg.d_model,
           "heads": f"{cfg.num_heads}/{cfg.num_kv_heads}", "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat_policy,
           "optimizer": "AdamW, fp32 moments, lr 3e-4", "batch": b,
           "seq": s, "steps": steps, "params": n_params,
           "active_mm_params": active_mm_params(cfg), "init_s": init_s,
           "init_peak_memory_bytes": init_peak,
           **{f"{key}_per_step": xs for key, xs in curves.items()},
           "step_ms": res.step_ms, "ms_per_step": ms_step,
           "ms_per_step_of": "median of steps 2-6",
           "tokens_per_s": b * s / ms_step * 1e3,
           "model_flops_per_step": flops,
           "mfu_bf16_dense_peak": flops / (ms_step / 1e3) / BF16_TC_FLOPS,
           "launches": launches, "launches_by_mode": modes,
           f"flash_{route}_per_step": launches[f"flash_{route}"] / steps,
           "peak_memory_bytes": peak, "profile_step": prof}
    if front:
        out.update(users=users, frontend=front,
                   encoder_layers=cfg.encoder_layers or None,
                   tokens_per_s_of="text tokens (the CE's positions)",
                   positions_per_s=b * (s + n_front) / ms_step * 1e3)
    if extra is not None:
        out.update(extra(probe, prof, ms_step))
    emit(out)
    del res, state, batch, one
    torch.cuda.empty_cache()
    return out


def train_moe_a_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                      mlp_mod) -> dict:
    """dbrx at full width (d 6,144, 48/8 heads, hd 128, d_ff 10,752,
    vocab 100,352), one layer, 8 of its 16 experts, top-4, scatter at
    capacity factor 1.25: 2.9 B parameters, ~46.5 GB of fp32 AdamW state.
    Adds the MoE layer's forward and backward device ms (profiler ranges)
    against their bounds."""
    cfg = dataclasses.replace(rt.get_config("dbrx_132b"), num_layers=1,
                              num_experts=8)
    b, s = 4, 1024

    def moe_rows(probe, prof, ms_step):
        bounds = moe_train_bounds(cfg, b * s)
        fwd, bwd = (prof["ranges"]["moe_forward"],
                    prof["ranges"]["moe_backward"])
        return {"moe_layer": {
            **bounds, "tokens": b * s,
            "capacity": mlp_mod.moe_capacity(b * s, cfg.experts_per_token,
                                              cfg.num_experts,
                                              cfg.moe_capacity_factor),
            "forward_calls": fwd["calls"],
            "forward_device_ms_per_call": fwd["device_ms"]
            / max(fwd["calls"], 1),
            "backward_calls": bwd["calls"],
            "backward_device_ms": bwd["device_ms"],
            "backward_host_ms": bwd["host_ms"],
            "share_of_step": (fwd["device_ms"] + bwd["device_ms"])
            / ms_step,
            "note": "forward ranges: the forward and remat's recompute"}}

    return train_family_phase(
        torch, rt, fa, train_mod, steps_mod, data_mod, "train_moe_a", cfg,
        b=b, s=s, flash_per_step=2,
        cut="depth 40 -> 1 layer, experts 16 -> 8 (top-4 kept), full "
            "width", annotate=lambda: moe_ranges(torch, mlp_mod),
        ranges=("moe_forward", "moe_backward"), extra=moe_rows)


def train_hybrid_a_phase(torch, rt, fa, train_mod, steps_mod,
                         data_mod) -> dict:
    """Zamba2-7B at full width, 9 of its 27 groups (27 blocks): ~1.84 B
    parameters, ~29 GB of fp32 AdamW state."""
    cfg = dataclasses.replace(rt.get_config("zamba2_7b"), num_layers=27)
    return train_family_phase(
        torch, rt, fa, train_mod, steps_mod, data_mod, "train_hybrid_a",
        cfg, b=4, s=1024, flash_per_step=2 * 9,
        cut="depth 81 -> 27 blocks (9 of 27 groups), full width")


def train_xlstm_a_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                        ssm_mod) -> dict:
    """xLSTM-125M at full width and depth (6 mLSTM + sLSTM pairs), B=8 x
    S=1,024. Adds the sLSTM loop's share of a step, read in the profiled
    step itself (``slstm_clock``): the host ms of its sLSTM blocks'
    forwards, recomputes and backwards over that step's host ms."""
    cfg = rt.get_config("xlstm_125m")
    b, s = 8, 1024
    blocks = cfg.num_layers // 2

    def slstm_rows(probe, prof, ms_step):
        # remat full: one forward, recompute and backward per block
        calls = ("forward_calls", "backward_calls", "slstm_recompute_calls",
                 "mlstm_recompute_calls")
        if any(probe[c] != blocks for c in calls):
            fail(f"train_xlstm_a: sLSTM calls {probe}, want {blocks} of "
                 f"each of {calls} in one step")
        loop_ms = probe["loop_ms"]
        return {"slstm_blocks": blocks, "slstm_in_step": probe,
                "slstm_loop_ms_per_step": loop_ms,
                "slstm_share_of_step": loop_ms
                / prof["profiled_step_host_ms"],
                "slstm_share_of": "host ms of the sLSTM blocks over the "
                                  "host ms of the same (profiled) step"}

    return train_family_phase(
        torch, rt, fa, train_mod, steps_mod, data_mod, "train_xlstm_a",
        cfg, b=b, s=s, flash_per_step=0, profile="busy", cut=None,
        annotate=lambda: slstm_clock(torch, ssm_mod), extra=slstm_rows)


def train_moe_small_phase(torch, rt, fa, steps_mod, mlp_mod) -> list:
    """dbrx's and llama4's shapes at d_model 512 (``moe_small_configs``),
    fp32, the card against the CPU from the same masters on the same
    batch: loss, ce, aux and every leaf's gradient at rtol 1e-4 (atol
    1e-4 x the leaf's largest), every router call's routes compared (a
    flip allowed only below FLIP_MARGIN on the CPU; with one, the
    gradients are reported, not held)."""
    from repro_torch.models.blocks import DEFAULT_CTX
    rows = []
    for cfg in moe_small_configs(rt):
        state = steps_mod.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                               generator=torch.Generator().manual_seed(1))
        res, taps, launches = {}, {}, {}
        for dev in ("cuda", "cpu"):
            req = {n: p.detach().to(dev).clone().requires_grad_()
                   for n, p in state.params.items()}
            fa.reset_launches()
            with RouteTap(torch, mlp_mod) as tap:
                loss, (ce, aux) = steps_mod.loss_fn(
                    cfg, req, {"tokens": tokens.to(dev)}, DEFAULT_CTX, 0.01)
                loss.backward()
            launches[dev] = dict(fa.LAUNCHES)
            taps[dev] = tap
            res[dev] = ([float(loss), float(ce), float(aux)],
                        {n: p.grad for n, p in req.items()})
        groups = cfg.num_layers // max(cfg.moe_every, 1)
        # remat runs each attention layer's forward twice
        passes = 2 if cfg.remat and cfg.remat_policy != "none" else 1
        if launches["cuda"]["flash_tf32"] != passes * cfg.num_layers or \
                any(launches["cpu"].values()):
            fail(f"train_moe_small {cfg.name}: launches {launches}, want "
                 f"{passes * cfg.num_layers} flash_tf32 on the card (the "
                 "forward and the recompute), none on the CPU")
        flips, _ = route_flips(taps["cuda"], taps["cpu"], lambda i, r: r,
                               FLIP_MARGIN, f"train_moe_small {cfg.name}")
        vals, valc = res["cuda"][0], res["cpu"][0]
        worst = 0.0
        for n, g in res["cpu"][1].items():
            ok, rel = grads_close(res["cuda"][1][n], g, TRAIN_RTOL)
            worst = max(worst, rel)
            if not ok and not flips:
                fail(f"train_moe_small {cfg.name}: gradient {n} card vs CPU:"
                     f" max err {rel} of max|g| (rtol {TRAIN_RTOL})")
        if not flips and not all(abs(a - c) <= TRAIN_RTOL * abs(c) + 1e-7
                                 for a, c in zip(vals, valc)):
            fail(f"train_moe_small {cfg.name}: loss, ce, aux {vals} vs "
                 f"{valc}")
        margins = torch.cat([m for _, m in taps["cpu"].calls])
        row = {"phase": "train_moe_small", "model": cfg.name,
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
               "dtype": cfg.dtype, "tokens": "2 x 64",
               "loss_ce_aux": vals, "loss_ce_aux_cpu": valc,
               "grad_max_err_over_max": worst, "rtol": TRAIN_RTOL,
               "router_calls": len(taps["cuda"].calls),
               "router_calls_want": passes * groups,
               "route_flips": flips, "held": not flips,
               "min_cpu_margin": float(margins.min()),
               "launches": launches["cuda"]}
        emit(row)
        rows.append(row)
        del state, res
        torch.cuda.empty_cache()
    return rows


def tree_close(torch, a, b, rtol) -> float:
    """Worst max|a - b| / max|b| over two nested trees of tensors; fails
    where a leaf is off rtol |b| + rtol max|b|."""
    if isinstance(b, dict):
        return max([tree_close(torch, a[k], b[k], rtol) for k in b] or [0.0])
    if isinstance(b, list):
        return max([tree_close(torch, x, y, rtol) for x, y in zip(a, b)]
                   or [0.0])
    ok, rel = grads_close(a, b, rtol)
    if not ok:
        fail(f"card vs CPU (ssm_small / zoo_small): the card and the CPU "
             f"differ by {rel} of max|ref| (rtol {rtol})")
    return rel


def ssm_small_phase(torch, rt, fa, steps_mod, serve_mod,
                    archs=("xlstm_125m", "zamba2_7b"),
                    phase: str = "ssm_small") -> list:
    """The smoke variants of ``archs`` (fp32; by default xLSTM's and
    Zamba2's), the card against the CPU from the same weights: the
    forward's logits, a prefill then 4 decode steps (logits and every
    cached state), and every leaf's gradient of the loss, each at rtol
    1e-4 (atol 1e-4 x max|ref|). The encdec and vlm families get their
    frontend input (48 frames; 8 patches before the prompt) from one CPU
    generator, encdec's decode steps the cross K/V of ``encode``."""
    from repro_torch.models import transformer
    from repro_torch.models.blocks import DEFAULT_CTX
    rows = []
    for arch in archs:
        cfg = rt.smoke_variant(rt.get_config(arch))
        api = rt.build_model(cfg, device="cuda")
        params = api.init(torch.Generator(device="cuda").manual_seed(0))
        api_cpu = rt.build_model(cfg, device="cpu")
        params_cpu = {n: t.cpu() for n, t in params.items()}
        tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                               generator=torch.Generator().manual_seed(2))
        front = serve_mod.frontend_inputs(
            cfg, 2, 48, torch.Generator().manual_seed(3), "cpu")
        p0 = transformer.prefix_len(cfg, front)
        out, worst = {}, {}
        fa.reset_launches()
        for dev, a, p in (("cuda", api, params), ("cpu", api_cpu,
                                                  params_cpu)):
            tok = tokens.to(dev)
            fr = {k: t.to(dev) for k, t in front.items()}
            with torch.no_grad():
                logits, _ = a.forward(p, {"tokens": tok, **fr})
                kw = {}
                if a.encode is not None:
                    enc_out, enc_pos = a.encode(p, fr["enc_embeds"])
                    kw = {"enc_kv": transformer._enc_kv_all_layers(
                        cfg, p, enc_out), "enc_pos": enc_pos}
                cache = a.init_cache(p, 2, p0 + 40)
                steps = [a.prefill(p, {"tokens": tok[:, :36], **fr},
                                   cache)[0]]
                for i in range(4):
                    steps.append(a.decode_step(p, tok[:, 36 + i:37 + i],
                                               p0 + 36 + i, cache, **kw)[0])
            req = {n: t.detach().clone().requires_grad_()
                   for n, t in p.items()}
            loss, _ = steps_mod.loss_fn(cfg, req, {"tokens": tok, **fr},
                                        DEFAULT_CTX, 0.01)
            loss.backward()
            out[dev] = {"forward": logits, "steps": torch.cat(steps, 1),
                        "cache": cache, "loss": loss.detach(),
                        "grads": {n: t.grad for n, t in req.items()}}
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(fa.LAUNCHES)
        for key in ("forward", "steps", "cache", "loss", "grads"):
            worst[key] = tree_close(torch, out["cuda"][key],
                                    out["cpu"][key], TRAIN_RTOL)
        if fa.LAUNCHES != launches:
            fail(f"{phase} {arch}: the CPU run launched a kernel")
        row = {"phase": phase, "model": cfg.name,
               "family": cfg.family, "d_model": cfg.d_model,
               "layers": cfg.num_layers, "dtype": cfg.dtype,
               "scan_chunk": cfg.scan_chunk, "tokens": "2 x 40 (prefill "
               "36, 4 decode steps)", "rtol": TRAIN_RTOL,
               "max_err_over_max": worst, "launches": launches}
        if front:
            row.update(encoder_layers=cfg.encoder_layers or None,
                       frontend={k: list(t.shape) for k, t in front.items()})
        emit(row)
        rows.append(row)
        del params, params_cpu, out
        torch.cuda.empty_cache()
    return rows


def serve_encdec_a_phase(torch, rt, fa, serve_mod) -> dict:
    """SeamlessM4T-medium at full width and depth (12 encoder + 12
    decoder layers, 16/16 heads, hd 64, vocab 256,206), bf16: 8
    utterances of 1,500 frames (30 s at 50 frames/s, the stubbed speech
    frontend's frame embeddings), a 32-token decoder prompt, 64 tokens,
    through ``serve_phase``: the encoder's mma launches in mode cross,
    the decoder's causal and cross launches, split + combine twice per
    layer and step."""
    return serve_phase(
        torch, rt, fa, serve_mod, "serve_encdec_a",
        rt.get_config("seamless_m4t_medium"), batch=8, prompt_len=32,
        gen=64, fwd_tol=FWD_TOL, enc_len=1500,
        users="batched speech-to-text translation: 30 s utterances, a "
              "32-token prompt, 64 tokens out")


def serve_vlm_a_phase(torch, rt, fa, serve_mod) -> dict:
    """InternVL2-26B at full width and depth (48 layers, 48/8 heads, hd
    128: 19.88 B parameters, 39.8 GB in bf16) on one card: 4 requests of
    one 448 x 448 image tile (256 patch embeddings of the stubbed
    InternViT) and 1,024 text tokens, 16 tokens, through ``serve_phase``;
    decode against the bytes one step reads."""
    return serve_phase(
        torch, rt, fa, serve_mod, "serve_vlm_a",
        rt.get_config("internvl2_26b"), batch=4, prompt_len=1024, gen=16,
        fwd_tol=FWD_TOL,
        users="multimodal chat: an image tile and a 1,024-token prompt")


def train_encdec_a_phase(torch, rt, fa, train_mod, steps_mod,
                         data_mod) -> dict:
    """SeamlessM4T-medium at full width and depth: 0.979 B parameters,
    15.7 GB of fp32 AdamW state; B=4 x 1,024 frames and 1,024 decoder
    tokens. Each step runs every encoder layer's mma (mode cross) and each
    decoder layer's causal and cross mma twice (remat full)."""
    cfg = rt.get_config("seamless_m4t_medium")
    return train_family_phase(
        torch, rt, fa, train_mod, steps_mod, data_mod, "train_encdec_a",
        cfg, b=4, s=1024, cut=None, enc_len=1024,
        flash_per_step=2 * (cfg.encoder_layers + 2 * cfg.num_layers),
        users="fine-tuning speech-to-text translation")


def train_vlm_a_phase(torch, rt, fa, train_mod, steps_mod,
                      data_mod) -> dict:
    """InternVL2-26B at full width, 4 of its 48 layers: 2.717 B
    parameters, 43.5 GB of fp32 AdamW state (full depth's is 318 GB);
    B=4 x (256 patches + 1,024 text tokens), the CE over the text. Then
    its witness ``train_vlm_a_fp32``: the same run (seed, data, lr) in
    fp32 compute (flash_tf32), whose loss curve says whether the bf16
    curve is the optimizer's or the precision's."""
    cfg = dataclasses.replace(rt.get_config("internvl2_26b"), num_layers=4)
    kw = dict(b=4, s=1024, flash_per_step=2 * cfg.num_layers,
              cut="depth 48 -> 4 layers (full width): full depth's fp32 "
                  "AdamW state is 318 GB",
              users="multimodal instruction tuning: an image tile and "
                    "1,024 text tokens")
    out = train_family_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                             "train_vlm_a", cfg, **kw)
    train_family_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                       "train_vlm_a_fp32",
                       dataclasses.replace(cfg, dtype="float32"),
                       profile="busy", **kw)
    return out


def serve_hybrid_a_phase(torch, rt, fa, serve_mod) -> dict:
    """Zamba2-7B at full width and depth (81 blocks, 27 groups of 2 Mamba2
    blocks and the shared attention + MLP, sliding window 4,096), bf16,
    B=2 x 4,096 prompt, 16 tokens, through ``serve_phase``, its last step
    against the full forward at FWD_TOL_DEEP. Then decode after a
    511-token prefill against the full forward, in bf16 at FWD_TOL, and
    the fp32 twin (18.6 GB of weights): that check and the one after the
    4,096-token prefill at HYBRID_FP32_TOL, which shows the decode path
    exact and the bf16 difference rounding."""
    cfg = rt.get_config("zamba2_7b")
    out = serve_phase(torch, rt, fa, serve_mod, "serve_hybrid_a", cfg,
                      batch=2, prompt_len=4096, gen=16, fwd_tol=FWD_TOL_DEEP)
    checks = {}
    for dtype, tol, lens in (("bfloat16", FWD_TOL, (511,)),
                             ("float32", HYBRID_FP32_TOL, (511, 4096))):
        api = rt.build_model(dataclasses.replace(cfg, dtype=dtype),
                             device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        params = api.init(g)
        tokens = torch.randint(0, cfg.vocab_size, (2, 4096 + 15),
                               generator=g, device="cuda")
        rows = [decode_vs_forward(torch, api, params,
                                  tokens[:, :n + 1] if n < 4096 else tokens,
                                  n) for n in lens]
        for row in rows:
            if not row["max_abs_diff"] <= tol * row["max_abs_logit"]:
                fail(f"serve_hybrid_a {dtype}: decode disagrees with "
                     f"forward: {row} (tolerance {tol} * max|logits|)")
        checks[dtype] = {"tolerance": f"{tol} * max|logits|",
                         "checks": rows}
        del params
        torch.cuda.empty_cache()
    emit({"phase": "serve_hybrid_a_decode_checks", "model": cfg.name,
          "layers": cfg.num_layers, **checks})
    out["decode_checks"] = checks
    return out


# ---------------------------------------------------------------------------
# launch and sharding: expert parallelism at one rank, the dry run on the
# card, the serve_batched example
# ---------------------------------------------------------------------------

# dryrun_card: size_pair's bytes against memory_allocated()'s delta
DRYRUN_TOL = 5e-3


def collective_kernel_ms(torch, fn) -> dict:
    """``fn`` once under ``torch.profiler``: the device ms and calls of
    the collective kernels (NCCL's) in the window. At one rank NCCL
    launches none for an in-place all-reduce."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, calls = 0.0, 0
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type) or "nccl" not in ev.key.lower():
            continue
        dev_us = getattr(ev, "device_time_total", None)
        ms += (ev.cuda_time_total if dev_us is None else dev_us) / 1e3
        calls += ev.count
    return {"device_ms": ms, "kernels": calls}


def ep_moe_a_phase(torch, fa, mlp_mod, api, params, prompt, gen: int,
                   mesh) -> dict:
    """serve_moe_a's Llama-4-Maverick group (one dense and one MoE layer,
    128 experts top-1 + shared; its prompts) through the expert-parallel
    branch on ``mesh`` (1 x 1 over the script's NCCL rank): the prefill and
    ``gen`` - 1 greedy decode steps with and without the mesh, logits and
    cache bitwise; the flash launches and the axis's all-reduces of the
    run with the mesh (counts zeroed just before it, read just after);
    the MoE layer's device ms in the prefill and in one decode step with
    and without the mesh, the NCCL kernels in each, and the device ms of
    the axis's ``psum`` (its clone and the all-reduce) at the prefill's
    and a step's (T, d) against its bytes bound."""
    from repro_torch.models.blocks import DEFAULT_CTX, ModelCtx
    name = "ep_moe_a"
    cfg = api.cfg
    ctx = ModelCtx(mesh=mesh, model_axis="model")
    axis = mlp_mod.expert_axis(mesh, "model")
    b, s = prompt.shape

    def run(c):
        cache = api.init_cache(params, b, s + gen)
        with torch.no_grad():
            logits, cache = api.prefill(params, {"tokens": prompt}, cache, c)
            out = [logits[:, -1]]
            for i in range(gen - 1):
                tok = torch.argmax(out[-1], dim=-1)[:, None]
                logits, cache = api.decode_step(params, tok, s + i, cache,
                                                ctx=c)
                out.append(logits[:, -1])
        return torch.stack(out, dim=1), cache

    plain_logits, plain_cache = run(DEFAULT_CTX)
    torch.cuda.synchronize()
    fa.reset_launches()
    axis.reset_counts()
    ep_logits, ep_cache = run(ctx)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    calls, sent = dict(axis.counts), dict(axis.sent_bytes)
    want = want_flash_launches(torch, fa, cfg, s, gen)
    if launches != want:
        fail(f"{name}: flash launches {launches}, want {want}")
    moe_layers = cfg.num_layers // max(cfg.moe_every, 1)
    if calls != {"all-reduce": moe_layers * gen}:
        fail(f"{name}: the axis made {calls}, want one all-reduce per MoE "
             f"layer and call ({moe_layers * gen})")
    same = torch.equal(ep_logits, plain_logits) and all(
        torch.equal(ep_cache[key], plain_cache[key]) for key in plain_cache)
    if not same:
        fail(f"{name}: logits or cache through the expert-parallel branch "
             "are not bitwise those without the mesh")
    del plain_cache, ep_cache
    tok = torch.argmax(ep_logits[:, -1], dim=-1)[:, None]
    rows = {}
    with torch.no_grad():
        for label, c in (("plain", DEFAULT_CTX), ("mesh", ctx)):
            cache = api.init_cache(params, b, s + gen)
            prefill = lambda: api.prefill(params, {"tokens": prompt}, cache,
                                          c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            cache = api.init_cache(params, b, s + gen)
            pf = moe_profile(torch, mlp_mod, prefill, host)
            step = lambda: api.decode_step(params, tok, s + gen - 1, cache,
                                           ctx=c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            st = moe_profile(torch, mlp_mod, step, host)
            rows[label] = {"prefill_moe_device_ms": pf["moe_device_ms"],
                           "prefill_device_ms": pf["device_ms"],
                           "prefill_host_ms": pf["host_ms"],
                           "step_moe_device_ms": st["moe_device_ms"],
                           "step_device_ms": st["device_ms"],
                           "step_host_ms": st["host_ms"]}
            if label == "mesh":
                cache = api.init_cache(params, b, s + gen)
                rows["nccl_kernels_prefill"] = collective_kernel_ms(
                    torch, prefill)
                rows["nccl_kernels_step"] = collective_kernel_ms(torch,
                                                                 step)
            del cache
    t, d = b * s, cfg.d_model
    for key, n in (("psum_prefill", t), ("psum_step", b)):
        y = torch.zeros((n, d), dtype=getattr(torch, cfg.dtype),
                        device="cuda")
        nbytes = 2 * y.numel() * y.element_size()   # the clone's read, write
        rows[key] = {"shape": [n, d], "device_ms": device_ms(
            torch, lambda: axis.psum(y), 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        del y
    out = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "experts": cfg.num_experts, "mesh": "1 x 1 (data, model), NCCL",
           "batch": b, "prompt": s, "gen": gen, "launches": launches,
           "axis_calls": calls, "axis_sent_bytes": sent,
           "all_reduce_prefill_bytes": t * d * 2,
           "bitwise": same, **rows}
    emit(out)
    torch.cuda.empty_cache()
    return out


def ep_train_small_phase(torch, rt, fa, steps_mod, mesh) -> list:
    """train_moe_small's two shapes (fp32, d_model 512) on the card: the
    loss, ce, aux and every gradient through the expert-parallel branch
    on ``mesh`` (M = 1), bitwise those without it."""
    from repro_torch.models.blocks import DEFAULT_CTX, ModelCtx
    ctx = ModelCtx(mesh=mesh, model_axis="model")
    rows = []
    for cfg in moe_small_configs(rt):
        state = steps_mod.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                               generator=torch.Generator().manual_seed(1))
        res = {}
        for label, c in (("plain", DEFAULT_CTX), ("mesh", ctx)):
            req = {n: p.detach().clone().requires_grad_()
                   for n, p in state.params.items()}
            fa.reset_launches()
            loss, (ce, aux) = steps_mod.loss_fn(
                cfg, req, {"tokens": tokens.cuda()}, c, 0.01)
            loss.backward()
            res[label] = (torch.stack([loss, ce, aux]).detach(),
                          {n: p.grad for n, p in req.items()},
                          dict(fa.LAUNCHES))
        same_loss = torch.equal(res["plain"][0], res["mesh"][0])
        diff = [n for n, g in res["plain"][1].items()
                if not torch.equal(g, res["mesh"][1][n])]
        if not same_loss or diff:
            fail(f"ep_train_small {cfg.name}: loss bitwise {same_loss}, "
                 f"gradients that differ: {diff[:5]}")
        row = {"phase": "ep_train_small", "model": cfg.name,
               "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
               "loss_ce_aux": res["mesh"][0].tolist(), "bitwise": True,
               "gradients": len(res["mesh"][1]),
               "launches": res["mesh"][2]}
        emit(row)
        rows.append(row)
        del state, res
        torch.cuda.empty_cache()
    return rows


def dryrun_card_phase(torch, rt, vlm_a: dict, train_a: dict) -> dict:
    """``launch.dryrun.size_pair`` on a 1 x 1 mesh against what the card
    allocated: serve_vlm_a's parameters (bf16; sized with bf16 masters,
    whose norm gains the reference keeps in fp32) and its cache
    (p0 + prompt + gen slots), train_a's state (8 of 36 layers); each
    within DRYRUN_TOL. Then one traced full-config pair (Qwen3-4B, all 36
    layers, train_a's B=4 x S=1,024) on meta: its flops beside
    ``model_flops`` (no recompute) of the same step."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, mesh as mesh_mod
    one = mesh_mod.MeshSpec(("data", "model"), (1, 1))
    vlm = rt.get_config("internvl2_26b")
    slots = vlm_a["prefix_positions"] + vlm_a["prompt"] + vlm_a["gen"]
    sv = dryrun.size_pair("internvl2_26b",
                          InputShape("serve_vlm_a", slots, vlm_a["batch"],
                                     "prefill"), mesh=one, trace=False,
                          opts=dryrun.Opts(param_dtype=vlm.dtype))
    qwen = rt.get_config("qwen3_4b")
    cut = dataclasses.replace(qwen, num_layers=train_a["layers"])
    shape = InputShape("train_a", train_a["seq"], train_a["batch"], "train")
    st = dryrun.size_pair("qwen3_4b", shape, mesh=one, trace=False, cfg=cut)
    checks = {"serve_vlm_a_params": (sv["memory"]["parts"]["params"],
                                     vlm_a["params_bytes_allocated"]),
              "serve_vlm_a_cache": (sv["memory"]["parts"]["cache"],
                                    vlm_a["cache_bytes_allocated"]),
              "train_a_state": (st["memory"]["parts"]["state"],
                                train_a["state_bytes_allocated"])}
    ratios = {}
    for key, (sized, allocated) in checks.items():
        ratios[key] = {"sized_bytes": sized, "allocated_bytes": allocated,
                       "ratio": allocated / sized}
        if not abs(allocated / sized - 1.0) <= DRYRUN_TOL:
            fail(f"dryrun_card {key}: size_pair's {sized} bytes against "
                 f"{allocated} allocated (tolerance {DRYRUN_TOL})")
    t0 = time.perf_counter()
    traced = dryrun.size_pair("qwen3_4b", shape, mesh=one, trace=True)
    trace_s = time.perf_counter() - t0
    want = model_flops(qwen, train_a["batch"], train_a["seq"])
    out = {"phase": "dryrun_card", "mesh": "1 x 1", "tolerance": DRYRUN_TOL,
           **ratios,
           "traced_pair": "qwen3_4b, 36 layers, train B=4 x S=1,024, meta",
           "traced_flops": traced["flops"], "model_flops": want,
           "traced_over_model_flops": traced["flops"] / want,
           "trace_s": trace_s}
    emit(out)
    return out


def serve_batched_phase(torch, rt, fa) -> list:
    """``examples/torch_serve_batched.py``'s three smoke archs (fp32) on
    the card against the CPU from the same weights (drawn on the CPU) and
    prompt: greedy tokens equal while the CPU's top-1 margin is above
    FLIP_MARGIN, every step's logits within SMALL_RTOL of max|logits|
    while the tokens agree, the same decode state; the example's timings
    on the card."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "torch_serve_batched.py"
    spec = importlib.util.spec_from_file_location("torch_serve_batched",
                                                  path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    rows = []
    for arch in ex.ARCHS:
        cfg = rt.smoke_variant(rt.get_config(arch))
        params = rt.build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                               generator=torch.Generator().manual_seed(1))
        cpu = ex.serve_arch(arch, device="cpu", params=params, prompt=prompt)
        fa.reset_launches()
        card = ex.serve_arch(arch, device="cuda", prompt=prompt, params={
            n: t.cuda() for n, t in params.items()})
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        top2 = torch.topk(cpu["logits"], 2, dim=-1).values
        margins = top2[..., 0] - top2[..., 1]
        compared, worst = 0, 0.0
        scale = float(cpu["logits"].abs().max())
        for r in range(prompt.shape[0]):
            for t in range(cpu["tokens"].shape[1]):
                diff = float((card["logits"][r, t].cpu()
                              - cpu["logits"][r, t]).abs().max())
                worst = max(worst, diff)
                if not diff <= SMALL_RTOL * scale:
                    fail(f"serve_batched {arch}: step {t} row {r} logits "
                         f"differ by {diff} (> {SMALL_RTOL} x {scale})")
                if float(margins[r, t]) <= FLIP_MARGIN:
                    break
                if int(card["tokens"][r, t]) != int(cpu["tokens"][r, t]):
                    fail(f"serve_batched {arch}: token {t} of row {r} "
                         "differs at a margin above FLIP_MARGIN")
                compared += 1
        if card["decode_state_bytes"] != cpu["decode_state_bytes"]:
            fail(f"serve_batched {arch}: decode state "
                 f"{card['decode_state_bytes']} vs "
                 f"{cpu['decode_state_bytes']} bytes")
        if cfg.family != "xlstm" and not launches["flash_split"] > 0:
            fail(f"serve_batched {arch}: no flash launches {launches}")
        row = {"phase": "serve_batched", "arch": arch, "family": cfg.family,
               "prefill_ms": card["prefill_ms"],
               "decode_ms_per_token": card["decode_ms_per_token"],
               "decode_state_mb": card["decode_state_bytes"] / 1e6,
               "tokens_compared": compared,
               "tokens_total": int(cpu["tokens"].numel()),
               "max_abs_logit_diff": worst, "launches": launches}
        emit(row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the topology compiler and the distributed runtime (world size 1, NCCL)
# ---------------------------------------------------------------------------

TOPO_GRAPHS = ("ring", "cycle2", "torus2d", "expander", "hypercube",
               "complete")
# the per-node plan executor against dense_mix: rtol, with an atol of
# PLAN_RTOL x max|dense| (the colors sum W_kl v_l in another order than
# the product, and entries near 0 cancel)
PLAN_RTOL = 1e-6
# a distributed run against run_cola on the card where bitwise does not
# hold: rtol, atol DIST_RTOL x max(1, max|value|)
DIST_RTOL = 1e-6


def init_nccl_group(torch) -> None:
    """The process group of the distributed phases: NCCL, one rank on the
    card, through a free localhost port. No other backend is tried."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=300),
        device_id=torch.device("cuda", torch.cuda.current_device()))


def topo_plan_phase(torch, topology, mixing, topo, k: int = NODES,
                    d: int = EPS_SAMPLES, m: int = 4) -> list:
    """The compiler's executors without ranks at (K, d) fp32 on the card,
    per graph family: ``plan_mix_dense`` (one gather per color) against
    ``dense_mix`` at rtol PLAN_RTOL, ``block_mix_dense`` at M ranks held
    to it bitwise; colors, ``comm_budget`` bytes, device ms of each."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn((k, d), generator=gen, device="cuda")
    rows = []
    for name in TOPO_GRAPHS:
        graph = topo.build(name, k)
        w_np = topology.metropolis_weights(graph).astype(np.float32)
        w = torch.as_tensor(w_np, device="cuda")
        plan = topo.compile_plan(graph)
        block = topo.compile_block_plan(graph, m)
        diag, coefs = (torch.as_tensor(a, device="cuda")
                       for a in topo.plan_coefficients(plan, w_np))
        dense = mixing.dense_mix(w, v)
        per_node = topo.plan_mix_dense(plan, diag, coefs, v)
        blocks = topo.block_mix_dense(block, w, v)
        err = float((per_node - dense).abs().max())
        scale = float(dense.abs().max())
        if not torch.allclose(per_node, dense, rtol=PLAN_RTOL,
                              atol=PLAN_RTOL * scale):
            fail(f"topo_plan {name}: plan_mix_dense is {err} from "
                 f"dense_mix (rtol {PLAN_RTOL}, atol {PLAN_RTOL} x {scale})")
        if not torch.equal(blocks, dense):
            fail(f"topo_plan {name}: block_mix_dense at M={m} is not "
                 f"bitwise dense_mix (max diff "
                 f"{float((blocks - dense).abs().max())})")
        row = {"phase": "topo_plan", "graph": name, "K": k, "d": d,
               "colors": plan.num_colors,
               "budget_bytes": topo.comm_budget(plan, d)["bytes_per_device"],
               "block_M": m, "block_colors": block.num_colors,
               "block_budget_bytes":
                   topo.comm_budget(block, d)["bytes_per_device"],
               "plan_max_abs_err": err, "plan_rtol": PLAN_RTOL,
               "block_bitwise": True,
               "dense_mix_device_ms": device_ms(
                   torch, lambda: mixing.dense_mix(w, v), 10),
               "plan_mix_device_ms": device_ms(
                   torch, lambda: topo.plan_mix_dense(plan, diag, coefs, v),
                   10),
               "block_mix_device_ms": device_ms(
                   torch, lambda: topo.block_mix_dense(block, w, v,
                                                       check=False), 10)}
        emit(row)
        rows.append(row)
    return rows


def dist_body(axis, comm: str, graph, cfg, *, churn: bool):
    """``make_body`` for the profiles: the distributed runtime's round body
    for this graph and comm, built by ``runtime.dist_round_body`` as
    ``run_dist_cola`` builds it (``make.plan``: the plan it compiled)."""
    from repro_torch.core import topology
    from repro_torch.dist import runtime

    def make(prob, part):
        body, _, make.plan = runtime.dist_round_body(
            prob, part, cfg, axis, graph, topology.metropolis_weights(graph),
            comm=comm, churn=churn)
        return body

    return make


def collective_device_ms(torch, axis, k: int, d: int) -> dict:
    """Device ms of the collectives the runtime makes at (K, d) on one
    rank: the dense path's all-gather of the (K, d) stack, the
    certificate's psum of the (2, d) Lemma-1 sums, a scalar pmax and the
    gap row's broadcast."""
    v = torch.ones((k, d), device="cuda")
    sums = torch.ones((2, d), device="cuda")
    one = torch.ones((), device="cuda")
    row = torch.ones((5,), device="cuda")
    return {"all_gather_stack": device_ms(torch,
                                          lambda: axis.all_gather(v), 10),
            "psum_2xd": device_ms(torch, lambda: axis.psum(sums), 10),
            "pmax_scalar": device_ms(torch, lambda: axis.pmax(one), 10),
            "broadcast_row": device_ms(torch, lambda: axis.broadcast(row),
                                       10)}


def dist1_run(torch, cd_glm, dist_mod, axis, name, prob, graph, cfg,
              rounds, ref, *, profile, extra=None, bitwise=False,
              **kw) -> dict:
    """``run_dist_cola`` at world size 1 through ``comm="plan"`` (the block
    plan at M = 1: no colors) and ``comm="dense"``, with the launch counts
    zeroed before each run and read after: the Gram kernel once per
    executed round, no residual launch. The state and the history are held
    to ``ref`` (the same configuration's ``run_cola`` run on the card):
    bitwise, or within DIST_RTOL where bitwise does not hold (the row says
    which; ``bitwise`` requires it). ``profile(comm)`` gives the round's
    timing keys."""
    import numpy as np
    out = {}
    want = ref["raw_history"]
    for comm in ("plan", "dense"):
        cd_glm.reset_launches()
        axis.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dist_mod.run_dist_cola(prob, graph, cfg, axis, rounds,
                                     comm=comm, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cd_glm.LAUNCHES)
        calls = dict(axis.counts)
        h = res.history
        executed = executed_rounds(h, rounds, kw["block_size"])
        if launches["cd_gram"] != executed or launches["cd_residual"]:
            fail(f"{name} ({comm}): launches {launches}, want cd_gram once "
                 f"per executed round ({executed}) and no cd_residual")
        if h["round"] != want["round"] or h["stop_round"] != \
                want["stop_round"] or h.get("violated_round") != \
                want.get("violated_round"):
            fail(f"{name} ({comm}): rounds {h['round']} / stop "
                 f"{h['stop_round']} / violated {h.get('violated_round')}, "
                 f"run_cola {want['round']} / {want['stop_round']} / "
                 f"{want.get('violated_round')}")
        state, ref_state = res.state, ref["state"]
        same = (torch.equal(state.x_parts, ref_state.x_parts)
                and torch.equal(state.v_stack, ref_state.v_stack)
                and h == want)
        if bitwise and not same:
            fail(f"{name} ({comm}): not bitwise the run_cola run")
        worst = {}
        for key, a, b in (("x", state.x_parts, ref_state.x_parts),
                          ("v", state.v_stack, ref_state.v_stack)):
            worst[key] = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=DIST_RTOL, atol=DIST_RTOL * max(
                    1.0, float(b.abs().max()))):
                fail(f"{name} ({comm}): {key} is {worst[key]} from run_cola")
        for key, col in h.items():
            if isinstance(col, list) and key != "round":
                a, b = np.asarray(col), np.asarray(want[key])
                worst[key] = float(np.max(np.abs(a - b), initial=0.0))
                if not np.allclose(a, b, rtol=DIST_RTOL, atol=DIST_RTOL * max(
                        1.0, float(np.max(np.abs(b), initial=0.0)))):
                    fail(f"{name} ({comm}): history {key} {a.tolist()} vs "
                         f"run_cola {b.tolist()}")
        row = {"phase": name, **(extra or {}), "comm": comm,
               "ranks": axis.size,
               "backend": axis.backend, "nodes": graph.num_nodes,
               "rounds": rounds, "stop_round": h["stop_round"],
               "executed_rounds": executed, "launches": launches,
               "collective_calls": calls, "bitwise_run_cola": same,
               "max_abs_diff": worst, "rtol_if_not_bitwise": DIST_RTOL,
               "wall_s_incl_setup": wall,
               "run_cola_wall_s_incl_setup": ref["wall_s_incl_setup"],
               "run_cola_ms_per_round": ref["ms_per_round"],
               "run_cola_device_ms_per_round": ref["device_ms_per_round"],
               **profile(comm)}
        emit(row)
        out[comm] = row
    return out


def dist1_profile(torch, quant, axis, prob, graph, cfg, comm: str, *,
                  atk=None) -> dict:
    """``round_profile`` of the distributed round body at one rank (the
    attacks' entries of an attacked round when ``atk``), with one round's
    collective calls and bytes held to the plan's ``contract(wire=)``, or
    on the dense comm of a quantized wire to the narrow payload and its
    scales (``quant.payload_bytes``: 1 byte an element, 4 a row)."""
    make = dist_body(axis, comm, graph, cfg, churn=False)
    out = round_profile(torch, prob, graph, cfg, 3, make_body=make,
                        atk=atk, axis=axis)
    calls, sent = out["round_collective_calls"], out["round_sent_bytes"]
    wire = cfg.wire if quant.is_quantized(cfg.wire) else None
    if make.plan is not None:
        contract = make.plan.contract(prob.d, wire=wire)
        try:
            contract.check(calls, sent)
        except AssertionError as err:
            fail(f"dist1 ({comm}, {cfg.wire}): {err}")
        out["contract"] = contract.describe()
        out["contract_permute_bytes"] = contract.max_collective_permute_bytes
    elif wire is not None:
        want = quant.payload_bytes(prob.d, wire, graph.num_nodes)
        if sent.get("all-gather") != want or calls.get("all-gather") != 2:
            fail(f"dist1 dense ({cfg.wire}): one round all-gathers "
                 f"{calls.get('all-gather')} x, {sent.get('all-gather')} B; "
                 f"want 2 x (payload and scales), {want} B")
        out["wire_all_gather_bytes_want"] = want
    out["fp32_stack_bytes"] = graph.num_nodes * prob.d * 4
    return out


def dist1_wire_phases(torch, rt, cd_glm, dist_mod, quant, attack, axis,
                      lasso, ring, torus, refs: dict) -> dict:
    """dist1_q8, dist1_f8p, dist1_atk and dist1_rq8 (see the module): each
    configuration through ``run_dist_cola`` at one rank on both comms,
    held to its ``run_cola`` run of ``refs`` (states kept) by
    ``dist1_run``, timed by ``dist1_profile``."""
    import numpy as np
    kw = dict(recorder="gap+certificate", eps=1e-3, record_every=1,
              block_size=8)
    out = {}
    for name, ref, cfg in (
            ("dist1_q8", "run_q8", rt.ColaConfig(kappa=1.0, wire="int8")),
            ("dist1_f8p", "run_f8p",
             rt.ColaConfig(kappa=1.0, wire="fp8", pipeline=True))):
        out[name] = dist1_run(
            torch, cd_glm, dist_mod, axis, name, lasso, ring, cfg, 20,
            refs[ref], bitwise=True,
            extra={"wire": cfg.wire, "pipeline": cfg.pipeline,
                   "error_feedback": True, "run_cola": ref},
            profile=lambda comm, cfg=cfg: dist1_profile(
                torch, quant, axis, lasso, ring, cfg, comm), **kw)
    attacks = [attack.Byzantine(**FULL_BYZANTINE)]
    sched, info = attack_schedule(torus, 20, attacks, lasso.d)
    atk = {n: torch.as_tensor(np.array(sched["atk_" + n][10]), device="cuda")
           for n in info.entry_names if n not in ("dishonest", "bias")}
    out["dist1_atk"] = {}
    for mode in ROBUST_MODES:
        cfg = rt.ColaConfig(kappa=1.0, robust=mode)
        ref = f"run_atk_{mode}"
        out["dist1_atk"][mode] = dist1_run(
            torch, cd_glm, dist_mod, axis, "dist1_atk", lasso, torus, cfg,
            20, refs[ref], bitwise=mode != "clip",
            extra={"robust": mode, "attack": FULL_BYZANTINE,
                   "graph": torus.name, "run_cola": ref},
            profile=lambda comm, cfg=cfg: dist1_profile(
                torch, quant, axis, lasso, torus, cfg, comm, atk=atk),
            attacks=attacks, **kw)
    cfg = rt.ColaConfig(kappa=1.0, wire="int8", robust="trim")
    ref = main_run(torch, rt, cd_glm, "dist1_rq8_run_cola", lasso, torus,
                   cfg, 20, kernel="cd_gram", other="cd_residual",
                   keep_state=True, executor="block",
                   extra={"wire": "int8", "robust": "trim"}, **kw)
    out["dist1_rq8"] = dist1_run(
        torch, cd_glm, dist_mod, axis, "dist1_rq8", lasso, torus, cfg, 20,
        ref, bitwise=True,
        extra={"wire": "int8", "robust": "trim", "error_feedback": True,
               "graph": torus.name, "run_cola": "dist1_rq8_run_cola"},
        profile=lambda comm: dist1_profile(torch, quant, axis, lasso, torus,
                                           cfg, comm), **kw)
    return out


# ---------------------------------------------------------------------------
# observability: counters, spans, the profiler bridge, the run registry
# ---------------------------------------------------------------------------

OBS_ROUNDS = 20
# body-level timing: rounds per measurement, and the turns (telemetry off
# and on alternate, each side measured twice)
OBS_TURNS = (False, True, True, False)


def telemetry_profile(torch, prob, graph, cfg, attacks, rounds: int) -> dict:
    """The round body as ``run_cola``'s block driver runs it, without and
    with the telemetry counters' update (``obs.counters.make_update`` on the
    signals the body hands out, the row written into a (T, 3) buffer), in
    turns ``OBS_TURNS``: host-clock ms per round, device ms per round
    (queued behind a sleep kernel, 4 rounds: a defended round is ~250
    launches) and the idle share, each side the mean of its turns. The
    rounds replay ``attacks``' schedule (the attack entries of each
    round) from the initial state, each side from its own state."""
    import numpy as np
    from repro_torch.core import cola, partition, quant
    from repro_torch.obs import counters as obs_counters
    k = graph.num_nodes
    part = partition.make_partition(prob.n, k)
    env = cola.build_env(prob, part)
    body = cola.make_round(prob, part, cfg)
    sched, info = attack_schedule(graph, rounds, attacks, prob.d)
    names = tuple(n for n in (info.entry_names if info else ())
                  if n not in ("dishonest", "bias"))
    on_card = lambda a: torch.as_tensor(np.array(a), device="cuda")
    w = [on_card(sched["w"][t]) for t in range(rounds)]
    active = on_card(sched["active"][0])
    atk = [{n: on_card(sched["atk_" + n][t]) for n in names} or None
           for t in range(rounds)]
    draws = (quant.wire_uniforms(0, k, prob.d, "cuda")
             if quant.is_quantized(cfg.wire) else None)
    state0 = cola._arm_wire_state(cola.init_state(prob, part), cfg, draws)
    update = obs_counters.make_update(
        cfg, obs_counters.round_increments(graph, prob.d, cfg))
    rows = torch.zeros((rounds, 3), device="cuda")
    sides = {False: {"st": state0, "t": 0},
             True: {"st": state0, "t": 0,
                    "c": obs_counters.init_counters(k, "cuda")}}

    def stepper(tel: bool):
        side = sides[tel]

        def one():
            t = side["t"] % rounds
            sig = {} if tel else None
            new = body(side["st"], env, w[t], active, None, atk=atk[t],
                       sig=sig, **cola._round_draws(draws, t))
            if tel:
                side["c"], rows[t] = update(side["c"], sig, new)
            side["st"] = new
            side["t"] += 1
        return one

    meas = {False: [], True: []}
    out = {"turns": [], "body_ms_turns": []}
    for tel in OBS_TURNS:
        meas[tel].append(timed_rounds(torch, stepper(tel), rounds,
                                      device_reps=4))
        out["turns"].append("on" if tel else "off")
        out["body_ms_turns"].append(meas[tel][-1]["ms_per_round"])
    mean = lambda tel, key: statistics.mean(m[key] for m in meas[tel])
    for key in ("ms_per_round", "device_ms_per_round"):
        out[key + "_off"], out[key + "_on"] = mean(False, key), mean(True,
                                                                     key)
        out[key.replace("_per_round", "") + "_overhead"] = \
            out[key + "_on"] / out[key + "_off"] - 1.0
    for tel, tag in ((False, "off"), (True, "on")):
        out["device_idle_share_" + tag] = \
            1.0 - out["device_ms_per_round_" + tag] / out["ms_per_round_"
                                                          + tag]
    del env
    return out


def block_span_ms(summary: dict) -> float:
    """Milliseconds in a run's block spans (``Tracer.summary()``)."""
    spans = summary["spans"]
    return 1e3 * sum(spans[n]["total_s"] for n in ("block-first-dispatch",
                                                   "block-dispatch")
                     if n in spans)


def telemetry_twin(torch, rt, cd_glm, obs_report, obs_trace, topo, name,
                   prob, graph, cfg_kw: dict, attacks, replay=None) -> dict:
    """One configuration with telemetry off and on, in turns
    (``OBS_TURNS``), ``OBS_ROUNDS`` rounds, gap+certificate with eps 1e-3,
    blocks of 8, with the launch counts zeroed just before each run and
    read just after (the Gram kernel once per executed round). Checks: the
    on run's state (EF residual included) and every history column
    bitwise the off run's, equal stop rounds; ``wire_bytes`` and
    ``permutes`` equal the executed rounds x the compiled plan's
    ``contract(wire=)``; on a wire the saturation in [0, 1) and the EF
    norm positive; under an attack the rejections on the attackers'
    columns only, equal to ``replay``'s rejected edges (``attack_profile``
    on the same rounds). Times: the run's block spans per executed round
    (host clock, each run's own tracer; the on run's from its report) and
    ``telemetry_profile`` of the round body."""
    import dataclasses as dc
    cfg_off = rt.ColaConfig(kappa=1.0, **cfg_kw)
    cfg_on = dc.replace(cfg_off, telemetry=True)
    kw = dict(recorder="gap+certificate", eps=1e-3, record_every=1,
              executor="block", block_size=8, attacks=attacks)
    runs, span_ms, walls = {}, {False: [], True: []}, {False: [], True: []}
    turns = []
    for tel in OBS_TURNS:
        cd_glm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs_trace.use(obs_trace.Tracer()) as tr:
            res = rt.run_cola(prob, graph, cfg_on if tel else cfg_off,
                              OBS_ROUNDS, device="cuda", **kw)
        torch.cuda.synchronize()
        walls[tel].append(time.perf_counter() - t0)
        launches = dict(cd_glm.LAUNCHES)
        h = res.history
        executed = executed_rounds(h, OBS_ROUNDS, kw["block_size"])
        if launches["cd_gram"] != executed or launches["cd_residual"]:
            fail(f"obs_{name}: launches {launches}, want cd_gram once per "
                 f"executed round ({executed}) and no cd_residual")
        summary = (obs_report.load_reports()[-1]["spans"] if tel
                   else tr.summary())
        if tel and summary["cache"]["bypass"] != 1:
            fail(f"obs_{name}: the report's tracer saw {summary['cache']}")
        span_ms[tel].append(block_span_ms(summary) / executed)
        turns.append(span_ms[tel][-1])
        runs[tel] = (res, launches, executed)
    (off, _, executed), (on, launches, _) = runs[False], runs[True]
    h_on = dict(on.history)
    tel = h_on.pop("telemetry")
    same = lambda a, b: (a is None and b is None) or (
        a is not None and b is not None and torch.equal(a, b))
    bitwise = {"x": same(off.state.x_parts, on.state.x_parts),
               "v": same(off.state.v_stack, on.state.v_stack),
               "ef": same(off.state.ef, on.state.ef),
               "history": h_on == off.history}
    if not all(bitwise.values()):
        fail(f"obs_{name}: telemetry on is not bitwise off: {bitwise}")
    wire = cfg_off.wire if cfg_off.wire != "fp32" else None
    contract = topo.compile_plan(graph).contract(prob.d, wire=wire)
    stop = h_on["stop_round"]
    counted = OBS_ROUNDS if stop is None else stop + 1
    if tel["rounds"] != counted or tel["wire_bytes"] != \
            counted * contract.max_collective_permute_bytes or \
            tel["permutes"] != counted * contract.max_collective_permute_count:
        fail(f"obs_{name}: {tel['rounds']} rounds, {tel['wire_bytes']} B, "
             f"{tel['permutes']} exchanges; want {counted} x "
             f"{contract.describe()}")
    if wire is not None and not (0.0 <= tel["saturation_mean"] < 1.0
                                 and tel["ef_norm"] > 0.0):
        fail(f"obs_{name}: saturation {tel['saturation_mean']}, EF norm "
             f"{tel['ef_norm']}")
    row = {"phase": "obs_" + name, "graph": graph.name, **cfg_kw,
           "attack": FULL_BYZANTINE if attacks else None,
           "rounds": OBS_ROUNDS, "stop_round": stop,
           "executed_rounds": executed, "launches": launches,
           "bitwise_off_on": bitwise,
           **{key: tel[key] for key in (
               "rounds", "wire_bytes", "permutes", "contract",
               "saturation_mean", "ef_norm", "gate_total")},
           "contract_bytes_per_round": contract.max_collective_permute_bytes,
           "run_span_ms_per_round_off": statistics.mean(span_ms[False]),
           "run_span_ms_per_round_on": statistics.mean(span_ms[True]),
           "run_span_ms_turns": turns,
           "run_wall_s_off": statistics.mean(walls[False]),
           "run_wall_s_on": statistics.mean(walls[True])}
    row["run_span_overhead"] = (row["run_span_ms_per_round_on"]
                                / row["run_span_ms_per_round_off"] - 1.0)
    if attacks:
        gate = tel["gate_rejections"]
        bad = [i for i, n in enumerate(gate)
               if n and i not in FULL_BYZANTINE["nodes"]]
        want = sum(replay["rejected_edges_per_round"][:counted])
        if bad or tel["gate_honest"] != 0 or tel["gate_total"] != want \
                or tel["dishonest_nodes"] != list(FULL_BYZANTINE["nodes"]):
            fail(f"obs_{name}: gate rejections {gate} (honest "
                 f"{tel['gate_honest']}, dishonest nodes "
                 f"{tel['dishonest_nodes']}), replay counted {want}")
        row.update(gate_rejections=gate, gate_honest=tel["gate_honest"],
                   gate_dishonest=tel["gate_dishonest"],
                   replay_rejected_edges=want)
    row.update(telemetry_profile(torch, prob, graph, cfg_off, attacks,
                                 OBS_ROUNDS))
    row["recorders_share_off"] = 1.0 - row["ms_per_round_off"] / \
        row["run_span_ms_per_round_off"]
    emit(row)
    return row


def obs_dist_phase(torch, rt, cd_glm, dist_mod, axis, prob, graph) -> list:
    """run_a and run_q8 through ``run_dist_cola`` at one NCCL rank, plan
    and dense, telemetry off then on: the on run bitwise the off run; the
    counted bytes ``OBS_ROUNDS`` x the comm's budget (0 on the block plan
    at M = 1, the all-gathered narrow payload and scales on the int8
    dense comm: 16 x 400,000 + 16 x 4 = 6,400,064 B); ``NodeAxis``'s calls
    over the run the off run's plus the one all-reduce and the one
    all-gather that combine the rank's counts (none in a round)."""
    import dataclasses as dc
    from repro_torch.core import quant
    out = []
    kw = dict(recorder="gap+certificate", eps=1e-3, record_every=1,
              block_size=8)
    for name, cfg_kw in (("dist1_a", {}), ("dist1_q8", {"wire": "int8"})):
        cfg = rt.ColaConfig(kappa=1.0, **cfg_kw)
        for comm in ("plan", "dense"):
            runs = {}
            for tel in (False, True):
                cd_glm.reset_launches()
                axis.reset_counts()
                res = dist_mod.run_dist_cola(
                    prob, graph, dc.replace(cfg, telemetry=tel), axis,
                    OBS_ROUNDS, comm=comm, device="cuda", **kw)
                runs[tel] = (res, dict(axis.counts), dict(axis.sent_bytes),
                             dict(cd_glm.LAUNCHES))
            (off, calls_off, _, _), (on, calls_on, _, launches) = \
                runs[False], runs[True]
            h_on = dict(on.history)
            tel = h_on.pop("telemetry")
            executed = executed_rounds(h_on, OBS_ROUNDS, kw["block_size"])
            if launches["cd_gram"] != executed:
                fail(f"obs_{name} ({comm}): launches {launches}")
            bitwise = (torch.equal(off.state.x_parts, on.state.x_parts)
                       and torch.equal(off.state.v_stack, on.state.v_stack)
                       and h_on == off.history)
            added = {kind: calls_on.get(kind, 0) - calls_off.get(kind, 0)
                     for kind in set(calls_on) | set(calls_off)}
            per = (0 if comm == "plan" else quant.payload_bytes(
                prob.d, cfg.wire, graph.num_nodes))
            if not bitwise or tel["wire_bytes"] != tel["rounds"] * per or \
                    {k: v for k, v in added.items() if v} != \
                    {"all-gather": 1, "all-reduce": 1}:
                fail(f"obs_{name} ({comm}): bitwise {bitwise}, "
                     f"{tel['wire_bytes']} B (want {tel['rounds']} x "
                     f"{per}), calls added {added}")
            row = {"phase": "obs_" + name, "comm": comm, "wire": cfg.wire,
                   "bitwise_off_on": bitwise, "rounds": tel["rounds"],
                   "wire_bytes": tel["wire_bytes"],
                   "bytes_per_round": per, "contract": tel["contract"],
                   "collective_calls_off": calls_off,
                   "collective_calls_added_by_telemetry": added,
                   "launches": launches}
            emit(row)
            out.append(row)
    return out


def obs_trace_phase(torch, rt, obs_trace, lasso, ring, logdir) -> dict:
    """run_a (telemetry off) under a tracer that also records a CUDA event
    at each block span's start and end: the span summary, the exported
    Chrome trace's size, and the CUDA-event device ms from the first
    block's start to the last block's end; then the same run under
    ``obs.trace.torch_profile``: the device time of the kernels (and
    copies and sets) launched inside the block spans (a kernel's launch
    call, matched by correlation id, inside a ``block-*`` annotation of
    the exported trace), and its coverage: that time over the CUDA-event
    device ms of the same rounds."""
    import os

    class EventTracer(obs_trace.Tracer):
        def __init__(self):
            super().__init__()
            self.events = []

        @contextlib.contextmanager
        def span(self, name, **meta):
            if not name.endswith("dispatch"):   # times the blocks alone
                with super().span(name, **meta):
                    yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with super().span(name, **meta):
                yield
            end.record()
            self.events.append((start, end))

    kw = dict(recorder="gap+certificate", eps=1e-3, record_every=1,
              executor="block", block_size=8)
    cfg = rt.ColaConfig(kappa=1.0)
    with obs_trace.use(EventTracer()) as tr:
        rt.run_cola(lasso, ring, cfg, OBS_ROUNDS, device="cuda", **kw)
    torch.cuda.synchronize()
    event_ms = tr.events[0][0].elapsed_time(tr.events[-1][1])
    path = tr.export(os.path.join(logdir, "tracer.json"))
    with obs_trace.torch_profile(os.path.join(logdir, "profile"),
                                 device="cuda"):
        rt.run_cola(lasso, ring, cfg, OBS_ROUNDS, device="cuda", **kw)
    with open(os.path.join(logdir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
             if ev.get("cat") == "user_annotation"
             and str(ev.get("name", "")).startswith("block-")]
    launch_ts = {ev["args"]["correlation"]: ev["ts"] for ev in events
                 if ev.get("cat") == "cuda_runtime"
                 and "correlation" in ev.get("args", {})}
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    in_span = [ev for ev in events if ev.get("cat") in dev_cats
               and any(a <= launch_ts.get(ev.get("args", {}).get(
                   "correlation"), -1.0) <= b for a, b in spans)]
    all_dev = [ev for ev in events if ev.get("cat") in dev_cats]
    prof_ms = sum(ev["dur"] for ev in in_span) / 1e3
    row = {"phase": "obs_trace", "run": "run_a", "rounds": OBS_ROUNDS,
           "span_summary": tr.summary(),
           "chrome_trace_bytes": os.path.getsize(path),
           "block_spans_in_profile": len(spans),
           "cuda_event_device_ms": event_ms,
           "profiler_kernel_ms_in_spans": prof_ms,
           "profiler_kernels_in_spans": len(in_span),
           "profiler_kernel_ms_all": sum(ev["dur"] for ev in all_dev) / 1e3,
           "profiler_trace_bytes": os.path.getsize(
               os.path.join(logdir, "profile", "trace.json"))}
    if not spans or not tr.events:
        fail(f"obs_trace: no block spans ({len(spans)} in the profile, "
             f"{len(tr.events)} timed)")
    emit(row)
    emit({"phase": "obs_profiler_coverage", "run": "run_a",
          "profiler_kernel_ms_in_spans": prof_ms,
          "cuda_event_device_ms": event_ms,
          "coverage_pct": 100.0 * prof_ms / event_ms})
    return row


def obs_phase(torch, rt, cd_glm, bl, dist_mod, topo, axis, lasso, ring,
              torus, x, y, replay_trim: dict) -> dict:
    """The ``obs`` phase (see the module): the content fingerprint's
    seconds, telemetry twins of run_a, run_q8 and run_atk_trim (and trim
    on the clean run: no rejection), the dist1 twins, DGD's modeled bytes,
    the trace and profiler rows, then the run registry these runs filled
    (a temporary directory, removed at the end) through the CLI's list,
    show, diff and timeline, and run_a's off / on twin diffed."""
    import dataclasses as dc
    import io
    import os
    import shutil
    import tempfile
    from repro_torch import attack
    from repro_torch.core import executor as exec_engine
    from repro_torch.obs import cli as obs_cli, report as obs_report, \
        trace as obs_trace
    t_phase = time.perf_counter()
    reg = tempfile.mkdtemp(prefix="obs_")
    old = os.environ.get(obs_report.ENV_DIR)
    os.environ[obs_report.ENV_DIR] = reg
    try:
        t0 = time.perf_counter()
        digest = exec_engine.fingerprint(lasso)
        t1 = time.perf_counter()
        exec_engine.fingerprint(lasso)
        emit({"phase": "obs_fingerprint", "seconds": t1 - t0,
              "memoized_seconds": time.perf_counter() - t1,
              "bytes_hashed_at_least": lasso.a.numel() * 4,
              "digest": digest[:16]})
        twins = {}
        for name, graph, cfg_kw, attacks in (
                ("run_a", ring, {}, None),
                ("run_q8", ring, {"wire": "int8"}, None),
                ("run_atk_trim", torus, {"robust": "trim"},
                 [attack.Byzantine(**FULL_BYZANTINE)])):
            twins[name] = telemetry_twin(
                torch, rt, cd_glm, obs_report, obs_trace, topo, name, lasso,
                graph, cfg_kw, attacks, replay=replay_trim)
        clean = rt.run_cola(lasso, torus, rt.ColaConfig(
            kappa=1.0, robust="trim", telemetry=True), OBS_ROUNDS,
            device="cuda", recorder="gap+certificate", eps=1e-3,
            block_size=8).history["telemetry"]
        if clean["gate_total"] != 0:
            fail(f"obs: trim on the clean run rejected "
                 f"{clean['gate_rejections']}")
        emit({"phase": "obs_run_atk_trim_clean",
              "gate_total": clean["gate_total"],
              "wire_bytes": clean["wire_bytes"]})
        dist_rows = obs_dist_phase(torch, rt, cd_glm, dist_mod, axis, lasso,
                                   ring)
        cons = bl.make_consensus_problem(x, y, NODES, loss="square",
                                         reg="l2", lam=1e-4, device="cuda")
        dgd_rounds = 5
        dgd = bl.run_dgd(cons, ring, step=1.0 / smooth_lipschitz(
            torch, x, 1e-4), rounds=dgd_rounds, device="cuda",
            telemetry=True).history["telemetry"]
        want = dgd_rounds * NODES * x.shape[1] * 4
        if dgd["wire_bytes"] != want:
            fail(f"obs_dgd: {dgd['wire_bytes']} B, want {want}")
        emit({"phase": "obs_dgd", **dgd, "want_wire_bytes": want})
        del cons
        trace_row = obs_trace_phase(torch, rt, obs_trace, lasso, ring, reg)

        # the registry: run_a's off twin as a report beside its on run
        cfg_off = rt.ColaConfig(kappa=1.0)
        off = rt.run_cola(lasso, ring, cfg_off, OBS_ROUNDS, device="cuda",
                          recorder="gap+certificate", eps=1e-3,
                          block_size=8)
        h = off.history
        obs_report.append_report(obs_report.make_report(
            driver="run_cola", problem_fp=digest,
            config=dc.asdict(cfg_off),
            graph={"kind": ring.name, "num_nodes": ring.num_nodes},
            rounds=(OBS_ROUNDS if h["stop_round"] is None
                    else h["stop_round"] + 1), history=h))
        reports = obs_report.load_reports()
        on_a = next(i for i, r in enumerate(reports)
                    if r["driver"] == "run_cola"
                    and r["config"]["wire"] == "fp32"
                    and r["config"]["robust"] is None)
        twin = obs_report.diff_reports(reports[-1], reports[on_a])
        if not twin["only_telemetry"] or twin["history"]:
            fail(f"obs: run_a's off / on twin diffs as {twin}")
        outs = {}
        for args in (["list"], ["show", "-1"], ["diff", str(on_a), "-1"],
                     ["timeline", str(on_a)]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = obs_cli.main(["--dir", reg] + args)
            if rc != 0:
                fail(f"obs: `obs {' '.join(args)}` exited {rc}")
            outs[args[0]] = buf.getvalue()
        if "only_telemetry: True" not in outs["diff"]:
            fail(f"obs: the CLI's diff says {outs['diff']!r}")
        emit({"phase": "obs_report", "runs_in_registry": len(reports),
              "drivers": sorted({r["driver"] for r in reports}),
              "twin_only_telemetry": twin["only_telemetry"],
              "twin_history_delta": twin["history"],
              "twin_config_delta": twin["config"],
              "cli_lines": {k: len(v.splitlines()) for k, v in outs.items()},
              "timeline": outs["timeline"].splitlines()[:8]})
    finally:
        if old is None:
            os.environ.pop(obs_report.ENV_DIR, None)
        else:
            os.environ[obs_report.ENV_DIR] = old
        shutil.rmtree(reg, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "obs_total", "seconds": seconds})
    return {"twins": twins, "dist": dist_rows, "trace": trace_row,
            "seconds": seconds}


# one block of the full-width runs the analysis phase traces
ANALYSIS_ROUNDS = 8


def analysis_drivers(torch, axis) -> dict:
    """Every registered driver and seeded violation of
    ``repro_torch.analysis`` on the card, over the one-rank NCCL group:
    the simulator drivers PASS; the dist drivers, which need 3 or 4 ranks,
    SKIP with their reason (the CPU tests run them on 4 gloo ranks);
    every fixture CAUGHT, the ``.item()`` in a round body by
    ``set_sync_debug_mode("error")``, except a fixture that needs more
    ranks than one (SKIP with its reason)."""
    from repro_torch.analysis import drivers, selftest
    out = {"drivers": {}, "selftests": {}}
    with drivers.settings(device="cuda", axis=axis):
        for name in sorted(drivers.DRIVER_REGISTRY):
            t0 = time.perf_counter()
            res = drivers.run_one(drivers.DRIVER_REGISTRY[name])
            status = {"skip": "SKIP", "findings": "FAIL" if res["findings"]
                      else "PASS"}.get(res["status"], "FAIL")
            emit({"phase": "analysis_driver", "driver": name,
                  "status": status, "findings": res["findings"],
                  "detail": res["detail"][-2000:],
                  "seconds": time.perf_counter() - t0})
            if status == "FAIL" or (
                    status == "SKIP"
                    and drivers.DRIVER_REGISTRY[name].ranks <= axis.size):
                fail(f"analysis: driver {name} {status}: "
                     f"{res['findings'] or res['detail']}")
            out["drivers"][name] = status
        for name, caught, detail in selftest.run_selftests():
            status = {None: "SKIP", True: "CAUGHT", False: "MISSED"}[caught]
            emit({"phase": "analysis_selftest", "selftest": name,
                  "status": status, "detail": detail[-2000:]})
            if caught is False or (caught is None and
                                   selftest.SELFTESTS[name].ranks <= 1):
                fail(f"analysis: selftest {name} {status}: {detail}")
            out["selftests"][name] = status
    return out


def analysis_block(torch, rt, cd_glm, obs_trace, name, prob, graph, cfg,
                   attacks) -> dict:
    """The trace passes over one warmed full-width block of ``run_cola``
    (``ANALYSIS_ROUNDS`` rounds, gap+certificate with eps 1e-3, one
    block): zero findings, and no kernel built or loaded and one cache
    bypass for its one block-executor call on the warmed run (the
    retrace pass). Beside it the block's host span (``obs.trace``) traced
    and untraced, in turns untraced, traced, untraced: the passes' host
    cost per block."""
    from repro_torch.analysis import passes

    def run():
        return rt.run_cola(prob, graph, cfg, ANALYSIS_ROUNDS, device="cuda",
                           recorder="gap+certificate", eps=1e-3,
                           block_size=ANALYSIS_ROUNDS, attacks=attacks)

    def spans(fn):
        with obs_trace.use(obs_trace.Tracer()) as tracer:
            out = fn()
        torch.cuda.synchronize()
        return out, block_span_ms(tracer.summary())

    run()
    _, plain_a = spans(run)
    cd_glm.reset_launches()
    with passes.RetraceMonitor() as mon:
        trace, traced_ms = spans(lambda: passes.trace_ops(run))
    launches = dict(cd_glm.LAUNCHES)
    _, plain_b = spans(run)
    findings = (passes.trace_passes(trace, where=name)
                + passes.retrace_findings(mon, name))
    in_rounds = [op for op in trace.within("round")]
    row = {"phase": "analysis_" + name, "rounds": ANALYSIS_ROUNDS,
           "findings": [str(f) for f in findings],
           "ops": len(trace.ops), "ops_in_rounds": len(in_rounds),
           "ops_in_round_bodies": sum(1 for _ in trace.within("step")),
           "float_dtypes_in_block": sorted({
               str(m.dtype) for op in trace.within("block")
               for m in op.outputs if m.dtype.is_floating_point}),
           "launches_in_round_bodies": trace.launch_counts("step"),
           "launches": launches, "sync_debug_armed": True,
           "sync_errors": len(trace.sync_errors),
           "cache_events": [kind for _, kind in mon.events],
           "block_executor_calls": mon.runs, "builds_on_warmed_run":
               mon.builds,
           "block_span_ms_untraced": [plain_a, plain_b],
           "block_span_ms_traced": traced_ms,
           "passes_host_ms_per_block": traced_ms - (plain_a + plain_b) / 2}
    emit(row)
    if findings or not in_rounds or \
            launches["cd_gram"] != ANALYSIS_ROUNDS:
        fail(f"analysis_{name}: findings {row['findings']}, "
             f"{len(in_rounds)} ops in rounds, launches {launches}")
    return row


def analysis_round_ops(torch, rt, prob, graph) -> dict:
    """``op_analysis.analyze`` of one run_a round body (the round
    ``run_cola`` runs, without its recorder): flops, bytes, the ctypes
    launches it lists as opaque (one ``cd_gram``), and the bytes over the
    same call's device ms (CUDA events behind a sleep kernel) against the
    card's HBM rate."""
    import numpy as np
    from repro_torch.core import cola, partition, topology
    from repro_torch.launch import op_analysis
    cfg = rt.ColaConfig(kappa=1.0)
    part = partition.make_partition(prob.n, graph.num_nodes)
    env = cola.build_env(prob, part)
    body = cola.make_round(prob, part, cfg)
    state = cola.init_state(prob, part)
    w = torch.as_tensor(topology.metropolis_weights(graph).astype(
        np.float32), device="cuda")
    active = torch.ones((graph.num_nodes,), device="cuda")
    body(state, env, w, active)
    rep = op_analysis.analyze(body, state, env, w, active)
    dev_ms = device_ms(torch, lambda: body(state, env, w, active), 5)
    row = {"phase": "analysis_op_count", "run": "run_a round body",
           "flops": rep["flops"], "bytes": rep["bytes"],
           "opaque": rep["opaque"], "aten_ops": rep["ops"],
           "collectives_total": rep["collectives"]["total"],
           "device_ms": dev_ms,
           "bytes_per_s": rep["bytes"] / (dev_ms * 1e-3),
           "hbm_share": rep["bytes"] / (dev_ms * 1e-3) / HBM_BYTES_PER_S}
    emit(row)
    if rep["opaque"] != {"cd_gram": 1}:
        fail(f"analysis_op_count: opaque launches {rep['opaque']}, want "
             "one cd_gram")
    del env
    return row


def analysis_contracts(torch, rt, axis, prob, graph) -> list:
    """One round of dist1_a's body at one NCCL rank held to its contract:
    the block plan at M = 1 exchanges 0 bytes and calls nothing, within
    ``contract()`` (its per-rank ``check``: one rank may be unmatched in
    every color); the dense comm all-gathers the fp32 stack (16 x 400,000
    x 4 = 25,600,000 B) and the int8 one the narrow payload and its scales
    (6,400,064 B), each within ``gather_contract``."""
    from repro_torch.analysis import contracts, drivers
    rows = []
    with drivers.settings(device="cuda", axis=axis):
        for comm, wire, want in (("plan", "fp32", 0),
                                 ("dense", "fp32",
                                  graph.num_nodes * prob.d * 4),
                                 ("dense", "int8",
                                  graph.num_nodes * (prob.d + 4))):
            cfg = rt.ColaConfig(kappa=1.0, wire=wire)
            report, plan, _, _ = drivers.dist_round(prob, graph, cfg, axis,
                                                    comm=comm)
            coll = report["collectives"]
            counts = report["collective_counts"]
            if comm == "plan":
                contract = plan.contract(prob.d)
                contract.check({"permute": counts["collective-permute"],
                                **{k: counts[k] for k in contract.forbid}},
                               {"permute": coll["collective-permute"]})
                ok = coll["total"] == 0 and counts["total"] == 0
            else:
                contract = contracts.gather_contract(
                    f"dense-oracle-{wire}",
                    min_all_gather_bytes=prob.d * 4 if wire == "fp32"
                    else prob.d)
                contracts.check_comm(report, contract)
                ok = coll["all-gather"] == want and coll["total"] == want
            row = {"phase": "analysis_contract", "run": "dist1_a",
                   "comm": comm, "wire": wire, "ranks": axis.size,
                   "contract": contract.describe(), "bytes": coll,
                   "calls": counts, "want_bytes": want}
            emit(row)
            if not ok:
                fail(f"analysis_contract dist1_a {comm} {wire}: {coll}, "
                     f"want {want} B")
            rows.append(row)
    return rows


def analysis_phase(torch, rt, cd_glm, axis, lasso, ring, torus) -> dict:
    """The ``analysis`` phase (see the module)."""
    from repro_torch import attack
    from repro_torch.core import metrics
    from repro_torch.obs import trace as obs_trace
    t_phase = time.perf_counter()
    out = {"drivers": analysis_drivers(torch, axis)}
    for name, graph, cfg_kw, attacks in (
            ("run_a", ring, {}, None),
            ("run_q8", ring, {"wire": "int8"}, None),
            ("run_atk_trim", torus, {"robust": "trim"},
             [attack.Byzantine(**FULL_BYZANTINE)])):
        out[name] = analysis_block(torch, rt, cd_glm, obs_trace, name, lasso,
                                   graph, rt.ColaConfig(kappa=1.0, **cfg_kw),
                                   attacks)
    out["op_count"] = analysis_round_ops(torch, rt, lasso, ring)
    out["contracts"] = analysis_contracts(torch, rt, axis, lasso, ring)
    footprints = metrics.render_footprints(NODES, EPS_FEATURES, EPS_SAMPLES
                                           // NODES)
    print(footprints, flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "analysis_total", "seconds": out["seconds"],
          "footprint_lines": len(footprints.splitlines())})
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
    global HBM_BYTES_PER_S, BF16_TC_FLOPS
    from repro_torch.launch import mesh as mesh_mod
    HBM_BYTES_PER_S, BF16_TC_FLOPS = mesh_mod.HBM_BW, mesh_mod.PEAK_FLOPS_BF16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    import repro_torch as rt
    from repro_torch import attack, dist as dist_mod, topo
    from repro_torch.core import baselines as bl, metrics, mixing, quant, \
        schedule, subproblem, topology
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, cd_glm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import attention, mlp as mlp_mod, ssm as ssm_mod
    from repro_torch.optim import gossip as gossip_mod, privacy
    from repro_torch.train import data as data_mod, steps as steps_mod

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
    split_comb_112 = split_combine_phase(torch, fa, attention._mode_mask,
                                         case="decode_sliding_hd112_2src")
    gvr = gram_vs_residual_phase(torch, cd_glm, subproblem)
    small_phase(torch, rt, topology, synthetic, cd_glm)
    small_churn_phase(torch, rt, topology, synthetic, cd_glm)
    small_wire_phase(torch, rt, topology, synthetic, cd_glm, metrics)
    small_participation_phase(torch, rt, topology, synthetic, cd_glm,
                              metrics, schedule)
    small_baselines_phase(torch, bl, topology, synthetic)
    small_attack_phase(torch, rt, topology, synthetic, cd_glm, metrics,
                       attack, bl)

    ring = topology.ring(NODES)
    x, y = regression_on_device(torch, EPS_SAMPLES, EPS_FEATURES, seed=0)
    lasso = rt.PROBLEMS["lasso"](x, y, 0.05, box=10.0, device="cuda")
    run_a = main_run(torch, rt, cd_glm, "run_a", lasso, ring,
                     rt.ColaConfig(kappa=1.0), 20, kernel="cd_gram",
                     other="cd_residual", recorder="gap+certificate",
                     eps=1e-3, record_every=1, executor="block",
                     block_size=8, keep_state=True)
    # run_a on the quantized wire: int8 with EF; fp8 with EF, pipelined,
    # held bitwise to the unpipelined fp8 run; client sampling over
    # complete(16)
    run_q8 = wire_run(torch, rt, cd_glm, quant, mixing, "run_q8", lasso,
                      ring, "int8", run_a)
    run_f8p = wire_run(torch, rt, cd_glm, quant, mixing, "run_f8p", lasso,
                       ring, "fp8", run_a, pipeline=True)
    run_part = main_run(
        torch, rt, cd_glm, "run_part", lasso, topology.complete(NODES),
        rt.ColaConfig(kappa=1.0, participation=schedule.SampleConfig(
            k_active=NODES // 2)), 20, kernel="cd_gram", other="cd_residual",
        profile=lambda: participation_profile(
            torch, rt, schedule, lasso, topology.complete(NODES),
            rt.ColaConfig(kappa=1.0, participation=schedule.SampleConfig(
                k_active=NODES // 2)), 5),
        recorder="gap+certificate", eps=1e-3, record_every=1,
        executor="block", block_size=8,
        extra={"k_active": NODES // 2, "mode": "dense", "stream": True,
               "run_a_ms_per_round": run_a["ms_per_round"]})
    # the same lasso over 4 nodes: n_k = 500, G streamed
    run_c = main_run(torch, rt, cd_glm, "run_c", lasso, topology.ring(4),
                     rt.ColaConfig(kappa=1.0, cd_mode="auto"), 20,
                     kernel="cd_gram", other="cd_residual",
                     recorder="gap+certificate", eps=1e-3, record_every=1,
                     executor="block", block_size=8)
    # the same lasso under churn on Fig. 4's graph: leavers freeze, reset
    run_d = churn_run(torch, rt, cd_glm, "run_d", lasso, leave_mode="freeze")
    run_e = churn_run(torch, rt, cd_glm, "run_e", lasso, leave_mode="reset")
    # the topology compiler's executors; then run_a, run_d and run_e
    # through the distributed runtime at world size 1 on NCCL, each held
    # to its run_cola run above
    init_nccl_group(torch)
    axis = dist_mod.NodeAxis()
    topo_plan_phase(torch, topology, mixing, topo)
    coll = collective_device_ms(torch, axis, NODES, EPS_SAMPLES)
    cfg_a = rt.ColaConfig(kappa=1.0)
    dist1_a = dist1_run(
        torch, cd_glm, dist_mod, axis, "dist1_a", lasso, ring, cfg_a, 20,
        run_a, profile=lambda comm: dict(
            round_profile(torch, lasso, ring, cfg_a, 3,
                          make_body=dist_body(axis, comm, ring, cfg_a,
                                              churn=False)),
            collective_device_ms=coll),
        recorder="gap+certificate", eps=1e-3, record_every=1, block_size=8)
    graph_d, cfg_d, active_d, budgets_d = churn_inputs(20)
    dist1_d = {}
    for mode, ref in (("freeze", run_d), ("reset", run_e)):
        sched_d = churn_schedule(graph_d, active_d, budgets_d, mode)
        dist1_d[mode] = dist1_run(
            torch, cd_glm, dist_mod, axis, "dist1_d", lasso, graph_d, cfg_d,
            20, ref, extra={"leave_mode": mode, "graph": graph_d.name},
            profile=lambda comm: churn_profile(
                torch, lasso, graph_d, cfg_d, sched_d,
                make_body=dist_body(axis, comm, graph_d, cfg_d, churn=True),
                reset_total=lambda c: axis.psum(c.sum(dim=0))),
            recorder="gap+certificate", eps=1e-3, record_every=1,
            block_size=8, active_schedule=active_d,
            budget_schedule=budgets_d, leave_mode=mode)
    for run in (run_a, run_d, run_e):
        run.pop("state", None)
    # the same lasso on the reference's attack graph, torus_2d(4, 4):
    # clean, attacked (undefended, with an eavesdropper), each defense,
    # trim on a clean run, and trim on the int8 wire with EF
    torus = topology.torus_2d(4, 4)
    atk_runs = {}
    for name, robust, attacked, wire, eavesdrop in (
            ("run_atk_clean", None, False, "fp32", False),
            ("run_atk_none", None, True, "fp32", True),
            ("run_atk_trim", "trim", True, "fp32", False),
            ("run_atk_median", "median", True, "fp32", False),
            ("run_atk_clip", "clip", True, "fp32", False),
            ("run_atk_trim_clean", "trim", False, "fp32", False),
            ("run_atk_q8", "trim", True, "int8", False)):
        atk_runs[name] = attack_run(
            torch, rt, cd_glm, mixing, quant, attack, name, lasso, torus,
            robust=robust, attacked=attacked, wire=wire, eavesdrop=eavesdrop)
    a, b = (atk_runs[n]["state"] for n in ("run_atk_trim_clean",
                                           "run_atk_clean"))
    emit({"phase": "run_atk_trim_clean_vs_clean",
          "max_abs_diff_v": float((a.v_stack - b.v_stack).abs().max()),
          "max_abs_diff_x": float((a.x_parts - b.x_parts).abs().max()),
          "max_abs_v": float(b.v_stack.abs().max()),
          "rejected_edges_trim_clean": sum(
              atk_runs["run_atk_trim_clean"]["rejected_edges_per_round"])})
    # trim on a clean run rejects nothing, so it is the linear mix: the
    # same product on the same values, bitwise
    if not (torch.equal(a.v_stack, b.v_stack)
            and torch.equal(a.x_parts, b.x_parts)):
        fail("run_atk_trim_clean: the final state is not bitwise "
             "run_atk_clean's")
    side = atk_runs["run_atk_trim"]["side"]
    gate_step_check(torch, mixing, side["w"], side["v"], side["v_send"])
    # the wire, the defenses and the attacks through the distributed
    # runtime at one rank, each held to its run_cola run above
    dist1_wire_phases(torch, rt, cd_glm, dist_mod, quant, attack, axis,
                      lasso, ring, torus,
                      {"run_q8": run_q8, "run_f8p": run_f8p, **atk_runs})
    # telemetry: run_a, run_q8 and run_atk_trim off and on, the dist1
    # twins, DGD, the trace and the profiler's coverage, the run registry
    obs = obs_phase(torch, rt, cd_glm, bl, dist_mod, topo, axis, lasso, ring,
                    torus, x, y, atk_runs["run_atk_trim"])
    # contract analysis: the drivers and seeded violations on the card, the
    # passes over warmed full-width blocks, one round's op counts, dist1_a's
    # contracts at one rank
    analysis = analysis_phase(torch, rt, cd_glm, axis, lasso, ring, torus)
    for run in (run_q8, run_f8p, *atk_runs.values()):
        for key in ("state", "taps", "side"):
            run.pop(key, None)
    del a, b, side
    torch.cuda.empty_cache()
    del lasso
    torch.cuda.empty_cache()
    ridge = rt.PROBLEMS["ridge_dual"](x, y, 1e-2, device="cuda")
    run_b = main_run(torch, rt, cd_glm, "run_b", ridge, ring,
                     rt.ColaConfig(kappa=1.0), 5, kernel="cd_residual",
                     other="cd_gram", recorder="gap", record_every=1,
                     executor="block", block_size=8)
    del ridge
    torch.cuda.empty_cache()
    plain = baselines_phase(torch, bl, topology, x, y)
    baselines_robust_phase(torch, bl, topology, x, y, plain)
    del x, y
    torch.cuda.empty_cache()
    # a million clients, a thousand a round; half as many if the card's
    # memory does not hold them
    try:
        run_cohort = cohort_run(torch, rt, cd_glm, schedule, topology,
                                COHORT_CLIENTS)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        emit({"phase": "run_cohort_cut", "clients": COHORT_CLIENTS,
              "cut_to": COHORT_CLIENTS // 2,
              "reason": "out of device memory"})
        run_cohort = cohort_run(torch, rt, cd_glm, schedule, topology,
                                COHORT_CLIENTS // 2)

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
    small = serve_small_phase(torch, rt, fa, serve_mod, small_cfg)
    torch.cuda.empty_cache()
    # MoE serving: Llama-4-Maverick at full width (one group), then two
    # small MoE shapes card vs CPU
    # with ep_moe_a: the same group through the expert-parallel branch on
    # a 1 x 1 mesh over the NCCL rank
    ep_mesh = mesh_mod.make_host_mesh(1, 1)
    moe_a = serve_moe_a_phase(torch, rt, fa, serve_mod, mlp_mod,
                              ep_mesh=ep_mesh)
    moe_small = serve_moe_small_phase(torch, rt, fa, serve_mod, mlp_mod)
    # the recurrent families: Zamba2-7B at full width and depth, then the
    # xLSTM and Zamba2 smoke variants card vs CPU
    hybrid_a = serve_hybrid_a_phase(torch, rt, fa, serve_mod)
    ssm_small = ssm_small_phase(torch, rt, fa, steps_mod, serve_mod)
    # the encdec and vlm families: SeamlessM4T-medium and InternVL2-26B at
    # full width and depth, then both smoke variants card vs CPU
    encdec_a = serve_encdec_a_phase(torch, rt, fa, serve_mod)
    vlm_a = serve_vlm_a_phase(torch, rt, fa, serve_mod)
    zoo_small = ssm_small_phase(torch, rt, fa, steps_mod, serve_mod,
                                archs=("seamless_m4t_medium",
                                       "internvl2_26b"), phase="zoo_small")
    # examples/torch_serve_batched.py's three smoke archs, card vs CPU
    serve_batched_phase(torch, rt, fa)

    # training: the flash Function's gradient, card vs CPU at the smoke
    # width, then Qwen3-4B at full width through launch.train
    attn_grad = attn_grad_phase(torch, fa)
    train_small = train_small_phase(torch, rt, fa, train_mod, steps_mod,
                                    data_mod, gossip_mod, privacy)
    train_a = train_a_phase(torch, rt, fa, train_mod, steps_mod, data_mod)
    # the dry run's per-rank bytes against serve_vlm_a's and train_a's
    dryrun_card_phase(torch, rt, vlm_a, train_a)
    gossip_args = (rt, fa, train_mod, steps_mod, data_mod, gossip_mod,
                   privacy)
    train_gossip = gossip_phase_or_cut(torch, *gossip_args,
                                       name="train_gossip", layers=2)
    train_gossip_dp = gossip_phase_or_cut(torch, *gossip_args,
                                          name="train_gossip_dp", layers=2,
                                          dp=True)
    # MoE training (dbrx: small shapes card vs CPU, then full width, one
    # layer, 8 experts) and the recurrent families' training (Zamba2 at 9
    # of 27 groups, xLSTM-125M whole)
    moe_train_small = train_moe_small_phase(torch, rt, fa, steps_mod,
                                            mlp_mod)
    ep_train_small_phase(torch, rt, fa, steps_mod, ep_mesh)
    train_moe_a = train_moe_a_phase(torch, rt, fa, train_mod, steps_mod,
                                    data_mod, mlp_mod)
    train_hybrid_a = train_hybrid_a_phase(torch, rt, fa, train_mod,
                                          steps_mod, data_mod)
    train_xlstm_a_phase(torch, rt, fa, train_mod, steps_mod, data_mod,
                        ssm_mod)
    # the encdec and vlm families' training (SeamlessM4T whole, InternVL2
    # at 4 of 48 layers), on batches built here with their frontend input
    train_encdec_a = train_encdec_a_phase(torch, rt, fa, train_mod,
                                          steps_mod, data_mod)
    train_vlm_a = train_vlm_a_phase(torch, rt, fa, train_mod, steps_mod,
                                    data_mod)

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
        launches_run_q8=run_q8["launches"]["cd_gram"],
        launches_run_f8p=run_f8p["launches"]["cd_gram"],
        launches_run_part=run_part["launches"]["cd_gram"],
        launches_run_cohort=run_cohort["launches"]["cd_gram"],
        **{f"launches_{name}": run["launches"]["cd_gram"]
           for name, run in atk_runs.items()},
        **{f"launches_obs_{name}": row["launches"]["cd_gram"]
           for name, row in obs["twins"].items()},
        launches_dist1_a={comm: row["launches"]["cd_gram"]
                          for comm, row in dist1_a.items()},
        launches_dist1_d={f"{mode}_{comm}": row["launches"]["cd_gram"]
                          for mode, rows in dist1_d.items()
                          for comm, row in rows.items()},
        **{f"launches_analysis_{name}": analysis[name]["launches"]["cd_gram"]
           for name in ("run_a", "run_q8", "run_atk_trim")},
        n_k_2=gram_at(2),
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
                 "hd 128)",
        "launches_serve_moe_a": moe_a["launches"]["flash_mma"],
        "launches_ep_moe_a": moe_a["ep_moe_a"]["launches"]["flash_mma"],
        "launches_train_a": train_a["launches"]["flash_mma"],
        "launches_train_gossip": train_gossip["launches"]["flash_mma"],
        "launches_train_gossip_dp":
            train_gossip_dp["launches"]["flash_mma"],
        "launches_serve_hybrid_a": hybrid_a["launches"]["flash_mma"],
        "launches_train_moe_a": train_moe_a["launches"]["flash_mma"],
        "launches_train_hybrid_a": train_hybrid_a["launches"]["flash_mma"],
        "launches_serve_encdec_a": encdec_a["launches"]["flash_mma"],
        "launches_serve_vlm_a": vlm_a["launches"]["flash_mma"],
        "launches_train_encdec_a": train_encdec_a["launches"]["flash_mma"],
        "launches_train_vlm_a": train_vlm_a["launches"]["flash_mma"],
        "encoder": {key: by_case[("encoder", "bfloat16")][key]
                    for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "max_abs_err")},
        "hd112": {key: by_case[("sliding_hd112", "bfloat16")][key]
                  for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "max_abs_err")},
        "training": {key: attn_grad["bfloat16"][key] for key in (
            "forward_ms", "forward_device_ms", "backward_ms",
            "backward_device_ms", "backward_bound_ms", "backward_bound_by",
            "plain_fwd_bwd_ms", "sdpa_fwd_bwd_ms", "errors")}})
    kernels.append({
        "name": "flash_split", "route": "cuda", "source": flash_src,
        "replaces": flash_replaces,
        "launches": serve_a["launches"]["flash_split"],
        "launches_serve_moe_a": moe_a["launches"]["flash_split"],
        "launches_ep_moe_a": moe_a["ep_moe_a"]["launches"]["flash_split"],
        "launches_serve_moe_small": sum(r["launches"]["flash_split"]
                                        for r in moe_small),
        "launches_serve_hybrid_a": hybrid_a["launches"]["flash_split"],
        "launches_ssm_small": sum(r["launches"]["flash_split"]
                                  for r in ssm_small),
        "launches_serve_encdec_a": encdec_a["launches"]["flash_split"],
        "launches_serve_vlm_a": vlm_a["launches"]["flash_split"],
        "launches_zoo_small": sum(r["launches"]["flash_split"]
                                  for r in zoo_small),
        "decode_cross": {**timing(by_case[("decode_cross", "bfloat16")]),
                         "max_abs_err": by_case[("decode_cross",
                                                 "bfloat16")]["max_abs_err"],
                         "splits": by_case[("decode_cross",
                                            "bfloat16")]["splits"],
                         "shape": "cross decode, bf16, with the combine "
                                  "(B=8, Sq=1, Skv=1500, 16/16 heads, "
                                  "hd 64)"},
        "max_abs_err": max(split_comb["flash_split"]["max_abs_err"],
                           split_comb_112["flash_split"]["max_abs_err"],
                           err_of("split", "bfloat16")),
        "hd112": timing(split_comb_112["flash_split"]),
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
        "launches_serve_moe_a": moe_a["launches"]["flash_combine"],
        "launches_ep_moe_a": moe_a["ep_moe_a"]["launches"]["flash_combine"],
        "launches_serve_moe_small": sum(r["launches"]["flash_combine"]
                                        for r in moe_small),
        "launches_serve_hybrid_a": hybrid_a["launches"]["flash_combine"],
        "launches_ssm_small": sum(r["launches"]["flash_combine"]
                                  for r in ssm_small),
        "launches_serve_encdec_a": encdec_a["launches"]["flash_combine"],
        "launches_serve_vlm_a": vlm_a["launches"]["flash_combine"],
        "launches_zoo_small": sum(r["launches"]["flash_combine"]
                                  for r in zoo_small),
        "max_abs_err": max(split_comb["flash_combine"]["max_abs_err"],
                           split_comb_112["flash_combine"]["max_abs_err"]),
        "hd112": timing(split_comb_112["flash_combine"]),
        **timing(split_comb["flash_combine"]),
        "shape": f"decode partials, {decode['splits']} splits of "
                 "(8, 8, 4 rows, 128)"})
    prefill32 = by_case[("prefill", "float32")]
    kernels.append({
        "name": "flash_tf32", "route": "cuda", "source": flash_src,
        "replaces": flash_replaces,
        "launches": small["launches"]["flash_tf32"],
        "launches_in": "serve_small (fp32: its route at prefill)",
        "launches_train_small": train_small["launches_cuda"]["flash_tf32"],
        "launches_serve_moe_small": sum(r["launches"]["flash_tf32"]
                                        for r in moe_small),
        "launches_ssm_small": sum(r["launches"]["flash_tf32"]
                                  for r in ssm_small),
        "launches_train_moe_small": sum(r["launches"]["flash_tf32"]
                                        for r in moe_train_small),
        "launches_zoo_small": sum(r["launches"]["flash_tf32"]
                                  for r in zoo_small),
        "max_abs_err": err_of("tf32", "float32"),
        **timing(prefill32),
        "bound_peak": "3 x FLOPs at the TF32 tensor-core peak",
        "bound_fp32_cuda_cores_ms": prefill32["bound_fp32_cuda_cores_ms"],
        "shape": "prefill, fp32 (B=8, Sq=1024, Skv=2080, 32/8 heads, "
                 "hd 128)"})
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    for key in ("launches_ep_moe_a", "launches_train_a",
                "launches_serve_hybrid_a",
                "launches_train_moe_a", "launches_train_hybrid_a",
                "launches_serve_encdec_a", "launches_serve_vlm_a",
                "launches_train_encdec_a", "launches_train_vlm_a"):
        if not next(k for k in kernels if k["name"] == "flash_mma")[key] > 0:
            idle.append(f"flash_mma ({key[len('launches_'):]})")
    for name in ("flash_split", "flash_combine"):
        for key in ("launches_ep_moe_a", "launches_serve_encdec_a",
                    "launches_serve_vlm_a", "launches_zoo_small"):
            if not next(k for k in kernels if k["name"] == name)[key] > 0:
                idle.append(f"{name} ({key[len('launches_'):]})")
    if not next(k for k in kernels
                if k["name"] == "flash_tf32")["launches_zoo_small"] > 0:
        idle.append("flash_tf32 (zoo_small)")
    if idle:
        fail(f"kernels not launched on their main path: {idle}")
    import torch.distributed
    torch.distributed.destroy_process_group()
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
