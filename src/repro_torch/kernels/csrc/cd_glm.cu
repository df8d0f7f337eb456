// Hopper (sm_90a) kernels for the CoLA local subproblem solver (paper Eq. 1-2).
//
// Both kernels run, for every node k, `num_steps` cyclic coordinate-descent
// steps of the local quadratic subproblem and apply the generalized
// elastic-net prox
//
//   u      = z - step * grad_i - step * lin_i,   step = 1 / (sigma'/tau ||A_i||^2)
//   z_new  = clip(soft(u, step * l1) / (1 + step * l2), +-box)
//   delta  = z_new - z      (0 for padded / zero-norm coordinates, and for
//                            every step t >= budget[k])
//
// cd_residual_kernel replaces src/repro/kernels/cd_glm.py::_cd_kernel
// (launched by cd_solve_blocks): grad_i = A_i^T (grad + sigma'/tau r),
// r += A_i delta, with A given as contiguous rows A_i (layout (K, n_k, d)).
//
// cd_gram_kernel replaces src/repro/kernels/cd_glm.py::_cd_kernel_gram
// (launched by cd_solve_blocks_gram): grad_i = c_i + sigma'/tau h_i,
// h += G[:, i] delta, with ||A_i||^2 = diag(G), G given as its columns
// stored as contiguous rows (layout (K, n_k, ld)).
//
// The Pallas kernels' sequential fori_loop with VMEM carries becomes a loop
// inside one thread block per node. Unlike the TPU kernels these take a (K,)
// int32 step budget (NULL = no budget): the main path passes one.
//
// What bounds them on this card: each step is a dependent chain — a
// block-wide reduction (residual kernel) or a shuffle (Gram kernel) — and
// only K of the 132 SMs are busy; the bytes/peak bound (one read of A or G)
// is far below. The residual kernel keeps memory off that chain: rows are
// prefetched through a cp.async ring, the per-coordinate scalars are staged
// in shared memory ahead of use, r and grad sit in registers, and a step
// has one barrier (every thread computes the prox step itself). The Gram
// kernel runs each node's recurrence in one warp with no barrier in the
// step loop and no division on it (see its section below).
// Clusters that split d over several SMs per node are the next step.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, loaded with ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;

// Scalar step shared by both kernels: returns delta for coordinate i.
__device__ __forceinline__ float prox_delta(float z, float g, float q,
                                            float lin, float mask, bool live,
                                            float l1, float l2, float box) {
  float q_safe = q > 0.f ? q : 1.f;
  float step = 1.f / q_safe;
  float u = z - g * step - step * lin;
  float mag = fmaxf(fabsf(u) - step * l1, 0.f);
  float soft = u > 0.f ? mag : (u < 0.f ? -mag : 0.f);
  float z_new = fminf(fmaxf(soft / (1.f + step * l2), -box), box);
  bool ok = live && (q > 0.f) && (mask > 0.f);
  return ok ? z_new - z : 0.f;
}

__device__ __forceinline__ int live_steps(const int* budgets, int k,
                                          int num_steps) {
  if (budgets == nullptr) return num_steps;
  int b = budgets[k];
  b = b < 0 ? 0 : b;
  return b < num_steps ? b : num_steps;
}

// ---------------------------------------------------------------------------
// Residual kernel: one block per node, one barrier per step.
//
// * Rows A_i stream through a shared-memory ring of `stages` rows (4-8),
//   issued stages - 1 steps ahead with cp.async (16-byte copies when d is
//   a multiple of 4, 4-byte otherwise). When even four rows do not fit
//   (d > ~13,000) the kernel reads each row from global memory (RING =
//   false).
// * r and grad live in registers when d <= RPT * threads (thread t owns
//   j = t + e * threads), else in shared memory (r_smem) or, when 2 d
//   floats do not fit either, r in scratch[k, 0:d] and grad in global.
// * x, lin, mask and dx move through two shared-memory buffers of kChunk
//   coordinates: while the steps walk one chunk, the next one's x, lin and
//   mask are in flight (cp.async) and its dx is read back; dx is written
//   back when the walk leaves a chunk. Each step reads its scalars from
//   shared memory before the barrier (dx[i] was last written n_k >= 2 steps
//   earlier; for n_k = 1 every thread keeps the value in a register).
// * ||A_i||^2 is summed in the same pass as the dot product (no prologue
//   over A). Each warp writes (dot, ||A_i||^2) into warp_sums[t & 1]; after
//   the one barrier every thread sums them in the same order and computes
//   the same prox step itself; thread 0 alone stores dx[i].
// ---------------------------------------------------------------------------
constexpr int kChunk = 1024;
constexpr int kMaxStages = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
  }
}

// Dynamic shared memory holds, in order: the ring (stages x d_pad floats,
// when RING), r and grad (2 d floats, when RPT = 0 and r_smem), and the
// two chunk buffers (2 x 4 x kChunk floats: x, lin, mask, dx).
template <int RPT, bool RING>
__global__ void cd_residual_kernel(const float* __restrict__ a_cols,
                                   const float* __restrict__ x,
                                   const float* __restrict__ grads,
                                   const float* __restrict__ lin,
                                   const float* __restrict__ mask,
                                   const int* __restrict__ budgets,
                                   float* __restrict__ dx_out,
                                   float* __restrict__ scratch,
                                   int d, int n_k, int num_steps, float sot,
                                   float l1, float l2, float box, int r_smem,
                                   int stages) {
  extern __shared__ __align__(16) float res_smem[];
  __shared__ float2 warp_sums[2][kMaxWarps];

  const int k = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const float* a = a_cols + (size_t)k * n_k * d;
  const float* g_in = grads + (size_t)k * d;
  const size_t node = (size_t)k * n_k;
  const int d_pad = (d + 3) & ~3;
  const bool vec16 =
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(a_cols) & 15) == 0;

  float* ring = res_smem;
  float* sp = res_smem + (RING ? (size_t)stages * d_pad : 0);
  constexpr int NR = RPT > 0 ? RPT : 1;
  float r_reg[NR], g_reg[NR];
  float* r = nullptr;
  const float* grad = nullptr;
  if (RPT > 0) {
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const int j = tid + e * nth;
      r_reg[e] = 0.f;
      g_reg[e] = j < d ? g_in[j] : 0.f;
    }
  } else if (r_smem) {
    r = sp;
    float* gs = sp + d;
    for (int j = tid; j < d; j += nth) {
      gs[j] = g_in[j];
      r[j] = 0.f;
    }
    grad = gs;
    sp += 2 * (size_t)d;
  } else {
    r = scratch + (size_t)k * d;
    grad = g_in;
    for (int j = tid; j < d; j += nth) r[j] = 0.f;
  }

  float* cbuf = sp;  // [2][4][kChunk]
  const int nc = (n_k + kChunk - 1) / kChunk;
  auto chunk_len = [&](int c) { return min(kChunk, n_k - c * kChunk); };
  for (int c = 0; c < min(nc, 2); ++c) {
    float* cb = cbuf + c * 4 * kChunk;
    for (int e = tid; e < chunk_len(c); e += nth) {
      const size_t gi = node + (size_t)c * kChunk + e;
      cb[e] = x[gi];
      cb[kChunk + e] = lin[gi];
      cb[2 * kChunk + e] = mask[gi];
      cb[3 * kChunk + e] = 0.f;
    }
  }

  const int steps = live_steps(budgets, k, num_steps);
  auto issue_row = [&](int step) {
    const float* src = a + (size_t)(step % n_k) * d;
    float* dst = ring + (size_t)(step % stages) * d_pad;
    if (vec16) {
      for (int c = tid; c < (d >> 2); c += nth)
        cp_async16(dst + 4 * c, src + 4 * c);
    } else {
      for (int j = tid; j < d; j += nth) cp_async4(dst + j, src + j);
    }
  };
  if (RING) {
    for (int s = 0; s < stages - 1; ++s) {
      if (s < steps) issue_row(s);
      cp_async_commit();
    }
    cp_async_wait(stages - 2);  // row 0 has landed
  }
  __syncthreads();

  int i = 0, u = 0, c = 0;  // coordinate, chunk visit, chunk of the visit
  int ready_at = 0;         // first step that may read the next buffer
  int i_last = -1;
  float dx_last = 0.f;
  for (int t = 0; t < steps; ++t) {
    if (t > 0 && nc > 1 && (i % kChunk) == 0) {
      ++u;
      c = c + 1 == nc ? 0 : c + 1;
    }
    const bool transition = t > 0 && nc > 1 && (i % kChunk) == 0;
    const int off = i - c * kChunk;
    float* cb = cbuf + (u & 1) * 4 * kChunk;
    const float xi = cb[off], li = cb[kChunk + off], mi = cb[2 * kChunk + off];
    const float dxi = i == i_last ? dx_last : cb[3 * kChunk + off];

    const float* row = RING ? ring + (size_t)(t % stages) * d_pad
                            : a + (size_t)i * d;
    float dot = 0.f, nrm = 0.f;
    float av[NR];
    if (RPT > 0) {
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int j = tid + e * nth;
        av[e] = j < d ? row[j] : 0.f;
        dot = fmaf(av[e], fmaf(sot, r_reg[e], g_reg[e]), dot);
        nrm = fmaf(av[e], av[e], nrm);
      }
    } else {
      for (int j = tid; j < d; j += nth) {
        const float aj = row[j];
        dot = fmaf(aj, fmaf(sot, r[j], grad[j]), dot);
        nrm = fmaf(aj, aj, nrm);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
      nrm += __shfl_xor_sync(0xffffffffu, nrm, o);
    }
    if (lane == 0) warp_sums[t & 1][warp] = make_float2(dot, nrm);
    if (RING) cp_async_wait(stages - 3);  // row t + 1 has landed (own copies)
    __syncthreads();  // the one barrier of the step

    if (RING && t + stages - 1 < steps) issue_row(t + stages - 1);
    if (transition) {
      // write back the chunk just left, then fetch the one after this
      float* ob = cbuf + ((u - 1) & 1) * 4 * kChunk;
      const int cp = c == 0 ? nc - 1 : c - 1;
      for (int e = tid; e < chunk_len(cp); e += nth)
        dx_out[node + (size_t)cp * kChunk + e] = ob[3 * kChunk + e];
      const int cn = c + 1 == nc ? 0 : c + 1;
      const bool seen = u + 1 >= nc;  // visited before: its dx is in dx_out
      for (int e = tid; e < chunk_len(cn); e += nth) {
        const size_t gi = node + (size_t)cn * kChunk + e;
        cp_async4(ob + e, x + gi);
        cp_async4(ob + kChunk + e, lin + gi);
        cp_async4(ob + 2 * kChunk + e, mask + gi);
        ob[3 * kChunk + e] = seen ? __ldcg(dx_out + gi) : 0.f;
      }
      ready_at = RING ? t + stages - 1 : INT_MAX;
    }
    if (RING || transition) cp_async_commit();

    float gi = 0.f, qn = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float2 ws = warp_sums[t & 1][w];
      gi += ws.x;
      qn += ws.y;
    }
    const float delta =
        prox_delta(xi + dxi, gi, sot * qn, li, mi, true, l1, l2, box);
    const float dxn = dxi + delta;
    if (tid == 0) cb[3 * kChunk + off] = dxn;
    i_last = i;
    dx_last = dxn;
    if (RPT > 0) {
#pragma unroll
      for (int e = 0; e < NR; ++e) r_reg[e] = fmaf(av[e], delta, r_reg[e]);
    } else {
      // each thread updates exactly the r[j] it read above
      for (int j = tid; j < d; j += nth) r[j] = fmaf(row[j], delta, r[j]);
    }

    i = i + 1 == n_k ? 0 : i + 1;
    if (nc > 1 && t + 1 < steps && (i % kChunk) == 0 && t + 1 < ready_at) {
      // the next chunk's copies may still be in flight (short chunk, or
      // no ring): wait for them before the next step reads its scalars
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the chunk of the last visit goes back; chunks never visited are 0
  const float* cb = cbuf + (u & 1) * 4 * kChunk;
  for (int e = tid; e < chunk_len(c); e += nth)
    dx_out[node + (size_t)c * kChunk + e] = cb[3 * kChunk + e];
  if (u + 1 < nc)
    for (int e = (u + 1) * kChunk + tid; e < n_k; e += nth)
      dx_out[node + e] = 0.f;
}

// ---------------------------------------------------------------------------
// Gram kernel: one warp per node runs the recurrence, with no block barrier
// inside the step loop.
//
// * G comes as its columns stored as contiguous rows (gram_cols: row i is
//   G[:, i], row stride ld = n_k rounded up to 4, zero padded), so each
//   step reads one contiguous row of ld floats.
// * Lane l owns the coordinates j = 4 l + 128 v + c (v < RPT / 4, c < 4)
//   and holds h[j] and dx[j] in registers; it reads G[j, i] for its j as
//   RPT / 4 float4 loads (conflict-free: 32 lanes, 512 consecutive bytes).
// * Each step the lane that owns i hands h_i and z_i = x_i + dx_i over with
//   __shfl_sync, and every lane computes the same prox step itself, so no
//   delta goes through shared memory. The step loop is unrolled over the
//   register index of i (v, c), so that h[4 v + c] stays a register.
// * No division on the chain, and one FMA from h_i to u: a prologue,
//   parallel over the block's 128 threads, stores per coordinate
//   a_i = sigma'/tau / q_i, b_i = (c_i + lin_i) / q_i, l1 / q_i,
//   1 / (1 + l2 / q_i), the live flag (q_i > 0 and mask_i > 0) and x_i
//   (CoordConst, 32 bytes) in shared memory, so that
//   u = z - (c_i + sigma'/tau h_i + lin_i) / q_i = fma(-a_i, h_i, z - b_i)
//   with z - b_i off the chain. Each step reads its coordinate's constants
//   and its G row before the shuffle, since neither depends on delta.
// * G moves by TMA bulk copies (cp.async.bulk, completion on an
//   mbarrier), in groups of 4 rows (the steps that the unrolled loop walks
//   together), so that a step pays a wait and a copy only once per 4:
//   RESIDENT (G fits shared memory, n_k <= 236): one copy of all of G,
//   issued before the prologue and waited for once before the loop (eight
//   row chunks waited for as the first pass reaches them measured slower
//   at n_k = 125 and no faster at 236). Streamed (n_k up to
//   1,536): a ring of kGramStages groups (4 kGramStages rows ahead); the
//   step that loads a group's last row into registers refills its slot
//   (after a __syncwarp) before its prox chain, so the copy overlaps the
//   chain's latency, and the recurrence warp waits only on mbarriers.
// After the prologue's one __syncthreads the other three warps exit.
// ---------------------------------------------------------------------------
constexpr int kGramThreads = 128;
constexpr int kGramStages = 4;  // streamed: ring slots of 4 rows each
constexpr int kGramMaxRpt = 48;  // n_k <= 32 * 48 = 1,536

struct __align__(16) CoordConst {
  float a, b, sl1, inv;    // sigma'/tau / q, (c + lin) / q, l1 / q, 1/(1 + l2/q)
  float ok, x, pad0, pad1;  // live flag, x_i
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once on `bar` and expect `bytes` of TMA transactions on it
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one TMA bulk copy global -> shared of `bytes` (multiple of 16, both
// addresses 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Dynamic shared memory: n_k CoordConst, then G (n_k x ld floats) when
// RESIDENT, else the ring (kGramStages x 4 x ld floats).
template <int RPT, bool RESIDENT>
__global__ void __launch_bounds__(kGramThreads)
    cd_gram_kernel(const float* __restrict__ gram_cols,
                   const float* __restrict__ x,
                   const float* __restrict__ atg,
                   const float* __restrict__ lin,
                   const float* __restrict__ mask,
                   const int* __restrict__ budgets,
                   float* __restrict__ dx_out, int n_k, int ld,
                   int num_steps, float sot, float l1, float l2, float box) {
  extern __shared__ __align__(16) float gram_smem[];
  __shared__ __align__(8) uint64_t bars[kGramStages];
  constexpr int NV = RPT / 4;  // float4 groups per lane
  constexpr int stages = kGramStages;
  const int k = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* gk = gram_cols + (size_t)k * n_k * ld;
  const size_t node = (size_t)k * n_k;
  CoordConst* cc = reinterpret_cast<CoordConst*>(gram_smem);
  float* gbuf = gram_smem + 8 * (size_t)n_k;
  const int steps = live_steps(budgets, k, num_steps);
  const uint32_t row_bytes = (uint32_t)ld * sizeof(float);
  // group g holds rows [4 g, min(4 g + 4, n_k)); ng groups per pass
  const int ng = (n_k + 3) >> 2;
  auto group_bytes = [&](int g) {
    return row_bytes * (uint32_t)min(4, n_k - 4 * g);
  };
  // streamed: the next group to copy and the step at which it starts
  int issue_g = 0, issue_t = 0;
  auto next_group = [&]() {
    issue_t += issue_g == ng - 1 ? n_k - 4 * issue_g : 4;
    issue_g = issue_g == ng - 1 ? 0 : issue_g + 1;
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
    if (RESIDENT) {
      if (steps > 0) {
        mbar_expect_tx(&bars[0], row_bytes * n_k);
        bulk_g2s(gbuf, gk, row_bytes * n_k, &bars[0]);
      }
    } else {
      for (int s = 0; s < stages && issue_t < steps; ++s) {
        mbar_expect_tx(&bars[s], group_bytes(issue_g));
        bulk_g2s(gbuf + (size_t)4 * s * ld, gk + (size_t)4 * issue_g * ld,
                 group_bytes(issue_g), &bars[s]);
        next_group();
      }
      issue_g = issue_t = 0;  // every lane advances past these below
    }
  }
  for (int i = tid; i < n_k; i += kGramThreads) {
    const float q = sot * gk[(size_t)i * ld + i];  // diag(G) = ||A_i||^2
    const float qs = q > 0.f ? q : 1.f;
    CoordConst v;
    v.a = sot / qs;
    v.b = (atg[node + i] + lin[node + i]) / qs;
    v.sl1 = l1 / qs;
    v.inv = 1.f / (1.f + l2 / qs);
    v.ok = (q > 0.f && mask[node + i] > 0.f) ? 1.f : 0.f;
    v.x = x[node + i];
    v.pad0 = v.pad1 = 0.f;
    cc[i] = v;
  }
  __syncthreads();  // the kernel's only block barrier
  if (tid >= 32) return;

  float h[RPT], dxr[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) h[e] = dxr[e] = 0.f;
  if (!RESIDENT)  // the groups the prologue has issued
    for (int s = 0; s < stages && issue_t < steps; ++s) next_group();
  if (RESIDENT && steps > 0) mbar_wait(&bars[0], 0);  // G has landed

  // streamed: the ring slot of the current group and its phase
  int slot = 0;
  uint32_t phase = 0;
  int t = 0;
  while (t < steps) {
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int owners = min(32, (n_k - 128 * e + 3) >> 2);
      for (int q = 0; q < owners && t < steps; ++q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 128 * e + 4 * q + c;
          if (i < n_k && t < steps) {
            if (!RESIDENT && c == 0)  // entering group i / 4: it landed
              mbar_wait(&bars[slot], phase);
            const float* grow =
                gbuf + (size_t)(RESIDENT ? i : 4 * slot + c) * ld;
            float4 gv[NV];
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const int j = 4 * lane + 128 * v;
              gv[v] = j < ld ? *reinterpret_cast<const float4*>(grow + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            const float4 ca = *reinterpret_cast<const float4*>(&cc[i].a);
            const float4 cb = *reinterpret_cast<const float4*>(&cc[i].ok);
            if (!RESIDENT && (c == 3 || i == n_k - 1)) {
              // every lane has read the group: refill its slot
              __syncwarp();
              if (issue_t < steps) {
                if (lane == 0) {
                  mbar_expect_tx(&bars[slot], group_bytes(issue_g));
                  bulk_g2s(gbuf + (size_t)4 * slot * ld,
                           gk + (size_t)4 * issue_g * ld,
                           group_bytes(issue_g), &bars[slot]);
                }
                next_group();
              }
              if (++slot == stages) {
                slot = 0;
                phase ^= 1u;
              }
            }
            const float z =
                __shfl_sync(0xffffffffu, cb.y + dxr[4 * e + c], q);
            const float w = z - ca.y;
            const float hi = __shfl_sync(0xffffffffu, h[4 * e + c], q);
            const float u = fmaf(-ca.x, hi, w);
            const float mag = fmaxf(fabsf(u) - ca.z, 0.f);
            const float zn = fminf(fmaxf(copysignf(mag, u) * ca.w, -box), box);
            const float delta = cb.x != 0.f ? zn - z : 0.f;
            if (lane == q) dxr[4 * e + c] += delta;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              h[4 * v] = fmaf(gv[v].x, delta, h[4 * v]);
              h[4 * v + 1] = fmaf(gv[v].y, delta, h[4 * v + 1]);
              h[4 * v + 2] = fmaf(gv[v].z, delta, h[4 * v + 2]);
              h[4 * v + 3] = fmaf(gv[v].w, delta, h[4 * v + 3]);
            }
            ++t;
          }
        }
      }
    }
  }

#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * lane + 128 * v + c;
      if (j < n_k) dx_out[node + j] = dxr[4 * v + c];
    }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Dynamic shared memory a block may ask for: Hopper's opt-in limit of
// 232,448 B less room for the kernels' static shared memory.
constexpr size_t kSmemDynamicMax = 232448 - 1024;

// Where the residual kernel keeps its state, from d and the thread count:
// r and grad in registers (rpt per thread) when d <= 32 * threads, else in
// shared memory (r_smem) when 2 d floats fit beside the chunk buffers, else
// r in global scratch; rows through a ring of 4-8 stages when four fit,
// else read from global memory (stages = 0). bytes: dynamic shared memory.
struct ResidualLayout {
  int rpt, r_smem, stages, scratch;
  size_t bytes;
};

ResidualLayout residual_layout(int d, int threads) {
  ResidualLayout L{};
  const int need = (d + threads - 1) / threads;
  const int widths[] = {4, 8, 16, 32};  // the RPT the kernel is built for
  for (int w : widths)
    if (w >= need) {
      L.rpt = w;
      break;
    }
  const size_t chunks = 8 * (size_t)kChunk * sizeof(float);
  size_t room = kSmemDynamicMax - chunks;
  const size_t rg = 2 * (size_t)d * sizeof(float);
  L.r_smem = L.rpt == 0 && rg <= room;
  if (L.r_smem) room -= rg;
  const size_t row = (size_t)((d + 3) & ~3) * sizeof(float);
  const size_t fit = room / row;
  L.stages = fit >= 4 ? (int)(fit < (size_t)kMaxStages ? fit : kMaxStages) : 0;
  L.scratch = L.rpt == 0 && !L.r_smem;
  L.bytes = (size_t)L.stages * row + (L.r_smem ? rg : 0) + chunks;
  return L;
}

bool residual_threads_ok(int threads) {
  return threads >= 32 && threads <= 32 * kMaxWarps && threads % 32 == 0;
}

}  // namespace

extern "C" {

// The residual kernel's layout at (d, threads) into out[4] = {rpt, r_smem,
// stages, scratch} (see residual_layout). Returns 0, or cudaErrorInvalidValue
// for a thread count the kernel does not take.
int cd_residual_layout(int d, int threads, int* out) {
  if (!residual_threads_ok(threads) || d < 1)
    return (int)cudaErrorInvalidValue;
  const ResidualLayout L = residual_layout(d, threads);
  out[0] = L.rpt;
  out[1] = L.r_smem;
  out[2] = L.stages;
  out[3] = L.scratch;
  return 0;
}

// One block of `threads` threads per node, in the layout residual_layout
// picks; scratch holds K x d floats (read only when the layout says so).
int cd_residual_launch(const float* a_cols, const float* x,
                       const float* grads, const float* lin,
                       const float* mask, const int* budgets, float* dx,
                       float* scratch, int K, int d, int n_k, int num_steps,
                       float sot, float l1, float l2, float box, int threads,
                       void* stream) {
  if (!residual_threads_ok(threads) || n_k < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const ResidualLayout L = residual_layout(d, threads);
  int r_smem = L.r_smem, stages = L.stages;
  const void* fn = nullptr;
  const bool ring = stages > 0;
#define CD_PICK(R)                                                  \
  fn = ring ? (const void*)cd_residual_kernel<R, true>              \
            : (const void*)cd_residual_kernel<R, false>;
  switch (L.rpt) {
    case 0: CD_PICK(0) break;
    case 4: CD_PICK(4) break;
    case 8: CD_PICK(8) break;
    case 16: CD_PICK(16) break;
    case 32: CD_PICK(32) break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CD_PICK
  int rc = set_smem(fn, L.bytes);
  if (rc) return rc;
  void* args[] = {(void*)&a_cols, (void*)&x,     (void*)&grads,
                  (void*)&lin,    (void*)&mask,  (void*)&budgets,
                  (void*)&dx,     (void*)&scratch, (void*)&d,
                  (void*)&n_k,    (void*)&num_steps, (void*)&sot,
                  (void*)&l1,     (void*)&l2,    (void*)&box,
                  (void*)&r_smem, (void*)&stages};
  rc = (int)cudaLaunchKernel(fn, dim3(K), dim3(threads), args, L.bytes,
                             (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// One block of kGramThreads per node; gram_cols (K, n_k, ld): row i of
// node k is G_k[:, i], ld = n_k rounded up to 4 (zero padded), 16-byte
// aligned. resident: G in shared memory (the caller checks that it fits:
// (8 n_k + n_k ld) floats), else streamed through a ring of kGramStages
// groups of 4 rows. Returns cudaErrorInvalidValue for n_k > 1,536 or a
// bad ld.
int cd_gram_launch(const float* gram_cols, const float* x, const float* atg,
                   const float* lin, const float* mask, const int* budgets,
                   float* dx, int K, int n_k, int ld, int num_steps,
                   float sot, float l1, float l2, float box, int resident,
                   void* stream) {
  if (n_k < 1 || n_k > 32 * kGramMaxRpt || ld < n_k || (ld & 3) ||
      (reinterpret_cast<uintptr_t>(gram_cols) & 15))
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      (8 * (size_t)n_k + (size_t)(resident ? n_k : 4 * kGramStages) * ld) *
      sizeof(float);
  if (bytes > kSmemDynamicMax) return (int)cudaErrorInvalidValue;
  const int need = (n_k + 31) / 32;
  const void* fn = nullptr;
  if (resident) {
    if (need <= 4) fn = (const void*)cd_gram_kernel<4, true>;
    else if (need <= 8) fn = (const void*)cd_gram_kernel<8, true>;
    else return (int)cudaErrorInvalidValue;
  } else if (need <= 4) {
    fn = (const void*)cd_gram_kernel<4, false>;
  } else if (need <= 8) {
    fn = (const void*)cd_gram_kernel<8, false>;
  } else if (need <= 16) {
    fn = (const void*)cd_gram_kernel<16, false>;
  } else if (need <= 32) {
    fn = (const void*)cd_gram_kernel<32, false>;
  } else {
    fn = (const void*)cd_gram_kernel<48, false>;
  }
  int rc = set_smem(fn, bytes);
  if (rc) return rc;
  void* args[] = {(void*)&gram_cols, (void*)&x,   (void*)&atg,
                  (void*)&lin,       (void*)&mask, (void*)&budgets,
                  (void*)&dx,        (void*)&n_k, (void*)&ld,
                  (void*)&num_steps, (void*)&sot, (void*)&l1,
                  (void*)&l2,        (void*)&box};
  rc = (int)cudaLaunchKernel(fn, dim3(K), dim3(kGramThreads), args, bytes,
                             (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
