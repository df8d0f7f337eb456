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
// h += G[:, i] delta, with ||A_i||^2 = diag(G).
//
// The Pallas kernels' sequential fori_loop with VMEM carries becomes a loop
// inside one thread block per node. Unlike the TPU kernels these take a (K,)
// int32 step budget (NULL = no budget): the main path passes one.
//
// What bounds them on this card: each step is a dependent chain — a
// block-wide reduction (residual kernel) or a broadcast (Gram kernel) — and
// only K of the 132 SMs are busy; the bytes/peak bound (one read of A or G)
// is far below. The residual kernel keeps memory off that chain: rows are
// prefetched through a cp.async ring, the per-coordinate scalars are staged
// in shared memory ahead of use, r and grad sit in registers, and a step
// has one barrier (every thread computes the prox step itself). The Gram
// kernel keeps thread 0's prox broadcast and two barriers per step.
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
// Gram kernel. Dynamic shared memory holds, in order:
//   G with an odd row stride ld (n_k * ld floats)   when g_smem
//   x, c, lin, mask, q, dx, h (7 n_k floats)        when vec_smem
// otherwise G is read in global memory (ld = n_k) and the vectors live in
// scratch[k, 0:2 n_k] (q, h) and the global inputs / output.
// ---------------------------------------------------------------------------
__global__ void cd_gram_kernel(const float* __restrict__ gram,
                               const float* __restrict__ x,
                               const float* __restrict__ atg,
                               const float* __restrict__ lin,
                               const float* __restrict__ mask,
                               const int* __restrict__ budgets,
                               float* __restrict__ dx_out,
                               float* __restrict__ scratch,
                               int n_k, int num_steps, float sot, float l1,
                               float l2, float box, int g_smem, int vec_smem) {
  extern __shared__ float smem[];
  __shared__ float delta_sh;

  const int k = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* g_in = gram + (size_t)k * n_k * n_k;
  float* scr = scratch + (size_t)k * 2 * n_k;

  float* sp = smem;
  const float* G;
  int ld;
  if (g_smem) {
    ld = n_k | 1;  // odd stride: the column reads G[j*ld + i] hit distinct banks
    float* gs = sp;
    for (int e = tid; e < n_k * n_k; e += nth) {
      const int row = e / n_k, col = e - row * n_k;
      gs[row * ld + col] = g_in[e];
    }
    G = gs;
    sp += (size_t)n_k * ld;
  } else {
    ld = n_k;
    G = g_in;
  }

  const float *xs, *cs, *ls, *ms;
  float *qs, *dxs, *hs;
  if (vec_smem) {
    float* xv = sp;
    float* cv = sp + n_k;
    float* lv = sp + 2 * n_k;
    float* mv = sp + 3 * n_k;
    qs = sp + 4 * n_k;
    dxs = sp + 5 * n_k;
    hs = sp + 6 * n_k;
    for (int i = tid; i < n_k; i += nth) {
      xv[i] = x[(size_t)k * n_k + i];
      cv[i] = atg[(size_t)k * n_k + i];
      lv[i] = lin[(size_t)k * n_k + i];
      mv[i] = mask[(size_t)k * n_k + i];
    }
    xs = xv; cs = cv; ls = lv; ms = mv;
  } else {
    xs = x + (size_t)k * n_k;
    cs = atg + (size_t)k * n_k;
    ls = lin + (size_t)k * n_k;
    ms = mask + (size_t)k * n_k;
    qs = scr;
    hs = scr + n_k;
    dxs = dx_out + (size_t)k * n_k;
  }
  for (int i = tid; i < n_k; i += nth) {
    dxs[i] = 0.f;
    hs[i] = 0.f;
    qs[i] = sot * g_in[(size_t)i * n_k + i];  // diag(G) = ||A_i||^2
  }
  __syncthreads();

  const int steps = live_steps(budgets, k, num_steps);
  for (int t = 0; t < steps; ++t) {
    const int i = t % n_k;
    if (tid == 0) {
      const float z = xs[i] + dxs[i];
      const float gi = cs[i] + sot * hs[i];
      const float delta =
          prox_delta(z, gi, qs[i], ls[i], ms[i], true, l1, l2, box);
      dxs[i] += delta;
      delta_sh = delta;
    }
    __syncthreads();
    const float delta = delta_sh;
    for (int j = tid; j < n_k; j += nth) hs[j] += G[(size_t)j * ld + i] * delta;
    __syncthreads();  // thread 0 reads h[i] of another thread next step
  }

  if (vec_smem)
    for (int i = tid; i < n_k; i += nth) dx_out[(size_t)k * n_k + i] = dxs[i];
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

int cd_gram_launch(const float* gram, const float* x, const float* atg,
                   const float* lin, const float* mask, const int* budgets,
                   float* dx, float* scratch, int K, int n_k, int num_steps,
                   float sot, float l1, float l2, float box, int g_smem,
                   int vec_smem, int threads, void* stream) {
  const size_t ld = (size_t)(n_k | 1);
  size_t bytes = ((g_smem ? (size_t)n_k * ld : 0) +
                  (vec_smem ? 7 * (size_t)n_k : 0)) * sizeof(float);
  int rc = set_smem((const void*)cd_gram_kernel, bytes);
  if (rc) return rc;
  cd_gram_kernel<<<K, threads, bytes, (cudaStream_t)stream>>>(
      gram, x, atg, lin, mask, budgets, dx, scratch, n_k, num_steps, sot, l1,
      l2, box, g_smem, vec_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
