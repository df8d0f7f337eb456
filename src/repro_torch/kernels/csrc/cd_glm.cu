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
// block-wide reduction (residual kernel) or a broadcast (Gram kernel)
// followed by two __syncthreads — and only K of the 132 SMs are busy. The
// kernels are latency-bound, far above their bytes/peak bound (the bound is
// one read of A or G). This first port keeps them simple and right; several
// nodes per SM, a warp per node for small n_k and clusters for large d are
// the known ways to make them fast.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, loaded with ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <math.h>

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

// Block-wide sum; the total is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float tot = 0.f;
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    tot = lane < nwarps ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      tot += __shfl_down_sync(0xffffffffu, tot, o);
  }
  return tot;
}

// ---------------------------------------------------------------------------
// Residual kernel. Dynamic shared memory holds, in order:
//   r, grad      (2 d floats)      when r_smem
//   x, lin, mask, q, dx (5 n_k)    when vec_smem
// otherwise r lives in scratch[k, 0:d] and q in scratch[k, d:d+n_k], and
// x/lin/mask/dx are read and written in global memory.
// ---------------------------------------------------------------------------
__global__ void cd_residual_kernel(const float* __restrict__ a_cols,
                                   const float* __restrict__ x,
                                   const float* __restrict__ grads,
                                   const float* __restrict__ lin,
                                   const float* __restrict__ mask,
                                   const int* __restrict__ budgets,
                                   float* __restrict__ dx_out,
                                   float* __restrict__ scratch,
                                   int d, int n_k, int num_steps, float sot,
                                   float l1, float l2, float box,
                                   int r_smem, int vec_smem) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kMaxWarps];
  __shared__ float delta_sh;

  const int k = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* a = a_cols + (size_t)k * n_k * d;
  const float* g_in = grads + (size_t)k * d;
  float* scr = scratch + (size_t)k * (d + n_k);

  float* sp = smem;
  float* r;
  const float* grad;
  if (r_smem) {
    r = sp;
    float* gs = sp + d;
    for (int j = tid; j < d; j += nth) gs[j] = g_in[j];
    grad = gs;
    sp += 2 * d;
  } else {
    r = scr;
    grad = g_in;
  }
  for (int j = tid; j < d; j += nth) r[j] = 0.f;

  const float *xs, *ls, *ms;
  float *qs, *dxs;
  if (vec_smem) {
    float* xv = sp;
    float* lv = sp + n_k;
    float* mv = sp + 2 * n_k;
    qs = sp + 3 * n_k;
    dxs = sp + 4 * n_k;
    for (int i = tid; i < n_k; i += nth) {
      xv[i] = x[(size_t)k * n_k + i];
      lv[i] = lin[(size_t)k * n_k + i];
      mv[i] = mask[(size_t)k * n_k + i];
    }
    xs = xv; ls = lv; ms = mv;
  } else {
    xs = x + (size_t)k * n_k;
    ls = lin + (size_t)k * n_k;
    ms = mask + (size_t)k * n_k;
    qs = scr + d;
    dxs = dx_out + (size_t)k * n_k;
  }
  for (int i = tid; i < n_k; i += nth) dxs[i] = 0.f;

  // prologue: q_i = sigma'/tau ||A_i||^2, one warp per row
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  for (int i = warp; i < n_k; i += nwarps) {
    const float* ai = a + (size_t)i * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += ai[j] * ai[j];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) qs[i] = sot * s;
  }
  __syncthreads();

  const int steps = live_steps(budgets, k, num_steps);
  for (int t = 0; t < steps; ++t) {
    const int i = t % n_k;
    const float* ai = a + (size_t)i * d;
    float part = 0.f;
    for (int j = tid; j < d; j += nth) part += ai[j] * (grad[j] + sot * r[j]);
    const float gi = block_sum(part, warp_sums);
    if (tid == 0) {
      const float z = xs[i] + dxs[i];
      const float delta =
          prox_delta(z, gi, qs[i], ls[i], ms[i], true, l1, l2, box);
      dxs[i] += delta;
      delta_sh = delta;
    }
    __syncthreads();
    const float delta = delta_sh;
    // each thread updates exactly the r[j] it read above: no sync needed
    // before the next step's dot
    for (int j = tid; j < d; j += nth) r[j] += ai[j] * delta;
  }

  if (vec_smem) {
    __syncthreads();
    for (int i = tid; i < n_k; i += nth) dx_out[(size_t)k * n_k + i] = dxs[i];
  }
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

}  // namespace

extern "C" {

int cd_residual_launch(const float* a_cols, const float* x,
                       const float* grads, const float* lin,
                       const float* mask, const int* budgets, float* dx,
                       float* scratch, int K, int d, int n_k, int num_steps,
                       float sot, float l1, float l2, float box, int r_smem,
                       int vec_smem, int threads, void* stream) {
  size_t bytes = ((r_smem ? 2 * (size_t)d : 0) +
                  (vec_smem ? 5 * (size_t)n_k : 0)) * sizeof(float);
  int rc = set_smem((const void*)cd_residual_kernel, bytes);
  if (rc) return rc;
  cd_residual_kernel<<<K, threads, bytes, (cudaStream_t)stream>>>(
      a_cols, x, grads, lin, mask, budgets, dx, scratch, d, n_k, num_steps,
      sot, l1, l2, box, r_smem, vec_smem);
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
