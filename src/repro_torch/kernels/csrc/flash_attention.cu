// Hopper (sm_90a) flash attention with GQA and position masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention through pl.pallas_call). It computes, for
// every query row, softmax(q k^T / sqrt(hd)) v over the KV slots that the
// mode admits, with the reference's online softmax in fp32:
//
//   m = -1e30, l = 0, acc = 0
//   per KV tile:  s = (q * hd^-0.5) k^T, s = NEG_INF where masked
//                 m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m')
//                 p = 0 where masked   (a row with no admissible key gives 0)
//                 l = l alpha + sum p, acc = acc alpha + p v, m = m'
//   out = acc / max(l, 1e-30), written in q's dtype.
//
// Masks follow _mask_block (flash_attention.py:32-45): a slot with kv_pos < 0
// is empty; causal k <= q; sliding also k > q - window; chunked_local also
// k / window == q / window (positions are non-negative there, so C's
// truncation is the floor); cross admits every valid slot.
//
// Layout. q (B, Sq, H, hd), k and v (B, Skv, KV, hd) are read in the
// reference's layout through their strides (last dim contiguous); out is
// (B, Sq, H, hd). A "query row" is a (query position, group member) pair:
// the G = H / KV query heads that share a KV head share every K/V tile. One
// block of 256 threads per (tile of BM query rows, KV head, batch row); a
// loop inside the block walks the KV tiles. Q, K and V tiles are staged in
// shared memory as fp32 (rows padded to an odd stride), the BM x BN score
// tile lives in registers (thread (tx, ty) of the 16 x 16 grid owns rows
// ty + 16 i and keys tx + 16 j), and the output accumulator too (head-dim
// columns tx + 16 c). Both products are fp32 FMAs: the configs ask for
// fp32 attention math (attn_compute_dtype = "float32"), P.V included. The
// ragged edges of Sq and Skv are masked here, so the wrapper pads nothing.
// A KV tile in which no (row, key) pair is admissible is skipped, which is
// exact (m stays, alpha = 1, p = 0): at prefill it skips the empty cache
// slots and the future keys.
//
// What bounds it on this card. At prefill, operations: 4 hd FLOPs per
// admissible (query head, key) pair, run here on the fp32 CUDA cores out of
// shared memory. At decode (Sq = 1), the bytes of the K/V cache, and only
// B * KV blocks are busy. This first port makes the kernel right and
// simple; making it fast (wgmma / mma.sync for Q K^T and P V in bf16 with
// fp32 accumulation where the tolerance allows, TMA-fed K/V rings, split-KV
// for decode) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, loaded with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

enum Mode { kCausal = 0, kSliding = 1, kChunkedLocal = 2, kCross = 3 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;   // (B, Sq) contiguous
  const int* kv_pos;  // (B, Skv) contiguous
  void* out;
  long long q_sb, q_ss, q_sh;  // strides in elements; last dim stride 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, skv, kvh, g, hd, mode, window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool admissible(int mode, int qp, int kp,
                                           int window) {
  if (kp < 0) return false;
  switch (mode) {
    case kCausal:
      return kp <= qp;
    case kSliding:
      return kp <= qp && kp > qp - window;
    case kChunkedLocal:
      return kp <= qp && (kp / window) == (qp / window);
    default:
      return true;
  }
}

// RM query rows and CN keys per thread per tile (BM = 16 RM, BN = 16 CN),
// ND head-dim columns of the accumulator per thread (hd <= 16 ND).
template <typename T, int RM, int CN, int ND>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int BM = 16 * RM;
  constexpr int BN = 16 * CN;
  constexpr int LDP = BN + 16;  // half-warps of rows ty, ty+1 hit other banks
  extern __shared__ float smem[];
  const int hd = p.hd;
  const int ld = hd | 1;  // odd row stride: the key reads k_s[c*ld+d] of
                          // 16 lanes fall in 16 distinct banks
  float* q_s = smem;              // BM x ld
  float* k_s = q_s + BM * ld;     // BN x ld
  float* v_s = k_s + BN * ld;     // BN x ld
  float* p_s = v_s + BN * ld;     // BM x LDP
  int* qpos_s = reinterpret_cast<int*>(p_s + BM * LDP);  // BM
  int* kpos_s = qpos_s + BM;                             // BN

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int nrows = p.sq * p.g;
  const int r0 = blockIdx.x * BM;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int* kvp = p.kv_pos + static_cast<long long>(b) * p.skv;

  // stage the query tile, scaled by hd^-0.5 in fp32, and its positions
  for (int idx = tid; idx < BM * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int row = r0 + r;
    float val = 0.f;
    if (row < nrows) {
      const int qi = row / p.g;
      const int gi = row - qi * p.g;
      val = to_float(qg[qi * p.q_ss + (kh * p.g + gi) * p.q_sh + d]) * p.scale;
    }
    q_s[r * ld + d] = val;
  }
  for (int r = tid; r < BM; r += kThreads) {
    const int row = r0 + r;
    qpos_s[r] = row < nrows
                    ? p.q_pos[static_cast<long long>(b) * p.sq + row / p.g]
                    : 0;
  }

  float m[RM], l[RM], acc[RM][ND];
  bool row_ok[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    row_ok[i] = r0 + ty + 16 * i < nrows;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();
  int qp[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) qp[i] = qpos_s[ty + 16 * i];

  for (int n0 = 0; n0 < p.skv; n0 += BN) {
    for (int c = tid; c < BN; c += kThreads) {
      const int n = n0 + c;
      kpos_s[c] = n < p.skv ? kvp[n] : -1;
    }
    __syncthreads();
    bool any_pair = false;
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN;
      const int c = idx - r * BN;
      any_pair |= (r0 + r < nrows) &&
                  admissible(p.mode, qpos_s[r], kpos_s[c], p.window);
    }
    if (!__syncthreads_or(any_pair)) continue;  // exact: nothing admissible

    // stage the K and V tiles as fp32 (zeros past the end of Skv)
    const int kv_rows = min(BN, p.skv - n0);
    for (int idx = tid; idx < BN * hd; idx += kThreads) {
      const int c = idx / hd;
      const int d = idx - c * hd;
      float kv = 0.f, vv = 0.f;
      if (c < kv_rows) {
        const long long n = n0 + c;
        kv = to_float(kg[n * p.k_ss + d]);
        vv = to_float(vg[n * p.v_ss + d]);
      }
      k_s[c * ld + d] = kv;
      v_s[c * ld + d] = vv;
    }
    __syncthreads();

    // scores of this thread's rows and keys
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's BN keys are spread over the 16 lanes tx of
    // one half-warp, so the row reductions are 4 xor-shuffles
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool ok[CN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        ok[j] = row_ok[i] &&
                admissible(p.mode, qp[i], kpos_s[tx + 16 * j], p.window);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float pv = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V over this tile's keys
    for (int j = 0; j < kv_rows; ++j) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < hd ? v_s[j * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    // the next tile's first __syncthreads orders these reads before the
    // next writes of k_s, v_s and p_s
  }

  T* og = static_cast<T*>(p.out) + b * p.o_sb;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (!row_ok[i]) continue;
    const int row = r0 + ty + 16 * i;
    const int qi = row / p.g;
    const int gi = row - qi * p.g;
    T* orow = og + qi * p.o_ss + (kh * p.g + gi) * p.o_sh;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int RM, int CN, int ND>
int launch_tiles(const Params& p, int batch, cudaStream_t stream) {
  constexpr int BM = 16 * RM;
  constexpr int BN = 16 * CN;
  const int ld = p.hd | 1;
  const size_t smem =
      static_cast<size_t>(BM * ld + 2 * BN * ld + BM * (BN + 16)) *
          sizeof(float) +
      static_cast<size_t>(BM + BN) * sizeof(int);
  auto kernel = flash_attention_kernel<T, RM, CN, ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.g + BM - 1) / BM, p.kvh, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Tiles: BM = 16 rows when all Sq * G rows fit (decode), else 64; BN = 64
// keys up to hd = 128 and 32 above, so that the staged tiles stay within
// the 227 KB of shared memory a block may have (hd = 256: ~140 KB).
template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t stream) {
  const bool few_rows = p.sq * p.g <= 16;
  const int nd = (p.hd + 15) / 16;
  if (nd <= 2)
    return few_rows ? launch_tiles<T, 1, 4, 2>(p, batch, stream)
                    : launch_tiles<T, 4, 4, 2>(p, batch, stream);
  if (nd <= 4)
    return few_rows ? launch_tiles<T, 1, 4, 4>(p, batch, stream)
                    : launch_tiles<T, 4, 4, 4>(p, batch, stream);
  if (nd <= 8)
    return few_rows ? launch_tiles<T, 1, 4, 8>(p, batch, stream)
                    : launch_tiles<T, 4, 4, 8>(p, batch, stream);
  return few_rows ? launch_tiles<T, 1, 2, 16>(p, batch, stream)
                  : launch_tiles<T, 4, 2, 16>(p, batch, stream);
}

}  // namespace

extern "C" {

// Returns 0 or the CUDA error of the launch. Strides are in elements.
// mode: 0 causal, 1 sliding, 2 chunked_local, 3 cross. is_bf16: 0 fp32,
// 1 bf16 (q, k, v and out share the type). hd <= 256.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* out,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_ss, long long o_sh,
                           int batch, int sq, int skv, int kvh, int g, int hd,
                           int mode, int window, int is_bf16, float scale,
                           void* stream) {
  if (hd < 1 || hd > 256 || batch < 1 || sq < 1 || kvh < 1 || g < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    q_pos, kv_pos, out,  q_sb, q_ss,   q_sh,
           k_sb, k_ss, k_sh, v_sb,  v_ss,   v_sh, o_sb, o_ss,   o_sh,
           sq,   skv,  kvh,  g,     hd,     mode, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, batch, s)
                 : dispatch<float>(p, batch, s);
}

}  // extern "C"
