// Hopper (sm_90a) flash attention with GQA and position masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention through pl.pallas_call). It computes, for
// every query row, softmax(q k^T / sqrt(hd)) v over the KV slots that the
// mode admits, with the reference's online softmax in fp32:
//
//   m = -1e30, l = 0, acc = 0
//   per KV tile:  s = (q k^T) hd^-0.5, s = NEG_INF where masked
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
// Layout. q (B, Sq, H, hd) and out (B, Sq, H, hd); the keys are the logical
// concatenation of one or two sources (a KV cache and the fresh chunk), each
// k, v (B, S_i, KV, hd) with its own (B, S_i) int32 positions, read in place
// through their strides (last dim contiguous): key n < S_0 is row n of
// source 0, key n >= S_0 row n - S_0 of source 1, and a tile may straddle
// the two. A "query row" is a (query position, group member) pair: the
// G = H / KV query heads that share a KV head share every K/V tile.
//
// Tile skip. Before its loop a block lists the KV tiles that may hold an
// admissible (row, key) pair, from the min/max of its query positions and
// of each tile's valid key positions, and walks only those (a tile left
// out has no admissible pair, so skipping it is exact: m stays, alpha = 1,
// p = 0). At prefill it skips the empty cache slots and the future keys.
//
// Three routes (the wrapper, kernels/flash_attention.py, picks one from the
// dtype and the shape):
//
// * flash_split_kernel + flash_combine_kernel (rows = Sq * G <= 8, decode):
//   the grid is (split, KV head, batch row); each block walks its share of
//   the KV tiles (32 keys) through a two-stage cp.async ring, each warp
//   keeps its own (m, l, acc) over 8 keys of every tile in fp32 on the CUDA
//   cores (lane owns hd / 32 columns; scores are warp all-reduces), the
//   warps merge in shared memory, and the block writes fp32 partials
//   (m, l, acc) of its split. The combine kernel merges the splits: M = max
//   m_i, w_i = exp(m_i - M), out = sum w_i acc_i / max(sum w_i l_i, 1e-30),
//   rounded once. A split with no admissible slot writes m = -1e30, l = 0.
//   Bound: the bytes of the K/V cache; the splits put >= 4 blocks per SM
//   in flight.
// * flash_mma_kernel (bf16, rows > 8: prefill and chunks): one block of four
//   warps owns 64 query rows (16 per warp); K/V tiles of 64 keys (32 at
//   hd > 128) come through a two-stage cp.async ring (16-byte copies where
//   base and strides allow, element copies otherwise); S = Q K^T runs as
//   mma.sync m16n8k16 on bf16 operands with fp32 accumulators (a product of
//   two bf16 values is exact in fp32), fed by ldmatrix; the scale and the
//   online softmax run in fp32 registers in the accumulator layout; P V
//   runs as three mma.sync with A from registers: p = p_hi + p_mid + p_lo,
//   three bf16 parts that keep ~25 bits of p (one bf16 P misses the 2-ulp
//   bar of the fp32 reference, and two parts, ~17 bits, miss its 1e-6
//   floor on outputs near 0). hd is padded to 32/64/128/256 with
//   zeros in shared memory and the store masks the extra columns. Bound:
//   bf16 tensor-core operations.
// * flash_tf32_kernel (fp32 inputs, rows > 8): flash_mma_kernel's skeleton
//   (warps of 16 rows, eight per block up to hd 128, tile list, two-stage
//   cp.async ring, 64-key tiles, 32 at hd > 128) with both products as 3xTF32 on the tensor
//   cores (mma.sync m16n8k8: small*big + big*small + big*big of the split
//   fp32 operands), held to the fp32 bar. Bound: TF32 tensor-core
//   operations, three per product.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC, loaded with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

enum Mode { kCausal = 0, kSliding = 1, kChunkedLocal = 2, kCross = 3 };

struct KVSource {
  const void* k;
  const void* v;
  const int* pos;  // (B, len) contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int len;
};

struct Params {
  const void* q;
  const int* q_pos;  // (B, Sq) contiguous
  void* out;
  long long q_sb, q_ss, q_sh;  // strides in elements; last dim stride 1
  long long o_sb, o_ss, o_sh;
  KVSource src0, src1;  // src1.len = 0 when there is one source
  int sq, skv, kvh, g, hd, mode, window;
  float scale;
  int splits, tiles_per_split;  // split-KV route
  float* part_m;                // (B, KV, splits, Sq * G)
  float* part_l;
  float* part_acc;              // (B, KV, splits, Sq * G, hd)
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

// Whether a tile whose valid key positions span [kmin, kmax] may hold an
// admissible pair with a query position in [qmin, qmax]. Never false when
// one exists: every admissible (q, k) has k <= q <= qmax, for sliding
// k > q - window >= qmin - window, for chunked_local k >= floor(q / w) w
// >= floor(qmin / w) w (and k >= 0).
__device__ __forceinline__ bool tile_may_admit(int mode, int qmin, int qmax,
                                               int kmin, int kmax,
                                               int window) {
  switch (mode) {
    case kCausal:
      return kmin <= qmax;
    case kSliding:
      return kmin <= qmax && kmax > qmin - window;
    case kChunkedLocal: {
      const int lo = qmin >= 0 ? (qmin / window) * window : 0;
      return kmin <= qmax && kmax >= lo;
    }
    default:
      return true;
  }
}

// Whether every pair of a query position in [qmin, qmax] and a valid key
// position in [kmin, kmax] is admissible (the tile then needs no mask).
__device__ __forceinline__ bool tile_all_admit(int mode, int qmin, int qmax,
                                               int kmin, int kmax,
                                               int window) {
  switch (mode) {
    case kCausal:
      return kmax <= qmin;
    case kSliding:
      return kmax <= qmin && kmin > qmax - window;
    case kChunkedLocal:
      return kmax <= qmin && kmin >= 0 && kmin / window == qmax / window;
    default:
      return true;
  }
}

// A tile-list entry: the tile index, and kFullTile when every slot of the
// tile is valid and admissible for every row of the block.
constexpr int kFullTile = 1 << 30;

// Pointers to K/V row n (logical index into the concatenation) of batch
// row b, KV head kh; false past the end.
template <typename T>
__device__ __forceinline__ bool kv_row(const Params& p, int b, int kh, int n,
                                       const T*& kr, const T*& vr,
                                       const int*& pr) {
  if (n >= p.skv) return false;
  const bool second = n >= p.src0.len;
  const long long m = second ? n - p.src0.len : n;
  // field by field: no dynamic indexing of the kernel's parameter struct
  const KVSource &s0 = p.src0, &s1 = p.src1;
  kr = static_cast<const T*>(second ? s1.k : s0.k) +
       b * (second ? s1.k_sb : s0.k_sb) + m * (second ? s1.k_ss : s0.k_ss) +
       kh * (second ? s1.k_sh : s0.k_sh);
  vr = static_cast<const T*>(second ? s1.v : s0.v) +
       b * (second ? s1.v_sb : s0.v_sb) + m * (second ? s1.v_ss : s0.v_ss) +
       kh * (second ? s1.v_sh : s0.v_sh);
  pr = (second ? s1.pos : s0.pos) +
       static_cast<long long>(b) * (second ? s1.len : s0.len) + m;
  return true;
}

__device__ __forceinline__ int kv_pos_at(const Params& p, int b, int n) {
  if (n >= p.skv) return -1;
  if (n < p.src0.len)
    return p.src0.pos[static_cast<long long>(b) * p.src0.len + n];
  return p.src1.pos[static_cast<long long>(b) * p.src1.len + n - p.src0.len];
}

// Lists, in order, the tiles of bn keys in [t_begin, t_end) that may hold an
// admissible pair for query positions [qmin, qmax] into list[] (shared;
// entries carry kFullTile, see above) and returns their number. Called by
// every thread of the block.
__device__ int build_tile_list(const Params& p, int b, int t_begin,
                               int t_end, int bn, int qmin, int qmax,
                               int* list, int* count_sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nt = max(t_end - t_begin, 0);
  for (int i = warp; i < nt; i += nwarps) {
    const int n0 = (t_begin + i) * bn;
    int kmin = INT_MAX, kmax = INT_MIN, valid = 0;
    for (int c = lane; c < bn; c += 32) {
      const int kp = kv_pos_at(p, b, n0 + c);
      if (kp >= 0) {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
        ++valid;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
      valid += __shfl_xor_sync(0xffffffffu, valid, o);
    }
    if (lane == 0) {
      const bool keep =
          kmin <= kmax &&
          tile_may_admit(p.mode, qmin, qmax, kmin, kmax, p.window);
      const bool full =
          keep && valid == bn &&
          tile_all_admit(p.mode, qmin, qmax, kmin, kmax, p.window);
      list[i] = keep ? 1 + (full ? kFullTile : 0) : 0;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < nt; base += 32) {
      const int i = base + lane;
      const int flag = i < nt ? list[i] : 0;
      const bool keep = flag != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      __syncwarp();
      if (keep) list[count + __popc(ballot & ((1u << lane) - 1u))] =
          (t_begin + i) | (flag & kFullTile);
      count += __popc(ballot);
      __syncwarp();
    }
    if (lane == 0) *count_sh = count;
  }
  __syncthreads();
  return *count_sh;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Route 0: fp32 inputs on the tensor cores as 3xTF32 (mma.sync m16n8k8).
//
// The skeleton is flash_mma_kernel's: warps of 16 query rows each (eight
// per block up to hd 128, four above), the tile list, a two-stage
// cp.async ring of K/V tiles read in place from one or two sources, the
// online softmax in fp32 registers in the accumulator layout. Both products run on the tensor cores: every fp32
// operand a is split into big = rna_tf32(a) and small = rna_tf32(a - big)
// (~22 bits of a), and each product is small*big + big*small + big*big,
// accumulated in fp32 (one TF32 product keeps ~11 bits and misses the fp32
// bar by an order of magnitude; the dropped small*small term is ~2^-22
// relative).
//
// P needs no layout change: the m16n8 accumulator gives lane (g, t) the
// keys 2t, 2t + 1 of rows g, g + 8, and the A operand of m16n8k8 wants
// k-indices t, t + 4. P V sums over the keys of a chunk in any order, so
// k-index t stands for key 2t and t + 4 for key 2t + 1, and the V fragment
// reads the same keys: P stays in the registers that hold it.
//
// Shared memory rows are padded to hd + 4 floats: the fragment loads (row
// lane / 4, column lane % 4; for V row 2 (lane % 4), column lane / 4) fall
// in 32 distinct banks. Tiles of 64 keys up to hd 128, 32 above
// (hd 128, 128 rows: ~203 KB of the 227 KB a block may have; hd 256, 64
// rows: ~200 KB).
// Bound: the TF32 tensor-core operations (three products per product).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to ~2^-22 |x|, each part a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b for one m16n8k8 tile (TF32 operands, fp32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 from fp32 operands: the small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// HDP: hd padded (32, 64, 128, 256); BN keys per tile; BM query rows per
// block (16 per warp); VEC: 16-byte copies.
template <int HDP, int BN, int BM, bool VEC>
__global__ void __launch_bounds__(BM * 2)
    flash_tf32_kernel(const __grid_constant__ Params p) {
  constexpr int kThreads = BM * 2;  // BM / 16 warps
  constexpr int LDS = HDP + 4;  // fragment loads hit 32 distinct banks
  extern __shared__ __align__(16) float tf32_smem[];
  float* q_s = tf32_smem;                 // BM x LDS
  float* k_s = q_s + BM * LDS;            // 2 x BN x LDS
  float* v_s = k_s + 2 * BN * LDS;        // 2 x BN x LDS
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * BN * LDS);  // 2 x BN
  int* list = kpos_s + 2 * BN;            // tiles
  __shared__ int sh[3];                   // qmin, qmax, count

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int hd = p.hd;
  const int nrows = p.sq * p.g;
  const int r0 = blockIdx.x * BM;

  {  // zero Q, K, V: pad columns (and rows past the ends) stay zero
    float4* z = reinterpret_cast<float4*>(tf32_smem);
    constexpr int n16 = (BM + 4 * BN) * LDS / 4;
    for (int i = tid; i < n16; i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) {
    sh[0] = INT_MAX;
    sh[1] = INT_MIN;
  }
  __syncthreads();

  // the query tile, as it is (the scale is applied to S in fp32)
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb;
  if (VEC) {
    const int chunks = hd / 4;
    for (int idx = tid; idx < BM * chunks; idx += kThreads) {
      const int r = idx / chunks, c = idx - r * chunks, row = r0 + r;
      if (row >= nrows) continue;
      const int qi = row / p.g, gi = row - qi * p.g;
      cp_async16(q_s + r * LDS + c * 4,
                 qg + qi * p.q_ss + (kh * p.g + gi) * p.q_sh + c * 4, 16);
    }
  } else {
    for (int idx = tid; idx < BM * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd, row = r0 + r;
      if (row >= nrows) continue;
      const int qi = row / p.g, gi = row - qi * p.g;
      cp_async4(q_s + r * LDS + d,
                qg + qi * p.q_ss + (kh * p.g + gi) * p.q_sh + d);
    }
  }
  cp_async_commit();
  for (int r = tid; r < BM; r += kThreads) {
    const int row = r0 + r;
    if (row < nrows) {
      const int qp = p.q_pos[static_cast<long long>(b) * p.sq + row / p.g];
      atomicMin(&sh[0], qp);
      atomicMax(&sh[1], qp);
    }
  }
  __syncthreads();
  const int ntiles = (p.skv + BN - 1) / BN;
  const int nl = build_tile_list(p, b, 0, ntiles, BN, sh[0], sh[1], list,
                                 &sh[2]);

  // this thread's rows: ra (accumulator elements 0, 1) and ra + 8 (2, 3)
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ra = warp * 16 + g8, rb = ra + 8;
  const bool ok_a = r0 + ra < nrows, ok_b = r0 + rb < nrows;
  const int qp_a =
      ok_a ? p.q_pos[static_cast<long long>(b) * p.sq + (r0 + ra) / p.g] : 0;
  const int qp_b =
      ok_b ? p.q_pos[static_cast<long long>(b) * p.sq + (r0 + rb) / p.g] : 0;

  auto issue = [&](int tile, int st) {
    const int n0 = tile * BN;
    float* ks = k_s + st * BN * LDS;
    float* vs = v_s + st * BN * LDS;
    int* kp = kpos_s + st * BN;
    if (VEC) {
      const int chunks = hd / 4;
      for (int idx = tid; idx < BN * chunks; idx += kThreads) {
        const int c = idx / chunks, ch = idx - c * chunks;
        const float *kr = qg, *vr = qg;
        const int* pr;
        const bool ok = kv_row(p, b, kh, n0 + c, kr, vr, pr);
        cp_async16(ks + c * LDS + ch * 4, ok ? kr + ch * 4 : qg, ok ? 16 : 0);
        cp_async16(vs + c * LDS + ch * 4, ok ? vr + ch * 4 : qg, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BN * hd; idx += kThreads) {
        const int c = idx / hd, d = idx - c * hd;
        const float *kr, *vr;
        const int* pr;
        if (kv_row(p, b, kh, n0 + c, kr, vr, pr)) {
          cp_async4(ks + c * LDS + d, kr + d);
          cp_async4(vs + c * LDS + d, vr + d);
        } else {
          ks[c * LDS + d] = 0.f;
          vs[c * LDS + d] = 0.f;
        }
      }
    }
    for (int c = tid; c < BN; c += kThreads) {
      const float *kr, *vr;
      const int* pr;
      if (kv_row(p, b, kh, n0 + c, kr, vr, pr))
        cp_async4(kp + c, pr);
      else
        kp[c] = -1;
    }
  };

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (nl > 0) issue(list[0] & ~kFullTile, 0);
  cp_async_commit();
  const float* qw = q_s + (warp * 16 + g8) * LDS + t4;
  for (int it = 0; it < nl; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < nl) issue(list[it + 1] & ~kFullTile, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const bool full = (list[it] & kFullTile) != 0;
    const float* ks = k_s + st * BN * LDS;
    const float* vs = v_s + st * BN * LDS;
    const int* kp = kpos_s + st * BN;

    // S = Q K^T
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HDP / 8; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(qw[kk * 8], ab[0], as[0]);
      split_tf32(qw[8 * LDS + kk * 8], ab[1], as[1]);
      split_tf32(qw[kk * 8 + 4], ab[2], as[2]);
      split_tf32(qw[8 * LDS + kk * 8 + 4], ab[3], as[3]);
      const float* kr = ks + g8 * LDS + kk * 8 + t4;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        mma_3xtf32(s[nt], ab, as, kr[nt * 8 * LDS], kr[nt * 8 * LDS + 4]);
    }

    // scale, mask and the online softmax of rows ra and rb; a row's keys
    // are spread over the four lanes of a quad (xor 1, 2)
    float mx_a = kNegInf, mx_b = kNegInf;
    if (full) {  // every pair admissible (rows past the end are not stored)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpv = kp[j * 8 + 2 * t4 + e];
          const bool ka = ok_a && admissible(p.mode, qp_a, kpv, p.window);
          const bool kb = ok_b && admissible(p.mode, qp_b, kpv, p.window);
          s[j][e] = ka ? s[j][e] * p.scale : kNegInf;
          s[j][2 + e] = kb ? s[j][2 + e] * p.scale : kNegInf;
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - mn_a);
        const float pb =
            s[j][2 + e] == kNegInf ? 0.f : expf(s[j][2 + e] - mn_b);
        s[j][e] = pa;
        s[j][2 + e] = pb;
        sum_a += pa;
        sum_b += pb;
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // acc += P V, chunk kk of 8 keys: k-index t4 is key 2 t4, t4 + 4 is
    // key 2 t4 + 1 (see above), for A (P, from s) and B (V) alike
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(s[kk][0], ab[0], as[0]);
      split_tf32(s[kk][2], ab[1], as[1]);
      split_tf32(s[kk][1], ab[2], as[2]);
      split_tf32(s[kk][3], ab[3], as[3]);
      const float* vr = vs + (kk * 8 + 2 * t4) * LDS + g8;
#pragma unroll
      for (int nt = 0; nt < HDP / 8; ++nt)
        mma_3xtf32(acc[nt], ab, as, vr[nt * 8], vr[LDS + nt * 8]);
    }
  }
  cp_async_wait_all();

  float* og = static_cast<float*>(p.out) + b * p.o_sb;
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool ok = half ? ok_b : ok_a;
    if (!ok) continue;
    const int row = r0 + (half ? rb : ra);
    const int qi = row / p.g, gi = row - qi * p.g;
    float* orow = og + qi * p.o_ss + (kh * p.g + gi) * p.o_sh;
    const float den = half ? den_b : den_a;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t4 + e;
        if (col < hd) orow[col] = acc[j][2 * half + e] / den;
      }
    }
  }
}

template <int HDP, int BN, int BM, bool VEC>
int launch_tf32(const Params& p, int batch, cudaStream_t stream) {
  constexpr int LDS = HDP + 4;
  const int ntiles = (p.skv + BN - 1) / BN;
  const size_t smem =
      static_cast<size_t>(BM + 4 * BN) * LDS * sizeof(float) +
      static_cast<size_t>(2 * BN + ntiles) * sizeof(int);
  auto kernel = flash_tf32_kernel<HDP, BN, BM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.g + BM - 1) / BM, p.kvh, batch);
  kernel<<<grid, BM * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 128 rows (eight warps) per block where the tiles fit shared memory
// (hd <= 128: ~203 KB at hd 128), else 64 rows (hd 256: ~200 KB). Eight
// warps measured 2.78 ms against four warps' 4.58 at the fp32 prefill
// shape on the H100: at one block per SM, four warps left each scheduler
// one warp to issue from.
template <bool VEC>
int dispatch_tf32_vec(const Params& p, int batch, cudaStream_t stream) {
  if (p.hd <= 32) return launch_tf32<32, 64, 128, VEC>(p, batch, stream);
  if (p.hd <= 64) return launch_tf32<64, 64, 128, VEC>(p, batch, stream);
  if (p.hd <= 128) return launch_tf32<128, 64, 128, VEC>(p, batch, stream);
  return launch_tf32<256, 32, 64, VEC>(p, batch, stream);
}

// ---------------------------------------------------------------------------
// Route 1: bf16 tensor cores (mma.sync m16n8k16, fp32 accumulators).
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // four warps, 16 query rows each
constexpr int kMmaBM = 64;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// d += a b for one m16n8k16 tile (bf16 operands, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p (two adjacent columns) as three bf16 parts, p = hi + mid + lo to
// within 2^-27 |p| (each part keeps the next 9 bits of what is left)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
  const float r0 = p0 - __bfloat162float(h0), r1 = p1 - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16(r0), m1 = __float2bfloat16(r1);
  hi = pack_bf16(h0, h1);
  mid = pack_bf16(m0, m1);
  lo = pack_bf16(__float2bfloat16(r0 - __bfloat162float(m0)),
                 __float2bfloat16(r1 - __bfloat162float(m1)));
}

// HDP: hd padded (32, 64, 128, 256); BN keys per tile; VEC: 16-byte copies.
template <int HDP, int BN, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __grid_constant__ Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int LDS = HDP + 8;  // rows 16 B apart in banks: ldmatrix is
                                // conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // BM x LDS
  bf16* k_s = q_s + kMmaBM * LDS;                    // 2 x BN x LDS
  bf16* v_s = k_s + 2 * BN * LDS;                    // 2 x BN x LDS
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * BN * LDS);  // 2 x BN
  int* list = kpos_s + 2 * BN;                       // tiles
  __shared__ int sh[3];                              // qmin, qmax, count

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int hd = p.hd;
  const int nrows = p.sq * p.g;
  const int r0 = blockIdx.x * kMmaBM;

  {  // zero Q, K, V: pad columns (and rows past the ends) stay zero
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    constexpr int n16 = (kMmaBM + 4 * BN) * LDS * 2 / 16;
    for (int i = tid; i < n16; i += kMmaThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    sh[0] = INT_MAX;
    sh[1] = INT_MIN;
  }
  __syncthreads();

  // the query tile, as it is (the scale is applied to S in fp32)
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb;
  if (VEC) {
    const int chunks = hd / 8;
    for (int idx = tid; idx < kMmaBM * chunks; idx += kMmaThreads) {
      const int r = idx / chunks, c = idx - r * chunks, row = r0 + r;
      if (row >= nrows) continue;
      const int qi = row / p.g, gi = row - qi * p.g;
      cp_async16(q_s + r * LDS + c * 8,
                 qg + qi * p.q_ss + (kh * p.g + gi) * p.q_sh + c * 8, 16);
    }
  } else {
    for (int idx = tid; idx < kMmaBM * hd; idx += kMmaThreads) {
      const int r = idx / hd, d = idx - r * hd, row = r0 + r;
      if (row >= nrows) continue;
      const int qi = row / p.g, gi = row - qi * p.g;
      q_s[r * LDS + d] = qg[qi * p.q_ss + (kh * p.g + gi) * p.q_sh + d];
    }
  }
  cp_async_commit();
  for (int r = tid; r < kMmaBM; r += kMmaThreads) {
    const int row = r0 + r;
    if (row < nrows) {
      const int qp = p.q_pos[static_cast<long long>(b) * p.sq + row / p.g];
      atomicMin(&sh[0], qp);
      atomicMax(&sh[1], qp);
    }
  }
  __syncthreads();
  const int ntiles = (p.skv + BN - 1) / BN;
  const int nl = build_tile_list(p, b, 0, ntiles, BN, sh[0], sh[1], list,
                                 &sh[2]);

  // this thread's rows: ra (accumulator elements 0, 1) and ra + 8 (2, 3)
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const bool ok_a = r0 + ra < nrows, ok_b = r0 + rb < nrows;
  const int qp_a =
      ok_a ? p.q_pos[static_cast<long long>(b) * p.sq + (r0 + ra) / p.g] : 0;
  const int qp_b =
      ok_b ? p.q_pos[static_cast<long long>(b) * p.sq + (r0 + rb) / p.g] : 0;

  auto issue = [&](int tile, int st) {
    const int n0 = tile * BN;
    bf16* ks = k_s + st * BN * LDS;
    bf16* vs = v_s + st * BN * LDS;
    int* kp = kpos_s + st * BN;
    if (VEC) {
      const int chunks = hd / 8;
      for (int idx = tid; idx < BN * chunks; idx += kMmaThreads) {
        const int c = idx / chunks, ch = idx - c * chunks;
        const bf16 *kr = qg, *vr = qg;
        const int* pr;
        const bool ok = kv_row(p, b, kh, n0 + c, kr, vr, pr);
        cp_async16(ks + c * LDS + ch * 8, ok ? kr + ch * 8 : qg, ok ? 16 : 0);
        cp_async16(vs + c * LDS + ch * 8, ok ? vr + ch * 8 : qg, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BN * hd; idx += kMmaThreads) {
        const int c = idx / hd, d = idx - c * hd;
        const bf16 *kr, *vr;
        const int* pr;
        const bool ok = kv_row(p, b, kh, n0 + c, kr, vr, pr);
        ks[c * LDS + d] = ok ? kr[d] : __float2bfloat16(0.f);
        vs[c * LDS + d] = ok ? vr[d] : __float2bfloat16(0.f);
      }
    }
    for (int c = tid; c < BN; c += kMmaThreads) {
      const bf16 *kr, *vr;
      const int* pr;
      if (kv_row(p, b, kh, n0 + c, kr, vr, pr))
        cp_async4(kp + c, pr);
      else
        kp[c] = -1;
    }
  };

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (nl > 0) issue(list[0] & ~kFullTile, 0);
  cp_async_commit();
  const int t4 = lane & 3;
  for (int it = 0; it < nl; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < nl) issue(list[it + 1] & ~kFullTile, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const bool full = (list[it] & kFullTile) != 0;
    const bf16* ks = k_s + st * BN * LDS;
    const bf16* vs = v_s + st * BN * LDS;
    const int* kp = kpos_s + st * BN;

    // S = Q K^T
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < BN / 16; ++nt) {
        uint32_t bb[4];
        ldmatrix_x4(bb, ks + (nt * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nt], a, bb[0], bb[1]);
        mma_bf16(s[2 * nt + 1], a, bb[2], bb[3]);
      }
    }

    // scale, mask and the online softmax of rows ra and rb; a row's keys
    // are spread over the four lanes of a quad (xor 1, 2)
    float mx_a = kNegInf, mx_b = kNegInf;
    if (full) {  // every pair admissible (rows past the end are not stored)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpv = kp[j * 8 + 2 * t4 + e];
          const bool ka = ok_a && admissible(p.mode, qp_a, kpv, p.window);
          const bool kb = ok_b && admissible(p.mode, qp_b, kpv, p.window);
          s[j][e] = ka ? s[j][e] * p.scale : kNegInf;
          s[j][2 + e] = kb ? s[j][2 + e] * p.scale : kNegInf;
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - mn_a);
        const float pb =
            s[j][2 + e] == kNegInf ? 0.f : expf(s[j][2 + e] - mn_b);
        s[j][e] = pa;
        s[j][2 + e] = pb;
        sum_a += pa;
        sum_b += pb;
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // acc += (p_hi + p_mid + p_lo) V; the small parts first
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ah[4], am[4], alo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], am[0], alo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], am[1], alo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], am[2], alo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], am[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < HDP / 16; ++nt) {
        uint32_t bb[4];
        ldmatrix_x4_trans(
            bb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    nt * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nt], alo, bb[0], bb[1]);
        mma_bf16(acc[2 * nt], am, bb[0], bb[1]);
        mma_bf16(acc[2 * nt], ah, bb[0], bb[1]);
        mma_bf16(acc[2 * nt + 1], alo, bb[2], bb[3]);
        mma_bf16(acc[2 * nt + 1], am, bb[2], bb[3]);
        mma_bf16(acc[2 * nt + 1], ah, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait_all();

  bf16* og = static_cast<bf16*>(p.out) + b * p.o_sb;
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool ok = half ? ok_b : ok_a;
    if (!ok) continue;
    const int row = r0 + (half ? rb : ra);
    const int qi = row / p.g, gi = row - qi * p.g;
    bf16* orow = og + qi * p.o_ss + (kh * p.g + gi) * p.o_sh;
    const float den = half ? den_b : den_a;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t4 + e;
        if (col < hd) orow[col] = __float2bfloat16(acc[j][2 * half + e] / den);
      }
    }
  }
}

template <int HDP, int BN, bool VEC>
int launch_mma(const Params& p, int batch, cudaStream_t stream) {
  constexpr int LDS = HDP + 8;
  const int ntiles = (p.skv + BN - 1) / BN;
  const size_t smem = static_cast<size_t>(kMmaBM + 4 * BN) * LDS * 2 +
                      static_cast<size_t>(2 * BN + ntiles) * sizeof(int);
  auto kernel = flash_mma_kernel<HDP, BN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq * p.g + kMmaBM - 1) / kMmaBM, p.kvh, batch);
  kernel<<<grid, kMmaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch_mma_vec(const Params& p, int batch, cudaStream_t stream) {
  if (p.hd <= 32) return launch_mma<32, 64, VEC>(p, batch, stream);
  if (p.hd <= 64) return launch_mma<64, 64, VEC>(p, batch, stream);
  if (p.hd <= 128) return launch_mma<128, 64, VEC>(p, batch, stream);
  return launch_mma<256, 32, VEC>(p, batch, stream);
}

// ---------------------------------------------------------------------------
// Route 2: split-KV partials (rows = Sq * G <= RMAX) and their combine.
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitBN = 32;                         // keys per tile
constexpr int kKeysPerWarp = kSplitBN / kSplitWarps;  // 8
constexpr int kKeyGroup = 4;

template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* src, float (&out)[DPL]);
template <>
__device__ __forceinline__ void load_row<float, 4>(const float* src,
                                                   float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_row<float, 8>(const float* src,
                                                   float (&out)[8]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  const float4 w = *reinterpret_cast<const float4*>(src + 4);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  out[4] = w.x; out[5] = w.y; out[6] = w.z; out[7] = w.w;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(
    const __nv_bfloat16* src, float (&out)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  out[0] = __low2float(a); out[1] = __high2float(a);
  out[2] = __low2float(c); out[3] = __high2float(c);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 8>(
    const __nv_bfloat16* src, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    out[2 * i] = __low2float(a);
    out[2 * i + 1] = __high2float(a);
  }
}

// Stages of the split kernel's ring. Two keep ~41 KB of shared memory per
// block at hd 128 in bf16, so five blocks fit on an SM and one wave covers
// the decode grids; four stages (three tiles in flight) cost that
// occupancy and measured slower inside the model.
constexpr int kSplitStages = 2;

// DPL head-dim columns per lane (hd <= 32 DPL); RMAX query rows at most.
template <typename T, int DPL, int RMAX, bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
    flash_split_kernel(const __grid_constant__ Params p) {
  constexpr int LDK = 32 * DPL;               // smem row, zero padded
  constexpr int CH = 16 / sizeof(T);          // elements per 16-byte copy
  constexpr int ST = kSplitStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);    // ST x BN x LDK
  T* v_s = k_s + ST * kSplitBN * LDK;         // ST x BN x LDK
  int* kpos_s = reinterpret_cast<int*>(v_s + ST * kSplitBN * LDK);  // ST x BN
  float* comb = reinterpret_cast<float*>(kpos_s + ST * kSplitBN);
  // comb: warps x RMAX x (2 + LDK): m, l, acc of every warp
  int* list = reinterpret_cast<int*>(comb + kSplitWarps * RMAX * (2 + LDK));
  __shared__ int count_sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int hd = p.hd;
  const int R = p.sq * p.g;

  {  // zero the K/V ring: pad columns and rows past the end stay zero
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    constexpr int n16 = 2 * ST * kSplitBN * LDK * sizeof(T) / 16;
    for (int i = tid; i < n16; i += kSplitThreads) z[i] = make_uint4(0, 0, 0, 0);
  }

  // this lane's columns of every row, scaled by hd^-0.5 in fp32
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  float q[RMAX][DPL];
  int qp[RMAX];
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    qp[r] = 0;
#pragma unroll
    for (int e = 0; e < DPL; ++e) q[r][e] = 0.f;
    if (r < R) {
      const int qi = r / p.g, gi = r - qi * p.g;
      qp[r] = p.q_pos[static_cast<long long>(b) * p.sq + qi];
      qmin = min(qmin, qp[r]);
      qmax = max(qmax, qp[r]);
      const T* qrow = qg + qi * p.q_ss + (kh * p.g + gi) * p.q_sh;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane * DPL + e;
        if (d < hd) q[r][e] = to_float(qrow[d]) * p.scale;
      }
    }
  }
  __syncthreads();

  const int ntiles = (p.skv + kSplitBN - 1) / kSplitBN;
  const int t0 = split * p.tiles_per_split;
  const int t1 = min(t0 + p.tiles_per_split, ntiles);
  const int nl =
      build_tile_list(p, b, t0, t1, kSplitBN, qmin, qmax, list, &count_sh);

  auto issue = [&](int tile, int st) {
    const int n0 = tile * kSplitBN;
    T* ks = k_s + st * kSplitBN * LDK;
    T* vs = v_s + st * kSplitBN * LDK;
    int* kp = kpos_s + st * kSplitBN;
    if (VEC) {
      const int chunks = hd / CH;
      for (int idx = tid; idx < kSplitBN * chunks; idx += kSplitThreads) {
        const int c = idx / chunks, ch = idx - c * chunks;
        const T *kr = qg, *vr = qg;
        const int* pr;
        const bool ok = kv_row(p, b, kh, n0 + c, kr, vr, pr);
        cp_async16(ks + c * LDK + ch * CH, ok ? kr + ch * CH : qg, ok ? 16 : 0);
        cp_async16(vs + c * LDK + ch * CH, ok ? vr + ch * CH : qg, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kSplitBN * hd; idx += kSplitThreads) {
        const int c = idx / hd, d = idx - c * hd;
        const T *kr, *vr;
        const int* pr;
        const bool ok = kv_row(p, b, kh, n0 + c, kr, vr, pr);
        ks[c * LDK + d] = ok ? kr[d] : from_float<T>(0.f);
        vs[c * LDK + d] = ok ? vr[d] : from_float<T>(0.f);
      }
    }
    for (int c = tid; c < kSplitBN; c += kSplitThreads) {
      const T *kr, *vr;
      const int* pr;
      if (kv_row(p, b, kh, n0 + c, kr, vr, pr))
        cp_async4(kp + c, pr);
      else
        kp[c] = -1;
    }
  };

  float m[RMAX], l[RMAX], acc[RMAX][DPL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  // ST - 1 tiles in flight ahead of the one being computed
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nl) issue(list[s] & ~kFullTile, s);
    cp_async_commit();
  }
  for (int it = 0; it < nl; ++it) {
    cp_async_wait<ST - 2>();  // tile it landed (this thread's copies)
    __syncthreads();  // ... everyone's; every warp is done with tile it - 1
    if (it + ST - 1 < nl)
      issue(list[it + ST - 1] & ~kFullTile, (it + ST - 1) % ST);
    cp_async_commit();
    const int st = it % ST;
    const T* ks = k_s + st * kSplitBN * LDK;
    const T* vs = v_s + st * kSplitBN * LDK;
    const int* kp = kpos_s + st * kSplitBN;
#pragma unroll
    for (int grp = 0; grp < kKeysPerWarp / kKeyGroup; ++grp) {
      const int c0 = warp * kKeysPerWarp + grp * kKeyGroup;
      float sc[kKeyGroup][RMAX];
#pragma unroll
      for (int c = 0; c < kKeyGroup; ++c) {
        float kv[DPL];
        load_row<T, DPL>(ks + (c0 + c) * LDK + lane * DPL, kv);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) part = fmaf(q[r][e], kv[e], part);
          sc[c][r] = part;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int c = 0; c < kKeyGroup; ++c)
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            sc[c][r] += __shfl_xor_sync(0xffffffffu, sc[c][r], o);
      int kpv[kKeyGroup];
#pragma unroll
      for (int c = 0; c < kKeyGroup; ++c) kpv[c] = kp[c0 + c];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int c = 0; c < kKeyGroup; ++c) {
          const bool ok = r < R && admissible(p.mode, qp[r], kpv[c], p.window);
          sc[c][r] = ok ? sc[c][r] : kNegInf;
          mx = fmaxf(mx, sc[c][r]);
        }
        const float mn = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - mn);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kKeyGroup; ++c) {
          sc[c][r] = sc[c][r] == kNegInf ? 0.f : expf(sc[c][r] - mn);
          sum += sc[c][r];
        }
        l[r] = l[r] * alpha + sum;
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < kKeyGroup; ++c) {
        float vv[DPL];
        load_row<T, DPL>(vs + (c0 + c) * LDK + lane * DPL, vv);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[r][e] = fmaf(sc[c][r], vv[e], acc[r][e]);
      }
    }
  }
  cp_async_wait_all();

  // merge the warps' (m, l, acc) and write this split's partials
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    float* cw = comb + (warp * RMAX + r) * (2 + LDK);
    if (lane == 0) {
      cw[0] = m[r];
      cw[1] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) cw[2 + lane * DPL + e] = acc[r][e];
  }
  __syncthreads();
  const long long base =
      ((static_cast<long long>(b) * p.kvh + kh) * p.splits + split) * R;
  for (int idx = tid; idx < R * hd; idx += kSplitThreads) {
    const int r = idx / hd, d = idx - r * hd;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mm = fmaxf(mm, comb[(w * RMAX + r) * (2 + LDK)]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* cw = comb + (w * RMAX + r) * (2 + LDK);
      const float sw = expf(cw[0] - mm);
      ll = fmaf(sw, cw[1], ll);
      aa = fmaf(sw, cw[2 + d], aa);
    }
    p.part_acc[(base + r) * hd + d] = aa;
    if (d == 0) {
      p.part_m[base + r] = mm;
      p.part_l[base + r] = ll;
    }
  }
}

template <typename T, int DPL, int RMAX, bool VEC>
int launch_split(const Params& p, int batch, cudaStream_t stream) {
  constexpr int LDK = 32 * DPL;
  constexpr int ST = kSplitStages;
  const size_t smem =
      static_cast<size_t>(2 * ST * kSplitBN * LDK) * sizeof(T) +
      ST * kSplitBN * sizeof(int) +
      static_cast<size_t>(kSplitWarps * RMAX * (2 + LDK)) * sizeof(float) +
      static_cast<size_t>(p.tiles_per_split) * sizeof(int);
  auto kernel = flash_split_kernel<T, DPL, RMAX, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.splits, p.kvh, batch);
  kernel<<<grid, kSplitThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_split_vec(const Params& p, int batch, cudaStream_t stream) {
  const bool wide = p.hd > 128;
  const bool few = p.sq * p.g <= 4;
  if (!wide)
    return few ? launch_split<T, 4, 4, VEC>(p, batch, stream)
               : launch_split<T, 4, 8, VEC>(p, batch, stream);
  return few ? launch_split<T, 8, 4, VEC>(p, batch, stream)
             : launch_split<T, 8, 8, VEC>(p, batch, stream);
}

constexpr int kMaxSplits = 128;
constexpr int kCombineThreads = 128;

// One block per (query row, KV head, batch row): the split maxima and sums
// go through shared memory, then each thread merges columns d.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    flash_combine_kernel(const float* __restrict__ pm,
                         const float* __restrict__ pl,
                         const float* __restrict__ pacc, void* out,
                         long long o_sb, long long o_ss, long long o_sh,
                         int kvh, int sq, int g, int hd, int splits) {
  __shared__ float sm[kMaxSplits], sw[kMaxSplits];
  __shared__ float inv_l;
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int R = sq * g;
  const long long base =
      (static_cast<long long>(b) * kvh + kh) * splits * R + r;  // split 0
  for (int s = threadIdx.x; s < splits; s += blockDim.x)
    sm[s] = pm[base + static_cast<long long>(s) * R];
  __syncthreads();
  float mm = kNegInf;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, sm[s]);
  for (int s = threadIdx.x; s < splits; s += blockDim.x)
    sw[s] = expf(sm[s] - mm);
  __syncthreads();
  if (threadIdx.x == 0) {
    float ll = 0.f;
    for (int s = 0; s < splits; ++s)
      ll = fmaf(sw[s], pl[base + static_cast<long long>(s) * R], ll);
    inv_l = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  const float den = inv_l;
  const int qi = r / g, gi = r - qi * g;
  T* orow = static_cast<T*>(out) + b * o_sb + qi * o_ss + (kh * g + gi) * o_sh;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float aa = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      aa = fmaf(sw[s], pacc[(base + static_cast<long long>(s) * R) * hd + d],
                aa);
    orow[d] = from_float<T>(aa / den);
  }
}

// Launches flash_combine_kernel over partials (B, KV, splits, Sq * G [, hd]).
int launch_combine(const float* part_m, const float* part_l,
                   const float* part_acc, void* out, long long o_sb,
                   long long o_ss, long long o_sh, int batch, int kvh, int sq,
                   int g, int hd, int splits, int is_bf16,
                   cudaStream_t stream) {
  if (hd < 1 || batch < 1 || kvh < 1 || sq < 1 || g < 1 || splits < 1 ||
      splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sq * g, kvh, batch);
  if (is_bf16)
    flash_combine_kernel<__nv_bfloat16><<<grid, kCombineThreads, 0, stream>>>(
        part_m, part_l, part_acc, out, o_sb, o_ss, o_sh, kvh, sq, g, hd,
        splits);
  else
    flash_combine_kernel<float><<<grid, kCombineThreads, 0, stream>>>(
        part_m, part_l, part_acc, out, o_sb, o_ss, o_sh, kvh, sq, g, hd,
        splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 or the CUDA error of the launch. route: 0 3xTF32 tensor cores
// (fp32 only), 1 bf16 tensor cores (bf16 only), 2 split-KV: the partials
// go to `part` (fp32: m, l, then acc, in the layout of launch_combine),
// and when out is not null flash_combine_kernel follows on the same stream
// and writes out. strides (elements, 18): q, out,
// k0, v0, k1, v1, each (batch, seq, head). mode: 0 causal, 1 sliding,
// 2 chunked_local, 3 cross. is_bf16: 0 fp32, 1 bf16 (q, k, v and out share
// the type). vec: 16-byte copies (base pointers and strides aligned).
int flash_attention_launch(int route, const void* q, const int* q_pos,
                           void* out, const void* k0, const void* v0,
                           const int* pos0, int skv0, const void* k1,
                           const void* v1, const int* pos1, int skv1,
                           const long long* strides, int batch, int sq,
                           int kvh, int g, int hd, int mode, int window,
                           float scale, int is_bf16, int vec, int splits,
                           int tiles_per_split, float* part, void* stream) {
  if (hd < 1 || hd > 256 || batch < 1 || sq < 1 || kvh < 1 || g < 1 ||
      skv0 < 0 || skv1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.q_pos = q_pos;
  p.out = out;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.o_sb = strides[3]; p.o_ss = strides[4]; p.o_sh = strides[5];
  p.src0 = KVSource{k0, v0, pos0, strides[6], strides[7], strides[8],
                    strides[9], strides[10], strides[11], skv0};
  p.src1 = KVSource{k1, v1, pos1, strides[12], strides[13], strides[14],
                    strides[15], strides[16], strides[17], skv1};
  p.sq = sq; p.skv = skv0 + skv1; p.kvh = kvh; p.g = g; p.hd = hd;
  p.mode = mode; p.window = window; p.scale = scale;
  p.splits = splits; p.tiles_per_split = tiles_per_split;
  const long long n = static_cast<long long>(batch) * kvh * splits * sq * g;
  p.part_m = part;
  p.part_l = part ? part + n : nullptr;
  p.part_acc = part ? part + 2 * n : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
      return vec ? dispatch_tf32_vec<true>(p, batch, s)
                 : dispatch_tf32_vec<false>(p, batch, s);
    case 1:
      if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
      return vec ? dispatch_mma_vec<true>(p, batch, s)
                 : dispatch_mma_vec<false>(p, batch, s);
    case 2: {
      if (sq * g > 8 || splits < 1 || splits > kMaxSplits ||
          tiles_per_split < 1 || part == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      int rc;
      if (is_bf16)
        rc = vec ? dispatch_split_vec<__nv_bfloat16, true>(p, batch, s)
                 : dispatch_split_vec<__nv_bfloat16, false>(p, batch, s);
      else
        rc = vec ? dispatch_split_vec<float, true>(p, batch, s)
                 : dispatch_split_vec<float, false>(p, batch, s);
      if (rc != 0 || out == nullptr) return rc;
      return launch_combine(p.part_m, p.part_l, p.part_acc, out, p.o_sb,
                            p.o_ss, p.o_sh, batch, kvh, sq, g, hd, splits,
                            is_bf16, s);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Merges split-KV partials (B, KV, splits, Sq * G [, hd]) into out.
int flash_combine_launch(const float* part_m, const float* part_l,
                         const float* part_acc, void* out, long long o_sb,
                         long long o_ss, long long o_sh, int batch, int kvh,
                         int sq, int g, int hd, int splits, int is_bf16,
                         void* stream) {
  return launch_combine(part_m, part_l, part_acc, out, o_sb, o_ss, o_sh,
                        batch, kvh, sq, g, hd, splits, is_bf16,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
