// Flash attention, forward and backward, for Hopper (sm_90a): online
// softmax over K/V tiles with fp32 statistics, and the two-kernel
// backward that recomputes the probabilities from (q, k, lse).
//
// Replaces the TPU kernels
//   theanompi_tpu/ops/pallas_attention.py:131  _fwd_kernel     (#7)  -> flash_fwd
//   theanompi_tpu/ops/pallas_attention.py:174  _dq_kernel      (#8)  -> flash_dq
//   theanompi_tpu/ops/pallas_attention.py:264  _dq_kernel_2d   (#10) -> flash_dq
//   theanompi_tpu/ops/pallas_attention.py:207  _dkv_kernel     (#9)  -> flash_dkv
//   theanompi_tpu/ops/pallas_attention.py:302  _dkv_kernel_2d  (#11) -> flash_dkv
// (wrappers and plain PyTorch versions in ops/flash_attention.py). The
// TPU needs the 2-D kernels only because its 1-D ones keep the whole
// opposite sequence in VMEM, which overflows at T >= 8192. Here every
// kernel streams the opposite side through shared memory a tile at a
// time, so residency is O(tile) at any T and one kernel serves both
// regimes.
//
// Layout: q, k, v, dO are [BH, T, D] contiguous in bf16 or fp32 (all of
// one dtype), D <= 64. o is in that dtype; lse and dsum are [BH, Tq] fp32;
// dq, dk, dv are fp32 (a ring of shards would add partials losslessly).
//
// Arithmetic, at the reference's cast points:
//   fwd:  s = dot(q, k) * scale (fp32 accumulation, scale after the dot);
//         masked logits -> -1e30; m' = max(m, rowmax s);
//         p = valid ? exp(s - m') : 0; c = exp(m - m'); l = l*c + sum p;
//         acc = acc*c + dot(T(p), v); o = T(acc / max(l, 1e-37));
//         lse = m + log(max(l, 1e-37))
//   dq:   p = valid ? exp(s - lse) : 0; dp = dot(T(dO), v);
//         ds = T(p * (dp - dsum) * scale); dq += dot(ds, k)
//   dkv:  dv += dot(p^T, f32(dO)) in fp32 FMAs with p NOT rounded (the
//         reference upcasts dO to fp32 before this product);
//         dk += dot(ds^T, q)
// where T() rounds to the input dtype (identity for fp32). Valid means
// key column < Tk (padding is local) and, when causal,
// q_off + row >= k_off + col (global positions).
//
// Products: bf16 tiles go through the tensor cores (nvcuda::wmma
// 16x16x16, fp32 accumulators); fp32 tiles, and the fp32 x fp32 dv
// product, through fp32 FMAs on the CUDA cores, never TF32. Softmax
// statistics, probabilities and all accumulators are fp32. expf / logf,
// not the __expf intrinsics. Built with -fmad=false, so the elementwise
// steps round as PyTorch's separate ops do; sums inside the products run
// in another order than on the CPU, so the kernels are held to a
// tolerance, not to bit identity.
//
// Design: one block of 256 threads (8 warps) per (64-row tile, b*h). The
// block keeps its own tile (Q, or K and V) in shared memory and loops over
// the other side's 64-row tiles, staging each in shared memory; products
// land in fp32 shared tiles, and an elementwise phase (four threads per
// row, 16 columns each) applies masks, softmax and casts. The bf16
// kernels' shared memory (70-104 KB) and registers are held to two
// resident blocks per SM, so 16 warps hide each other's latency. Causally dead
// tiles are skipped as the reference skips them (_k_blocks_for,
// _q_block_start), in the kernel's own 64-row tiles.
//
// Bound, at the 136M LM's shape (BH 96, T 1024, D 64, bf16, causal):
// each launch moves 51-101 MB (15-30 us at 3.35 TB/s) and does 13-19
// GFLOP of bf16 products over the causal half (13-20 us at 989 TFLOP/s);
// flash_dkv's fp32 dv product (6.4 GFLOP at 67 TFLOP/s, 96 us) makes it
// the slowest by its bound (chip_smoke.py phase times computes each).
// This first version is simple: synchronous 16-byte loads into shared
// memory (no cp.async/TMA), wmma (not wgmma), a block per tile with no
// pipelining; making it fast is later work (ROADMAP section 3).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // rows of every tile (Q, K, V, dO)
constexpr int kD = 64;         // head dim held in shared memory (D <= kD, zero-padded)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = kThreads / kTile;  // threads per tile row in the elementwise phases
constexpr int kRowCols = kTile / kRowThreads;  // and the columns each of them takes
constexpr int kMinBlocks = 2;  // resident blocks per SM the register budget is held to
constexpr int kLdF = kTile + 4;  // leading dim of fp32 tiles (kTile == kD)
constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-37f;

static_assert(kTile == kD, "tiles are square: one leading dimension per dtype");
static_assert(kRowThreads * kTile == kThreads && kRowThreads <= 32, "a row's threads share a warp");

// leading dim of an input-dtype tile: padded to dodge bank conflicts,
// a multiple of 8 elements and of 32 bytes per 16 rows (wmma's rules)
template <typename T>
__host__ __device__ constexpr int ld_of() { return kD + (sizeof(T) == 2 ? 8 : 4); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint4 zero_chunk(uint4*) { return make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ float zero_chunk(float*) { return 0.0f; }
__device__ __forceinline__ bf16 zero_chunk(bf16*) { return __float2bfloat16_rn(0.0f); }

// rows [row0, row0 + 64) of src ([nrows, D]) into dst, in chunks of type C
// (16-byte uint4, or one element): every chunk a thread moves is loaded
// before any is stored, so its loads are in flight together
template <typename T, typename C>
__device__ __forceinline__ void load_chunks(T* dst, const T* __restrict__ src, int row0,
                                            int nrows, int D) {
  constexpr int kVec = sizeof(C) / sizeof(T);
  constexpr int kPer = kTile * kD / kVec / kThreads;  // chunks per thread at D == kD
  constexpr int ld = ld_of<T>();
  const int cpr = D / kVec;  // chunks per row
  const int n = kTile * cpr;
  C buf[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / cpr;
    buf[j] = zero_chunk((C*)nullptr);
    if (i < n && row0 + r < nrows)
      buf[j] = reinterpret_cast<const C*>(src + (int64_t)(row0 + r) * D)[i - r * cpr];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / cpr;
    if (i < n) reinterpret_cast<C*>(dst + r * ld)[i - r * cpr] = buf[j];
  }
}

// dst[r][c] = src[(row0 + r) * D + c] inside (nrows, D), zero outside:
// 16-byte chunks when rows are whole chunks and src is aligned to them
template <typename T>
__device__ void load_tile(T* dst, const T* __restrict__ src, int row0, int nrows, int D) {
  constexpr int ld = ld_of<T>();
  constexpr int kVec = 16 / sizeof(T);
  if (D % kVec == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    load_chunks<T, uint4>(dst, src, row0, nrows, D);
  } else {
    load_chunks<T, T>(dst, src, row0, nrows, D);
  }
  const int pad = kD - D;  // the head dim's zero padding
  for (int i = threadIdx.x; i < kTile * pad; i += kThreads) {
    dst[(i / pad) * ld + D + i % pad] = from_f32<T>(0.0f);
  }
}

// dst[r] = src[row0 + r] inside nrows, zero outside
__device__ void load_rows(float* dst, const float* __restrict__ src, int row0, int nrows) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) dst[r] = row0 + r < nrows ? src[row0 + r] : 0.0f;
}

__device__ void zero_f32_tile(float* t) {
  for (int i = threadIdx.x; i < kTile * kLdF; i += kThreads) t[i] = 0.0f;
}

// dst[(row0 + r) * D + c] = T(src[r][c]) inside (nrows, D)
template <typename T>
__device__ void store_tile(T* __restrict__ dst, const float* src, int row0, int nrows, int D) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    if (row0 + r < nrows && c < D) dst[(int64_t)(row0 + r) * D + c] = from_f32<T>(src[r * kLdF + c]);
  }
}

// C[m][n] (+)= sum_k opA[m][k] * opB[k][n] over 64 x 64 x 64, C fp32 in
// shared memory (leading dim kLdF). opA = A, or A^T when TA; opB = B, or
// B^T when TB. fp32 FMAs on the CUDA cores: thread t owns kMr rows from
// (t/16)*kMr and columns t%16 + 16j, j < 4.
template <bool TA, bool TB, typename TAe, typename TBe>
__device__ void mm_fma(const TAe* A, int lda, const TBe* B, int ldb, float* C, bool accumulate) {
  constexpr int kMr = kTile * 16 / kThreads;
  const int r0 = (threadIdx.x / 16) * kMr, c0 = threadIdx.x % 16;
  float acc[kMr][4];
#pragma unroll
  for (int i = 0; i < kMr; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = accumulate ? C[(r0 + i) * kLdF + c0 + 16 * j] : 0.0f;
#pragma unroll 4
  for (int k = 0; k < kD; ++k) {
    float a[kMr], b[4];
#pragma unroll
    for (int i = 0; i < kMr; ++i) a[i] = to_f32(TA ? A[k * lda + r0 + i] : A[(r0 + i) * lda + k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = to_f32(TB ? B[(c0 + 16 * j) * ldb + k] : B[k * ldb + c0 + 16 * j]);
#pragma unroll
    for (int i = 0; i < kMr; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kMr; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) C[(r0 + i) * kLdF + c0 + 16 * j] = acc[i][j];
}

// The same product on bf16 tiles through the tensor cores: of the 4 x 4
// output fragments (16 x 16 each, fp32 accumulation), warp w owns row
// block w % 4 and kTnPerWarp consecutive column blocks.
template <bool TA, bool TB>
__device__ void mm_wmma(const bf16* A, const bf16* B, float* C, bool accumulate) {
  using namespace nvcuda;
  constexpr int ld = ld_of<bf16>();
  using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  constexpr int kBlocks = kTile / 16;
  constexpr int kTnPerWarp = kBlocks * kBlocks / kWarps;
  const int warp = threadIdx.x / 32;
  const int tm = warp % kBlocks;
  const int tn0 = (warp / kBlocks) * kTnPerWarp;
#pragma unroll
  for (int tn = tn0; tn < tn0 + kTnPerWarp; ++tn) {
    float* cp = C + tm * 16 * kLdF + tn * 16;
    if (accumulate) {
      wmma::load_matrix_sync(c, cp, kLdF, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(c, 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::load_matrix_sync(a, TA ? A + kk * 16 * ld + tm * 16 : A + tm * 16 * ld + kk * 16, ld);
      wmma::load_matrix_sync(b, TB ? B + tn * 16 * ld + kk * 16 : B + kk * 16 * ld + tn * 16, ld);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, kLdF, wmma::mem_row_major);
  }
}

// input-dtype product: tensor cores for bf16, fp32 FMAs for fp32
template <bool TA, bool TB>
__device__ __forceinline__ void mm(const bf16* A, const bf16* B, float* C, bool accumulate) {
  mm_wmma<TA, TB>(A, B, C, accumulate);
}
template <bool TA, bool TB>
__device__ __forceinline__ void mm(const float* A, const float* B, float* C, bool accumulate) {
  mm_fma<TA, TB>(A, ld_of<float>(), B, ld_of<float>(), C, accumulate);
}

// max / sum over the kRowThreads neighbouring lanes that share a tile row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int causal, int q_off, int k_off, int qrow, int kcol, int Tk) {
  return kcol < Tk && (!causal || q_off + qrow >= k_off + kcol);
}

// last K tile (exclusive) a Q tile starting at q0 can see (_k_blocks_for)
__device__ __forceinline__ int k_tiles_for(int causal, int q0, int q_off, int k_off, int nk) {
  if (!causal) return nk;
  const int j = floor_div(q_off - k_off + q0 + kTile - 1, kTile) + 1;
  return min(max(j, 0), nk);
}

// first Q tile that can see the K tile starting at k0 (_q_block_start)
__device__ __forceinline__ int q_tile_start(int causal, int k0, int q_off, int k_off) {
  if (!causal) return 0;
  return max(0, floor_div(k_off + k0 - q_off, kTile));
}

template <typename T>
struct FwdSmem {
  T q[kTile * ld_of<T>()];
  T k[kTile * ld_of<T>()];
  T v[kTile * ld_of<T>()];
  T p[kTile * ld_of<T>()];
  float s[kTile * kLdF];
  float acc[kTile * kLdF];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int D,
                 int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T>& sm = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  constexpr int ld = ld_of<T>();
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const T* qb = q + bh * Tq * D;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const int r = threadIdx.x / kRowThreads;               // this thread's tile row
  const int c0 = (threadIdx.x % kRowThreads) * kRowCols;  // and its first column

  load_tile(sm.q, qb, q0, Tq, D);
  zero_f32_tile(sm.acc);
  float m = kNeg, l = 0.0f;
  const int jmax = k_tiles_for(causal, q0, q_off, k_off, (Tk + kTile - 1) / kTile);
  for (int j = 0; j < jmax; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(sm.k, kb, k0, Tk, D);
    load_tile(sm.v, vb, k0, Tk, D);
    __syncthreads();
    mm<false, true>(sm.q, sm.k, sm.s, false);  // s = q k^T
    __syncthreads();
    float mx = kNeg;
    for (int c = c0; c < c0 + kRowCols; ++c) {
      const float s = visible(causal, q_off, k_off, q0 + r, k0 + c, Tk) ? sm.s[r * kLdF + c] * scale : kNeg;
      sm.s[r * kLdF + c] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, row_max(mx));
    float sum = 0.0f;
    for (int c = c0; c < c0 + kRowCols; ++c) {
      const float p = visible(causal, q_off, k_off, q0 + r, k0 + c, Tk)
                          ? expf(sm.s[r * kLdF + c] - m_new) : 0.0f;
      sm.p[r * ld + c] = from_f32<T>(p);
      sum += p;
    }
    const float corr = expf(m - m_new);
    l = l * corr + row_sum(sum);
    m = m_new;
    for (int c = c0; c < c0 + kRowCols; ++c) sm.acc[r * kLdF + c] *= corr;
    __syncthreads();
    mm<false, false>(sm.p, sm.v, sm.acc, true);  // acc += T(p) v
  }
  __syncthreads();
  const float l_safe = fmaxf(l, kTiny);
  for (int c = c0; c < c0 + kRowCols; ++c) sm.acc[r * kLdF + c] = sm.acc[r * kLdF + c] / l_safe;
  if (threadIdx.x % kRowThreads == 0 && q0 + r < Tq) lse[bh * Tq + q0 + r] = m + logf(l_safe);
  __syncthreads();
  store_tile(o + bh * Tq * D, sm.acc, q0, Tq, D);
}

template <typename T>
struct DqSmem {
  T q[kTile * ld_of<T>()];
  T d_o[kTile * ld_of<T>()];
  T k[kTile * ld_of<T>()];
  T v[kTile * ld_of<T>()];
  T ds[kTile * ld_of<T>()];
  float s[kTile * kLdF];
  float dp[kTile * kLdF];
  float dq[kTile * kLdF];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ d_o, const float* __restrict__ lse,
                const float* __restrict__ dsum, float* __restrict__ dq, int Tq, int Tk, int D,
                int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<T>& sm = *reinterpret_cast<DqSmem<T>*>(smem_raw);
  constexpr int ld = ld_of<T>();
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const int r = threadIdx.x / kRowThreads;
  const int c0 = (threadIdx.x % kRowThreads) * kRowCols;

  load_tile(sm.q, q + bh * Tq * D, q0, Tq, D);
  load_tile(sm.d_o, d_o + bh * Tq * D, q0, Tq, D);
  zero_f32_tile(sm.dq);
  const float lse_r = q0 + r < Tq ? lse[bh * Tq + q0 + r] : 0.0f;
  const float dsum_r = q0 + r < Tq ? dsum[bh * Tq + q0 + r] : 0.0f;
  const int jmax = k_tiles_for(causal, q0, q_off, k_off, (Tk + kTile - 1) / kTile);
  for (int j = 0; j < jmax; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile(sm.k, kb, k0, Tk, D);
    load_tile(sm.v, vb, k0, Tk, D);
    __syncthreads();
    mm<false, true>(sm.q, sm.k, sm.s, false);     // s  = q k^T
    mm<false, true>(sm.d_o, sm.v, sm.dp, false);  // dp = T(dO) v^T
    __syncthreads();
    for (int c = c0; c < c0 + kRowCols; ++c) {
      const float p = (q0 + r < Tq && visible(causal, q_off, k_off, q0 + r, k0 + c, Tk))
                          ? expf(sm.s[r * kLdF + c] * scale - lse_r) : 0.0f;
      sm.ds[r * ld + c] = from_f32<T>(p * (sm.dp[r * kLdF + c] - dsum_r) * scale);
    }
    __syncthreads();
    mm<false, false>(sm.ds, sm.k, sm.dq, true);  // dq += ds k
  }
  __syncthreads();
  store_tile(dq + bh * Tq * D, sm.dq, q0, Tq, D);
}

template <typename T>
struct DkvSmem {
  T k[kTile * ld_of<T>()];
  T v[kTile * ld_of<T>()];
  T q[kTile * ld_of<T>()];
  T d_o[kTile * ld_of<T>()];
  float p[kTile * kLdF];
  float dp[kTile * kLdF];  // dp, then ds in the input dtype (leading dim ld_of<T>)
  float dk[kTile * kLdF];
  float dv[kTile * kLdF];
  float lse[kTile];
  float dsum[kTile];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ d_o, const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dk, float* __restrict__ dv,
                 int Tq, int Tk, int D, int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem<T>& sm = *reinterpret_cast<DkvSmem<T>*>(smem_raw);
  constexpr int ld = ld_of<T>();
  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const T* qb = q + bh * Tq * D;
  const T* ob = d_o + bh * Tq * D;
  const int r = threadIdx.x / kRowThreads;  // a Q row of the tile
  const int c0 = (threadIdx.x % kRowThreads) * kRowCols;

  load_tile(sm.k, k + bh * Tk * D, k0, Tk, D);
  load_tile(sm.v, v + bh * Tk * D, k0, Tk, D);
  zero_f32_tile(sm.dk);
  zero_f32_tile(sm.dv);
  const int nq = (Tq + kTile - 1) / kTile;
  for (int i = q_tile_start(causal, k0, q_off, k_off); i < nq; ++i) {
    const int q0 = i * kTile;
    __syncthreads();
    load_tile(sm.q, qb, q0, Tq, D);
    load_tile(sm.d_o, ob, q0, Tq, D);
    load_rows(sm.lse, lse + bh * Tq, q0, Tq);
    load_rows(sm.dsum, dsum + bh * Tq, q0, Tq);
    __syncthreads();
    mm<false, true>(sm.q, sm.k, sm.p, false);     // s  = q k^T
    mm<false, true>(sm.d_o, sm.v, sm.dp, false);  // dp = T(dO) v^T
    __syncthreads();
    T ds[kRowCols];
#pragma unroll
    for (int j = 0; j < kRowCols; ++j) {
      const int c = c0 + j;
      const float p = (q0 + r < Tq && visible(causal, q_off, k_off, q0 + r, k0 + c, Tk))
                          ? expf(sm.p[r * kLdF + c] * scale - sm.lse[r]) : 0.0f;
      sm.p[r * kLdF + c] = p;
      ds[j] = from_f32<T>(p * (sm.dp[r * kLdF + c] - sm.dsum[r]) * scale);
    }
    // ds overwrites dp in place (the smaller footprint lets two blocks
    // share an SM): every dp is read before any ds lands
    T* ds_tile = reinterpret_cast<T*>(sm.dp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowCols; ++j) ds_tile[r * ld + c0 + j] = ds[j];
    __syncthreads();
    // dv += p^T f32(dO): fp32 x fp32, p unrounded
    mm_fma<true, false>(sm.p, kLdF, sm.d_o, ld, sm.dv, true);
    mm<true, false>(ds_tile, sm.q, sm.dk, true);  // dk += ds^T q
  }
  __syncthreads();
  store_tile(dk + bh * Tk * D, sm.dk, k0, Tk, D);
  store_tile(dv + bh * Tk * D, sm.dv, k0, Tk, D);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_of(int rows, int bh) { return dim3((rows + kTile - 1) / kTile, bh); }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Tq, int Tk,
        int D, int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(FwdSmem<T>);
  cudaError_t err = prepare(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T><<<grid_of(Tq, BH), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Tq, Tk, D, q_off, k_off, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
       const void* dsum, void* dq_out, int BH, int Tq, int Tk, int D, int q_off, int k_off,
       int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(DqSmem<T>);
  cudaError_t err = prepare(flash_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<T><<<grid_of(Tq, BH), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)d_o, (const float*)lse,
      (const float*)dsum, (float*)dq_out, Tq, Tk, D, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
        const void* dsum, void* dk_out, void* dv_out, int BH, int Tq, int Tk, int D, int q_off,
        int k_off, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(DkvSmem<T>);
  cudaError_t err = prepare(flash_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<T><<<grid_of(Tk, BH), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)d_o, (const float*)lse,
      (const float*)dsum, (float*)dk_out, (float*)dv_out, Tq, Tk, D, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each returns cudaGetLastError() after its launch (0 = launched). dtype:
// 0 fp32, 1 bf16 (ops/kernels.py DTYPE_CODES). BH, Tq, Tk >= 1 and
// 1 <= D <= 64, checked by the wrappers in ops/flash_attention.py.

int tmpi_flash_fwd(int device, const void* q, const void* k, const void* v, void* o, void* lse,
                   int BH, int Tq, int Tk, int D, int q_off, int k_off, int causal, float scale,
                   int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return fwd<bf16>(q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale, s);
  return fwd<float>(q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale, s);
}

int tmpi_flash_dq(int device, const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* dsum, void* dq_out, int BH, int Tq, int Tk, int D,
                  int q_off, int k_off, int causal, float scale, int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return dq<bf16>(q, k, v, d_o, lse, dsum, dq_out, BH, Tq, Tk, D, q_off, k_off, causal, scale, s);
  return dq<float>(q, k, v, d_o, lse, dsum, dq_out, BH, Tq, Tk, D, q_off, k_off, causal, scale, s);
}

int tmpi_flash_dkv(int device, const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* dsum, void* dk_out, void* dv_out, int BH, int Tq,
                   int Tk, int D, int q_off, int k_off, int causal, float scale, int dtype,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return dkv<bf16>(q, k, v, d_o, lse, dsum, dk_out, dv_out, BH, Tq, Tk, D, q_off, k_off, causal,
                     scale, s);
  return dkv<float>(q, k, v, d_o, lse, dsum, dk_out, dv_out, BH, Tq, Tk, D, q_off, k_off, causal,
                    scale, s);
}

}  // extern "C"
