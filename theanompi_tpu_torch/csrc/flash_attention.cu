// Flash attention, forward and backward, for Hopper (sm_90a): online
// softmax over K/V tiles with fp32 statistics, and the two-kernel
// backward that recomputes the probabilities from (q, k, lse).
//
// Replaces the TPU kernels
//   theanompi_tpu/ops/pallas_attention.py:131  _fwd_kernel     (#7)  -> flash_fwd_sm90 (bf16,
//                                                                   D % 8 == 0), flash_fwd_mma
//                                                                   (fp32), flash_fwd_mma_bf16
//                                                                   (bf16, D % 8 != 0)
//   theanompi_tpu/ops/pallas_attention.py:174  _dq_kernel      (#8)  -> flash_dq_sm90 (bf16,
//                                                                   D % 8 == 0), flash_dq_mma
//                                                                   (fp32), flash_dq_mma_bf16
//                                                                   (bf16, D % 8 != 0)
//   theanompi_tpu/ops/pallas_attention.py:264  _dq_kernel_2d   (#10) -> the same three
//   theanompi_tpu/ops/pallas_attention.py:207  _dkv_kernel     (#9)  -> flash_dkv_sm90 (bf16,
//                                                                   D % 8 == 0), flash_dkv_mma
//                                                                   (fp32), flash_dkv_mma_bf16
//                                                                   (bf16, D % 8 != 0)
//   theanompi_tpu/ops/pallas_attention.py:302  _dkv_kernel_2d  (#11) -> the same three
// (wrappers, routes and plain PyTorch versions in ops/flash_attention.py).
// flash_fwd, flash_dq and flash_dkv, the generic kernels, serve no route
// since flash_fwd_mma_bf16, flash_dq_mma and flash_dkv_mma_bf16; they stay
// reachable for timing in turns. The
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
//   dkv:  dv += dot(p^T, f32(dO)) with p NOT rounded (the reference
//         upcasts dO to fp32 before this product);
//         dk += dot(ds^T, q)
// where T() rounds to the input dtype (identity for fp32). Valid means
// key column < Tk (padding is local) and, when causal,
// q_off + row >= k_off + col (global positions).
//
// Products: bf16 tiles go through the tensor cores (nvcuda::wmma
// 16x16x16 in the generic kernels, wgmma in the sm90 kernels, mma.sync
// m16n8k16 in the *_mma_bf16 kernels; fp32 accumulators). fp32 tiles run as
// three tf32 products on the tensor cores, each operand split into a tf32
// hi and lo part, in flash_fwd_mma (the fp32 forward), flash_dq_mma (the
// fp32 dq) and flash_dkv_mma (the fp32 dk/dv), never one TF32 product; the
// generic kernels (on no route) run fp32 products as fp32 FMAs on the CUDA
// cores. The fp32 x fp32 dv
// product runs as fp32 FMAs in the generic flash_dkv (on no route), as
// three exact bf16 products of p's hi, mid and lo parts in flash_dkv_sm90
// and flash_dkv_mma_bf16, and as 3xTF32 in flash_dkv_mma (their sections
// below). Softmax
// statistics, probabilities and all accumulators are fp32. expf / logf,
// not the __expf intrinsics. Built with -fmad=false, so the elementwise
// steps round as PyTorch's separate ops do; sums inside the products run
// in another order than on the CPU, so the kernels are held to a
// tolerance, not to bit identity.
//
// Design of the generic kernels (flash_fwd_sm90, flash_dkv_sm90 and
// flash_dq_sm90, the bf16 forward, dk/dv and dq on TMA and wgmma, and
// flash_fwd_mma, flash_dq_mma, flash_dkv_mma and the three *_mma_bf16
// kernels on mma.sync, have
// their own sections below): one block of 256 threads (8 warps) per
// (64-row tile, b*h). The block keeps its own tile (Q, or K and V) in
// shared memory and loops over
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
// the slowest by its bound, and flash_dkv_sm90's split (38.7 GFLOP of
// bf16, 39 us) takes that away (chip_smoke.py phase times computes each).
// The generic kernels are simple: synchronous 16-byte loads into shared
// memory (no cp.async/TMA), wmma (not wgmma), a block per tile with no
// pipelining, and they serve no route: on the LM's bf16 route all three
// run on the sm90 kernels, fp32 on flash_fwd_mma, flash_dq_mma and
// flash_dkv_mma, the other bf16 heads on flash_fwd_mma_bf16,
// flash_dq_mma_bf16 and flash_dkv_mma_bf16.

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

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


// ---------------------------------------------------------------------------
// flash_fwd_sm90: the bf16 forward for Hopper, on TMA and wgmma
// ---------------------------------------------------------------------------
//
// The same function as flash_fwd_kernel<bf16> (the plain version is
// flash_fwd_plain with block_k = 64): the online softmax over 64-key
// tiles at the same cast points, expf/logf, -fmad=false. Only the
// summation order inside the two products differs.
//
// Block: one CTA of 256 threads per (128-row Q tile, b*h); two consumer
// warpgroups own 64 query rows each (one wgmma M). The Q tiles of a causal
// launch go heaviest first (blockIdx.y reversed; b*h is blockIdx.x, the
// fast grid dimension), so the longest CTAs start first instead of forming
// the tail.
//
// Loads: TMA over 3-D tensor maps of [BH, T, D] bf16 with a box of 64
// columns (D * 2 <= 128 bytes: one row of the 128-byte swizzle) and 64
// (K, V, O) or 128 (Q) rows. Rows past T and columns past D come back as
// zeros, which is the ragged edge and the zero-padded head for free; the
// global row stride D * 2 must be a multiple of 16 (D % 8 == 0). Q is
// loaded once; K and V go through a ring of kStages stages, each with a
// "full" mbarrier (TMA bytes) and an "empty" one (all 256 threads arrive
// when the stage is read). Thread 0 issues the load of tile j + 1 before
// the warpgroups compute on tile j.
//
// Products: S = Q K^T as wgmma m64n64k16 (bf16 x bf16 -> fp32), both
// operands K-major in the swizzled shared memory, 4 k-steps over D = 64.
// The softmax runs on the accumulator in registers: a row's 64 values sit
// in the 4 lanes of a quad (16 each), so its max and sum are 2 shuffles;
// the mask is computed only on tiles that cross the diagonal or the
// ragged key edge. O += P V takes P (rounded to bf16) from registers as
// wgmma's A operand (the accumulator's fragment is the A fragment for
// 16-bit types) and V from shared memory, read MN-major (transposed by
// the descriptor: V's contiguous dim is D = N).
//
// Epilogue: acc / l_safe -> bf16 -> shared memory in the 128-byte swizzle
// -> a TMA store, which clips rows past Tq and columns past D; lse from
// the registers of each quad's first lane.
//
// Not yet: a producer warp with setmaxnreg (warp specialisation), the
// softmax overlapped with the next tile's wgmma, 128-key tiles.

namespace sm90 {

constexpr int kQRows = 128;   // query rows of a CTA
constexpr int kWgRows = 64;   // query rows of a consumer warpgroup
constexpr int kKeys = 64;     // keys of a softmax tile (the plain version's block_k)
constexpr int kStages = 2;    // depth of the K/V ring (3 and 4 measured no faster)
constexpr int kThreads = 256;
constexpr uint32_t kRowBytes = kD * 2;  // one 128-byte swizzle row
constexpr uint32_t kAtom = 8 * kRowBytes;  // 8 rows: one swizzle atom, 1024 bytes

// every array a multiple of 1024 bytes, so each tile starts on a swizzle atom
struct Smem {
  bf16 q[kQRows * kD];
  bf16 k[kStages][kKeys * kD];
  bf16 v[kStages][kKeys * kD];
  bf16 o[kQRows * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + slack to align the base to 1024

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` has completed; a wait that outlasts
// any real one (2^28 polls) traps, so a broken ring is a launch error and
// not a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma (before its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B over m64 n64 k16: A and B K-major from swizzled shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B over m64 n64 k16: A (bf16 pairs) from registers, B MN-major from
// swizzled shared memory (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K tiles a query row range ending (exclusively) at q_end can see
__device__ __forceinline__ int k_tiles_seen(int causal, int q_end, int q_off, int k_off, int nk) {
  if (!causal) return nk;
  const int j = floor_div(q_off - k_off + q_end - 1, kKeys) + 1;
  return min(max(j, 0), nk);
}

// One tile's online softmax on the S accumulator, in place: sc[4g + e] is
// row qr0 (e < 2) or qr1, key column c0 + 8g + e % 2. The scores become
// p; the rows' m and l advance, and corr0/corr1 rescale the output. Only
// kMasked tiles (across the diagonal or the ragged key edge) test each
// element; the others are all visible.
template <bool kMasked>
__device__ __forceinline__ void tile_softmax(float (&sc)[32], float& m0, float& m1, float& l0,
                                             float& l1, float& corr0, float& corr1, float scale,
                                             int causal, int q_off, int k_off, int qr0, int qr1,
                                             int c0, int Tk) {
  float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * scale;
    if (kMasked && !visible(causal, q_off, k_off, (i % 4) < 2 ? qr0 : qr1, c0 + 8 * (i / 4) + i % 2, Tk))
      x = kNeg;
    sc[i] = x;
    if ((i % 4) < 2) {
      mx0 = fmaxf(mx0, x);
    } else {
      mx1 = fmaxf(mx1, x);
    }
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool top = (i % 4) < 2;
    float p = expf(sc[i] - (top ? mn0 : mn1));
    if (kMasked && !visible(causal, q_off, k_off, top ? qr0 : qr1, c0 + 8 * (i / 4) + i % 2, Tk))
      p = 0.0f;
    sc[i] = p;
    if (top) {
      sum0 += p;
    } else {
      sum1 += p;
    }
  }
  corr0 = expf(m0 - mn0);
  corr1 = expf(m1 - mn1);
  l0 = l0 * corr0 + quad_sum(sum0);
  l1 = l1 * corr1 + quad_sum(sum1);
  m0 = mn0;
  m1 = mn1;
}

// K/V tile j into its stage of a ring (Smem's, or flash_dq_sm90's DqRing)
template <typename Ring>
__device__ __forceinline__ void load_kv(Ring& sm, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        int j, int bh) {
  const int s = j % (int)std::extent<decltype(Ring::full)>::value;
  mbar_arrive_expect_tx(&sm.full[s], 2 * kKeys * kRowBytes);
  tma_load(sm.k[s], tm_k, &sm.full[s], 0, j * kKeys, bh);
  tma_load(sm.v[s], tm_v, &sm.full[s], 0, j * kKeys, bh);
}

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int Tq,
                      int Tk, int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const uint32_t raw = smem_addr(dyn_smem);
  Smem& sm = *reinterpret_cast<Smem*>(dyn_smem + (((raw + 1023u) & ~1023u) - raw));
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row0 = ((tid % 128) / 32) * 16 + lane / 4;  // first of this thread's 2 rows (+8)
  const int col0 = 2 * (lane % 4);  // first of its 2 columns in each 8-column group
  const int wq0 = q0 + wg * kWgRows;  // the warpgroup's first query row
  const int qr0 = wq0 + row0, qr1 = qr0 + 8;
  const int nk = (Tk + kKeys - 1) / kKeys;
  const int n_tiles = k_tiles_seen(causal, min(q0 + kQRows, Tq), q_off, k_off, nk);
  // the warpgroup's own last tile: the first warpgroup skips the CTA's
  // last tile of a causal diagonal (it still waits for it and releases it)
  const int n_mine = wq0 < Tq ? k_tiles_seen(causal, min(wq0 + kWgRows, Tq), q_off, k_off, nk) : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&sm.q_full, kQRows * kRowBytes);
    tma_load(sm.q, &tm_q, &sm.q_full, 0, q0, bh);
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_kv(sm, &tm_k, &tm_v, j, bh);
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  const bf16* q_wg = sm.q + wg * kWgRows * kD;
  mbar_wait(&sm.q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int next = j + kStages - 1;
    if (tid == 0 && next < n_tiles) {
      // the stage of tile `next` last held tile j - 1: wait until all read it
      if (j >= 1) mbar_wait(&sm.empty[(j - 1) % kStages], ((j - 1) / kStages) & 1);
      load_kv(sm, &tm_k, &tm_v, next, bh);
    }
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    if (j >= n_mine) {
      mbar_arrive(&sm.empty[s]);
      continue;
    }

    // s = q k^T: 4 k-steps of 16 along D (32 bytes into each swizzled row)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(sc, smem_desc(q_wg + kk * 16, 16, kAtom), smem_desc(sm.k[s] + kk * 16, 16, kAtom),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // softmax on the accumulator: sc[4g + e] is row row0 (e < 2) or row0 + 8,
    // column 8g + col0 + e % 2
    const int k0 = j * kKeys;
    float corr0, corr1;
    if (k0 + kKeys > Tk || (causal && k_off + k0 + kKeys - 1 > q_off + wq0)) {
      tile_softmax<true>(sc, m0, m1, l0, l1, corr0, corr1, scale, causal, q_off, k_off, qr0, qr1,
                         k0 + col0, Tk);
    } else {
      tile_softmax<false>(sc, m0, m1, l0, l1, corr0, corr1, scale, causal, q_off, k_off, qr0, qr1,
                          k0 + col0, Tk);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = acc[i] * ((i % 4) < 2 ? corr0 : corr1);

    // P in bf16 as wgmma's A fragment: k-step kk takes column groups 2kk, 2kk + 1
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) pa[4 * kk + h] = pack_bf16(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
    }
    // acc += T(p) v: 4 k-steps of 16 keys (16 rows of V, 2 swizzle atoms)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs_tb(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  smem_desc(sm.v[s] + kk * 16 * kD, 16, kAtom));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(&sm.empty[s]);
  }

  // epilogue: o = T(acc / l_safe) through the swizzled staging tile and a
  // TMA store; lse from each quad's first lane
  const float ls0 = fmaxf(l0, kTiny), ls1 = fmaxf(l1, kTiny);
  unsigned char* o_wg = reinterpret_cast<unsigned char*>(sm.o + wg * kWgRows * kD);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const float ls = h ? ls1 : ls0;
      const uint32_t v = pack_bf16(acc[4 * g + 2 * h] / ls, acc[4 * g + 2 * h + 1] / ls);
      // 16-byte chunk g of row r sits at chunk g ^ (r % 8)
      *reinterpret_cast<uint32_t*>(o_wg + r * kRowBytes + ((g ^ (r & 7)) * 16) + col0 * 2) = v;
    }
  }
  if (lane % 4 == 0) {
    if (qr0 < Tq) lse[(int64_t)bh * Tq + qr0] = m0 + logf(ls0);
    if (qr1 < Tq) lse[(int64_t)bh * Tq + qr1] = m1 + logf(ls1);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (tid % 128 == 0 && wq0 < Tq) {
    tma_store(&tm_o, o_wg, 0, wq0, bh);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime so that
// the library links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// codes below 0 are the tensor maps' own (tmpi_cuda_error_string names them)
constexpr int kNoEncoder = -100000;

// a 3-D map of [BH, T, D] bf16 with a box of 64 columns x `rows` rows and
// the 128-byte swizzle; 0 or a negative code
int bf16_map(CUtensorMap* map, const void* base, int BH, int T, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Tq, int Tk,
        int D, int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  if (D % 8 != 0 || D < 8 || D > kD) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  int rc = bf16_map(&mq, q, BH, Tq, D, kQRows);
  if (rc == 0) rc = bf16_map(&mk, k, BH, Tk, D, kKeys);
  if (rc == 0) rc = bf16_map(&mv, v, BH, Tk, D, kKeys);
  if (rc == 0) rc = bf16_map(&mo, o, BH, Tq, D, kWgRows);
  if (rc != 0) return rc;
  cudaError_t err = prepare(flash_fwd_sm90_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tq + kQRows - 1) / kQRows);
  flash_fwd_sm90_kernel<<<grid, kThreads, kSmemBytes, stream>>>(mq, mk, mv, mo, (float*)lse, Tq,
                                                                Tk, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_dkv_sm90: the bf16 dk/dv backward for Hopper, on TMA and wgmma
// ---------------------------------------------------------------------------
//
// The same function as flash_dkv_kernel<bf16> and flash_dkv_plain: p =
// valid ? expf(s * scale - lse) : 0 with s = q.k (fp32 sums, the scale
// after the dot); ds = bf16(p * (dp - dsum) * scale) with dp = dO.v;
// dk += ds^T q; dv += p^T dO with p NOT rounded; expf, -fmad=false. The
// tiling changes only the order of the sums, so the CTA shape is free.
//
// Bound: every product is on the tensor cores. The reference's fp32 x
// fp32 dv product (pallas_attention.py:218 upcasts dO) is made exact in
// bf16: p = p_hi + p_mid + p_lo, each part bf16 (3 x 8 significand bits
// cover fp32's 24; exact for p >= 2^-100, the subtractions exact in
// fp32), and dO is bf16 already, so each of the three products is exact
// in fp32 and dv sums them into one fp32 accumulator. 12 D bf16 FLOPs a
// visible pair (S, dP, dK once, dV three times): at the 136M LM's shape
// 38.7 GFLOP, 39 us at 989 TFLOP/s, above the 30 us of its 101.5 MB.
//
// Block: one CTA of 256 threads per (128-key tile, b*h); two consumer
// warpgroups own 64 keys each (one wgmma M). The key tiles go heaviest
// first (blockIdx.y is the key tile: in a causal launch the lowest keys
// see the most queries; b*h is blockIdx.x, the fast grid dimension).
//
// Transposed products (FlashAttention-3's dkv): S^T = K Q^T and dP^T =
// V dO^T as wgmma_ss, both operands K-major, exactly like the forward's
// Q K^T; the accumulator rows are keys, its columns queries. P^T (its
// three parts) and dS^T then go from registers as wgmma's A operand into
// dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major through the
// transpose bit, as the forward reads V: one swizzled Q (dO) tile serves
// both of its descriptors, and neither P nor dS goes through shared
// memory.
//
// Loads: K and V (128 rows) once per CTA by TMA; Q and dO (64 rows)
// through a ring of kQStages stages with full/empty mbarriers, thread 0
// loading tile j + kQAhead while tile j is computed, into a stage both
// warpgroups have released. Rows past T and columns
// past D come back as zeros. lse and dsum ([BH, Tq] fp32, whose rows need
// not be 16-byte aligned, so no tensor map) are read by each thread for
// its own 16 query columns, before the tile's wait so the loads hide
// behind it.
//
// Masks: only on tiles across the causal diagonal or a ragged query or
// key edge; a query column past Tq is masked explicitly (zero-filled q
// and dO would give p = exp(-lse), not 0). Query tiles wholly above a
// warpgroup's keys are skipped (they still pass through its barriers).
//
// Epilogue: dk and dv straight from the accumulators to fp32 [BH, Tk, D]
// in 8-byte stores (a row's 4 lanes write one 32-byte sector), clipped
// to rows < Tk and columns < D.
//
// Not yet: a producer warp with setmaxnreg (warp specialisation), and the
// two warpgroups kept out of step, so one's products overlap the other's
// elementwise work (tools/dkv_variants.py measures where the time goes).

constexpr int kKeyRows = 128;  // keys of a CTA
constexpr int kQTile = 64;     // queries of a streamed tile
constexpr int kQStages = 2;    // depth of the Q/dO ring
constexpr int kQAhead = 1;     // tiles loaded ahead of the one computed (< kQStages)
static_assert(kQAhead >= 1 && kQAhead < kQStages, "a stage is refilled only after its release");
static_assert(kQTile == kTile, "q_tile_start counts tiles of kTile queries");

struct BwdSmem {
  bf16 k[kKeyRows * kD];
  bf16 v[kKeyRows * kD];
  bf16 q[kQStages][kQTile * kD];
  bf16 d_o[kQStages][kQTile * kD];
  uint64_t full[kQStages];
  uint64_t empty[kQStages];
  uint64_t kv_full;
};
constexpr size_t kBwdSmemBytes = sizeof(BwdSmem) + 1024;  // + slack to align the base to 1024

// until at most one committed wgmma group is still in flight
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// rounds (x0, x1) to a packed bf16 pair and leaves the exact remainders
// x - bf16(x) in x0, x1: three calls split an fp32 pair into hi, mid, lo
__device__ __forceinline__ uint32_t split_bf16(float& x0, float& x1) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  x0 = __fsub_rn(x0, __low2float(b));
  x1 = __fsub_rn(x1, __high2float(b));
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void load_qdo(BwdSmem& sm, const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_do, int j, int q0, int bh) {
  const int s = j % kQStages;
  mbar_arrive_expect_tx(&sm.full[s], 2 * kQTile * kRowBytes);
  tma_load(sm.q[s], tm_q, &sm.full[s], 0, q0, bh);
  tma_load(sm.d_o[s], tm_do, &sm.full[s], 0, q0, bh);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ dsum, float* __restrict__ dk_out,
                      float* __restrict__ dv_out, int Tq, int Tk, int D, int q_off, int k_off,
                      int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const uint32_t raw = smem_addr(dyn_smem);
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(dyn_smem + (((raw + 1023u) & ~1023u) - raw));
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeyRows;  // heaviest causal key tiles first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row0 = ((tid % 128) / 32) * 16 + lane / 4;  // first of this thread's 2 keys (+8)
  const int col0 = 2 * (lane % 4);  // first of its 2 query columns in each 8-column group
  const int wk0 = k0 + wg * kWgRows;  // the warpgroup's first key
  const int kr0 = wk0 + row0, kr1 = kr0 + 8;
  const int nq = (Tq + kQTile - 1) / kQTile;
  const int i0 = q_tile_start(causal, k0, q_off, k_off);
  const int n_tiles = max(nq - i0, 0);
  // the warpgroup's own first tile: the second one skips the tiles of a
  // causal diagonal that lie wholly above its keys (and has none past Tk)
  const int i_mine = wk0 < Tk ? q_tile_start(causal, wk0, q_off, k_off) : nq;
  const float* lse_b = lse + (int64_t)bh * Tq;
  const float* dsum_b = dsum + (int64_t)bh * Tq;

  if (tid == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_init(&sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 2 * kKeyRows * kRowBytes);
    tma_load(sm.k, &tm_k, &sm.kv_full, 0, k0, bh);
    tma_load(sm.v, &tm_v, &sm.kv_full, 0, k0, bh);
    for (int j = 0; j < kQAhead && j < n_tiles; ++j)
      load_qdo(sm, &tm_q, &tm_do, j, (i0 + j) * kQTile, bh);
  }

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  const bf16* k_wg = sm.k + wg * kWgRows * kD;
  const bf16* v_wg = sm.v + wg * kWgRows * kD;
  mbar_wait(&sm.kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kQStages;
    const int next = j + kQAhead;
    if (tid == 0 && next < n_tiles) {
      // the stage of tile `next` last held tile `prev`: wait until all read it
      const int prev = next - kQStages;
      if (prev >= 0) mbar_wait(&sm.empty[prev % kQStages], (prev / kQStages) & 1);
      load_qdo(sm, &tm_q, &tm_do, next, (i0 + next) * kQTile, bh);
    }
    const int i = i0 + j;
    if (i < i_mine) {
      mbar_wait(&sm.full[s], (j / kQStages) & 1);
      mbar_arrive(&sm.empty[s]);
      continue;
    }
    const int q0 = i * kQTile;
    // lse and dsum of this thread's query columns 8g + col0 + e: c[2g + e]
    float lse_c[16], dsum_c[16];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = q0 + 8 * g + col0 + e;
        lse_c[2 * g + e] = c < Tq ? __ldg(lse_b + c) : 0.0f;
        dsum_c[2 * g + e] = c < Tq ? __ldg(dsum_b + c) : 0.0f;
      }
    }
    mbar_wait(&sm.full[s], (j / kQStages) & 1);

    // s^T = k q^T and dp^T = v dO^T: 4 k-steps of 16 along D each; the
    // scores' group is waited for first, so p runs while dp^T finishes
    float st[32], dpt[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) st[r] = dpt[r] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(st, smem_desc(k_wg + kk * 16, 16, kAtom), smem_desc(sm.q[s] + kk * 16, 16, kAtom),
               kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(dpt, smem_desc(v_wg + kk * 16, 16, kAtom),
               smem_desc(sm.d_o[s] + kk * 16, 16, kAtom), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_1();
    fence_regs(st);

    // p on the accumulator: st[4g + e] is key kr0 (e < 2) or kr1, query
    // column q0 + 8g + col0 + e % 2
    const bool masked = q0 + kQTile > Tq || wk0 + kWgRows > Tk ||
                        (causal && q_off + q0 < k_off + wk0 + kWgRows - 1);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int c = 2 * (r / 4) + r % 2;
      float p = expf(st[r] * scale - lse_c[c]);
      if (masked) {
        const int qc = q0 + 8 * (r / 4) + col0 + r % 2;
        if (!(qc < Tq && visible(causal, q_off, k_off, qc, (r % 4) < 2 ? kr0 : kr1, Tk))) p = 0.0f;
      }
      st[r] = p;
    }
    wgmma_wait();
    fence_regs(dpt);

    // ds^T in bf16 as wgmma's A fragment (k-step kk takes column groups
    // 2kk, 2kk + 1), and dk += ds^T q while the split of p is formed
    uint32_t dsa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = 8 * kk + 2 * h;
        const int c = 2 * (r / 4);
        dsa[4 * kk + h] = pack_bf16(st[r] * (dpt[r] - dsum_c[c]) * scale,
                                    st[r + 1] * (dpt[r + 1] - dsum_c[c + 1]) * scale);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQTile / 16; ++kk) {
      wgmma_rs_tb(dk, dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3],
                  smem_desc(sm.q[s] + kk * 16 * kD, 16, kAtom));
    }
    wgmma_commit();

    // p = hi + mid + lo in bf16, exactly; dv += (hi + mid + lo)^T dO
    uint32_t hi[16], mid[16], lo[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const int r = 8 * (a / 4) + 2 * (a % 4);
      float x0 = st[r], x1 = st[r + 1];
      hi[a] = split_bf16(x0, x1);
      mid[a] = split_bf16(x0, x1);
      lo[a] = split_bf16(x0, x1);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQTile / 16; ++kk) {
      const uint64_t b = smem_desc(sm.d_o[s] + kk * 16 * kD, 16, kAtom);
      wgmma_rs_tb(dv, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], b);
      wgmma_rs_tb(dv, mid[4 * kk], mid[4 * kk + 1], mid[4 * kk + 2], mid[4 * kk + 3], b);
      wgmma_rs_tb(dv, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3], b);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(dsa);
    fence_regs(hi);
    fence_regs(mid);
    fence_regs(lo);
    mbar_arrive(&sm.empty[s]);
  }

  // epilogue: rows kr0, kr1, columns 8g + col0 and + 1, as 8-byte stores
  float* dk_b = dk_out + (int64_t)bh * Tk * D;
  float* dv_b = dv_out + (int64_t)bh * Tk * D;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int c = 8 * g + col0;
    if (c >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = h ? kr1 : kr0;
      if (kr >= Tk) continue;
      const int64_t at = (int64_t)kr * D + c;
      *reinterpret_cast<float2*>(dk_b + at) = make_float2(dk[4 * g + 2 * h], dk[4 * g + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv_b + at) = make_float2(dv[4 * g + 2 * h], dv[4 * g + 2 * h + 1]);
    }
  }
}

int dkv(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
        const void* dsum, void* dk_out, void* dv_out, int BH, int Tq, int Tk, int D, int q_off,
        int k_off, int causal, float scale, cudaStream_t stream) {
  if (D % 8 != 0 || D < 8 || D > kD) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int rc = bf16_map(&mq, q, BH, Tq, D, kQTile);
  if (rc == 0) rc = bf16_map(&mk, k, BH, Tk, D, kKeyRows);
  if (rc == 0) rc = bf16_map(&mv, v, BH, Tk, D, kKeyRows);
  if (rc == 0) rc = bf16_map(&mdo, d_o, BH, Tq, D, kQTile);
  if (rc != 0) return rc;
  cudaError_t err = prepare(flash_dkv_sm90_kernel, kBwdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tk + kKeyRows - 1) / kKeyRows);
  flash_dkv_sm90_kernel<<<grid, kThreads, kBwdSmemBytes, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)dsum, (float*)dk_out, (float*)dv_out, Tq,
      Tk, D, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_dq_sm90: the bf16 dq backward for Hopper, on TMA and wgmma
// ---------------------------------------------------------------------------
//
// The same function as flash_dq_kernel<bf16> and flash_dq_plain: p =
// valid ? expf(s * scale - lse) : 0 with s = q.k (fp32 sums, the scale
// after the dot); dp = dO.v; ds = bf16(p * (dp - dsum) * scale); dq +=
// ds k with an fp32 accumulator; expf, -fmad=false. No rounding depends
// on the key tile (there is no online softmax), so the tiling changes
// only the order of the sums and the CTA shape is free.
//
// Bound, at the 136M LM's shape: 76.3 MB (q, k, v, dO in bf16, lse and
// dsum, dq in fp32) at 3.35 TB/s, 22.8 us, above the 19.3 GFLOP of bf16
// products (6 D a visible pair: S, dP, dQ) at 989 TFLOP/s.
//
// Block: flash_fwd_sm90's. One CTA of 256 threads per (128-query tile,
// b*h), two consumer warpgroups of 64 queries each (one wgmma M); b*h is
// blockIdx.x, the fast grid dimension, and causal query tiles go heaviest
// first. Q and dO (128 rows) are loaded once by TMA; K and V (64-key
// tiles) go through a ring of kDqStages stages with full/empty
// mbarriers, thread 0 loading tile j + kDqStages - 1 while tile j is
// computed, into the stage both warpgroups released last. lse and dsum
// ([BH, Tq] fp32, rows not 16-byte aligned, so no tensor map) are read
// once per thread for its two rows.
//
// Products per key tile and warpgroup: S = Q K^T and dP = dO V^T as
// wgmma_ss (both operands K-major, the forward's Q K^T), committed as two
// groups; wgmma_wait_1 lets p's exponentials run while dP finishes. ds
// is rounded to bf16 from the accumulators' fragments straight into
// wgmma's A fragments (as the forward packs P), and dQ += dS K reads the
// K stage MN-major through the transpose bit, as the forward reads V: one
// K tile serves both of its descriptors, and neither P nor dS goes
// through shared memory.
//
// Masks: only on tiles across the causal diagonal or the ragged key edge
// (kMasked); keys past Tk are masked explicitly, since zero-filled K
// would give p = exp(-lse), not 0, and a masked element takes p = 0
// without expf, so a blind row's -1e30 sentinel lse never gives an inf. Key tiles wholly above a warpgroup's queries are skipped (they
// still pass through its barriers). Query rows past Tq read lse = dsum =
// 0 from zero-filled Q and dO: ds = 0, and the rows are never stored.
//
// Epilogue: dq straight from the accumulator to fp32 [BH, Tq, D] in
// 8-byte stores, clipped to rows < Tq and columns < D (flash_dkv_sm90's).
//
// Not yet: a producer warp with setmaxnreg (warp specialisation), the two
// warpgroups out of step, 128-key tiles (tools/dq_variants.py measures
// where the time goes).

constexpr int kDqStages = 2;  // depth of the K/V ring

struct DqRing {
  bf16 q[kQRows * kD];
  bf16 d_o[kQRows * kD];
  bf16 k[kDqStages][kKeys * kD];
  bf16 v[kDqStages][kKeys * kD];
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
  uint64_t qdo_full;
};
constexpr size_t kDqSmemBytes = sizeof(DqRing) + 1024;  // + slack to align the base to 1024

// p on the S accumulator, in place: sc[4g + e] is row qr0 (e < 2) or
// qr1, key column c0 + 8g + e % 2. Only kMasked tiles test each element.
template <bool kMasked>
__device__ __forceinline__ void tile_probs(float (&sc)[32], float lse0, float lse1, float scale,
                                           int causal, int q_off, int k_off, int qr0, int qr1,
                                           int c0, int Tk) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool top = (i % 4) < 2;
    const bool seen = visible(causal, q_off, k_off, top ? qr0 : qr1, c0 + 8 * (i / 4) + i % 2, Tk);
    sc[i] = !kMasked || seen ? expf(sc[i] * scale - (top ? lse0 : lse1)) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dq_out, int Tq, int Tk,
                     int D, int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const uint32_t raw = smem_addr(dyn_smem);
  DqRing& sm = *reinterpret_cast<DqRing*>(dyn_smem + (((raw + 1023u) & ~1023u) - raw));
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row0 = ((tid % 128) / 32) * 16 + lane / 4;  // first of this thread's 2 rows (+8)
  const int col0 = 2 * (lane % 4);  // first of its 2 columns in each 8-column group
  const int wq0 = q0 + wg * kWgRows;  // the warpgroup's first query row
  const int qr0 = wq0 + row0, qr1 = qr0 + 8;
  const int nk = (Tk + kKeys - 1) / kKeys;
  const int n_tiles = k_tiles_seen(causal, min(q0 + kQRows, Tq), q_off, k_off, nk);
  // the warpgroup's own last tile, as flash_fwd_sm90's
  const int n_mine = wq0 < Tq ? k_tiles_seen(causal, min(wq0 + kWgRows, Tq), q_off, k_off, nk) : 0;

  if (tid == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_init(&sm.qdo_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&sm.qdo_full, 2 * kQRows * kRowBytes);
    tma_load(sm.q, &tm_q, &sm.qdo_full, 0, q0, bh);
    tma_load(sm.d_o, &tm_do, &sm.qdo_full, 0, q0, bh);
    for (int j = 0; j < kDqStages - 1 && j < n_tiles; ++j) load_kv(sm, &tm_k, &tm_v, j, bh);
  }

  const float* lse_b = lse + (int64_t)bh * Tq;
  const float* dsum_b = dsum + (int64_t)bh * Tq;
  const float lse0 = qr0 < Tq ? __ldg(lse_b + qr0) : 0.0f;
  const float lse1 = qr1 < Tq ? __ldg(lse_b + qr1) : 0.0f;
  const float dsum0 = qr0 < Tq ? __ldg(dsum_b + qr0) : 0.0f;
  const float dsum1 = qr1 < Tq ? __ldg(dsum_b + qr1) : 0.0f;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  const bf16* q_wg = sm.q + wg * kWgRows * kD;
  const bf16* do_wg = sm.d_o + wg * kWgRows * kD;
  mbar_wait(&sm.qdo_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kDqStages;
    const int next = j + kDqStages - 1;
    if (tid == 0 && next < n_tiles) {
      // the stage of tile `next` last held tile j - 1: wait until all read it
      if (j >= 1) mbar_wait(&sm.empty[(j - 1) % kDqStages], ((j - 1) / kDqStages) & 1);
      load_kv(sm, &tm_k, &tm_v, next, bh);
    }
    mbar_wait(&sm.full[s], (j / kDqStages) & 1);
    if (j >= n_mine) {
      mbar_arrive(&sm.empty[s]);
      continue;
    }

    // s = q k^T and dp = dO v^T: 4 k-steps of 16 along D each; the scores'
    // group is waited for first, so p runs while dp finishes
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(sc, smem_desc(q_wg + kk * 16, 16, kAtom), smem_desc(sm.k[s] + kk * 16, 16, kAtom),
               kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss(dp, smem_desc(do_wg + kk * 16, 16, kAtom), smem_desc(sm.v[s] + kk * 16, 16, kAtom),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_1();
    fence_regs(sc);

    const int k0 = j * kKeys;
    const bool dq_masked = k0 + kKeys > Tk || (causal && k_off + k0 + kKeys - 1 > q_off + wq0);
    if (dq_masked) {
      tile_probs<true>(sc, lse0, lse1, scale, causal, q_off, k_off, qr0, qr1, k0 + col0, Tk);
    } else {
      tile_probs<false>(sc, lse0, lse1, scale, causal, q_off, k_off, qr0, qr1, k0 + col0, Tk);
    }
    wgmma_wait();
    fence_regs(dp);

    // ds in bf16 as wgmma's A fragment: k-step kk takes column groups 2kk,
    // 2kk + 1; the pair of elements 8kk + 2h shares row qr0 (h even) or qr1
    uint32_t dsa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = 8 * kk + 2 * h;
        const float ds_sum = h % 2 ? dsum1 : dsum0;
        dsa[4 * kk + h] = pack_bf16(sc[r] * (dp[r] - ds_sum) * scale,
                                    sc[r + 1] * (dp[r + 1] - ds_sum) * scale);
      }
    }
    // dq += ds k: 4 k-steps of 16 keys, K read MN-major (16 rows, 2 atoms)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t b = smem_desc(sm.k[s] + kk * 16 * kD, 16, kAtom);
      wgmma_rs_tb(dq, dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3], b);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dq);
    fence_regs(dsa);
    mbar_arrive(&sm.empty[s]);
  }

  // epilogue: rows qr0, qr1, columns 8g + col0 and + 1, as 8-byte stores
  float* dq_b = dq_out + (int64_t)bh * Tq * D;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int c = 8 * g + col0;
    if (c >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = h ? qr1 : qr0;
      if (qr >= Tq) continue;
      *reinterpret_cast<float2*>(dq_b + (int64_t)qr * D + c) =
          make_float2(dq[4 * g + 2 * h], dq[4 * g + 2 * h + 1]);
    }
  }
}

int dq(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
       const void* dsum, void* dq_out, int BH, int Tq, int Tk, int D, int q_off, int k_off,
       int causal, float scale, cudaStream_t stream) {
  if (D % 8 != 0 || D < 8 || D > kD) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int rc = bf16_map(&mq, q, BH, Tq, D, kQRows);
  if (rc == 0) rc = bf16_map(&mk, k, BH, Tk, D, kKeys);
  if (rc == 0) rc = bf16_map(&mv, v, BH, Tk, D, kKeys);
  if (rc == 0) rc = bf16_map(&mdo, d_o, BH, Tq, D, kQRows);
  if (rc != 0) return rc;
  cudaError_t err = prepare(flash_dq_sm90_kernel, kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tq + kQRows - 1) / kQRows);
  flash_dq_sm90_kernel<<<grid, kThreads, kDqSmemBytes, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)dsum, (float*)dq_out, Tq, Tk, D, q_off,
      k_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// flash_fwd_mma: the fp32 forward for Hopper, on mma.sync tf32 (3xTF32)
// ---------------------------------------------------------------------------
//
// The same function as flash_fwd_kernel<float> and flash_fwd_plain (block_k
// 64): s = dot(q, k) * scale, the online softmax over 64-key tiles at the
// same points (sm90::tile_softmax, expf/logf, -fmad=false), acc = acc * c +
// dot(p, v), o = acc / max(l, 1e-37), lse = m + log(max(l, 1e-37)). Only
// the products differ: each runs on the tensor cores as three tf32
// products, so the kernel is held to phase flash's fp32 limits, not to bits.
//
// Products (3xTF32): an fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna, round to nearest, ties away; x - hi is exact), and
// a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, the two small terms first. What
// is left out (lo_a lo_b and the remainders below lo) is about 2^-22 of
// |a b|, against 2^-11 for one tf32 product. mma.sync.m16n8k8 (tf32 in,
// fp32 accumulators), not wgmma: wgmma's tf32 form takes only K-major
// operands, and V in P V is MN-major, so it would need V transposed in
// shared memory on every tile.
//
// Block: one CTA of 256 threads (8 warps) per (128-row Q tile, b*h); a
// warp owns 16 query rows, one M of the mma. The Q tiles of a causal launch
// go heaviest first (blockIdx.y reversed; b*h is blockIdx.x). Q is read
// once from device memory into registers as tf32 hi and lo A fragments (64
// registers at D 64). Registers bound the occupancy: 255 a thread (Q's
// fragments, S, the tile's P V and acc take 32 each beyond them), so one
// CTA, 8 warps, an SM; 128 rows share each K/V tile and its split (64-row
// CTAs, two an SM, split each tile twice as often and measured slower).
//
// Loads: K and V tiles of 64 keys go through a two-stage shared-memory ring
// by cp.async (16-byte copies when D % 4 == 0 and k and v are 16-byte
// aligned, else 4-byte ones; rows past Tk are zero-filled by the copy, the
// columns from D to 64 zeroed once). Tile j + 1 is in flight while tile j
// is computed. Once tile j lands, the CTA splits it: K's tf32 hi in place
// and lo beside the ring, V's hi and lo transposed into V^T arrays (a row
// per head column). Each warp reads every K and V value, so splitting
// where it is read would do it 8 times. Three barriers a tile: landed,
// split, read.
//
// Fragments: S, P, the tile's P V, acc, m and l stay in registers. The
// tf32 A fragment of m16n8k8 (a thread holds columns t and t + 4) is not
// laid out like the C fragment (columns 2t and 2t + 1), so S = Q K^T is
// computed with its D columns permuted: logical column t is d = 2t, t + 4
// is d = 2t + 1 (a sum over d does not care). P's C fragment then is P V's
// A fragment as it stands, with the keys of each 8-key step permuted the
// same way in V's B fragment. Neither needs a shuffle or a shared stage.
// V^T turns V's (key 2t, key 2t + 1) pair into adjacent floats. Banks: K
// and V^T rows are 72 floats apart, so a half-warp's 8-byte (d, d + 1) or
// (key, key + 1) loads hit 32 distinct banks; the ring's V rows are 68
// apart, so the split pass's transposed stores, a lane a row, do too.
//
// Issue order: in each 8-column (or 8-key) step a warp issues the 8 column
// groups' products back to back, one of the three terms at a time, so 8
// independent accumulators separate each dependent pair of mma.sync (a
// group's three terms in a row stall on each other's results).
//
// Accumulation: each tile's P V goes into a zeroed fragment and is added
// to acc in fp32 (acc * c + tile, as the plain version orders it), so the
// tensor cores' own accumulation spans 8 key steps, not the whole row.
// Masks are computed only on tiles across the causal diagonal or the
// ragged key edge (per warp); a warp skips the tiles its rows cannot see.
//
// Bound, at the 136M LM's shape in fp32 (BH 96, T 1024, D 64, causal):
// 101 MB (30 us at 3.35 TB/s); 12.9 GFLOP as fp32 products (193 us at 67
// TFLOP/s on the CUDA cores), 38.7 GFLOP as 3xTF32 (78 us at the 495
// TFLOP/s dense tf32 rate), so the tensor cores' share bounds it.
//
// Not yet: wgmma (V transposed in shared memory), a producer warp, the
// softmax of one tile overlapped with the products of the next.

namespace mma {

constexpr int kRows = 128;      // query rows of a CTA
constexpr int kWarpRows = 16;   // query rows of a warp: one mma M
constexpr int kMmaThreads = 256;
constexpr int kRing = 2;        // K/V tiles in the shared-memory ring
// floats between rows: K's and V^T's 72, so a half-warp's (d, d + 1) pairs
// are conflict-free; the ring's V rows 68, so the split's transposed reads are
constexpr int kLdK = kD + 8;
constexpr int kLdV = kD + 4;
static_assert(kRows == (kMmaThreads / 32) * kWarpRows, "a warp owns 16 rows");

struct Smem {
  float k[kRing][kTile * kLdK];
  float v[kRing][kTile * kLdV];
  // the tile being computed, split: K's lo parts (its hi parts in place),
  // V's hi and lo parts as V^T (a row per head column), so P V reads (key
  // 2t, 2t + 1) pairs
  float k_lo[kTile * kLdK];
  float vt_hi[kD * kLdK];
  float vt_lo[kD * kLdK];
};

// hi = tf32(x), lo = tf32(x - hi), both as the mma reads them (round to
// nearest, ties away from zero); the format leaves hi's low 13 bits
// unspecified, so they are cleared before hi is subtracted
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(h)));
  hi = h;
}

// d += A B over m16 n8 k8, tf32 in, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a B fragment's (b0, b1) pair, adjacent at `at`, as its tf32 hi and lo
// parts: one float2 from each of the split tile's arrays
__device__ __forceinline__ void b_parts(const float* hi, const float* lo, int at,
                                        uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(hi + at);
  const float2 y = *reinterpret_cast<const float2*>(lo + at);
  bh[0] = __float_as_uint(x.x);
  bh[1] = __float_as_uint(x.y);
  bl[0] = __float_as_uint(y.x);
  bl[1] = __float_as_uint(y.y);
}

// cp.async of kBytes (4 or 16) from src, or zeros when !fill (src is then
// not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool fill) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sm90::smem_addr(dst)),
                 "l"(src), "r"(fill ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(sm90::smem_addr(dst)),
                 "l"(src), "r"(fill ? 4 : 0)
                 : "memory");
  }
}

// rows [k0, k0 + 64) of src ([Tk, D] fp32) into dst (kLd floats a row):
// columns below D only, rows past Tk as zeros
template <int kLd>
__device__ __forceinline__ void tile_async(float* dst, const float* __restrict__ src, int k0,
                                           int Tk, int D, bool vec) {
  const int per = vec ? D / 4 : D;  // copies a row
  for (int i = threadIdx.x; i < kTile * per; i += kMmaThreads) {
    const int r = i / per;
    const int c = (i - r * per) * (vec ? 4 : 1);
    const bool in = k0 + r < Tk;
    const float* s = src + (int64_t)(in ? k0 + r : 0) * D + c;
    if (vec) {
      cp_async<16>(dst + r * kLd + c, s, in);
    } else {
      cp_async<4>(dst + r * kLd + c, s, in);
    }
  }
}

// K/V tile j into its stage of a ring (Smem's, or flash_dq_mma's
// DqMmaSmem, whose V rows are as long as K's)
template <typename Ring>
__device__ __forceinline__ void load_kv_async(Ring& sm, const float* kb, const float* vb, int j,
                                              int Tk, int D, bool vec) {
  constexpr int kLdv = sizeof(Ring::v) / sizeof(float) / kRing / kTile;
  const int s = j % kRing;
  tile_async<kLdK>(sm.k[s], kb, j * kTile, Tk, D, vec);
  tile_async<kLdv>(sm.v[s], vb, j * kTile, Tk, D, vec);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// the K tile ks -> its hi parts in place and lo parts in sm.k_lo; the V
// tile vs -> sm.vt_hi and sm.vt_lo, transposed. A thread loads all its
// float4s before it splits and stores any. K: consecutive lanes take
// consecutive float4s of a row; V: consecutive rows of one column group,
// so the transposed 4-byte stores of a warp hit 32 distinct banks.
__device__ __forceinline__ void split_kv(Smem& sm, float* ks, const float* vs) {
  constexpr int kPer = kTile * kD / 4 / kMmaThreads;  // float4s a thread, each of K and V
  float4 xk[kPer], xv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    xk[j] = *reinterpret_cast<const float4*>(ks + (i / (kD / 4)) * kLdK + (i % (kD / 4)) * 4);
    xv[j] = *reinterpret_cast<const float4*>(vs + (i % kTile) * kLdV + (i / kTile) * 4);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int at = (i / (kD / 4)) * kLdK + (i % (kD / 4)) * 4;
    uint32_t h[4], l[4];
    split_tf32(xk[j].x, h[0], l[0]);
    split_tf32(xk[j].y, h[1], l[1]);
    split_tf32(xk[j].z, h[2], l[2]);
    split_tf32(xk[j].w, h[3], l[3]);
    *reinterpret_cast<uint4*>(ks + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(sm.k_lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    const int r = i % kTile, c = (i / kTile) * 4;
    const float x[4] = {xv[j].x, xv[j].y, xv[j].z, xv[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(x[e], h[e], l[e]);
      sm.vt_hi[(c + e) * kLdK + r] = __uint_as_float(h[e]);
      sm.vt_lo[(c + e) * kLdK + r] = __uint_as_float(l[e]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int D, int q_off, int k_off,
                     int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dyn_smem);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread in group
  const int wq0 = q0 + (tid / 32) * kWarpRows;  // the warp's first query row
  const int qr0 = wq0 + g, qr1 = qr0 + 8;      // this thread's two rows
  const float* kb = k + (int64_t)bh * Tk * D;
  const float* vb = v + (int64_t)bh * Tk * D;
  const bool vec = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int nk = (Tk + kTile - 1) / kTile;
  const int n_tiles = sm90::k_tiles_seen(causal, min(q0 + kRows, Tq), q_off, k_off, nk);
  // the warp's own last tile (exclusive): it skips the CTA's later ones
  const int n_mine =
      wq0 < Tq ? sm90::k_tiles_seen(causal, min(wq0 + kWarpRows, Tq), q_off, k_off, nk) : 0;
  const int steps = (D + 7) / 8;  // 8-column steps of the head that hold data

  if (n_tiles > 0) load_kv_async(sm, kb, vb, 0, Tk, D, vec);
  // the head's zero padding, never written by the copies
  const int pad = kD - D;
  for (int i = tid; i < kRing * kTile * pad; i += kMmaThreads) {
    const int s = i / (kTile * pad);
    const int r = (i / pad) % kTile, c = D + i % pad;
    sm.k[s][r * kLdK + c] = 0.0f;
    sm.v[s][r * kLdV + c] = 0.0f;
  }

  // Q's A fragments, hi and lo: element e of step kk is row e & 1 ? qr1 :
  // qr0, head column 8kk + 2t + (e >> 1) (the permuted columns)
  uint32_t qh[kD / 8][4], ql[kD / 8][4];
  const float* qb = q + (int64_t)bh * Tq * D;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1 ? qr1 : qr0;
      const int c = 8 * kk + 2 * t + (e >> 1);
      split_tf32(r < Tq && c < D ? qb[(int64_t)r * D + c] : 0.0f, qh[kk][e], ql[kk][e]);
    }
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv_async(sm, kb, vb, j + 1, Tk, D, vec);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile j has landed for every thread
    float* ks = sm.k[j % kRing];
    const float* vs = sm.v[j % kRing];
    split_kv(sm, ks, vs);
    __syncthreads();  // the split tile is whole
    if (j < n_mine) {
      // s = q k^T: sc[4n + e] is row e < 2 ? qr0 : qr1, key 8n + 2t + e % 2.
      // Each 8-column step runs the 8 key groups' independent products
      // back to back, one of the three terms at a time.
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        if (kk < steps) {
          uint32_t kh[kTile / 8][2], kl[kTile / 8][2];
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            b_parts(ks, sm.k_lo, (8 * n + g) * kLdK + 8 * kk + 2 * t, kh[n], kl[n]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n) mma_tf32(sc + 4 * n, ql[kk], kh[n][0], kh[n][1]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n) mma_tf32(sc + 4 * n, qh[kk], kl[n][0], kl[n][1]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n) mma_tf32(sc + 4 * n, qh[kk], kh[n][0], kh[n][1]);
        }
      }

      const int k0 = j * kTile;
      const bool edge = k0 + kTile > Tk || (causal && k_off + k0 + kTile - 1 > q_off + wq0);
      float corr0, corr1;
      if (edge) {
        sm90::tile_softmax<true>(sc, m0, m1, l0, l1, corr0, corr1, scale, causal, q_off, k_off,
                                 qr0, qr1, k0 + 2 * t, Tk);
      } else {
        sm90::tile_softmax<false>(sc, m0, m1, l0, l1, corr0, corr1, scale, causal, q_off, k_off,
                                  qr0, qr1, k0 + 2 * t, Tk);
      }

      // the tile's p v: key step kk's A fragment is P's C fragment of keys
      // 8kk..8kk+7 (a0 = sc[4kk], a1 = sc[4kk + 2], a2 = sc[4kk + 1], a3 =
      // sc[4kk + 3]); B takes V's keys 8kk + 2t and + 1, column 8n + g
      float pv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTile / 8; ++kk) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[4 * kk], ph[0], pl[0]);
        split_tf32(sc[4 * kk + 2], ph[1], pl[1]);
        split_tf32(sc[4 * kk + 1], ph[2], pl[2]);
        split_tf32(sc[4 * kk + 3], ph[3], pl[3]);
        uint32_t vh[kD / 8][2], vl[kD / 8][2];
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps)
            b_parts(sm.vt_hi, sm.vt_lo, (8 * n + g) * kLdK + 8 * kk + 2 * t, vh[n], vl[n]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(pv + 4 * n, pl, vh[n][0], vh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(pv + 4 * n, ph, vl[n][0], vl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(pv + 4 * n, ph, vh[n][0], vh[n][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = acc[i] * ((i % 4) < 2 ? corr0 : corr1) + pv[i];
    }
    __syncthreads();  // every thread is done with the stage tile j + 2 will fill
  }

  // epilogue: o = acc / l_safe for rows qr0, qr1, columns 8n + 2t and + 1;
  // lse from each quad's first lane
  const float ls0 = fmaxf(l0, kTiny), ls1 = fmaxf(l1, kTiny);
  float* ob = o + (int64_t)bh * Tq * D;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? qr1 : qr0;
      const float ls = h ? ls1 : ls0;
      if (r >= Tq || c >= D) continue;
      const float x0 = acc[4 * n + 2 * h] / ls, x1 = acc[4 * n + 2 * h + 1] / ls;
      float* dst = ob + (int64_t)r * D + c;
      if (D % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        if (c + 1 < D) dst[1] = x1;
      }
    }
  }
  if (t == 0) {
    if (qr0 < Tq) lse[(int64_t)bh * Tq + qr0] = m0 + logf(ls0);
    if (qr1 < Tq) lse[(int64_t)bh * Tq + qr1] = m1 + logf(ls1);
  }
}

int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Tq, int Tk,
        int D, int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  if (D < 1 || D > kD) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem);
  cudaError_t err = prepare(flash_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tq + kRows - 1) / kRows);
  flash_fwd_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Tq, Tk, D, q_off,
      k_off, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_fwd_mma_bf16: the bf16 forward for heads with D % 8 != 0, on mma.sync bf16
// ---------------------------------------------------------------------------
//
// The same function as flash_fwd_kernel<bf16> and flash_fwd_plain (block_k
// 64): s = dot(q, k) * scale with bf16 x bf16 products summed in fp32, the
// online softmax at the same points (sm90::tile_softmax, expf/logf,
// -fmad=false), p rounded to bf16 before P V (pallas_attention.py:153-156),
// o = bf16(acc / max(l, 1e-37)), lse = m + log(max(l, 1e-37)). Rows that
// see no key get o = 0 and lse <= -1e29. Only the order of the sums inside
// the two products differs. It takes any 1 <= D <= 64; the route sends it
// the bf16 heads whose rows are not whole 16-byte units (D % 8 != 0), which
// flash_fwd_sm90's tensor maps refuse.
//
// Products: mma.sync.m16n8k16 with bf16 operands and fp32 accumulators,
// one product each for S = Q K^T and for P V (bf16 x bf16 is exact in
// fp32). The head dim is zero-padded in shared memory to the next multiple
// of 16 (the k of S = Q K^T), at most kD = 64.
//
// Block: flash_fwd_mma's. One CTA of 256 threads (8 warps) per (128-row Q
// tile, b*h), heaviest causal tiles first; a warp owns 16 query rows (one
// M). Q is read once from device memory into registers as A fragments (16
// registers at D 64). S, P, acc, m and l stay in registers; the C fragments
// of S's n8 tiles 2kk and 2kk + 1, packed to bf16 pairs, are P V's A
// fragment of key step kk as they stand (the fragment layouts of the 16-bit
// m16n8k16 agree), so P needs no shuffle, and acc is rescaled in place and
// accumulated by the mma. K's B fragments come from the K/V stage by
// ldmatrix.x4 (two key groups of 8 a call), V's by ldmatrix.x4.trans (V is
// read MN-major: the transpose hands each thread its (key 2t, 2t + 1) pair).
// Stage rows are 72 bf16 (144 bytes) apart, so the 8 row addresses of each
// ldmatrix phase hit 8 distinct 16-byte bank groups. Two CTAs an SM with
// cp.async loads (held to 128 registers, it spills ~120 bytes a thread and
// still beats one CTA an SM without spills); one with staged loads.
//
// Loads: K and V tiles of 64 keys go through a two-stage shared-memory
// ring. With D even (and k, v 4-byte aligned), by 4-byte cp.async copies
// (a row of D bf16 is no whole number of 16-byte units): tile j + 1 is in
// flight while tile j is computed, rows past Tk zero-filled by the copy.
// With D odd a row is no whole number of 4-byte units and cp.async has no
// 2-byte form, so the loads are staged in registers (kStaged): tile j + 1's
// 16 + 16 bf16 a thread are loaded into registers before tile j is
// computed and stored to the free stage after it. A thread walks its
// elements by adds (Walk), not by a division by the run-time D each: with
// the divisions the staged loads took 2.2x as long. The columns from D to
// 64 are zeroed once. Two barriers a tile: landed, read.
//
// Bound, at BH 96, T 1024, D 60, bf16, causal: 47.6 MB (14 us at 3.35 TB/s)
// against 12.1 GFLOP of bf16 products over the causal half (12 us at 989
// TFLOP/s): the bytes bound it (chip_smoke.py phase times computes both).
//
// Not yet: wgmma (its bf16 tensor maps need whole 16-byte rows; a cp.async
// ring with wgmma from shared memory would do), a producer warp.

constexpr int kLdB = kD + 8;  // bf16 between the rows of a K/V stage
constexpr int kStagedPer = kTile * kD / kMmaThreads;  // bf16 a thread, each of K and V

struct SmemBf16 {
  bf16 k[kRing][kTile * kLdB];
  bf16 v[kRing][kTile * kLdB];
};

// d += A B over m16 n8 k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8. r[m] is matrix m's (row lane / 4; columns
// 2 (lane % 4), + 1) pair, or with kTrans its (rows 2 (lane % 4), + 1;
// column lane / 4) pair.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(sm90::smem_addr(row))
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(sm90::smem_addr(row))
                 : "memory");
  }
}

// Element threadIdx.x + 256 s of a row-major tile `width` units wide, as
// (row, column): the first, and the step of 256 units, taken once, so a
// loop over a tile adds instead of dividing by a width known at run time
struct Walk {
  int r0, c0, dr, dc, width;
  __device__ explicit Walk(int w)
      : r0(threadIdx.x / w), c0(threadIdx.x % w), dr(kMmaThreads / w), dc(kMmaThreads % w),
        width(w) {}
  __device__ __forceinline__ void next(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

// rows [row0, row0 + 64) of a and b ([nrows, D] bf16, D even) into the
// stages ad and bd by 4-byte cp.async (`w` walks D / 2 words a row):
// columns below D, rows past nrows as zeros
__device__ __forceinline__ void pair_async_bf16(bf16* ad, bf16* bd, const bf16* a, const bf16* b,
                                                int row0, int nrows, int D, const Walk& w) {
  for (int r = w.r0, c = w.c0; r < kTile; w.next(r, c)) {
    const bool in = row0 + r < nrows;
    const int64_t at = (int64_t)(in ? row0 + r : 0) * D + 2 * c;
    cp_async<4>(reinterpret_cast<float*>(ad + r * kLdB + 2 * c),
                reinterpret_cast<const float*>(a + at), in);
    cp_async<4>(reinterpret_cast<float*>(bd + r * kLdB + 2 * c),
                reinterpret_cast<const float*>(b + at), in);
  }
}

// K/V tile j into its stage by 4-byte cp.async (D even), one group
__device__ __forceinline__ void load_kv_bf16(SmemBf16& sm, const bf16* kb, const bf16* vb, int j,
                                             int Tk, int D, const Walk& w) {
  pair_async_bf16(sm.k[j % kRing], sm.v[j % kRing], kb, vb, j * kTile, Tk, D, w);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// columns D to 64 of every stage of two rings: the head's zero padding,
// never written by the loads
__device__ __forceinline__ void zero_pad_bf16(bf16 (&a)[kRing][kTile * kLdB],
                                              bf16 (&b)[kRing][kTile * kLdB], int D) {
  const int pad = kD - D;
  for (int i = threadIdx.x; i < kRing * kTile * pad; i += kMmaThreads) {
    const int s = i / (kTile * pad);
    const int r = (i / pad) % kTile, c = D + i % pad;
    a[s][r * kLdB + c] = __float2bfloat16_rn(0.0f);
    b[s][r * kLdB + c] = __float2bfloat16_rn(0.0f);
  }
}

// A fragments of rows r0 and r0 + 8 of src ([nrows, D] bf16), read once
// from device memory: step kk's a[kk][e] holds row e & 1 ? r0 + 8 : r0,
// columns 16kk + 8 (e >> 1) + 2t and + 1 (the lower column in the low
// half); zero past nrows and D
__device__ __forceinline__ void a_frags_bf16(uint32_t (&a)[kD / 16][4], const bf16* src, int r0,
                                             int nrows, int D) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1);
      const int c = 16 * kk + 8 * (e >> 1) + 2 * t;
      const uint32_t lo = r < nrows && c < D ? s[(int64_t)r * D + c] : 0u;
      const uint32_t hi = r < nrows && c + 1 < D ? s[(int64_t)r * D + c + 1] : 0u;
      a[kk][e] = lo | (hi << 16);
    }
  }
}

// the register-staged loads (D odd; `w` walks D elements a row) of a pair
// of tiles, K and V (or Q and dO in flash_dkv_mma_bf16): element i = tid
// + s * 256 of the tile's 64 x D, at row r and column c, is element (k0 +
// r) * D + c = k0 * D + i of the [Tk, D] source
struct Staged {
  unsigned short k[kStagedPer];
  unsigned short v[kStagedPer];
};

__device__ __forceinline__ void staged_load(Staged& st, const bf16* kb, const bf16* vb, int k0,
                                            int Tk, int D, const Walk& w) {
  const unsigned short* ks = reinterpret_cast<const unsigned short*>(kb);
  const unsigned short* vs = reinterpret_cast<const unsigned short*>(vb);
  int r = w.r0, c = w.c0;
#pragma unroll
  for (int s = 0; s < kStagedPer; ++s) {
    const bool in = r < kTile && k0 + r < Tk;
    const int64_t at = (int64_t)k0 * D + threadIdx.x + s * kMmaThreads;
    st.k[s] = in ? __ldg(ks + at) : (unsigned short)0;
    st.v[s] = in ? __ldg(vs + at) : (unsigned short)0;
    w.next(r, c);
  }
}

__device__ __forceinline__ void staged_store(const Staged& st, bf16* kd, bf16* vd,
                                             const Walk& w) {
  unsigned short* k = reinterpret_cast<unsigned short*>(kd);
  unsigned short* v = reinterpret_cast<unsigned short*>(vd);
  int r = w.r0, c = w.c0;
#pragma unroll
  for (int s = 0; s < kStagedPer; ++s) {
    if (r < kTile) {
      k[r * kLdB + c] = st.k[s];
      v[r * kLdB + c] = st.v[s];
    }
    w.next(r, c);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMmaThreads, kStaged ? 1 : 2)
flash_fwd_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int Tq, int Tk, int D, int q_off, int k_off,
                          int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(dyn_smem);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread in group
  const int wq0 = q0 + (tid / 32) * kWarpRows;  // the warp's first query row
  const int qr0 = wq0 + g, qr1 = qr0 + 8;      // this thread's two rows
  const bf16* kb = k + (int64_t)bh * Tk * D;
  const bf16* vb = v + (int64_t)bh * Tk * D;
  const int nk = (Tk + kTile - 1) / kTile;
  const int n_tiles = sm90::k_tiles_seen(causal, min(q0 + kRows, Tq), q_off, k_off, nk);
  const int n_mine =
      wq0 < Tq ? sm90::k_tiles_seen(causal, min(wq0 + kWarpRows, Tq), q_off, k_off, nk) : 0;
  const int steps = (D + 15) / 16;  // 16-column steps of the head that hold data

  zero_pad_bf16(sm.k, sm.v, D);
  Staged stg;
  const Walk walk(kStaged ? D : D / 2);  // elements (staged) or 4-byte words a row
  if (n_tiles > 0) {
    if constexpr (kStaged) {
      staged_load(stg, kb, vb, 0, Tk, D, walk);
      staged_store(stg, sm.k[0], sm.v[0], walk);
    } else {
      load_kv_bf16(sm, kb, vb, 0, Tk, D, walk);
    }
  }

  // Q's A fragments: step kk's qa[kk][e] holds row e & 1 ? qr1 : qr0
  uint32_t qa[kD / 16][4];
  a_frags_bf16(qa, q + (int64_t)bh * Tq * D, qr0, Tq, D);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (kStaged) {
      if (j + 1 < n_tiles) staged_load(stg, kb, vb, (j + 1) * kTile, Tk, D, walk);
    } else if (j + 1 < n_tiles) {
      load_kv_bf16(sm, kb, vb, j + 1, Tk, D, walk);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile j has landed for every thread
    const bf16* ks = sm.k[j % kRing];
    const bf16* vs = sm.v[j % kRing];
    if (j < n_mine) {
      // s = q k^T: sc[4n + e] is row e < 2 ? qr0 : qr1, key 8n + 2t + e % 2.
      // ldmatrix p of step kk: matrix m is keys 16p + 8 (m >> 1) + 0..7,
      // head columns 16kk + 8 (m & 1) + 0..7, so r[0], r[1] are key group
      // 2p's (b0, b1) and r[2], r[3] group 2p + 1's
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if (kk < steps) {
          uint32_t kf[kTile / 16][4];
#pragma unroll
          for (int p = 0; p < kTile / 16; ++p)
            ldmatrix_x4<false>(kf[p], ks + (16 * p + 8 * (lane >> 4) + (lane & 7)) * kLdB +
                                          16 * kk + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int p = 0; p < kTile / 16; ++p) {
            mma_bf16(sc + 8 * p, qa[kk], kf[p][0], kf[p][1]);
            mma_bf16(sc + 8 * p + 4, qa[kk], kf[p][2], kf[p][3]);
          }
        }
      }

      const int k0 = j * kTile;
      const bool masked = k0 + kTile > Tk || (causal && k_off + k0 + kTile - 1 > q_off + wq0);
      float cr0, cr1;
      if (masked) {
        sm90::tile_softmax<true>(sc, m0, m1, l0, l1, cr0, cr1, scale, causal, q_off, k_off, qr0,
                                 qr1, k0 + 2 * t, Tk);
      } else {
        sm90::tile_softmax<false>(sc, m0, m1, l0, l1, cr0, cr1, scale, causal, q_off, k_off, qr0,
                                  qr1, k0 + 2 * t, Tk);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= (i % 4) < 2 ? cr0 : cr1;

      // acc += bf16(p) v: key step kk's A fragment is S's n8 tiles 2kk and
      // 2kk + 1 packed; ldmatrix.trans p is keys 16kk + 8 (m & 1) + 0..7,
      // head columns 16p + 8 (m >> 1) + 0..7: r[0], r[1] are head group
      // 2p's (b0, b1) and r[2], r[3] group 2p + 1's
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t pa[4] = {sm90::pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                                sm90::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                                sm90::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                                sm90::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
        uint32_t vf[kD / 16][4];
#pragma unroll
        for (int p = 0; p < kD / 16; ++p) {
          if (p < steps)
            ldmatrix_x4<true>(vf[p], vs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kLdB +
                                         16 * p + 8 * (lane >> 4));
        }
#pragma unroll
        for (int p = 0; p < kD / 16; ++p) {
          if (p < steps) {
            mma_bf16(acc + 8 * p, pa, vf[p][0], vf[p][1]);
            mma_bf16(acc + 8 * p + 4, pa, vf[p][2], vf[p][3]);
          }
        }
      }
    }
    if constexpr (kStaged) {
      // tile j + 1 into the stage tile j - 1 held, released at its barrier
      if (j + 1 < n_tiles) staged_store(stg, sm.k[(j + 1) % kRing], sm.v[(j + 1) % kRing], walk);
    }
    __syncthreads();  // every thread is done with the stage the next load fills
  }

  // epilogue: o = bf16(acc / l_safe) for rows qr0, qr1, columns 8n + 2t
  // and + 1 (a bf16 pair when D is even); lse from each quad's first lane
  const float ls0 = fmaxf(l0, kTiny), ls1 = fmaxf(l1, kTiny);
  bf16* ob = o + (int64_t)bh * Tq * D;
  const bool pairs = D % 2 == 0 && (reinterpret_cast<uintptr_t>(o) & 3) == 0;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? qr1 : qr0;
      const float ls = h ? ls1 : ls0;
      if (r >= Tq || c >= D) continue;
      const float x0 = acc[4 * n + 2 * h] / ls, x1 = acc[4 * n + 2 * h + 1] / ls;
      bf16* dst = ob + (int64_t)r * D + c;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (c + 1 < D) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
  if (t == 0) {
    if (qr0 < Tq) lse[(int64_t)bh * Tq + qr0] = m0 + logf(ls0);
    if (qr1 < Tq) lse[(int64_t)bh * Tq + qr1] = m1 + logf(ls1);
  }
}

int fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Tq,
             int Tk, int D, int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  if (D < 1 || D > kD) return (int)cudaErrorInvalidValue;
  const bool staged = D % 2 != 0 || ((reinterpret_cast<uintptr_t>(k) |
                                      reinterpret_cast<uintptr_t>(v)) & 3) != 0;
  const size_t smem = sizeof(SmemBf16);
  const dim3 grid(BH, (Tq + kRows - 1) / kRows);
  cudaError_t err;
  if (staged) {
    err = prepare(flash_fwd_mma_bf16_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma_bf16_kernel<true><<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, Tq, Tk, D, q_off,
        k_off, causal, scale);
  } else {
    err = prepare(flash_fwd_mma_bf16_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma_bf16_kernel<false><<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, Tq, Tk, D, q_off,
        k_off, causal, scale);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_dq_mma_bf16: the bf16 dq for heads with D % 8 != 0, on mma.sync bf16
// ---------------------------------------------------------------------------
//
// The same function as flash_dq_kernel<bf16> and flash_dq_plain: p = valid
// ? expf(s * scale - lse) : 0 with s = q.k (fp32 sums of exact bf16
// products, the scale after the dot); dp = dO.v; ds = bf16(p * (dp - dsum)
// * scale) (pallas_attention.py:195, the 2-D kernel's :296); dq += ds k in
// an fp32 accumulator; expf, -fmad=false. No rounding depends on the key
// tile, so only the order of the sums inside the products differs. It takes
// any 1 <= D <= 64; the route sends it the bf16 heads whose rows are not
// whole 16-byte units (D % 8 != 0), which flash_dq_sm90's tensor maps
// refuse.
//
// Block: flash_fwd_mma_bf16's, with one more product. One CTA of 256
// threads (8 warps) per (128-query tile, b*h), heaviest causal tiles
// first; a warp owns 16 query rows (one M). Q and dO are read once from
// device memory into registers as A fragments (32 registers at D 64), lse
// and dsum of the thread's two rows once. K/V tiles of 64 keys stream
// through the forward's two-stage ring: 4-byte cp.async copies for even D,
// register-staged loads for odd D (Staged, walked by adds), the head's
// columns from D to 64 zeroed once; two barriers a tile.
//
// Products per tile and warp, mma.sync m16n8k16 bf16 with fp32
// accumulators: S = Q K^T and dP = dO V^T, K's and V's B fragments by
// ldmatrix.x4 from the stage (the forward's K reads; rows 144 bytes apart,
// so each 8-address phase hits 8 distinct 16-byte bank groups). p on S's C
// fragments (sm90::tile_probs; masks only on tiles across the causal
// diagonal or the ragged key edge, a masked element selected to 0 without
// expf, so a blind row's sentinel lse never gives an inf). dS is rounded to
// bf16 straight from the C fragments: those of S's n8 tiles 2kk and 2kk + 1,
// packed, are the A fragment of key step kk of dQ += dS K (the layouts of
// the 16-bit m16n8k16 agree, as for the forward's P V), and K's B fragments
// for it come from the same stage by ldmatrix.x4.trans (the forward's V
// reads). dQ stays in fp32 registers and is stored once. Query rows past
// Tq read lse = dsum = 0 and zero Q and dO: p = 1, ds = 0, never stored.
//
// Registers: one CTA an SM. The cp.async build takes 235 (no spill), the
// staged one 255 with 8 bytes of stack and no slower at D 60; held to two
// CTAs an SM (128 registers) it spills 304 bytes and takes 27% longer
// (tools/bwd_mma_bf16_variants.py).
//
// Bound, at BH 96, T 1024, D 60, bf16, causal: 71.6 MB (q, k, v, dO in
// bf16; lse, dsum and dq in fp32; 21 us at 3.35 TB/s) against 18.1 GFLOP
// of bf16 products over the causal half (S, dP, dQ; 18 us at 989 TFLOP/s):
// the bytes bound it (chip_smoke.py phase times computes both).
//
// Not yet: wgmma from a cp.async ring (no tensor maps for these rows), a
// producer warp, the next tile's S and dP under this one's elementwise work
// (tools/bwd_mma_bf16_variants.py measures where the time goes).

constexpr int kDqMinBlocks = 1;  // resident CTAs an SM the registers are held to

template <bool kStaged>
__global__ void __launch_bounds__(kMmaThreads, kDqMinBlocks)
flash_dq_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         float* __restrict__ dq_out, int Tq, int Tk, int D, int q_off,
                         int k_off, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(dyn_smem);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % 4;  // the mma fragments' thread in group
  const int wq0 = q0 + (tid / 32) * kWarpRows;  // the warp's first query row
  const int qr0 = wq0 + lane / 4, qr1 = qr0 + 8;  // this thread's two rows
  const bf16* kb = k + (int64_t)bh * Tk * D;
  const bf16* vb = v + (int64_t)bh * Tk * D;
  const int nk = (Tk + kTile - 1) / kTile;
  const int n_tiles = sm90::k_tiles_seen(causal, min(q0 + kRows, Tq), q_off, k_off, nk);
  // the warp's own last tile (exclusive): it skips the CTA's later ones
  const int n_mine =
      wq0 < Tq ? sm90::k_tiles_seen(causal, min(wq0 + kWarpRows, Tq), q_off, k_off, nk) : 0;
  const int steps = (D + 15) / 16;  // 16-column steps of the head that hold data

  zero_pad_bf16(sm.k, sm.v, D);
  Staged stg;
  const Walk walk(kStaged ? D : D / 2);  // elements (staged) or 4-byte words a row
  if (n_tiles > 0) {
    if constexpr (kStaged) {
      staged_load(stg, kb, vb, 0, Tk, D, walk);
      staged_store(stg, sm.k[0], sm.v[0], walk);
    } else {
      load_kv_bf16(sm, kb, vb, 0, Tk, D, walk);
    }
  }

  // Q's and dO's A fragments (rows qr0, qr1); lse and dsum of the two rows
  uint32_t qfr[kD / 16][4], ofr[kD / 16][4];
  a_frags_bf16(qfr, q + (int64_t)bh * Tq * D, qr0, Tq, D);
  a_frags_bf16(ofr, d_o + (int64_t)bh * Tq * D, qr0, Tq, D);
  const float* lse_b = lse + (int64_t)bh * Tq;
  const float* dsum_b = dsum + (int64_t)bh * Tq;
  const float lse0 = qr0 < Tq ? __ldg(lse_b + qr0) : 0.0f;
  const float lse1 = qr1 < Tq ? __ldg(lse_b + qr1) : 0.0f;
  const float dsum0 = qr0 < Tq ? __ldg(dsum_b + qr0) : 0.0f;
  const float dsum1 = qr1 < Tq ? __ldg(dsum_b + qr1) : 0.0f;

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (kStaged) {
      if (j + 1 < n_tiles) staged_load(stg, kb, vb, (j + 1) * kTile, Tk, D, walk);
    } else if (j + 1 < n_tiles) {
      load_kv_bf16(sm, kb, vb, j + 1, Tk, D, walk);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile j has landed for every thread
    const bf16* ks = sm.k[j % kRing];
    const bf16* vs = sm.v[j % kRing];
    if (j < n_mine) {
      // s = q k^T and dp = dO v^T: s_acc[4n + e] (dp_acc's alike) is row
      // e < 2 ? qr0 : qr1, key 8n + 2t + e % 2; ldmatrix p of step kk reads
      // keys 16p + 8 (m >> 1) + 0..7, head columns 16kk + 8 (m & 1) + 0..7
      float s_acc[32], dp_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s_acc[i] = dp_acc[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if (kk < steps) {
          uint32_t kfr[kTile / 16][4], vfr[kTile / 16][4];
#pragma unroll
          for (int p = 0; p < kTile / 16; ++p) {
            const int at = (16 * p + 8 * (lane >> 4) + (lane & 7)) * kLdB + 16 * kk +
                           8 * ((lane >> 3) & 1);
            ldmatrix_x4<false>(kfr[p], ks + at);
            ldmatrix_x4<false>(vfr[p], vs + at);
          }
#pragma unroll
          for (int p = 0; p < kTile / 16; ++p) {
            mma_bf16(s_acc + 8 * p, qfr[kk], kfr[p][0], kfr[p][1]);
            mma_bf16(s_acc + 8 * p + 4, qfr[kk], kfr[p][2], kfr[p][3]);
          }
#pragma unroll
          for (int p = 0; p < kTile / 16; ++p) {
            mma_bf16(dp_acc + 8 * p, ofr[kk], vfr[p][0], vfr[p][1]);
            mma_bf16(dp_acc + 8 * p + 4, ofr[kk], vfr[p][2], vfr[p][3]);
          }
        }
      }

      const int k0 = j * kTile;
      if (k0 + kTile > Tk || (causal && k_off + k0 + kTile - 1 > q_off + wq0)) {
        sm90::tile_probs<true>(s_acc, lse0, lse1, scale, causal, q_off, k_off, qr0, qr1,
                               k0 + 2 * t, Tk);
      } else {
        sm90::tile_probs<false>(s_acc, lse0, lse1, scale, causal, q_off, k_off, qr0, qr1,
                                k0 + 2 * t, Tk);
      }

      // dq += bf16(ds) k: key step kk's A fragment is ds over S's n8 tiles
      // 2kk and 2kk + 1, packed (the pair 8kk + 2h is row qr0 for even h);
      // ldmatrix.trans p is keys 16kk + 8 (m & 1) + 0..7, head columns 16p +
      // 8 (m >> 1) + 0..7: r[0], r[1] are head group 2p's (b0, b1)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t dsa[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = 8 * kk + 2 * h;
          const float ds_sum = h % 2 ? dsum1 : dsum0;
          dsa[h] = sm90::pack_bf16(s_acc[r] * (dp_acc[r] - ds_sum) * scale,
                                   s_acc[r + 1] * (dp_acc[r + 1] - ds_sum) * scale);
        }
        uint32_t ktr[kD / 16][4];
#pragma unroll
        for (int p = 0; p < kD / 16; ++p) {
          if (p < steps)
            ldmatrix_x4<true>(ktr[p], ks + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kLdB +
                                          16 * p + 8 * (lane >> 4));
        }
#pragma unroll
        for (int p = 0; p < kD / 16; ++p) {
          if (p < steps) {
            mma_bf16(dq_acc + 8 * p, dsa, ktr[p][0], ktr[p][1]);
            mma_bf16(dq_acc + 8 * p + 4, dsa, ktr[p][2], ktr[p][3]);
          }
        }
      }
    }
    if constexpr (kStaged) {
      // tile j + 1 into the stage tile j - 1 held, released at its barrier
      if (j + 1 < n_tiles) staged_store(stg, sm.k[(j + 1) % kRing], sm.v[(j + 1) % kRing], walk);
    }
    __syncthreads();  // every thread is done with the stage the next load fills
  }

  // epilogue: rows qr0, qr1, columns 8n + 2t and + 1 (a float2 when D is even)
  float* dq_b = dq_out + (int64_t)bh * Tq * D;
  const bool pairs = D % 2 == 0 && (reinterpret_cast<uintptr_t>(dq_out) & 7) == 0;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? qr1 : qr0;
      if (r >= Tq || c >= D) continue;
      const float x0 = dq_acc[4 * n + 2 * h], x1 = dq_acc[4 * n + 2 * h + 1];
      float* dst = dq_b + (int64_t)r * D + c;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        if (c + 1 < D) dst[1] = x1;
      }
    }
  }
}

int dq_bf16(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
            const void* dsum, void* dq_out, int BH, int Tq, int Tk, int D, int q_off, int k_off,
            int causal, float scale, cudaStream_t stream) {
  if (D < 1 || D > kD) return (int)cudaErrorInvalidValue;
  // 4-byte copies need rows of whole words: D even, k and v 4-byte aligned
  const bool dq_words = D % 2 == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                        reinterpret_cast<uintptr_t>(v)) & 3) == 0;
  const size_t smem = sizeof(SmemBf16);
  const dim3 grid(BH, (Tq + kRows - 1) / kRows);
  cudaError_t err;
  if (dq_words) {
    err = prepare(flash_dq_mma_bf16_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dq_mma_bf16_kernel<false><<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)dsum, (float*)dq_out, Tq, Tk, D, q_off, k_off, causal, scale);
  } else {
    err = prepare(flash_dq_mma_bf16_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dq_mma_bf16_kernel<true><<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)dsum, (float*)dq_out, Tq, Tk, D, q_off, k_off, causal, scale);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_dkv_mma_bf16: the bf16 dk/dv for heads with D % 8 != 0, on mma.sync bf16
// ---------------------------------------------------------------------------
//
// The same function as flash_dkv_kernel<bf16> and flash_dkv_plain: p =
// valid ? expf(s * scale - lse) : 0 with s = q.k; dp = dO.v; ds = bf16(p *
// (dp - dsum) * scale) (pallas_attention.py:235, the 2-D kernel's :338);
// dk += ds^T q; dv += p^T f32(dO) with p not rounded (the reference upcasts
// dO, pallas_attention.py:218). dv runs as flash_dkv_sm90 runs it: p = hi +
// mid + lo in bf16, exactly (sm90::split_bf16; the plain split_bf16x3), and
// three exact bf16 products with dO summed in fp32. Two parts, or bf16(p),
// fail phase flash's dv limit (chip_smoke.py bf16_dv_control). It takes any
// 1 <= D <= 64; the route sends it the bf16 heads with D % 8 != 0.
//
// Block: one CTA of 256 threads (8 warps) per (128-key tile, b*h), key
// tiles heaviest first (blockIdx.y: in a causal launch the lowest keys see
// the most queries). Warp w owns keys 16w + 0..15 (one M) and every query
// of each 64-query tile. K and V are read once from device memory into
// registers as A fragments (32 registers at D 64); dK and dV stay in fp32
// registers (64) and are stored once. The shape: 128 keys on 8 warps, not
// flash_dkv_mma's 64 keys with each warp half of a query tile, because the
// registers fit at one CTA an SM (K, V, dK, dV, and S^T and dP^T of a
// kQSub-query step: 160 at kQSub 64; p's three parts are formed 16 queries
// at a time, 12 more; 252 in all with the cp.async loads, no spill), each
// Q/dO tile is staged once for 128 keys instead of 64, and no partial dK
// and dV are added at the end. With the register-staged loads (odd D) the
// queries go in steps of 16 (kQSubStaged; 246 registers, no spill): at 64
// the staging registers spilled 144 bytes a thread and cost 9% more time
// (tools/bwd_mma_bf16_variants.py).
//
// Transposed products (flash_dkv_sm90's): S^T = K Q^T and dP^T = V dO^T put
// keys on the C fragments' rows, Q's and dO's B fragments by ldmatrix.x4 of
// their rows (the forward's K reads). p^T and dS^T are formed on the C
// fragments in place; then, 16 queries at a time, the C fragments of n8
// tiles 2qk and 2qk + 1 are the A fragments as they stand (in bf16 the
// m16n8 C layout is the m16k16 A layout, so no query permutation is needed,
// unlike the tf32 kernels): p's lo, mid and hi parts for dV += (lo + mid +
// hi)^T dO (three products, small parts first) and dS packed for dK +=
// dS^T Q, with dO's and Q's B fragments by ldmatrix.x4.trans (the forward's
// V reads).
//
// Loads: Q/dO tiles of 64 queries from q_tile_start (_q_block_start)
// through a two-stage ring: 4-byte cp.async copies for even D, the
// register-staged loads for odd D; the tile's lse and dsum beside them by
// 4-byte cp.async, read from shared memory per element. Rows past Tq come
// in as zeros; the head's columns from D to 64 are zeroed once. Two
// barriers a tile.
//
// Masks: only on a warp's blocks that cross the causal diagonal or the
// ragged query edge. A query past Tq is masked explicitly: its zero q gives
// s = 0 and its lse reads 0, so p would be 1, not 0. A masked element is
// selected to 0 after expf, never multiplied by a 0/1 mask, so a blind
// query's sentinel lse (<= -1e29: exp overflows) never reaches a product.
// Keys past Tk compute rows that are never stored. A warp skips the query
// tiles wholly above its keys.
//
// Bound, at BH 96, T 1024, D 60, bf16, causal: 95.2 MB (28 us at 3.35
// TB/s) against 36.3 GFLOP of bf16 products over the causal half (S, dP,
// dK, and dV as three: 37 us at 989 TFLOP/s): the operations bound it.
//
// Not yet: wgmma, a producer warp, one query step's products under the
// other's elementwise work (tools/bwd_mma_bf16_variants.py measures where
// the time goes).

constexpr int kKeysBf16 = 128;  // keys of a flash_dkv_mma_bf16 CTA: 16 a warp
// queries of a step whose S^T and dP^T are held in registers: 64 with the
// cp.async loads; 16 with the register-staged ones, whose 32 staging
// registers spill 144 bytes a thread at 64 and 24 at 32
constexpr int kQSubCopies = 64;
constexpr int kQSubStaged = 16;
static_assert(kKeysBf16 == (kMmaThreads / 32) * 16, "a warp owns 16 keys");
static_assert(kTile % kQSubCopies == 0 && kQSubCopies % 16 == 0 && kTile % kQSubStaged == 0 &&
                  kQSubStaged % 16 == 0,
              "query steps of whole 16-query slices");

struct DkvSmemBf16 {
  bf16 q[kRing][kTile * kLdB];
  bf16 d_o[kRing][kTile * kLdB];
  float lse[kRing][kTile];
  float dsum[kRing][kTile];
};

// the Q/dO tile at row0 into ring stage s as one cp.async group: Q and dO
// by 4-byte copies unless kStaged (the caller stores the staged rows), the
// tile's lse and dsum by 4-byte copies; rows past Tq as zeros
template <bool kStaged>
__device__ __forceinline__ void load_qdo_bf16(DkvSmemBf16& sm, const bf16* qb, const bf16* dob,
                                              const float* lse_b, const float* dsum_b, int s,
                                              int row0, int Tq, int D, const Walk& w) {
  if constexpr (!kStaged) pair_async_bf16(sm.q[s], sm.d_o[s], qb, dob, row0, Tq, D, w);
  if (threadIdx.x < 2 * kTile) {
    const int r = threadIdx.x % kTile;
    const bool in = row0 + r < Tq;
    const bool first = threadIdx.x < kTile;  // lse; the second 64 threads copy dsum
    float* dst = (first ? sm.lse[s] : sm.dsum[s]) + r;
    cp_async<4>(dst, (first ? lse_b : dsum_b) + (in ? row0 + r : 0), in);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <bool kStaged>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_dkv_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          float* __restrict__ dk_out, float* __restrict__ dv_out, int Tq,
                          int Tk, int D, int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  DkvSmemBf16& sm = *reinterpret_cast<DkvSmemBf16*>(dyn_smem);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeysBf16;  // heaviest causal key tiles first
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % 4;  // the mma fragments' thread in group
  const int wk0 = k0 + (tid / 32) * 16;  // the warp's first key
  const int kr0 = wk0 + lane / 4, kr1 = kr0 + 8;  // this thread's two keys
  const bf16* qb = q + (int64_t)bh * Tq * D;
  const bf16* dob = d_o + (int64_t)bh * Tq * D;
  const float* lse_b = lse + (int64_t)bh * Tq;
  const float* dsum_b = dsum + (int64_t)bh * Tq;
  const int nq = (Tq + kTile - 1) / kTile;
  const int i0 = q_tile_start(causal, k0, q_off, k_off);
  const int n_tiles = max(nq - i0, 0);
  // the warp's own first tile: a later warp skips the tiles of the causal
  // diagonal that lie wholly above its keys (and a warp past Tk every tile)
  const int i_mine = wk0 < Tk ? q_tile_start(causal, wk0, q_off, k_off) : nq;
  const int steps = (D + 15) / 16;  // 16-column steps of the head that hold data
  constexpr int kQSub = kStaged ? kQSubStaged : kQSubCopies;

  zero_pad_bf16(sm.q, sm.d_o, D);
  Staged stg;
  const Walk walk(kStaged ? D : D / 2);  // elements (staged) or 4-byte words a row
  if (n_tiles > 0) {
    if constexpr (kStaged) {
      staged_load(stg, qb, dob, i0 * kTile, Tq, D, walk);
      staged_store(stg, sm.q[0], sm.d_o[0], walk);
    }
    load_qdo_bf16<kStaged>(sm, qb, dob, lse_b, dsum_b, 0, i0 * kTile, Tq, D, walk);
  }

  // K's and V's A fragments (keys kr0, kr1)
  uint32_t kfr[kD / 16][4], vfr[kD / 16][4];
  a_frags_bf16(kfr, k + (int64_t)bh * Tk * D, kr0, Tk, D);
  a_frags_bf16(vfr, v + (int64_t)bh * Tk * D, kr0, Tk, D);

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = (i0 + j) * kTile;
    if (j + 1 < n_tiles) {
      if constexpr (kStaged) staged_load(stg, qb, dob, q0 + kTile, Tq, D, walk);
      load_qdo_bf16<kStaged>(sm, qb, dob, lse_b, dsum_b, (j + 1) % kRing, q0 + kTile, Tq, D,
                             walk);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile j has landed for every thread
    const bf16* qs = sm.q[j % kRing];
    const bf16* os = sm.d_o[j % kRing];
    const float* lse_s = sm.lse[j % kRing];
    const float* dsum_s = sm.dsum[j % kRing];
    if (i0 + j >= i_mine) {
      const bool masked = q0 + kTile > Tq || (causal && q_off + q0 < k_off + wk0 + 15);
#pragma unroll
      for (int qh = 0; qh < kTile; qh += kQSub) {
        // s^T = k q^T and dp^T = v dO^T: st[4n + e] (dpt's alike) is key
        // e < 2 ? kr0 : kr1, query qh + 8n + 2t + e % 2 of the tile
        float st[kQSub / 2], dpt[kQSub / 2];
#pragma unroll
        for (int i = 0; i < kQSub / 2; ++i) st[i] = dpt[i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          if (kk < steps) {
            uint32_t qrow[kQSub / 16][4], orow[kQSub / 16][4];
#pragma unroll
            for (int p = 0; p < kQSub / 16; ++p) {
              const int at = (qh + 16 * p + 8 * (lane >> 4) + (lane & 7)) * kLdB + 16 * kk +
                             8 * ((lane >> 3) & 1);
              ldmatrix_x4<false>(qrow[p], qs + at);
              ldmatrix_x4<false>(orow[p], os + at);
            }
#pragma unroll
            for (int p = 0; p < kQSub / 16; ++p) {
              mma_bf16(st + 8 * p, kfr[kk], qrow[p][0], qrow[p][1]);
              mma_bf16(st + 8 * p + 4, kfr[kk], qrow[p][2], qrow[p][3]);
            }
#pragma unroll
            for (int p = 0; p < kQSub / 16; ++p) {
              mma_bf16(dpt + 8 * p, vfr[kk], orow[p][0], orow[p][1]);
              mma_bf16(dpt + 8 * p + 4, vfr[kk], orow[p][2], orow[p][3]);
            }
          }
        }

        // p^T and ds^T (not yet rounded) on the accumulators, in place
#pragma unroll
        for (int r = 0; r < kQSub / 2; ++r) {
          const int c = qh + 8 * (r / 4) + 2 * t + r % 2;  // the query's row in the tile
          float p = expf(st[r] * scale - lse_s[c]);
          if (masked &&
              !(q0 + c < Tq && visible(causal, q_off, k_off, q0 + c, (r % 4) < 2 ? kr0 : kr1, Tk)))
            p = 0.0f;
          st[r] = p;
          dpt[r] = p * (dpt[r] - dsum_s[c]) * scale;
        }

        // dv += (lo + mid + hi)^T dO and dk += bf16(ds)^T q over 16-query
        // slices: slice qk's A fragments are the C fragments of n8 tiles 2qk
        // and 2qk + 1 (the pair 8qk + 2h is key kr0 for even h);
        // ldmatrix.trans p is queries 16qk + 8 (m & 1) + 0..7 of the step,
        // head columns 16p + 8 (m >> 1) + 0..7: r[0], r[1] are head group
        // 2p's (b0, b1)
#pragma unroll
        for (int qk = 0; qk < kQSub / 16; ++qk) {
          uint32_t hi[4], mid[4], lo[4], dsa[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int r = 8 * qk + 2 * h;
            float x0 = st[r], x1 = st[r + 1];
            hi[h] = sm90::split_bf16(x0, x1);
            mid[h] = sm90::split_bf16(x0, x1);
            lo[h] = sm90::split_bf16(x0, x1);
            dsa[h] = sm90::pack_bf16(dpt[r], dpt[r + 1]);
          }
          const int row = (qh + 16 * qk + 8 * ((lane >> 3) & 1) + (lane & 7)) * kLdB +
                          8 * (lane >> 4);
          uint32_t bt[kD / 16][4];
#pragma unroll
          for (int p = 0; p < kD / 16; ++p) {
            if (p < steps) ldmatrix_x4<true>(bt[p], os + row + 16 * p);
          }
#pragma unroll
          for (int p = 0; p < kD / 16; ++p) {
            if (p < steps) {
              mma_bf16(dv_acc + 8 * p, lo, bt[p][0], bt[p][1]);
              mma_bf16(dv_acc + 8 * p + 4, lo, bt[p][2], bt[p][3]);
            }
          }
#pragma unroll
          for (int p = 0; p < kD / 16; ++p) {
            if (p < steps) {
              mma_bf16(dv_acc + 8 * p, mid, bt[p][0], bt[p][1]);
              mma_bf16(dv_acc + 8 * p + 4, mid, bt[p][2], bt[p][3]);
            }
          }
#pragma unroll
          for (int p = 0; p < kD / 16; ++p) {
            if (p < steps) {
              mma_bf16(dv_acc + 8 * p, hi, bt[p][0], bt[p][1]);
              mma_bf16(dv_acc + 8 * p + 4, hi, bt[p][2], bt[p][3]);
            }
          }
#pragma unroll
          for (int p = 0; p < kD / 16; ++p) {
            if (p < steps) ldmatrix_x4<true>(bt[p], qs + row + 16 * p);
          }
#pragma unroll
          for (int p = 0; p < kD / 16; ++p) {
            if (p < steps) {
              mma_bf16(dk_acc + 8 * p, dsa, bt[p][0], bt[p][1]);
              mma_bf16(dk_acc + 8 * p + 4, dsa, bt[p][2], bt[p][3]);
            }
          }
        }
      }
    }
    if constexpr (kStaged) {
      // tile j + 1 into the stage tile j - 1 held, released at its barrier
      if (j + 1 < n_tiles) staged_store(stg, sm.q[(j + 1) % kRing], sm.d_o[(j + 1) % kRing], walk);
    }
    __syncthreads();  // every thread is done with the stage the next load fills
  }

  // epilogue: rows kr0, kr1, columns 8n + 2t and + 1 (a float2 when D is even)
  float* dk_b = dk_out + (int64_t)bh * Tk * D;
  float* dv_b = dv_out + (int64_t)bh * Tk * D;
  const bool pairs = D % 2 == 0 && ((reinterpret_cast<uintptr_t>(dk_out) |
                                     reinterpret_cast<uintptr_t>(dv_out)) & 7) == 0;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = h ? kr1 : kr0;
      const int i = 4 * n + 2 * h;
      if (kr >= Tk || c >= D) continue;
      const int64_t at = (int64_t)kr * D + c;
      if (pairs) {
        *reinterpret_cast<float2*>(dk_b + at) = make_float2(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<float2*>(dv_b + at) = make_float2(dv_acc[i], dv_acc[i + 1]);
      } else {
        dk_b[at] = dk_acc[i];
        dv_b[at] = dv_acc[i];
        if (c + 1 < D) {
          dk_b[at + 1] = dk_acc[i + 1];
          dv_b[at + 1] = dv_acc[i + 1];
        }
      }
    }
  }
}

int dkv_bf16(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
             const void* dsum, void* dk_out, void* dv_out, int BH, int Tq, int Tk, int D,
             int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  if (D < 1 || D > kD) return (int)cudaErrorInvalidValue;
  // 4-byte copies need rows of whole words: D even, q and dO 4-byte aligned
  const bool dkv_words = D % 2 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                         reinterpret_cast<uintptr_t>(d_o)) & 3) == 0;
  const size_t smem = sizeof(DkvSmemBf16);
  const dim3 grid(BH, (Tk + kKeysBf16 - 1) / kKeysBf16);
  cudaError_t err;
  if (dkv_words) {
    err = prepare(flash_dkv_mma_bf16_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_mma_bf16_kernel<false><<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)dsum, (float*)dk_out, (float*)dv_out, Tq, Tk, D, q_off, k_off, causal,
        scale);
  } else {
    err = prepare(flash_dkv_mma_bf16_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_mma_bf16_kernel<true><<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)dsum, (float*)dk_out, (float*)dv_out, Tq, Tk, D, q_off, k_off, causal,
        scale);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_dkv_mma: the fp32 dk/dv backward for Hopper, on mma.sync tf32 (3xTF32)
// ---------------------------------------------------------------------------
//
// The same function as flash_dkv_kernel<float> and flash_dkv_plain: p =
// valid ? expf(s * scale - lse) : 0 with s = q.k; dp = dO.v; ds = p * (dp -
// dsum) * scale in fp32; dv += p^T dO with p not rounded and dO fp32 (the
// reference upcasts it, pallas_attention.py:218); dk += ds^T q. All four
// products run as three tf32 products each on the tensor cores (3xTF32,
// flash_fwd_mma's split_tf32: lo hi + hi lo + hi hi, the small terms
// first), about 2^-22 of |a b| left out, so the kernel is held to phase
// flash's fp32 dk/dv limit, not to bits. No rounding depends on the tiling.
// It serves #9 and #11 (one kernel streams every T) for fp32 at any D <= 64.
//
// Block: one CTA of 256 threads (8 warps) per (64-key tile, b*h), key tiles
// heaviest first (blockIdx.y; in a causal launch the lowest keys see the
// most queries). Warp w owns keys 16 (w % 4) + 0..15 (one M of the mma) and
// the query half w / 4 (32 queries) of each 64-query tile; the two warps of
// a key row add their partial dk and dv through shared memory at the end,
// in a fixed order. Registers: dk and dv accumulators (32 each), S^T and
// dP^T of the warp's 16 x 32 (16 each). K's and V's tf32 splits (128
// registers as A fragments) stay in shared memory: with them in registers a
// thread would need more than its 255.
//
// Transposed products (flash_dkv_sm90's): S^T = K Q^T and dP^T = V dO^T put
// keys on the C fragments' rows, so P^T and dS^T are the A operands of dV +=
// P^T dO and dK += dS^T Q. With the queries of each 8-query step taken in
// flash_fwd_mma's permuted order (logical t is query 2t, t + 4 is 2t + 1),
// those C fragments are the A fragments as they stand (a0 = c0, a1 = c2, a2
// = c1, a3 = c3), and the B fragments are (2t, 2t + 1) pairs of Q^T's and
// dO^T's rows. S^T and dP^T contract over the head in its natural order:
// A's (column t, t + 4) from K's and V's rows, B's (row t, t + 4) from Q^T
// and dO^T.
//
// Loads and splits: K and V (64 keys) are read once, split into tf32 hi and
// lo and kept as rows of 68 floats (A reads: banks 4g + t). Q and dO tiles
// of 64 queries go through a two-stage cp.async ring (16-byte copies when D
// % 4 == 0 and q, dO are 16-byte aligned, else 4-byte ones; rows past Tq
// zero-filled, the columns from D to 64 zeroed once), tile j + 1 in flight
// while tile j is computed. Once tile j lands the CTA splits it, transposed,
// into Q^T and dO^T hi and lo (a row per head column, 72 floats: the B reads
// hit 32 distinct banks). Three barriers a tile: landed, split, read. lse
// and dsum are read per tile for the thread's 8 query columns before the
// tile's wait.
//
// Masks: only on a warp's blocks that cross the causal diagonal or the
// ragged query edge; a query past Tq is masked explicitly (zero-filled q and
// dO would give p = exp(-lse), not 0). Keys past Tk compute garbage rows
// that are never stored. Query tiles start at q_tile_start (_q_block_start);
// a warp skips the products of a block wholly above its keys.
//
// Bound, at the 136M LM's shape in fp32 (BH 96, T 1024, D 64, causal):
// 152.6 MB (46 us at 3.35 TB/s); 12.9 GFLOP of products as fp32 FMAs (193
// us at 67 TFLOP/s), 77.4 GFLOP as 3xTF32 (156 us at the 494.7 TFLOP/s dense
// tf32 rate): the tensor cores' share bounds it.
//
// Not yet: wgmma (tf32 wgmma takes K-major operands only), a producer warp,
// the split of a Q/dO tile shared by the CTAs of neighbouring key tiles.

constexpr int kKeyWarps = 4;    // warps across a CTA's 64 keys, 16 each
constexpr int kHalfQ = 32;      // queries of a 64-query tile that one warp takes
constexpr int kLdS = kD + 4;    // floats between K, V and ring rows
constexpr int kLdT = kD + 8;    // floats between Q^T and dO^T rows (64 queries + 8)
static_assert(kKeyWarps * 16 == kTile && (kMmaThreads / 32 / kKeyWarps) * kHalfQ == kTile,
              "8 warps cover a 64-key x 64-query block");

struct DkvSmem {
  float k_hi[kTile * kLdS];
  float k_lo[kTile * kLdS];
  float v_hi[kTile * kLdS];
  float v_lo[kTile * kLdS];
  float q[kRing][kTile * kLdS];    // raw tiles; the partial dk, dv at the end
  float d_o[kRing][kTile * kLdS];
  float qt_hi[kD * kLdT];
  float qt_lo[kD * kLdT];
  float dot_hi[kD * kLdT];
  float dot_lo[kD * kLdT];
};
static_assert(kKeyWarps * 64 * 32 <= kRing * kTile * kLdS, "the partials fit the ring's q");

// Q/dO tile `row0` (64 queries) into ring stage s
__device__ __forceinline__ void load_qdo_async(DkvSmem& sm, const float* qb, const float* dob,
                                               int s, int row0, int Tq, int D, bool vec) {
  tile_async<kLdS>(sm.q[s], qb, row0, Tq, D, vec);
  tile_async<kLdS>(sm.d_o[s], dob, row0, Tq, D, vec);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// the ring's Q and dO tiles -> Q^T and dO^T, tf32 hi and lo. A thread
// loads all its float4s before it splits and stores any; consecutive lanes
// take consecutive rows of one column group (ring rows 68 floats apart:
// conflict-free float4 reads; transposed 4-byte stores to 32 banks).
__device__ __forceinline__ void split_qdo_t(DkvSmem& sm, const float* qs, const float* ds) {
  constexpr int kPer = kTile * kD / 4 / kMmaThreads;  // float4s a thread, each of Q and dO
  float4 xq[kPer], xd[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    xq[j] = *reinterpret_cast<const float4*>(qs + (i % kTile) * kLdS + (i / kTile) * 4);
    xd[j] = *reinterpret_cast<const float4*>(ds + (i % kTile) * kLdS + (i / kTile) * 4);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int r = i % kTile, c = (i / kTile) * 4;
    const float a[4] = {xq[j].x, xq[j].y, xq[j].z, xq[j].w};
    const float b[4] = {xd[j].x, xd[j].y, xd[j].z, xd[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split_tf32(a[e], h, l);
      sm.qt_hi[(c + e) * kLdT + r] = __uint_as_float(h);
      sm.qt_lo[(c + e) * kLdT + r] = __uint_as_float(l);
      split_tf32(b[e], h, l);
      sm.dot_hi[(c + e) * kLdT + r] = __uint_as_float(h);
      sm.dot_lo[(c + e) * kLdT + r] = __uint_as_float(l);
    }
  }
}

// an A fragment's hi and lo parts at head columns (t, t + 4) of rows (g,
// g + 8): `at` is row g's column t in the split rows
__device__ __forceinline__ void a_parts(const float* hi, const float* lo, int at,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  constexpr int kDown = 8 * kLdS;  // row g + 8
  ah[0] = __float_as_uint(hi[at]);
  ah[1] = __float_as_uint(hi[at + kDown]);
  ah[2] = __float_as_uint(hi[at + 4]);
  ah[3] = __float_as_uint(hi[at + kDown + 4]);
  al[0] = __float_as_uint(lo[at]);
  al[1] = __float_as_uint(lo[at + kDown]);
  al[2] = __float_as_uint(lo[at + 4]);
  al[3] = __float_as_uint(lo[at + kDown + 4]);
}

__global__ void __launch_bounds__(kMmaThreads, 1)
flash_dkv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ d_o,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     float* __restrict__ dk_out, float* __restrict__ dv_out, int Tq, int Tk,
                     int D, int q_off, int k_off, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(dyn_smem);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // heaviest causal key tiles first
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread in group
  const int wk = (tid / 32) % kKeyWarps;  // the warp's 16 keys
  const int qh = (tid / 32) / kKeyWarps;  // and its half of each query tile
  const int wk0 = k0 + 16 * wk;
  const int kr0 = wk0 + g, kr1 = kr0 + 8;  // this thread's two keys
  const float* qb = q + (int64_t)bh * Tq * D;
  const float* dob = d_o + (int64_t)bh * Tq * D;
  const float* lse_b = lse + (int64_t)bh * Tq;
  const float* dsum_b = dsum + (int64_t)bh * Tq;
  const bool vec = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                   reinterpret_cast<uintptr_t>(d_o)) & 15) == 0;
  const int nq = (Tq + kTile - 1) / kTile;
  const int i0 = q_tile_start(causal, k0, q_off, k_off);
  const int n_tiles = max(nq - i0, 0);
  const int steps = (D + 7) / 8;  // 8-column steps of the head that hold data

  if (n_tiles > 0) load_qdo_async(sm, qb, dob, 0, i0 * kTile, Tq, D, vec);
  // the ring's head padding, never written by the copies
  const int pad = kD - D;
  for (int i = tid; i < kRing * kTile * pad; i += kMmaThreads) {
    const int s = i / (kTile * pad);
    const int r = (i / pad) % kTile, c = D + i % pad;
    sm.q[s][r * kLdS + c] = 0.0f;
    sm.d_o[s][r * kLdS + c] = 0.0f;
  }
  // K and V of the CTA's keys, split once; zero past Tk and D
  const float* kb = k + (int64_t)bh * Tk * D;
  const float* vb = v + (int64_t)bh * Tk * D;
  for (int i = tid; i < kTile * kD; i += kMmaThreads) {
    const int r = i / kD, c = i % kD;
    const bool in = k0 + r < Tk && c < D;
    const int64_t at = (int64_t)(k0 + r) * D + c;
    uint32_t h, l;
    split_tf32(in ? kb[at] : 0.0f, h, l);
    sm.k_hi[r * kLdS + c] = __uint_as_float(h);
    sm.k_lo[r * kLdS + c] = __uint_as_float(l);
    split_tf32(in ? vb[at] : 0.0f, h, l);
    sm.v_hi[r * kLdS + c] = __uint_as_float(h);
    sm.v_lo[r * kLdS + c] = __uint_as_float(l);
  }

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  const int arow = 16 * wk * kLdS + g * kLdS + t;  // A's row g, column t in the split rows
  const int qcol = kHalfQ * qh;  // the warp's first column of Q^T and dO^T

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = (i0 + j) * kTile;
    if (j + 1 < n_tiles) {
      load_qdo_async(sm, qb, dob, (j + 1) % kRing, q0 + kTile, Tq, D, vec);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    const int qs = q0 + qcol;  // the warp's first query
    // lse and dsum of this thread's query columns qs + 8n + 2t + e: [2n + e]
    float lse_c[8], dsum_c[8];
#pragma unroll
    for (int n = 0; n < kHalfQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = qs + 8 * n + 2 * t + e;
        lse_c[2 * n + e] = c < Tq ? __ldg(lse_b + c) : 0.0f;
        dsum_c[2 * n + e] = c < Tq ? __ldg(dsum_b + c) : 0.0f;
      }
    }
    __syncthreads();  // tile j has landed for every thread (and K, V are split)
    split_qdo_t(sm, sm.q[j % kRing], sm.d_o[j % kRing]);
    __syncthreads();  // Q^T and dO^T are whole
    const bool active = wk0 < Tk && qs < Tq && (!causal || q_off + qs + kHalfQ - 1 >= k_off + wk0);
    if (active) {
      // s^T = k q^T and dp^T = v dO^T: st[4n + e] is key e < 2 ? kr0 : kr1,
      // query qs + 8n + 2t + e % 2. Each 8-column head step issues the 8
      // independent products (4 query groups of each) back to back, one of
      // the three terms at a time.
      float st[16], dpt[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.0f;
#pragma unroll
      for (int hs = 0; hs < kD / 8; ++hs) {
        if (hs < steps) {
          uint32_t kah[4], kal[4], vah[4], val[4];
          a_parts(sm.k_hi, sm.k_lo, arow + 8 * hs, kah, kal);
          a_parts(sm.v_hi, sm.v_lo, arow + 8 * hs, vah, val);
          uint32_t qbh[kHalfQ / 8][2], qbl[kHalfQ / 8][2], obh[kHalfQ / 8][2], obl[kHalfQ / 8][2];
#pragma unroll
          for (int n = 0; n < kHalfQ / 8; ++n) {
            const int at = (8 * hs + t) * kLdT + qcol + 8 * n + g;
            qbh[n][0] = __float_as_uint(sm.qt_hi[at]);
            qbh[n][1] = __float_as_uint(sm.qt_hi[at + 4 * kLdT]);
            qbl[n][0] = __float_as_uint(sm.qt_lo[at]);
            qbl[n][1] = __float_as_uint(sm.qt_lo[at + 4 * kLdT]);
            obh[n][0] = __float_as_uint(sm.dot_hi[at]);
            obh[n][1] = __float_as_uint(sm.dot_hi[at + 4 * kLdT]);
            obl[n][0] = __float_as_uint(sm.dot_lo[at]);
            obl[n][1] = __float_as_uint(sm.dot_lo[at + 4 * kLdT]);
          }
#pragma unroll
          for (int n = 0; n < kHalfQ / 8; ++n) {
            mma_tf32(st + 4 * n, kal, qbh[n][0], qbh[n][1]);
            mma_tf32(dpt + 4 * n, val, obh[n][0], obh[n][1]);
          }
#pragma unroll
          for (int n = 0; n < kHalfQ / 8; ++n) {
            mma_tf32(st + 4 * n, kah, qbl[n][0], qbl[n][1]);
            mma_tf32(dpt + 4 * n, vah, obl[n][0], obl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < kHalfQ / 8; ++n) {
            mma_tf32(st + 4 * n, kah, qbh[n][0], qbh[n][1]);
            mma_tf32(dpt + 4 * n, vah, obh[n][0], obh[n][1]);
          }
        }
      }

      // p and ds on the accumulators, in place; masks only on a block
      // across the diagonal or the ragged query edge
      const bool edge = qs + kHalfQ > Tq || (causal && q_off + qs < k_off + wk0 + 15);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int c = 2 * (r / 4) + r % 2;
        float pr = expf(st[r] * scale - lse_c[c]);
        if (edge) {
          const int qc = qs + 8 * (r / 4) + 2 * t + r % 2;
          if (!(qc < Tq && visible(causal, q_off, k_off, qc, (r % 4) < 2 ? kr0 : kr1, Tk)))
            pr = 0.0f;
        }
        st[r] = pr;
        dpt[r] = pr * (dpt[r] - dsum_c[c]) * scale;
      }

      // dv += p^T dO and dk += ds^T q over the warp's 4 query steps: step
      // qs8's A fragment is the C fragment of its query group (a0 = c0, a1 =
      // c2, a2 = c1, a3 = c3: query 2t is logical column t); B takes dO^T's
      // and Q^T's row 8n + g at queries 8 qs8 + 2t and + 1
#pragma unroll
      for (int qs8 = 0; qs8 < kHalfQ / 8; ++qs8) {
        uint32_t pah[4], pal[4], dah[4], dal[4];
        split_tf32(st[4 * qs8], pah[0], pal[0]);
        split_tf32(st[4 * qs8 + 2], pah[1], pal[1]);
        split_tf32(st[4 * qs8 + 1], pah[2], pal[2]);
        split_tf32(st[4 * qs8 + 3], pah[3], pal[3]);
        split_tf32(dpt[4 * qs8], dah[0], dal[0]);
        split_tf32(dpt[4 * qs8 + 2], dah[1], dal[1]);
        split_tf32(dpt[4 * qs8 + 1], dah[2], dal[2]);
        split_tf32(dpt[4 * qs8 + 3], dah[3], dal[3]);
        uint32_t bfh[kD / 8][2], bfl[kD / 8][2];
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps)
            b_parts(sm.dot_hi, sm.dot_lo, (8 * n + g) * kLdT + qcol + 8 * qs8 + 2 * t, bfh[n],
                    bfl[n]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dv + 4 * n, pal, bfh[n][0], bfh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dv + 4 * n, pah, bfl[n][0], bfl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dv + 4 * n, pah, bfh[n][0], bfh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps)
            b_parts(sm.qt_hi, sm.qt_lo, (8 * n + g) * kLdT + qcol + 8 * qs8 + 2 * t, bfh[n],
                    bfl[n]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dk + 4 * n, dal, bfh[n][0], bfh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dk + 4 * n, dah, bfl[n][0], bfl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dk + 4 * n, dah, bfh[n][0], bfh[n][1]);
        }
      }
    }
    __syncthreads();  // every thread is done with Q^T, dO^T and the stage tile j + 2 fills
  }

  // the second query half's warps hand their partial dk, dv to the first
  // half's through the ring (free after the last tile's barrier), in
  // fragment order; the first half adds them and stores rows kr0, kr1,
  // columns 8n + 2t and + 1
  float* part = sm.q[0] + wk * 64 * 32;
  if (qh == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      part[i * 32 + lane] = dk[i];
      part[(32 + i) * 32 + lane] = dv[i];
    }
  }
  __syncthreads();
  if (qh == 1) return;
  float* dk_b = dk_out + (int64_t)bh * Tk * D;
  float* dv_b = dv_out + (int64_t)bh * Tk * D;
  const bool pairs = D % 2 == 0 && ((reinterpret_cast<uintptr_t>(dk_out) |
                                     reinterpret_cast<uintptr_t>(dv_out)) & 7) == 0;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = h ? kr1 : kr0;
      const int i = 4 * n + 2 * h;
      if (kr >= Tk || c >= D) continue;
      const float k0v = dk[i] + part[i * 32 + lane], k1v = dk[i + 1] + part[(i + 1) * 32 + lane];
      const float v0v = dv[i] + part[(32 + i) * 32 + lane];
      const float v1v = dv[i + 1] + part[(33 + i) * 32 + lane];
      const int64_t at = (int64_t)kr * D + c;
      if (pairs) {
        *reinterpret_cast<float2*>(dk_b + at) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(dv_b + at) = make_float2(v0v, v1v);
      } else {
        dk_b[at] = k0v;
        dv_b[at] = v0v;
        if (c + 1 < D) {
          dk_b[at + 1] = k1v;
          dv_b[at + 1] = v1v;
        }
      }
    }
  }
}

int dkv_fp32(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
             const void* dsum, void* dk_out, void* dv_out, int BH, int Tq, int Tk, int D,
             int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  if (D < 1 || D > kD) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(DkvSmem);
  cudaError_t err = prepare(flash_dkv_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tk + kTile - 1) / kTile);
  flash_dkv_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
      (const float*)dsum, (float*)dk_out, (float*)dv_out, Tq, Tk, D, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_dq_mma: the fp32 dq for Hopper, on mma.sync tf32 (3xTF32)
// ---------------------------------------------------------------------------
//
// The same function as flash_dq_kernel<float> and flash_dq_plain: p = valid
// ? expf(s * scale - lse) : 0 with s = q.k; dp = dO.v; ds = p * (dp - dsum)
// * scale in fp32, never rounded (pallas_attention.py:195, the 2-D kernel's
// :296); dq += ds k in an fp32 accumulator. All three products run as three
// tf32 products each on the tensor cores (flash_fwd_mma's split_tf32: lo hi
// + hi lo + hi hi, the small terms first), so the kernel is held to phase
// flash's fp32 dq limit, not to bits. It serves #8 and #10 (one kernel
// streams every T) for fp32 at any D <= 64.
//
// Block: flash_fwd_mma's. One CTA of 256 threads (8 warps) per (128-query
// tile, b*h), heaviest causal tiles first; a warp owns 16 query rows (one M
// of the mma) and skips the tiles its rows cannot see. K/V tiles of 64 keys
// stream through the forward's two-stage cp.async ring (16-byte copies when
// D % 4 == 0 and k, v are 16-byte aligned, else 4-byte ones; rows past Tk
// zero-filled, the head's columns from D to 64 zeroed once). Once a tile
// lands the CTA splits it once (split_kv_dq): K's and V's tf32 hi parts in
// place, their lo parts beside the ring, and K's hi and lo parts again as
// K^T (a row per head column). Three barriers a tile: landed, split, read.
//
// Registers and shared memory: Q's tf32 hi and lo A fragments (64
// registers at D 64) and the S, dP and dQ accumulators (96) stay in
// registers. dO's hi and lo A fragments would take 64 more, past the 255 a
// thread has, so each thread parks its own in shared memory once (in
// fragment order: a warp's 16-byte reads of one k-step are 512 contiguous
// bytes) and reads back one k-step's 8 registers at a time. Ring, K's and
// V's lo parts, K^T and dO's fragments: 208 KB, one CTA an SM.
//
// Products per tile and warp, mma.sync m16n8k8 tf32: S = Q K^T and dP = dO
// V^T with the head dim permuted (logical column t is head column 2t, t + 4
// is 2t + 1, as in flash_fwd_mma), so K's and V's B fragments are float2s of
// their rows (72 floats apart: a half-warp's pairs hit 32 distinct banks).
// p and ds form on S's C fragments in place (sm90::tile_probs: masks only on
// tiles across the causal diagonal or the ragged key edge, a masked element
// selected to 0 without expf, so a blind row's sentinel lse never gives an
// inf); ds is split into tf32 hi and lo in registers. dQ += dS K takes dS's
// C fragment as its A fragment as it stands (a0 = c0, a1 = c2, a2 = c1, a3
// = c3), the keys of each 8-key step permuted the same way in K's B
// fragment, whose (key 2t, key 2t + 1) pairs are float2s of K^T's rows: no
// shuffle and no shared stage for dS. Each 8-column (or 8-key) step issues
// its 8 column groups' products back to back, one term at a time. Query
// rows past Tq read lse = dsum = 0 and zero Q and dO: p = 1, ds = 0, never
// stored (a row of dQ takes only its own row of dS).
//
// Bound, at the 136M LM's shape in fp32 (BH 96, T 1024, D 64, causal):
// 126.6 MB (38 us at 3.35 TB/s); 19.3 GFLOP of products over the causal
// half as fp32 FMAs (289 us at 67 TFLOP/s), 58.0 GFLOP as 3xTF32 (117 us at
// the 494.7 TFLOP/s dense tf32 rate): the tensor cores' share bounds it.
//
// Not yet: wgmma (tf32 wgmma takes K-major operands only), a producer warp,
// one tile's products under the previous tile's elementwise work.

struct DqMmaSmem {
  float k[kRing][kTile * kLdK];  // the ring; K's and V's tf32 hi parts in place once split
  float v[kRing][kTile * kLdK];
  float k_lo[kTile * kLdK];
  float v_lo[kTile * kLdK];
  float kt_hi[kD * kLdK];  // K^T: a row per head column, 64 keys + 8
  float kt_lo[kD * kLdK];
  // dO's A fragments, hi and lo, of each warp and k-step, in lane order
  uint4 do_frag[kMmaThreads / 32][kD / 8][2][32];
};

// the landed K tile ks -> its hi parts in place, lo parts in sm.k_lo, and
// both transposed into sm.kt_hi / sm.kt_lo; the V tile vs -> hi in place,
// lo in sm.v_lo. A thread loads all its float4s before it splits and
// stores any. K: consecutive lanes take consecutive rows of one column
// group, so the transposed 4-byte stores of a warp hit 32 distinct banks;
// V: consecutive float4s of a row.
__device__ __forceinline__ void split_kv_dq(DqMmaSmem& sm, float* ks, float* vs) {
  constexpr int kPer = kTile * kD / 4 / kMmaThreads;  // float4s a thread, each of K and V
  float4 xk[kPer], xv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    xk[j] = *reinterpret_cast<const float4*>(ks + (i % kTile) * kLdK + (i / kTile) * 4);
    xv[j] = *reinterpret_cast<const float4*>(vs + (i / (kD / 4)) * kLdK + (i % (kD / 4)) * 4);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int r = i % kTile, c = (i / kTile) * 4;
    const float xs[4] = {xk[j].x, xk[j].y, xk[j].z, xk[j].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(xs[e], h[e], l[e]);
      sm.kt_hi[(c + e) * kLdK + r] = __uint_as_float(h[e]);
      sm.kt_lo[(c + e) * kLdK + r] = __uint_as_float(l[e]);
    }
    *reinterpret_cast<uint4*>(ks + r * kLdK + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(sm.k_lo + r * kLdK + c) = make_uint4(l[0], l[1], l[2], l[3]);
    const int at = (i / (kD / 4)) * kLdK + (i % (kD / 4)) * 4;
    split_tf32(xv[j].x, h[0], l[0]);
    split_tf32(xv[j].y, h[1], l[1]);
    split_tf32(xv[j].z, h[2], l[2]);
    split_tf32(xv[j].w, h[3], l[3]);
    *reinterpret_cast<uint4*>(vs + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(sm.v_lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
flash_dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dq_out, int Tq, int Tk, int D, int q_off, int k_off,
                    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  DqMmaSmem& sm = *reinterpret_cast<DqMmaSmem*>(dyn_smem);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread in group
  const int wq0 = q0 + warp * kWarpRows;  // the warp's first query row
  const int qr0 = wq0 + g, qr1 = qr0 + 8;  // this thread's two rows
  const float* kb = k + (int64_t)bh * Tk * D;
  const float* vb = v + (int64_t)bh * Tk * D;
  const bool vec = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int nk = (Tk + kTile - 1) / kTile;
  const int n_tiles = sm90::k_tiles_seen(causal, min(q0 + kRows, Tq), q_off, k_off, nk);
  // the warp's own last tile (exclusive): it skips the CTA's later ones
  const int n_mine =
      wq0 < Tq ? sm90::k_tiles_seen(causal, min(wq0 + kWarpRows, Tq), q_off, k_off, nk) : 0;
  const int steps = (D + 7) / 8;  // 8-column steps of the head that hold data

  if (n_tiles > 0) load_kv_async(sm, kb, vb, 0, Tk, D, vec);
  // the head's zero padding, never written by the copies
  const int pad = kD - D;
  for (int i = tid; i < kRing * kTile * pad; i += kMmaThreads) {
    const int s = i / (kTile * pad);
    const int r = (i / pad) % kTile, c = D + i % pad;
    sm.k[s][r * kLdK + c] = 0.0f;
    sm.v[s][r * kLdK + c] = 0.0f;
  }

  // Q's A fragments in registers and dO's in shared memory, hi and lo:
  // element e of step kk is row e & 1 ? qr1 : qr0, head column 8kk + 2t +
  // (e >> 1) (the permuted columns)
  uint32_t q_hi[kD / 8][4], q_lo[kD / 8][4];
  const float* qb = q + (int64_t)bh * Tq * D;
  const float* ob = d_o + (int64_t)bh * Tq * D;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    uint32_t oh[4], ol[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1 ? qr1 : qr0;
      const int c = 8 * kk + 2 * t + (e >> 1);
      const bool in = r < Tq && c < D;
      split_tf32(in ? qb[(int64_t)r * D + c] : 0.0f, q_hi[kk][e], q_lo[kk][e]);
      split_tf32(in ? ob[(int64_t)r * D + c] : 0.0f, oh[e], ol[e]);
    }
    sm.do_frag[warp][kk][0][lane] = make_uint4(oh[0], oh[1], oh[2], oh[3]);
    sm.do_frag[warp][kk][1][lane] = make_uint4(ol[0], ol[1], ol[2], ol[3]);
  }
  const float* lse_b = lse + (int64_t)bh * Tq;
  const float* dsum_b = dsum + (int64_t)bh * Tq;
  const float lse0 = qr0 < Tq ? __ldg(lse_b + qr0) : 0.0f;
  const float lse1 = qr1 < Tq ? __ldg(lse_b + qr1) : 0.0f;
  const float dsum0 = qr0 < Tq ? __ldg(dsum_b + qr0) : 0.0f;
  const float dsum1 = qr1 < Tq ? __ldg(dsum_b + qr1) : 0.0f;

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv_async(sm, kb, vb, j + 1, Tk, D, vec);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile j has landed for every thread
    float* ks = sm.k[j % kRing];
    float* vs = sm.v[j % kRing];
    split_kv_dq(sm, ks, vs);
    __syncthreads();  // the split tile is whole
    if (j < n_mine) {
      // s = q k^T and dp = dO v^T: s_acc[4n + e] (dp_acc's alike) is row
      // e < 2 ? qr0 : qr1, key 8n + 2t + e % 2. Each 8-column step runs
      // the 8 key groups' independent products back to back, one of the
      // three terms at a time, S's and then dP's.
      float s_acc[32], dp_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s_acc[i] = dp_acc[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        if (kk < steps) {
          uint32_t kv_hi[kTile / 8][2], kv_lo[kTile / 8][2];
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            b_parts(ks, sm.k_lo, (8 * n + g) * kLdK + 8 * kk + 2 * t, kv_hi[n], kv_lo[n]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            mma_tf32(s_acc + 4 * n, q_lo[kk], kv_hi[n][0], kv_hi[n][1]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            mma_tf32(s_acc + 4 * n, q_hi[kk], kv_lo[n][0], kv_lo[n][1]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            mma_tf32(s_acc + 4 * n, q_hi[kk], kv_hi[n][0], kv_hi[n][1]);
          const uint4 oh4 = sm.do_frag[warp][kk][0][lane], ol4 = sm.do_frag[warp][kk][1][lane];
          const uint32_t o_hi[4] = {oh4.x, oh4.y, oh4.z, oh4.w};
          const uint32_t o_lo[4] = {ol4.x, ol4.y, ol4.z, ol4.w};
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            b_parts(vs, sm.v_lo, (8 * n + g) * kLdK + 8 * kk + 2 * t, kv_hi[n], kv_lo[n]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            mma_tf32(dp_acc + 4 * n, o_lo, kv_hi[n][0], kv_hi[n][1]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            mma_tf32(dp_acc + 4 * n, o_hi, kv_lo[n][0], kv_lo[n][1]);
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n)
            mma_tf32(dp_acc + 4 * n, o_hi, kv_hi[n][0], kv_hi[n][1]);
        }
      }

      const int k0 = j * kTile;
      if (k0 + kTile > Tk || (causal && k_off + k0 + kTile - 1 > q_off + wq0)) {
        sm90::tile_probs<true>(s_acc, lse0, lse1, scale, causal, q_off, k_off, qr0, qr1,
                               k0 + 2 * t, Tk);
      } else {
        sm90::tile_probs<false>(s_acc, lse0, lse1, scale, causal, q_off, k_off, qr0, qr1,
                                k0 + 2 * t, Tk);
      }
      // ds = p * (dp - dsum) * scale, in place, in fp32
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s_acc[i] = s_acc[i] * (dp_acc[i] - ((i % 4) < 2 ? dsum0 : dsum1)) * scale;

      // dq += ds k: key step kk's A fragment is ds's C fragment of keys
      // 8kk..8kk+7 (a0 = c0, a1 = c2, a2 = c1, a3 = c3); B takes K^T's row
      // 8n + g (head column) at keys 8kk + 2t and + 1
#pragma unroll
      for (int kk = 0; kk < kTile / 8; ++kk) {
        uint32_t ds_hi[4], ds_lo[4];
        split_tf32(s_acc[4 * kk], ds_hi[0], ds_lo[0]);
        split_tf32(s_acc[4 * kk + 2], ds_hi[1], ds_lo[1]);
        split_tf32(s_acc[4 * kk + 1], ds_hi[2], ds_lo[2]);
        split_tf32(s_acc[4 * kk + 3], ds_hi[3], ds_lo[3]);
        uint32_t th[kD / 8][2], tl[kD / 8][2];
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps)
            b_parts(sm.kt_hi, sm.kt_lo, (8 * n + g) * kLdK + 8 * kk + 2 * t, th[n], tl[n]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dq_acc + 4 * n, ds_lo, th[n][0], th[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dq_acc + 4 * n, ds_hi, tl[n][0], tl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          if (n < steps) mma_tf32(dq_acc + 4 * n, ds_hi, th[n][0], th[n][1]);
        }
      }
    }
    __syncthreads();  // every thread is done with the split tile and the stage tile j + 2 fills
  }

  // epilogue: rows qr0, qr1, columns 8n + 2t and + 1 (a float2 when D is even)
  float* dq_b = dq_out + (int64_t)bh * Tq * D;
  const bool pairs = D % 2 == 0 && (reinterpret_cast<uintptr_t>(dq_out) & 7) == 0;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? qr1 : qr0;
      if (r >= Tq || c >= D) continue;
      const float x0 = dq_acc[4 * n + 2 * h], x1 = dq_acc[4 * n + 2 * h + 1];
      float* dst = dq_b + (int64_t)r * D + c;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        if (c + 1 < D) dst[1] = x1;
      }
    }
  }
}

int dq_fp32(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
            const void* dsum, void* dq_out, int BH, int Tq, int Tk, int D, int q_off, int k_off,
            int causal, float scale, cudaStream_t stream) {
  if (D < 1 || D > kD) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(DqMmaSmem);
  cudaError_t err = prepare(flash_dq_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tq + kRows - 1) / kRows);
  flash_dq_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
      (const float*)dsum, (float*)dq_out, Tq, Tk, D, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace mma

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  if (code == sm90::kNoEncoder) return "cuTensorMapEncodeTiled not found through the runtime";
  if (code < 0) {
    static thread_local char buf[64];
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d", -code);
    return buf;
  }
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

// fp32 only (3xTF32 on mma.sync), any 1 <= D <= 64; o 8-byte aligned
// when D is even.
int tmpi_flash_fwd_mma(int device, const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int Tq, int Tk, int D, int q_off, int k_off, int causal,
                       float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mma::fwd(q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale,
                  (cudaStream_t)stream);
}

// bf16 at any 1 <= D <= 64 (mma.sync bf16; the route sends it D % 8 != 0):
// 4-byte cp.async copies when D is even and k, v 4-byte aligned, else
// register-staged loads.
int tmpi_flash_fwd_mma_bf16(int device, const void* q, const void* k, const void* v, void* o,
                            void* lse, int BH, int Tq, int Tk, int D, int q_off, int k_off,
                            int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mma::fwd_bf16(q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale,
                       (cudaStream_t)stream);
}

// bf16 only, 8 <= D <= 64 with D % 8 == 0, and q, k, v, o 16-byte aligned
// (the tensor maps' rules); a negative code is a tensor map's failure.
int tmpi_flash_fwd_sm90(int device, const void* q, const void* k, const void* v, void* o,
                        void* lse, int BH, int Tq, int Tk, int D, int q_off, int k_off, int causal,
                        float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return sm90::fwd(q, k, v, o, lse, BH, Tq, Tk, D, q_off, k_off, causal, scale,
                   (cudaStream_t)stream);
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

// bf16 only, 8 <= D <= 64 with D % 8 == 0, and q, k, v, dO 16-byte
// aligned (the tensor maps' rules), dq 8-byte aligned; a negative code is
// a tensor map's failure.
int tmpi_flash_dq_sm90(int device, const void* q, const void* k, const void* v, const void* d_o,
                       const void* lse, const void* dsum, void* dq_out, int BH, int Tq, int Tk,
                       int D, int q_off, int k_off, int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return sm90::dq(q, k, v, d_o, lse, dsum, dq_out, BH, Tq, Tk, D, q_off, k_off, causal, scale,
                  (cudaStream_t)stream);
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

// bf16 at any 1 <= D <= 64 (mma.sync bf16; the route sends it D % 8 != 0):
// 4-byte cp.async copies of K and V when D is even and k, v 4-byte
// aligned, else register-staged loads.
int tmpi_flash_dq_mma_bf16(int device, const void* q, const void* k, const void* v,
                           const void* d_o, const void* lse, const void* dsum, void* dq_out,
                           int BH, int Tq, int Tk, int D, int q_off, int k_off, int causal,
                           float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mma::dq_bf16(q, k, v, d_o, lse, dsum, dq_out, BH, Tq, Tk, D, q_off, k_off, causal, scale,
                      (cudaStream_t)stream);
}

// bf16 at any 1 <= D <= 64 (mma.sync bf16, dv through the three-part
// split of p; the route sends it D % 8 != 0): 4-byte cp.async copies of Q
// and dO when D is even and q, dO 4-byte aligned, else register-staged
// loads.
int tmpi_flash_dkv_mma_bf16(int device, const void* q, const void* k, const void* v,
                            const void* d_o, const void* lse, const void* dsum, void* dk_out,
                            void* dv_out, int BH, int Tq, int Tk, int D, int q_off, int k_off,
                            int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mma::dkv_bf16(q, k, v, d_o, lse, dsum, dk_out, dv_out, BH, Tq, Tk, D, q_off, k_off,
                       causal, scale, (cudaStream_t)stream);
}

// bf16 only, 8 <= D <= 64 with D % 8 == 0, and q, k, v, dO 16-byte
// aligned (the tensor maps' rules), dk and dv 8-byte aligned; a negative
// code is a tensor map's failure.
int tmpi_flash_dkv_sm90(int device, const void* q, const void* k, const void* v, const void* d_o,
                        const void* lse, const void* dsum, void* dk_out, void* dv_out, int BH,
                        int Tq, int Tk, int D, int q_off, int k_off, int causal, float scale,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return sm90::dkv(q, k, v, d_o, lse, dsum, dk_out, dv_out, BH, Tq, Tk, D, q_off, k_off, causal,
                   scale, (cudaStream_t)stream);
}

// fp32 only (3xTF32 on mma.sync), any 1 <= D <= 64.
int tmpi_flash_dkv_mma(int device, const void* q, const void* k, const void* v, const void* d_o,
                       const void* lse, const void* dsum, void* dk_out, void* dv_out, int BH,
                       int Tq, int Tk, int D, int q_off, int k_off, int causal, float scale,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mma::dkv_fp32(q, k, v, d_o, lse, dsum, dk_out, dv_out, BH, Tq, Tk, D, q_off, k_off,
                       causal, scale, (cudaStream_t)stream);
}

// fp32 only (3xTF32 on mma.sync), any 1 <= D <= 64.
int tmpi_flash_dq_mma(int device, const void* q, const void* k, const void* v, const void* d_o,
                      const void* lse, const void* dsum, void* dq_out, int BH, int Tq, int Tk,
                      int D, int q_off, int k_off, int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mma::dq_fp32(q, k, v, d_o, lse, dsum, dq_out, BH, Tq, Tk, D, q_off, k_off, causal, scale,
                      (cudaStream_t)stream);
}

}  // extern "C"
