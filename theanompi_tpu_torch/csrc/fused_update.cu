// Fused optimizer epilogue for Hopper (sm_90a): weight decay + clip
// coefficient + momentum/Nesterov (or plain SGD) + parameter write in ONE
// pass over device memory, in ONE launch over all of a step's leaves.
//
// Replaces the TPU kernels
//   theanompi_tpu/ops/pallas_update.py:78  _momentum_kernel
//   theanompi_tpu/ops/pallas_update.py:90  _sgd_kernel
// (reached through fused_update_leaf :115 / fused_sgd_leaf :160).
//
// Math, per element, in fp32 whatever the param dtype:
//   g' = g * coef + wd * p
//   v' = mu * v - lr * g'
//   p' = p + v'                       (classical)
//   p' = p + (mu * v' - lr * g')      (Nesterov)
//   p' = p - lr * g'                  (sgd, no velocity)
// p' is rounded ONCE to the param dtype (__float2bfloat16_rn for bf16);
// v stays fp32. Each multiply/add is rounded on its own, in the order of
// the plain PyTorch version (ops/fused_update.py), and the file is built
// with -fmad=false besides, so on fp32 params the kernel is bit-identical
// to the plain version's separate elementwise ops (a contracted FMA would
// not be).
//
// Bound: device-memory bytes. Per element it reads p, v, g and writes p,
// v once: 20 B for fp32 params and grads, 14 B for bf16 params and grads
// (16 B with fp32 grads), 12 B for fp32 SGD, against ~7 fp32 operations —
// far below the H100's operations-per-byte ridge. For AlexNet's
// 60,965,224 fp32 parameters that is 1.219 GB per step, 0.364 ms at the
// H100 SXM's 3.35 TB/s. The TPU kernel's (rows, 128) lane padding is not
// carried over: the flat storage of each leaf is walked unpadded (conv
// leaves are channels_last, and p, v and g share strides).
//
// Design (fused_update_multi_kernel):
// - One launch per (param dtype, grad dtype) group of leaves. The host
//   (ops/fused_update.py, ops/kernels.py::work_table) cuts every leaf into
//   chunks of `chunk` elements and writes a work table: per leaf its
//   pointers, length, index of its first chunk and whether all of its
//   pointers are 16-byte aligned. The table (csrc/work_table.cuh, shared
//   with csrc/quant.cu) travels as a __grid_constant__ kernel parameter
//   (32,764 bytes with CUDA >= 12.1, 818 leaves; 4,096 before, 101): no
//   device allocation, no host-to-device copy, no host sync, and legal
//   inside a CUDA graph capture.
// - The grid is kBlocksPerSm CTAs an SM (or one CTA a chunk, if fewer).
//   Each CTA walks the chunks grid-stride and finds a chunk's leaf by a
//   binary search over the leaves' first chunks, uniform across the CTA.
//   So the largest leaf's chunks and the biases' chunks share one wave,
//   and no leaf's tail runs alone.
// - A thread moves quads of 4 elements: fp32 arrays as one 16-byte float4,
//   bf16 arrays as one 8-byte uint2 of 4 bf16. Its kQuads quads of an
//   iteration sit kThreads * 4 elements apart, so every warp-wide load and
//   store covers consecutive bytes, and all kQuads quads of p, v and g are
//   loaded before any is computed (32 elements in flight a thread; one
//   iteration of the CTA is one 8192-element chunk). Of ten layouts and
//   occupancies timed on the card (8 consecutive elements a thread, as two
//   float4 or one uint4 of 8 bf16, or quads; 2 to 4 CTAs an SM; 4 or 8
//   quads in flight), this one was the fastest or within 0.5% of it in
//   fp32 and bf16, momentum and sgd (tools/update_variants.py; PERF.md).
// - g is read once and is loaded with a streaming hint (__ldcs) so it does
//   not push p and v lines out of L2. A leaf whose pointers are not all
//   16-byte aligned, and every chunk's ragged tail (< 4 elements), take
//   the same arithmetic with scalar accesses.
// - No TMA and no shared memory: the pass reuses nothing, so staging
//   through shared memory would add work without saving a byte; the
//   bound is the bytes above, and the loads above already keep enough of
//   them in flight (~192 KB an SM for fp32 momentum, against the ~18 KB
//   that 3.35 TB/s over ~700 ns of latency asks of each of 132 SMs).
//
// The per-leaf kernels (momentum_kernel / sgd_kernel, tmpi_fused_momentum
// / tmpi_fused_sgd) are the design this one replaced: one grid-stride
// launch per leaf with scalar accesses. Nothing in the package launches
// them; tools/update_variants.py times them beside the multi-tensor
// kernel.
//
// lr and coef are read from a 2-element fp32 DEVICE buffer, so a training
// step never syncs with the host.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "work_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;  // CTAs an SM that the multi-tensor grid is sized for
constexpr int kQuads = 8;        // 4-element quads a thread loads before it computes

// ---------------------------------------------------------------------------
// the per-element arithmetic, shared by every kernel of this file
// ---------------------------------------------------------------------------

template <bool kMomentum>
__device__ __forceinline__ float update(float pf, float graw, float& v, float lr, float coef,
                                        float mu, float wd, bool nesterov) {
  const float gf = __fadd_rn(__fmul_rn(graw, coef), __fmul_rn(wd, pf));
  if constexpr (kMomentum) {
    const float v2 = __fsub_rn(__fmul_rn(mu, v), __fmul_rn(lr, gf));
    v = v2;
    const float step = nesterov ? __fsub_rn(__fmul_rn(mu, v2), __fmul_rn(lr, gf)) : v2;
    return __fadd_rn(pf, step);
  } else {
    return __fsub_rn(pf, __fmul_rn(lr, gf));
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// the multi-tensor kernel
// ---------------------------------------------------------------------------

// One leaf of the work table; the layout is ops/fused_update.py's (its
// table_rows, through ops/kernels.py::pack_rows).
struct Leaf {
  int64_t p, v, g;  // device addresses (v = 0 for sgd)
  int64_t n;        // elements
  int32_t chunk0;   // index of the leaf's first chunk within the launch
  int32_t aligned;  // 1 when p, v and g are all 16-byte aligned
};
static_assert(sizeof(Leaf) == work_table::kRowBytes,
              "Leaf layout is shared with ops/fused_update.py");

constexpr int kCap = work_table::capacity(32);  // leaves a launch's table holds

struct Table {
  const float* sc;  // [lr, coef] on the device
  float mu, wd;
  int32_t nesterov, n_leaves, chunks, chunk;
  Leaf leaves[kCap];
};
static_assert(offsetof(Table, leaves) == 32, "header layout is shared with ops/fused_update.py");
static_assert(sizeof(Table) <= work_table::kParamLimit, "work table exceeds the parameter limit");

__device__ __forceinline__ void f4_to(const float4& a, float* x) {
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// quads: 4 elements to or from fp32 registers; *_stream loads evict first
__device__ __forceinline__ void load4(const float* p, float* x) {
  f4_to(*reinterpret_cast<const float4*>(p), x);
}
__device__ __forceinline__ void bf16x4_to(const uint2& u, float* x) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  bf16x4_to(*reinterpret_cast<const uint2*>(p), x);
}
__device__ __forceinline__ void load4_stream(const float* p, float* x) {
  f4_to(__ldcs(reinterpret_cast<const float4*>(p)), x);
}
__device__ __forceinline__ void load4_stream(const __nv_bfloat16* p, float* x) {
  bf16x4_to(__ldcs(reinterpret_cast<const uint2*>(p)), x);
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) =
      __halves2bfloat162(__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1]));
  *reinterpret_cast<__nv_bfloat162*>(&u.y) =
      __halves2bfloat162(__float2bfloat16_rn(x[2]), __float2bfloat16_rn(x[3]));
  *reinterpret_cast<uint2*>(p) = u;
}

// elements [start, start + len) of one leaf, by the CTA. A thread's kQuads
// quads of an iteration sit kThreads * 4 elements apart, so each warp's
// load or store covers consecutive bytes (512 of fp32, 256 of bf16).
template <typename P, typename G, bool kMomentum>
__device__ __forceinline__ void run_chunk(const Leaf& L, int64_t start, int len, float lr,
                                          float coef, float mu, float wd, bool nesterov) {
  P* p = reinterpret_cast<P*>(L.p) + start;
  float* v = kMomentum ? reinterpret_cast<float*>(L.v) + start : nullptr;
  const G* g = reinterpret_cast<const G*>(L.g) + start;
  const int nq = L.aligned ? (len & ~3) : 0;
  for (int e0 = threadIdx.x * 4; e0 < nq; e0 += kThreads * 4 * kQuads) {
    float pf[kQuads][4], vf[kQuads][4], gf[kQuads][4];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int e = e0 + q * kThreads * 4;
      if (e < nq) {
        load4(p + e, pf[q]);
        if constexpr (kMomentum) load4(v + e, vf[q]);
        load4_stream(g + e, gf[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int e = e0 + q * kThreads * 4;
      if (e < nq) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[q][j] = update<kMomentum>(pf[q][j], gf[q][j], vf[q][j], lr, coef, mu, wd, nesterov);
        if constexpr (kMomentum) store4(v + e, vf[q]);
        store4(p + e, pf[q]);
      }
    }
  }
  for (int e = nq + threadIdx.x; e < len; e += kThreads) {
    float vv = kMomentum ? v[e] : 0.0f;
    const float pn = update<kMomentum>(to_f32(p[e]), to_f32(g[e]), vv, lr, coef, mu, wd, nesterov);
    if constexpr (kMomentum) v[e] = vv;
    p[e] = from_f32<P>(pn);
  }
}

template <typename P, typename G, bool kMomentum>
__global__ void __launch_bounds__(kThreads)
fused_update_multi_kernel(const __grid_constant__ Table t) {
  const float lr = t.sc[0];
  const float coef = t.sc[1];
  const bool nesterov = t.nesterov != 0;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const Leaf L = t.leaves[work_table::leaf_of(t.leaves, t.n_leaves, c)];
    const int64_t start = (int64_t)(c - L.chunk0) * t.chunk;
    const int64_t rest = L.n - start;
    const int len = (int)(rest < t.chunk ? rest : t.chunk);
    run_chunk<P, G, kMomentum>(L, start, len, lr, coef, t.mu, t.wd, nesterov);
  }
}

template <typename P, typename G, bool kMomentum>
int launch_multi(int device, const void* rows, int n_leaves, int chunks, int chunk,
                 const float* sc, float mu, float wd, int nesterov, cudaStream_t s) {
  Table t;
  t.sc = sc;
  t.mu = mu;
  t.wd = wd;
  t.nesterov = nesterov;
  t.n_leaves = n_leaves;
  t.chunks = chunks;
  t.chunk = chunk;
  memcpy(t.leaves, rows, (size_t)n_leaves * sizeof(Leaf));
  const int cap = work_table::sm_count(device) * kBlocksPerSm;
  const int grid = chunks < cap ? chunks : cap;
  fused_update_multi_kernel<P, G, kMomentum><<<grid, kThreads, 0, s>>>(t);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the per-leaf kernels this design replaced, as they were (timed by
// tools/update_variants.py)
// ---------------------------------------------------------------------------

template <typename P, typename G>
__global__ void momentum_kernel(P* __restrict__ p, float* __restrict__ v,
                                const G* __restrict__ g, const float* __restrict__ sc,
                                int64_t n, float mu, float wd, int nesterov) {
  const float lr = sc[0];
  const float coef = sc[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float pf = to_f32(p[i]);
    const float gf = __fadd_rn(__fmul_rn(to_f32(g[i]), coef), __fmul_rn(wd, pf));
    const float v2 = __fsub_rn(__fmul_rn(mu, v[i]), __fmul_rn(lr, gf));
    v[i] = v2;
    const float step = nesterov ? __fsub_rn(__fmul_rn(mu, v2), __fmul_rn(lr, gf)) : v2;
    p[i] = from_f32<P>(__fadd_rn(pf, step));
  }
}

template <typename P, typename G>
__global__ void sgd_kernel(P* __restrict__ p, const G* __restrict__ g,
                           const float* __restrict__ sc, int64_t n, float wd) {
  const float lr = sc[0];
  const float coef = sc[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float pf = to_f32(p[i]);
    const float gf = __fadd_rn(__fmul_rn(to_f32(g[i]), coef), __fmul_rn(wd, pf));
    p[i] = from_f32<P>(__fsub_rn(pf, __fmul_rn(lr, gf)));
  }
}

int grid_for(int64_t n, int max_blocks) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)(blocks < 1 ? 1 : blocks);
}

// dtype codes shared with ops/kernels.py (DTYPE_CODES)
enum { kF32 = 0, kBF16 = 1 };

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Leaves one launch's work table may hold (the kernel-parameter limit).
int tmpi_fused_table_capacity() { return kCap; }

// One multi-tensor launch over a work table of `n_leaves` rows (struct
// Leaf, host memory) holding `chunks` chunks of `chunk` elements.
// rule 0 = momentum/Nesterov, 1 = sgd. Returns cudaGetLastError() after
// the launch (0 = launched).
int tmpi_fused_update_multi(int device, int rule, int p_dtype, int g_dtype, const void* rows,
                            int n_leaves, int chunks, int chunk, const void* sc, float mu,
                            float wd, int nesterov, void* stream) {
  if (n_leaves < 1 || n_leaves > kCap || chunks < 1 || chunk < 4 || chunk % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* scf = (const float*)sc;
#define TMPI_RULES(P, G)                                                                   \
  return rule == 0 ? launch_multi<P, G, true>(device, rows, n_leaves, chunks, chunk, scf, mu, \
                                              wd, nesterov, s)                             \
                   : launch_multi<P, G, false>(device, rows, n_leaves, chunks, chunk, scf, mu, \
                                               wd, 0, s)
  if (rule != 0 && rule != 1) return (int)cudaErrorInvalidValue;
  if (p_dtype == kF32 && g_dtype == kF32) {
    TMPI_RULES(float, float);
  } else if (p_dtype == kBF16 && g_dtype == kBF16) {
    TMPI_RULES(__nv_bfloat16, __nv_bfloat16);
  } else if (p_dtype == kBF16 && g_dtype == kF32) {
    TMPI_RULES(__nv_bfloat16, float);
  }
#undef TMPI_RULES
  return (int)cudaErrorInvalidValue;
}

// The replaced per-leaf launches (tools/update_variants.py only).
int tmpi_fused_momentum(int device, int p_dtype, int g_dtype, void* p, void* v,
                        const void* g, const void* sc, int64_t n, float mu, float wd,
                        int nesterov, int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = grid_for(n, max_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  float* vf = (float*)v;
  const float* scf = (const float*)sc;
  if (p_dtype == kF32 && g_dtype == kF32) {
    momentum_kernel<float, float><<<blocks, kThreads, 0, s>>>(
        (float*)p, vf, (const float*)g, scf, n, mu, wd, nesterov);
  } else if (p_dtype == kBF16 && g_dtype == kBF16) {
    momentum_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (__nv_bfloat16*)p, vf, (const __nv_bfloat16*)g, scf, n, mu, wd, nesterov);
  } else if (p_dtype == kBF16 && g_dtype == kF32) {
    momentum_kernel<__nv_bfloat16, float><<<blocks, kThreads, 0, s>>>(
        (__nv_bfloat16*)p, vf, (const float*)g, scf, n, mu, wd, nesterov);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int tmpi_fused_sgd(int device, int p_dtype, int g_dtype, void* p, const void* g,
                   const void* sc, int64_t n, float wd, int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = grid_for(n, max_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const float* scf = (const float*)sc;
  if (p_dtype == kF32 && g_dtype == kF32) {
    sgd_kernel<float, float><<<blocks, kThreads, 0, s>>>(
        (float*)p, (const float*)g, scf, n, wd);
  } else if (p_dtype == kBF16 && g_dtype == kBF16) {
    sgd_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (__nv_bfloat16*)p, (const __nv_bfloat16*)g, scf, n, wd);
  } else if (p_dtype == kBF16 && g_dtype == kF32) {
    sgd_kernel<__nv_bfloat16, float><<<blocks, kThreads, 0, s>>>(
        (__nv_bfloat16*)p, (const float*)g, scf, n, wd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
