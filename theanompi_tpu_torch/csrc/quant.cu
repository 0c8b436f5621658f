// int8 absmax quantizer kernels for Hopper (sm_90a): the building block of
// the compressed gradient wire (--wire-codec int8[:ef], --strategy
// ring_int8). A flat f32 buffer is viewed as (rows, 128) lanes.
//
// Replaces the TPU kernels
//   theanompi_tpu/ops/pallas_quant.py:114  _quant_block_kernel    (#3)
//   theanompi_tpu/ops/pallas_quant.py:125  _dequant_block_kernel  (#4)
//   theanompi_tpu/ops/pallas_quant.py:46   _quant_kernel          (#5)
//   theanompi_tpu/ops/pallas_quant.py:55   _dequant_kernel        (#6)
// (reached through quantize_int8_block :136, dequantize_int8_block :159,
// quantize_int8 :66, dequantize_int8 :89; plain PyTorch versions beside
// the wrappers in ops/quant.py).
//
// Arithmetic, exactly as the reference computes it on XLA:
//   amax  = max |x| over the row (#3) or the whole buffer (#5); a NaN
//           anywhere gives NaN (jnp.max propagates it; fmaxf would not)
//   scale = max(amax, 1e-30) * fl(1/127)   -- XLA rewrites the division by
//           the constant 127 into this reciprocal multiply, so a true
//           division would differ by one ulp on ~4% of rows
//   q     = clamp(rint(x / scale), -127, 127) -- a TRUE division (x/scale
//           has no constant divisor), round half to even; NaN -> 0, as
//           XLA's f32 -> s8 convert of NaN (scale NaN or inf: all zeros)
//   out   = float(q) * scale, or with the ring's decode-and-add
//           fma(float(q), scale, out), one rounding, as XLA contracts them
// Built with -fmad=false and without --use_fast_math (-prec-div stays on,
// no flush of denormals), so every operation rounds as IEEE float.
//
// Bound: device-memory bytes. #3 reads 4 B and writes 1 B + 4/128 B of
// scale per element (5.03 B); #4 the reverse (and with accumulate also
// reads the 4 B it adds to). A few operations per byte, far below the
// card's ridge.
//
// Design of #3 / #4 (block_codec_multi_kernel): ONE launch over all the
// leaves of a codec round, driven by a work table that travels as a
// __grid_constant__ kernel parameter, as csrc/fused_update.cu does.
// - Table: per leaf its f32 pointer (the input of #3, the output of #4),
//   its int8 values and f32 scales pointers (the scales only 4-byte
//   aligned inside a packed wire message), its element count n, its first
//   chunk and its first row in the wrapper's value buffer (the table's
//   layout: csrc/work_table.cuh, shared with csrc/fused_update.cu). The
//   host (ops/quant.py, ops/kernels.py::work_table) cuts every leaf into
//   chunks of `chunk_rows` 128-lane rows; a CTA walks the chunks
//   grid-stride and finds a chunk's leaf by a binary search over the
//   first chunks, so fc6's 37.7M elements and a 1-element bias share one
//   wave.
// - Ragged tails in the kernel: a leaf's last row reads the elements past
//   n as +0.0 (the reference's zero pad) and writes their int8 values as
//   0; the dequantize writes only the leaf's n outputs. No padded copy of
//   a leaf is made and none is cut back.
// - Memory: kRowThreads threads share a row. A thread's float4 slots of
//   the row interleave with its group's (slot g + kRowThreads * k), so
//   every warp-wide float4 access covers whole 128-byte lines and every
//   char4 access whole 32-byte sectors; a thread has its 4 float4s (64
//   bytes) in flight. The row's scale is read at one address by its group
//   (one request a row), and its absmax is a 3-step shuffle inside the
//   group. The grid is kQuantBlocksPerSm / kDequantBlocksPerSm CTAs an SM
//   (or one CTA a chunk, if fewer). The dequantize stores its output
//   with an evict-first hint (__stcs; the ring's accumulate does not,
//   its sum is read again at the next hop). Settled on the card with
//   tools/quant_variants.py (PERF.md): 16 consecutive elements a thread
//   (one 16-byte int8 vector) tied for the quantize but took 2.9x as long
//   for the dequantize, whose float4 stores then lie 64 bytes apart
//   across a warp; a warp a row (4 bytes of int8 a thread) was slower at
//   every occupancy tried.
// - Alignment: the f32 pointers must be 16-byte aligned, the values and
//   the scales 4-byte; the wrappers refuse anything else (no scalar path).
// It replaced one launch per (rows, 128) buffer: a warp a row for #3, a
// thread per 4 values for #4 (PERF.md).
//
// The whole-buffer #5 needs a reduction across blocks, which Hopper's
// blocks cannot carry between them as the TPU's sequential grid can.
// quant_whole_kernel does it in ONE launch: a persistent grid of no more
// CTAs than can be resident at once, each CTA a contiguous run of the
// buffer. A CTA reduces its run's absmax (nanmax / block_nanmax: a NaN
// wins), publishes it and waits at a grid-wide barrier (an atomic counter
// in the wrapper's scratch, zeroed on the launch's stream, so the launch
// is capturable and needs no host sync); then every CTA reduces the few
// hundred partials itself and applies scale_of (CTA 0 writes the scale),
// and quantizes its run last float4 first, so that what the L2 still
// holds of the first pass's end is read from there. Bytes: two reads of
// the input and one write, as the three-pass launcher it replaced
// (quant_three_pass: each block's absmax to scratch, one block's scale,
// then the values; three launches), which stays for timing in turns, and
// about as fast (PERF.md: 1-2% less time in turns; keeping a run's head
// in shared memory or registers across the barrier, or L2 eviction
// hints, measured slower). #6
// (dequant_scalar_kernel) moves 16 int8 a thread in one 16-byte load and
// writes them as four float4 stores with the evict-first hint, through a
// per-warp staging in shared memory that keeps every warp-wide store on
// 512 contiguous bytes; kScalarDequantBlocksPerSm CTAs an SM (or fewer, for
// a small buffer).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "work_table.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFloor = 1e-30f;
constexpr float kInv127 = 1.0f / 127.0f;

// the multi-leaf kernel's layout: threads a 128-lane row, and CTAs an SM
// for the quantize and the dequantize (tools/quant_variants.py, PERF.md)
constexpr int kRowThreads = 8;
constexpr int kQuantBlocksPerSm = 4;
constexpr int kDequantBlocksPerSm = 2;
// CTAs an SM of the whole-buffer dequantize (#6): 1,024 threads with a
// 16-byte load each in flight
constexpr int kScalarDequantBlocksPerSm = 4;
constexpr int kSlots = kLanes / 4 / kRowThreads;      // float4 slots of a row a thread
constexpr int kRowsPerPass = kThreads / kRowThreads;  // rows a CTA takes at once
static_assert(kRowThreads >= 8 && kRowThreads <= 32 && kLanes % (4 * kRowThreads) == 0,
              "a thread owns 1, 2 or 4 float4 slots of its row");

// max that keeps a NaN (jnp.max / torch.amax semantics)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nanmax(nanmax(fabsf(v.x), fabsf(v.y)), nanmax(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float warp_nanmax(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// max(amax, 1e-30) keeping a NaN amax, times fl(1/127)
__device__ __forceinline__ float scale_of(float amax) {
  const float m = isnan(amax) ? amax : fmaxf(amax, kFloor);
  return __fmul_rn(m, kInv127);
}

__device__ __forceinline__ signed char quant1(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (isnan(r)) return 0;
  return (signed char)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ char4 quant4(float4 v, float s) {
  return make_char4(quant1(v.x, s), quant1(v.y, s), quant1(v.z, s), quant1(v.w, s));
}

__device__ __forceinline__ float4 dequant4(char4 q, float s) {
  return make_float4(__fmul_rn((float)q.x, s), __fmul_rn((float)q.y, s),
                     __fmul_rn((float)q.z, s), __fmul_rn((float)q.w, s));
}

__device__ __forceinline__ float4 dequant_add4(char4 q, float s, float4 a) {
  return make_float4(__fmaf_rn((float)q.x, s, a.x), __fmaf_rn((float)q.y, s, a.y),
                     __fmaf_rn((float)q.z, s, a.z), __fmaf_rn((float)q.w, s, a.w));
}

// ---------------------------------------------------------------------------
// #3 / #4: one launch over a work table of leaves
// ---------------------------------------------------------------------------

// One leaf of the work table; the layout is ops/quant.py's (its
// table_rows, through ops/kernels.py::pack_rows).
struct Leaf {
  int64_t x;       // f32: the input (quantize) or the output (dequantize)
  int64_t vals;    // int8: the leaf's rows x 128 values
  int64_t scales;  // f32: one scale a row
  int64_t n;       // elements of x
  int32_t chunk0;  // index of the leaf's first chunk within the launch
  int32_t row0;    // the leaf's first row in the wrapper's buffer (row0s); not read here
};
static_assert(sizeof(Leaf) == work_table::kRowBytes, "Leaf layout is shared with ops/quant.py");

constexpr int kCap = work_table::capacity(16);  // leaves a launch's table holds

struct Table {
  int32_t n_leaves, chunks, chunk_rows, op;
  Leaf leaves[kCap];
};
static_assert(offsetof(Table, leaves) == 16, "header layout is shared with ops/quant.py");
static_assert(sizeof(Table) <= work_table::kParamLimit,
              "work table exceeds the parameter limit");

enum { kQuantize = 0, kDequantize = 1, kDequantizeAdd = 2 };

// the lanes of this thread's row group (kRowThreads consecutive lanes)
__device__ __forceinline__ unsigned group_mask() {
  const int lane = threadIdx.x & 31;
  return (0xffffffffu >> (32 - kRowThreads)) << (lane & ~(kRowThreads - 1));
}

__device__ __forceinline__ float group_nanmax(float m, unsigned mask) {
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(mask, m, off));
  return m;
}

// the element offset within its row of float4 slot k of the row group's
// thread g: slots interleave, so each warp-wide access of a slot covers
// whole 128-byte lines of f32 (whole 32-byte sectors of int8)
__device__ __forceinline__ int slot_at(int g, int k) { return 4 * (g + kRowThreads * k); }

// this thread's slots of one row of the leaf
__device__ __forceinline__ void quant_part(const Leaf& L, int64_t row, int g, unsigned mask) {
  const int64_t base = row * kLanes;
  const float* x = reinterpret_cast<const float*>(L.x) + base;
  float4 v[kSlots];
  if (base + kLanes <= L.n) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) v[k] = *reinterpret_cast<const float4*>(x + slot_at(g, k));
  } else {  // the leaf's last row: past n, the zero pad
    const int64_t left = L.n - base;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int e = slot_at(g, k);
      v[k] = make_float4(e < left ? x[e] : 0.0f, e + 1 < left ? x[e + 1] : 0.0f,
                         e + 2 < left ? x[e + 2] : 0.0f, e + 3 < left ? x[e + 3] : 0.0f);
    }
  }
  float m = 0.0f;  // |x| >= 0: 0 is max's identity
#pragma unroll
  for (int k = 0; k < kSlots; ++k) m = nanmax(m, absmax4(v[k]));
  const float s = scale_of(group_nanmax(m, mask));
  if (g == 0) reinterpret_cast<float*>(L.scales)[row] = s;
  signed char* out = reinterpret_cast<signed char*>(L.vals) + base;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    *reinterpret_cast<char4*>(out + slot_at(g, k)) = quant4(v[k], s);
}

template <bool kAdd>
__device__ __forceinline__ void dequant_part(const Leaf& L, int64_t row, int g) {
  const int64_t base = row * kLanes;
  const signed char* in = reinterpret_cast<const signed char*>(L.vals) + base;
  char4 c[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) c[k] = *reinterpret_cast<const char4*>(in + slot_at(g, k));
  const float s = reinterpret_cast<const float*>(L.scales)[row];
  float* out = reinterpret_cast<float*>(L.x) + base;
  if (base + kLanes <= L.n) {
    float4 a[kSlots];
    if constexpr (kAdd) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        a[k] = *reinterpret_cast<const float4*>(out + slot_at(g, k));
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if constexpr (kAdd) {
        *reinterpret_cast<float4*>(out + slot_at(g, k)) = dequant_add4(c[k], s, a[k]);
      } else {
        __stcs(reinterpret_cast<float4*>(out + slot_at(g, k)), dequant4(c[k], s));
      }
    }
  } else {  // the leaf's last row: only its n outputs
    const int64_t left = L.n - base;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const signed char* q = reinterpret_cast<const signed char*>(&c[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = slot_at(g, k) + j;
        if (e < left)
          out[e] = kAdd ? __fmaf_rn((float)q[j], s, out[e]) : __fmul_rn((float)q[j], s);
      }
    }
  }
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
block_codec_multi_kernel(const __grid_constant__ Table t) {
  const int g = threadIdx.x % kRowThreads;   // this thread's place in its row group
  const int r_in = threadIdx.x / kRowThreads;  // its group's row within a pass
  const unsigned mask = group_mask();
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const Leaf L = t.leaves[work_table::leaf_of(t.leaves, t.n_leaves, c)];
    const int64_t row0 = (int64_t)(c - L.chunk0) * t.chunk_rows;
    const int64_t left = (L.n + kLanes - 1) / kLanes - row0;
    const int rows = (int)(left < t.chunk_rows ? left : t.chunk_rows);
    // a row's group is all in or all out of an iteration, so its shuffles
    // see every lane of the mask
    for (int r = r_in; r < rows; r += kRowsPerPass) {
      if constexpr (kOp == kQuantize) {
        quant_part(L, row0 + r, g, mask);
      } else {
        dequant_part<kOp == kDequantizeAdd>(L, row0 + r, g);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// #5 / #6: one scale for the whole buffer
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_nanmax(float m) {
  __shared__ float warp_max[kWarps];
  m = warp_nanmax(m);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_max[w] = m;
  __syncthreads();
  m = lane < kWarps ? warp_max[lane] : 0.0f;  // |x| >= 0: 0 is max's identity
  return warp_nanmax(m);                      // every warp ends with the block max
}

// #5's three-pass launcher, pass 1: each block's absmax over its grid-stride share
__global__ void absmax_partial_kernel(const float4* __restrict__ x, int64_t n4,
                                      float* __restrict__ partial) {
  float m = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    m = nanmax(m, absmax4(x[i]));
  }
  m = block_nanmax(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// its pass 2: one block reduces the partials and writes the scale
__global__ void scale_from_partials_kernel(const float* __restrict__ partial, int n_partial,
                                           float* __restrict__ scale) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) m = nanmax(m, partial[i]);
  m = block_nanmax(m);
  if (threadIdx.x == 0) scale[0] = scale_of(m);
}

// its pass 3: quantize every value with the one device-resident scale
__global__ void quant_scalar_kernel(const float4* __restrict__ x, const float* __restrict__ scale,
                                    char4* __restrict__ vals, int64_t n4) {
  const float s = scale[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    vals[i] = quant4(x[i], s);
  }
}

// #6: a warp takes 32 consecutive 16-byte chunks of int8 (512 values) a
// pass, one 16-byte load a thread. The chunks are staged in the warp's 512
// bytes of shared memory, and the warp writes them back as four float4
// stores, each covering 512 contiguous bytes (lane i's store k holds values
// 128k + 4i..+3 of the pass); a thread's own 16 values would put its float4s
// 64 bytes apart across the warp. n16: 16-value chunks, a multiple of 8 (a
// row of 128 lanes is 8 chunks), so a store is whole for the warp or absent.
__global__ void __launch_bounds__(kThreads)
dequant_scalar_kernel(const int4* __restrict__ vals, const float* __restrict__ scale,
                      float4* __restrict__ out, int64_t n16) {
  __shared__ int4 stage[kWarps][32];
  const float s = scale[0];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const char4* words = reinterpret_cast<const char4*>(stage[w]);
  const int64_t stride = (int64_t)gridDim.x * kWarps * 32;
  for (int64_t c0 = ((int64_t)blockIdx.x * kWarps + w) * 32; c0 < n16; c0 += stride) {
    const int64_t left = n16 - c0;
    if (lane < left) stage[w][lane] = vals[c0 + lane];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (8 * k < left) __stcs(out + c0 * 4 + 32 * k + lane, dequant4(words[32 * k + lane], s));
    }
    __syncwarp();  // the stage is read before the next pass writes it
  }
}

// #5 in one launch: quant_whole_kernel (the file's header). The buffer is
// cut into slots of kThreads float4s (a float4 a thread), and each CTA
// takes a contiguous run of them; kWholeUnroll slots' loads a thread in
// flight. The second pass takes the run last slot first (kReverse), so
// whatever the L2 still holds of the first pass's end is read from there.
constexpr int kWholeUnroll = 4;
constexpr bool kReverse = true;
constexpr unsigned kSpinLimit = 1u << 26;  // ~7 s of 100 ns naps: a grid that cannot all be
                                           // resident traps instead of hanging the card

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// scratch: [0] the arrival counter, zeroed before the launch; [1 +
// block] each CTA's partial absmax
__global__ void __launch_bounds__(kThreads)
quant_whole_kernel(const float4* __restrict__ x, int64_t n4, char4* __restrict__ vals,
                   float* __restrict__ scale, unsigned* __restrict__ scratch) {
  float* partial = reinterpret_cast<float*>(scratch + 1);
  const int64_t slots = (n4 + kThreads - 1) / kThreads;
  const int64_t per = (slots + gridDim.x - 1) / gridDim.x;
  const int64_t first = (int64_t)blockIdx.x * per;  // this CTA's first slot
  const int64_t mine = slots > first ? (slots - first < per ? slots - first : per) : 0;
  // the float4 this thread takes of the CTA's slot k (n4: none)
  auto at = [&](int64_t k) {
    const int64_t i = (first + k) * kThreads + threadIdx.x;
    return k < mine && i < n4 ? i : n4;
  };
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m = 0.0f;  // |x| >= 0: 0 is max's identity
  for (int64_t k = 0; k < mine; k += kWholeUnroll) {
    float4 v[kWholeUnroll];
#pragma unroll
    for (int u = 0; u < kWholeUnroll; ++u) {
      const int64_t i = at(k + u);
      v[u] = i < n4 ? x[i] : zero;
    }
#pragma unroll
    for (int u = 0; u < kWholeUnroll; ++u) m = nanmax(m, absmax4(v[u]));
  }
  m = block_nanmax(m);
  if (threadIdx.x == 0) {
    __stcg(partial + blockIdx.x, m);
    __threadfence();
    atomicAdd(scratch, 1u);
    unsigned spins = 0;
    while (load_acquire(scratch) < gridDim.x) {
      if (++spins > kSpinLimit) __trap();
      __nanosleep(100);
    }
    __threadfence();
  }
  __syncthreads();  // every partial is published
  float a = 0.0f;
  for (int c = threadIdx.x; c < (int)gridDim.x; c += kThreads) a = nanmax(a, __ldcg(partial + c));
  const float s = scale_of(block_nanmax(a));
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[0] = s;
  for (int64_t r = 0; r < mine; r += kWholeUnroll) {
    float4 v[kWholeUnroll];
    int64_t i[kWholeUnroll];
#pragma unroll
    for (int u = 0; u < kWholeUnroll; ++u) {
      i[u] = r + u < mine ? at(kReverse ? mine - 1 - (r + u) : r + u) : n4;
      v[u] = i[u] < n4 ? x[i[u]] : zero;
    }
#pragma unroll
    for (int u = 0; u < kWholeUnroll; ++u)
      if (i[u] < n4) vals[i[u]] = quant4(v[u], s);
  }
}

int grid_for(int64_t work, int64_t per_block, int max_blocks) {
  int64_t blocks = (work + per_block - 1) / per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each returns cudaGetLastError() after its launch(es) (0 = launched).

// Leaves one launch's work table may hold (the kernel-parameter limit).
int tmpi_block_codec_capacity() { return kCap; }

// One launch of #3 (op 0), #4 (op 1) or #4 with accumulate (op 2) over a
// work table of `n_leaves` rows (struct Leaf, host memory) holding `chunks`
// chunks of `chunk_rows` rows. Pointers aligned as the file's header says,
// checked by the wrappers in ops/quant.py.
int tmpi_block_codec_multi(int device, int op, const void* rows, int n_leaves, int chunks,
                           int chunk_rows, void* stream) {
  if (n_leaves < 1 || n_leaves > kCap || chunks < 1 || chunk_rows < 1 || op < kQuantize ||
      op > kDequantizeAdd)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Table t;
  t.n_leaves = n_leaves;
  t.chunks = chunks;
  t.chunk_rows = chunk_rows;
  t.op = op;
  memcpy(t.leaves, rows, (size_t)n_leaves * sizeof(Leaf));
  const int cap = work_table::sm_count(device) *
                  (op == kQuantize ? kQuantBlocksPerSm : kDequantBlocksPerSm);
  const int grid = chunks < cap ? chunks : cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == kQuantize) {
    block_codec_multi_kernel<kQuantize><<<grid, kThreads, 0, s>>>(t);
  } else if (op == kDequantize) {
    block_codec_multi_kernel<kDequantize><<<grid, kThreads, 0, s>>>(t);
  } else {
    block_codec_multi_kernel<kDequantizeAdd><<<grid, kThreads, 0, s>>>(t);
  }
  return (int)cudaGetLastError();
}

// #5 in one launch. scratch: 1 + max_blocks 4-byte words (the barrier's
// counter, zeroed here on the stream, and the partials); the grid is the
// work's, at most max_blocks and at most the CTAs that can be resident at
// once (the barrier needs every CTA running).
int tmpi_quant(int device, const void* x, void* vals, void* scale, void* scratch, int64_t rows,
               int max_blocks, void* stream) {
  if (rows < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quant_whole_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int64_t n4 = rows * (kLanes / 4);
  const int resident = per_sm * work_table::sm_count(device);
  const int grid = grid_for(n4, kThreads, max_blocks < resident ? max_blocks : resident);
  if ((err = cudaMemsetAsync(scratch, 0, sizeof(unsigned), s)) != cudaSuccess) return (int)err;
  quant_whole_kernel<<<grid, kThreads, 0, s>>>((const float4*)x, n4, (char4*)vals,
                                               (float*)scale, (unsigned*)scratch);
  return (int)cudaGetLastError();
}

// #5 as the three passes quant_whole_kernel replaced (no route takes it;
// kept for timing in turns). partial: scratch of n_partial floats
// (n_partial >= 1 blocks for pass 1).
int tmpi_quant_three_pass(int device, const void* x, void* vals, void* scale, void* partial,
                          int64_t rows, int n_partial, int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n4 = rows * (kLanes / 4);
  absmax_partial_kernel<<<grid_for(n4, kThreads, n_partial), kThreads, 0, s>>>(
      (const float4*)x, n4, (float*)partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scale_from_partials_kernel<<<1, kThreads, 0, s>>>(
      (const float*)partial, grid_for(n4, kThreads, n_partial), (float*)scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  quant_scalar_kernel<<<grid_for(n4, kThreads, max_blocks), kThreads, 0, s>>>(
      (const float4*)x, (const float*)scale, (char4*)vals, n4);
  return (int)cudaGetLastError();
}

// vals and out 16-byte aligned, scale 4-byte (checked by ops/quant.py)
int tmpi_dequant(int device, const void* vals, const void* scale, void* out, int64_t rows,
                 void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n16 = rows * (kLanes / 16);
  const int cap = work_table::sm_count(device) * kScalarDequantBlocksPerSm;
  const int grid = grid_for(n16, 32 * kWarps, cap);  // a warp a pass of 32 chunks
  dequant_scalar_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)vals, (const float*)scale, (float4*)out, n16);
  return (int)cudaGetLastError();
}

}  // extern "C"
