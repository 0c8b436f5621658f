// int8 absmax quantizer kernels for Hopper (sm_90a): the building block of
// the compressed gradient wire (--wire-codec int8[:ef], --strategy
// ring_int8). The flat f32 buffer is viewed as (rows, 128) lanes.
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
//   out   = float(q) * scale
// Built with -fmad=false and without --use_fast_math (-prec-div stays on,
// no flush of denormals), so every operation rounds as IEEE float.
//
// Bound: device-memory bytes. #3 reads 4 B and writes 1 B + 4/128 B of
// scale per element (5.03 B); #4 the reverse. A few operations per byte,
// far below the card's ridge. Design for the bytes: each element is read
// once and written once with 16-byte loads (float4) and 4-byte stores
// (char4); #3 is one warp per 128-lane row (each lane 4 floats, the
// row's absmax by warp shuffles, no shared memory); #4 one thread per 4
// values. Both are grid-stride loops over a capped grid. The whole-buffer
// #5 needs a reduction across blocks, which Hopper's blocks cannot carry
// between them as the TPU's sequential grid can: pass 1 writes each
// block's absmax to scratch, pass 2 (one block) reduces those and writes
// the scale to device memory, pass 3 quantizes with it. No host sync.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFloor = 1e-30f;
constexpr float kInv127 = 1.0f / 127.0f;

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

// #3: one warp per row; lane l holds the row's floats 4l..4l+3
__global__ void quant_block_kernel(const float4* __restrict__ x, char4* __restrict__ vals,
                                   float* __restrict__ scales, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < rows; r += n_warps) {
    const int64_t i = r * (kLanes / 4) + lane;
    const float4 v = x[i];
    const float s = scale_of(warp_nanmax(absmax4(v)));
    if (lane == 0) scales[r] = s;
    vals[i] = quant4(v, s);
  }
}

__device__ __forceinline__ float4 dequant_add4(char4 q, float s, float4 a) {
  return make_float4(__fmaf_rn((float)q.x, s, a.x), __fmaf_rn((float)q.y, s, a.y),
                     __fmaf_rn((float)q.z, s, a.z), __fmaf_rn((float)q.w, s, a.w));
}

// #4: one thread per 4 values; row r's 32 char4 share scales[r]. With
// `accumulate` it adds into `out` with one rounding (the ring's decode
// and add as the reference compiles them: an fma)
__global__ void dequant_block_kernel(const char4* __restrict__ vals,
                                     const float* __restrict__ scales,
                                     float4* __restrict__ out, int64_t n4, int accumulate) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float s = scales[i / (kLanes / 4)];
    out[i] = accumulate ? dequant_add4(vals[i], s, out[i]) : dequant4(vals[i], s);
  }
}

__device__ __forceinline__ float block_nanmax(float m) {
  __shared__ float warp_max[kWarps];
  m = warp_nanmax(m);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_max[w] = m;
  __syncthreads();
  m = lane < kWarps ? warp_max[lane] : 0.0f;  // |x| >= 0: 0 is max's identity
  return warp_nanmax(m);                      // every warp ends with the block max
}

// #5 pass 1: each block's absmax over its grid-stride share
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

// #5 pass 2: one block reduces the partials and writes the scale
__global__ void scale_from_partials_kernel(const float* __restrict__ partial, int n_partial,
                                           float* __restrict__ scale) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) m = nanmax(m, partial[i]);
  m = block_nanmax(m);
  if (threadIdx.x == 0) scale[0] = scale_of(m);
}

// #5 pass 3: quantize every value with the one device-resident scale
__global__ void quant_scalar_kernel(const float4* __restrict__ x, const float* __restrict__ scale,
                                    char4* __restrict__ vals, int64_t n4) {
  const float s = scale[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    vals[i] = quant4(x[i], s);
  }
}

// #6
__global__ void dequant_scalar_kernel(const char4* __restrict__ vals,
                                      const float* __restrict__ scale,
                                      float4* __restrict__ out, int64_t n4) {
  const float s = scale[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    out[i] = dequant4(vals[i], s);
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
// rows > 0; pointers 16-byte (float4) / 4-byte (char4, scales) aligned,
// checked by the wrappers in ops/quant.py.

int tmpi_quant_block(int device, const void* x, void* vals, void* scales, int64_t rows,
                     int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  quant_block_kernel<<<grid_for(rows, kWarps, max_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (char4*)vals, (float*)scales, rows);
  return (int)cudaGetLastError();
}

int tmpi_dequant_block(int device, const void* vals, const void* scales, void* out,
                       int64_t rows, int accumulate, int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n4 = rows * (kLanes / 4);
  dequant_block_kernel<<<grid_for(n4, kThreads, max_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const char4*)vals, (const float*)scales, (float4*)out, n4, accumulate);
  return (int)cudaGetLastError();
}

// partial: scratch of n_partial floats (n_partial >= 1 blocks for pass 1)
int tmpi_quant(int device, const void* x, void* vals, void* scale, void* partial,
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

int tmpi_dequant(int device, const void* vals, const void* scale, void* out, int64_t rows,
                 int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n4 = rows * (kLanes / 4);
  dequant_scalar_kernel<<<grid_for(n4, kThreads, max_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const char4*)vals, (const float*)scale, (float4*)out, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
