// Fused optimizer epilogue for Hopper (sm_90a): weight decay + clip
// coefficient + momentum/Nesterov (or plain SGD) + parameter write in ONE
// pass over device memory, one launch per parameter leaf.
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
// (16 B with fp32 grads), against ~7 fp32 operations — far below the
// H100's operations-per-byte ridge. For AlexNet's 60,965,224 fp32
// parameters that is 1.219 GB per step, 0.364 ms at the H100 SXM's
// 3.35 TB/s. The design does the one thing that matters for a bytes-bound
// pass: it touches each byte once (the unfused tree-map path moves each
// leaf about four times). The TPU kernel's (rows, 128) lane padding is
// not carried over: the grid-stride loop runs over the unpadded flat
// leaf. lr and coef are read from a 2-element fp32 DEVICE buffer, so a
// training step never syncs with the host. Launch per leaf; a
// multi-tensor launch over all leaves is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// dtype codes shared with ops/fused_update.py
enum { kF32 = 0, kBF16 = 1 };

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 = launched).
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
