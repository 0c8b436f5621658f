// 3x3 / stride-1 / SAME max pool on NHWC tensors for Hopper (sm_90a):
// the forward, and Theano's all-maxima backward.
//
// Replaces the TPU kernels
//   theanompi_tpu/ops/pallas_pool.py:96   _fwd_kernel  (#12, called at :136)
//   theanompi_tpu/ops/pallas_pool.py:102  _bwd_kernel  (#13, called at :152)
// (reached through ops/pool.py: maxpool3x3_fwd, maxpool3x3_bwd).
//
// Function, per output element p = (n, h, w, c), exactly as the TPU kernels:
//   forward   y[p]  = max over (di, dj) in 0..2 x 0..2, di outer, of
//                     x[n, h+di-1, w+dj-1, c], positions outside the map
//                     reading -max of the dtype (not -inf). A NaN in the
//                     window gives NaN (jnp.maximum propagates it; fmaxf and
//                     __hmax would drop it, so the check is explicit).
//   backward  dx[p] = sum over (di, dj), di outer, from 0.0 in fp32, of
//                     (x[p] == y[q] ? g[q] : 0),  q = (n, h+di-1, w+dj-1, c),
//                     with y read as fp32 -max and g as 0 outside the map;
//                     the comparison in fp32 (bf16 embeds exactly), the sum
//                     cast once to x's dtype (round to nearest even).
// Each output element does the same 9 maxima or the same 9 adds in the same
// order as the plain PyTorch version (ops/pool.py), so both kernels are bit
// identical to it in fp32 and bf16; there is no multiply, so the build's
// -fmad=false changes nothing here. The forward returns one of the input's
// (or the border's) own bit patterns; of two equal values it keeps the first,
// so only the sign of a zero maximum over +0 and -0 is not pinned down.
//
// Bound: device-memory bytes. The forward reads x and writes y once (2
// tensor passes), the backward reads x, y and g and writes dx (4 passes);
// there is no arithmetic to speak of. Design: one thread per (n, h, w, group
// of 8 channels), neighbouring threads on neighbouring 16-byte chunks along
// C, so each of the 9 shifted reads is a coalesced 16-byte load (two for
// fp32), and the 9x re-reads of a neighbourhood hit L1/L2, not device
// memory. On the TPU a +-1 shift along W was a sublane shuffle (why the
// reference rejected the kernel there); here it is an address offset. A C
// that is not a multiple of 8, or a base that is not 16-byte aligned, takes
// the same code one channel per thread. Grid-stride loop, launch per call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels per thread on the vector path

// storage type, its fp32 view, and -max of the dtype as stored
struct F32 {
  using S = float;
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ float neg_max() { return -3.40282346638528859812e+38f; }
};

struct BF16 {
  using S = uint16_t;
  static __device__ __forceinline__ float f(uint16_t b) {
    return __uint_as_float(((unsigned int)b) << 16);  // exact
  }
  static __device__ __forceinline__ uint16_t from(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ uint16_t neg_max() { return (uint16_t)0xFF7Fu; }
};

// VEC consecutive elements: 16-byte loads/stores when VEC * sizeof(S) is a
// multiple of 16 (the caller guarantees the alignment), else one at a time
template <typename S, int VEC>
struct Pack {
  static constexpr bool kWide = (VEC * sizeof(S)) % 16 == 0;
  static constexpr int kWords = kWide ? (int)(VEC * sizeof(S) / 16) : 1;
  union {
    uint4 u[kWords];
    S v[VEC];
  };
  __device__ __forceinline__ void load(const S* p) {
    if constexpr (kWide) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) u[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = p[k];
    }
  }
  __device__ __forceinline__ void store(S* p) const {
    if constexpr (kWide) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) reinterpret_cast<uint4*>(p)[k] = u[k];
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) p[k] = v[k];
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const typename T::S* __restrict__ x, typename T::S* __restrict__ y,
                   int64_t N, int H, int W, int C) {
  using S = typename T::S;
  const int groups = C / VEC;
  const int64_t total = N * H * W * groups;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int cg = (int)(i % groups);
    const int64_t pix = i / groups;
    const int w = (int)(pix % W);
    const int h = (int)((pix / W) % H);
    const int64_t n = pix / ((int64_t)W * H);
    const S* img = x + n * H * W * C + cg * VEC;
    Pack<S, VEC> best;
    float bf[VEC];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int hh = h + di - 1, ww = w + dj - 1;
        Pack<S, VEC> s;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
          s.load(img + ((int64_t)hh * W + ww) * C);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) s.v[k] = T::neg_max();
        }
        if (di == 0 && dj == 0) {
          best = s;
#pragma unroll
          for (int k = 0; k < VEC; ++k) bf[k] = T::f(s.v[k]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float sf = T::f(s.v[k]);
            // maximum(best, s): NaN stays NaN; a NaN or a larger s replaces
            if (bf[k] == bf[k] && (sf != sf || sf > bf[k])) {
              best.v[k] = s.v[k];
              bf[k] = sf;
            }
          }
        }
      }
    }
    best.store(y + pix * C + cg * VEC);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const typename T::S* __restrict__ x, const typename T::S* __restrict__ y,
                   const typename T::S* __restrict__ g, typename T::S* __restrict__ dx,
                   int64_t N, int H, int W, int C) {
  using S = typename T::S;
  const int groups = C / VEC;
  const int64_t total = N * H * W * groups;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int cg = (int)(i % groups);
    const int64_t pix = i / groups;
    const int w = (int)(pix % W);
    const int h = (int)((pix / W) % H);
    const int64_t n = pix / ((int64_t)W * H);
    const int64_t base = n * H * W * C + cg * VEC;
    Pack<S, VEC> xs;
    xs.load(x + pix * C + cg * VEC);
    float xf[VEC], acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      xf[k] = T::f(xs.v[k]);
      acc[k] = 0.0f;
    }
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int hh = h + di - 1, ww = w + dj - 1;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const int64_t off = base + ((int64_t)hh * W + ww) * C;
          Pack<S, VEC> ys, gs;
          ys.load(y + off);
          gs.load(g + off);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] = __fadd_rn(acc[k], T::f(ys.v[k]) == xf[k] ? T::f(gs.v[k]) : 0.0f);
        } else {
          // the frame: y is fp32 -max and g is 0, so the term is 0 whatever
          // x is; adding it keeps the plain version's 9 adds
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], 0.0f);
        }
      }
    }
    Pack<S, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = T::from(acc[k]);
    out.store(dx + pix * C + cg * VEC);
  }
}

int grid_for(int64_t work, int max_blocks) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)(blocks < 1 ? 1 : blocks);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// dtype codes shared with ops/kernels.py
enum { kF32 = 0, kBF16 = 1 };

template <typename T>
int launch_fwd(const void* x, void* y, int64_t N, int H, int W, int C, int max_blocks,
               cudaStream_t s) {
  using S = typename T::S;
  if (C % kVec == 0 && aligned16(x) && aligned16(y)) {
    maxpool_fwd_kernel<T, kVec><<<grid_for(N * H * W * (C / kVec), max_blocks), kThreads, 0, s>>>(
        (const S*)x, (S*)y, N, H, W, C);
  } else {
    maxpool_fwd_kernel<T, 1><<<grid_for(N * H * W * C, max_blocks), kThreads, 0, s>>>(
        (const S*)x, (S*)y, N, H, W, C);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, void* dx, int64_t N, int H, int W,
               int C, int max_blocks, cudaStream_t s) {
  using S = typename T::S;
  if (C % kVec == 0 && aligned16(x) && aligned16(y) && aligned16(g) && aligned16(dx)) {
    maxpool_bwd_kernel<T, kVec><<<grid_for(N * H * W * (C / kVec), max_blocks), kThreads, 0, s>>>(
        (const S*)x, (const S*)y, (const S*)g, (S*)dx, N, H, W, C);
  } else {
    maxpool_bwd_kernel<T, 1><<<grid_for(N * H * W * C, max_blocks), kThreads, 0, s>>>(
        (const S*)x, (const S*)y, (const S*)g, (S*)dx, N, H, W, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each returns cudaGetLastError() after the launch (0 = launched).
int tmpi_maxpool3x3_fwd(int device, int dtype, const void* x, void* y, int64_t N, int H, int W,
                        int C, int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch_fwd<F32>(x, y, N, H, W, C, max_blocks, s);
  if (dtype == kBF16) return launch_fwd<BF16>(x, y, N, H, W, C, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

int tmpi_maxpool3x3_bwd(int device, int dtype, const void* x, const void* y, const void* g,
                        void* dx, int64_t N, int H, int W, int C, int max_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch_bwd<F32>(x, y, g, dx, N, H, W, C, max_blocks, s);
  if (dtype == kBF16) return launch_bwd<BF16>(x, y, g, dx, N, H, W, C, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
