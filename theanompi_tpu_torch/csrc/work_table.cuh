// The work table of the port's multi-tensor kernels (csrc/fused_update.cu,
// csrc/quant.cu): one launch walks many leaves, each cut into chunks that
// are numbered from 0 across the launch. The table travels as the
// kernel's __grid_constant__ parameter: a header of the kernel's own,
// then one 40-byte row per leaf, whose last 8 bytes are the int32 index
// of the leaf's first chunk and one int32 of the kernel's own. The host
// side is ops/kernels.py (work_table, table_capacity, pack_rows).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace work_table {

#if CUDART_VERSION >= 12010
constexpr int kParamLimit = 32764;  // kernel-parameter bytes, CUDA >= 12.1 on Volta and later
#else
constexpr int kParamLimit = 4096;
#endif
constexpr int kRowBytes = 40;

// leaves a launch's table holds behind a header of `header_bytes`
constexpr int capacity(int header_bytes) { return (kParamLimit - header_bytes) / kRowBytes; }

// the last leaf whose first chunk is <= c: the leaf that chunk c belongs
// to (leaves[0].chunk0 == 0, first chunks ascending)
template <typename Leaf>
__device__ __forceinline__ int leaf_of(const Leaf* leaves, int n_leaves, int c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// SMs of `device`, cached per device (the grid is sized by SMs)
inline int sm_count(int device) {
  static int cache[64];
  if (device >= 0 && device < 64 && cache[device]) return cache[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1)
    n = 1;
  if (device >= 0 && device < 64) cache[device] = n;
  return n;
}

}  // namespace work_table
