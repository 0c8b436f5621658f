// 3x3 / stride-1 / SAME max pool on NHWC tensors for Hopper (sm_90a):
// the forward, and Theano's all-maxima backward, from a halo tile staged in
// shared memory.
//
// Replaces the TPU kernels
//   theanompi_tpu/ops/pallas_pool.py:96   _fwd_kernel  (#12, called at :136)
//   theanompi_tpu/ops/pallas_pool.py:102  _bwd_kernel  (#13, called at :152)
// (reached through ops/pool.py: maxpool3x3_fwd, maxpool3x3_bwd).
//
// Function, per output element p = (n, h, w, c), exactly as the TPU kernels:
//   forward   y[p]  = the maximum of x over the 3x3 window around (h, w),
//                     positions outside the map reading -max of the dtype
//                     (not -inf). A NaN in the window gives NaN, as
//                     jnp.maximum propagates it: fp32 checks for it
//                     explicitly, bf16 takes the hardware's max.NaN on
//                     lane pairs (__hmax2_nan); fmaxf and __hmax would drop
//                     it.
//   backward  dx[p] = sum over (di, dj), di outer, from 0.0 in fp32, of
//                     (x[p] == y[q] ? g[q] : 0),  q = (n, h+di-1, w+dj-1, c),
//                     with y read as -max and g as 0 outside the map (the
//                     frame's term is +0.0 whatever x is); the comparison
//                     on the values (bf16: set.eq.bf16x2 on lane pairs,
//                     the same answers as fp32's), the sum cast once to
//                     x's dtype (round to nearest even).
// The forward takes its maxima in another order than the plain version's
// 9-way row-major one (below). A maximum with NaN propagation returns one
// of its inputs' bit patterns (or the canonical NaN), and on values other
// than +0 and -0 equal values have equal bits, so the order changes no bit
// but the sign of a zero maximum over +0 and -0, which is not pinned down.
// The backward's adds are order-sensitive and keep the plain version's
// order and its 9 adds (__fadd_rn; the build's -fmad=false changes nothing
// here). Both are bit-identical to ops/pool.py's plain versions in fp32
// and bf16, a NaN matching any NaN.
//
// Bound: device-memory bytes. The forward reads x and writes y once (2
// tensor passes), the backward reads x, y and g and writes dx (4 passes);
// the arithmetic is a few integer and float ops an element.
//
// What the grid-stride design this replaces lost: one thread per (pixel,
// 16 bytes of channels) decoded its index with five 64-bit divisions a
// thread iteration, took every bf16 lane's maximum or comparison one at a
// time in fp32, and read its 9 neighbours (18 for the backward, y and g)
// straight from L2: a CTA of 256 threads covered 2.5-10 pixels of one
// row, so the rows above and below belonged to other CTAs on other SMs.
// It read 27.5% (forward) and 46.7% (backward) of the bound at GoogLeNet's
// nine inception pools, batch 512, bf16 (NVIDIA H100 80GB HBM3, 700 W).
// Grafted onto this design (tools/pool_variants.py, same card), the 64-bit
// decode costs 0.09 ms (forward) and 0.40 ms (backward) a step of nine
// launches, and fp32 lanes 0.66 and 0.90 ms.
//
// Design: the halo tile. A CTA owns one image n, a block of cb channels
// (a power of two, at most 64), a band of bh output rows and bw <= 32
// output columns. It stages the (bh + 2) x (bw + 2) x cb halo of its input
// (x for the forward; y and g for the backward) in shared memory with
// 16-byte cp.async copies (plain loads into the tile cost 0.27 and 1.26
// ms a step more: fewer bytes in flight a thread); the frame cells are
// written by the kernel (-max, or 0 for g), never read, since cp.async
// has no fill value and TMA's out-of-bounds fill is zero or NaN, never
// -max. Each input element crosses into the SM once per CTA that needs it;
// the only re-read is the two halo rows of a band shorter than its map
// (none where one band holds the whole map: GoogLeNet's 14x14 and 7x7
// maps), and those rows are the neighbouring band's, launched a few CTAs
// earlier, so they mostly hit L2. The tile's layout is [row][column][16-byte
// word], so a warp's threads, on consecutive (column, word) pairs, read
// consecutive 16-byte words of shared memory: no bank conflicts without
// padding.
// A thread owns one output column and one 16-byte word of channels and
// walks down the band. The forward keeps the horizontal maxima of 3 tile
// rows in registers: h[r] = max(x[r][w-1], x[r][w], x[r][w+1]), y[r] =
// max(h[r-1], h[r], h[r+1]): 4 maxima an output and 3 shared-memory reads
// a row, not 8 and 9. The backward keeps a 3x3 window of y and g words in
// registers, the three rows taking turns, and loads 3 of each a row; x
// goes straight from device memory to registers at the thread's own
// outputs, two rows ahead of its use.
// The launch plan (bands, column tiles, channel blocks, threads, shared
// bytes) is computed by the wrapper (ops/pool.py: tile_plan) and passed in
// as plain integers; the kernel decodes its tile from blockIdx.x (n folded
// in, so N is not bound by gridDim.y's 65,535) with 32-bit arithmetic and
// uses no 64-bit division; offsets into the tensors stay 64-bit products.
// Tile budgets: 18,432 elements a staged tensor, 36 KB in bf16 and 72 KB
// in fp32, so at every inception shape in bf16 at least 3 backward CTAs
// (two tiles each) and 6 forward CTAs fit an SM by shared memory, and in
// fp32 at least one backward CTA. Above 48 KB a kernel instantiation gets
// cudaFuncAttributeMaxDynamicSharedMemorySize once per device.
// What holds the backward back (tools/pool_variants.py): with its
// arithmetic removed (each output its x) it still takes 1.46 ms a step
// against the 1.14 ms bound, and the arithmetic adds the other 0.25 ms.
// Bands of 4 or 14 rows, channel blocks of 16 or 32, and 2 or 3 CTAs an
// SM forced by shared memory or registers are all slower, and so is
// staging each tile row behind its own mbarrier.
// A C whose row is not a whole number of 16-byte words, or a base that is
// not 16-byte aligned, takes the same tiled kernel one channel a word
// (VEC = 1, plain loads into the tile).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a CTA may have on sm_90
constexpr int kMaxDevices = 64;

// storage type, rounding from fp32 (and bf16's exact fp32 view), -max
struct F32 {
  using S = float;
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

// VEC consecutive channels: one 16-byte word on the vector path, one
// element on the VEC = 1 path
template <typename S, int VEC>
struct alignas(VEC * sizeof(S)) Pack {
  static constexpr bool kWide = VEC * sizeof(S) == 16;
  S v[VEC];
};

template <int VEC>
__host__ __device__ constexpr int log2_of() {
  return VEC == 8 ? 3 : VEC == 4 ? 2 : VEC == 2 ? 1 : 0;
}

// The launch plan (ops/pool.py: tile_plan), as the kernel reads it
struct Tile {
  int H, W, C;
  int bh, bw, cb_log2;         // band rows, tile columns, log2 of the channel block
  int bands, ctiles, cblocks;  // per image
};

// One CTA's tile, from blockIdx.x: channel block fastest, then column
// tile, band and image, so a band's upper and lower neighbours run a few
// CTAs before and after it
struct Where {
  int n, h0, w0, c0;
  int rows, cols;  // output rows and columns of this tile
  int shift;       // log2 of the words a pixel takes in the tile
  int units;       // words of this channel block that hold channels
};

template <int VEC>
__device__ __forceinline__ Where locate(const Tile& t) {
  unsigned b = blockIdx.x;
  const unsigned cblk = b % (unsigned)t.cblocks;
  b /= (unsigned)t.cblocks;
  const unsigned ct = b % (unsigned)t.ctiles;
  b /= (unsigned)t.ctiles;
  const unsigned band = b % (unsigned)t.bands;
  Where o;
  o.n = (int)(b / (unsigned)t.bands);
  o.h0 = (int)band * t.bh;
  o.w0 = (int)ct * t.bw;
  o.c0 = (int)cblk << t.cb_log2;
  o.rows = min(t.bh, t.H - o.h0);
  o.cols = min(t.bw, t.W - o.w0);
  o.shift = t.cb_log2 - log2_of<VEC>();
  o.units = min(1 << o.shift, (t.C - o.c0) / VEC);
  return o;
}

template <typename P>
__device__ __forceinline__ void copy_unit(P* dst, const P* src) {
  if constexpr (P::kWide) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename P>
__device__ __forceinline__ P load_global(const P* p) {
  if constexpr (P::kWide) {
    union {
      uint4 u;
      P p;
    } w;
    w.u = __ldg(reinterpret_cast<const uint4*>(p));
    return w.p;
  } else {
    return *p;
  }
}

// Stage the (rows + 2) x (cols + 2) halo of src's channel block into
// tile[(r * (cols + 2) + c) << shift | u]; cells outside the map get
// frame in every channel.
template <typename P, typename S>
__device__ __forceinline__ void stage(P* tile, const S* __restrict__ src, S frame,
                                      const Tile& t, const Where& o, int vec) {
  const int per_row = (o.cols + 2) << o.shift;
  const int mask = (1 << o.shift) - 1;
  const int64_t img = (int64_t)o.n * t.H * t.W * t.C + o.c0;
  P fill;
#pragma unroll
  for (int k = 0; k < (int)(sizeof(P) / sizeof(S)); ++k) fill.v[k] = frame;
  for (int r = 0; r < o.rows + 2; ++r) {
    const int hh = o.h0 - 1 + r;
    const bool row_in = hh >= 0 && hh < t.H;
    const int64_t row = img + (int64_t)hh * t.W * t.C;
    for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
      const int u = i & mask;
      if (u >= o.units) continue;
      const int ww = o.w0 - 1 + (i >> o.shift);
      P* dst = tile + r * per_row + i;
      if (row_in && ww >= 0 && ww < t.W) {
        copy_unit(dst, reinterpret_cast<const P*>(src + row + (int64_t)ww * t.C + u * vec));
      } else {
        *dst = fill;
      }
    }
  }
}

// maximum(a, b) as jnp.maximum: NaN stays NaN; a NaN or a larger b replaces
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a == a && (b != b || b > a)) ? b : a;
}

// The lane-wise maximum of two words, a NaN in either lane giving NaN. fp32:
// the explicit check (fmaxf would drop a NaN). bf16: the hardware's
// max.NaN on lane pairs (__hmax2_nan), which returns one of its inputs' bit
// patterns or the canonical NaN (__hmax would drop a NaN).
template <int VEC>
__device__ __forceinline__ Pack<float, VEC> vmax(const Pack<float, VEC>& a,
                                                 const Pack<float, VEC>& b) {
  Pack<float, VEC> r;
#pragma unroll
  for (int k = 0; k < VEC; ++k) r.v[k] = max_nan(a.v[k], b.v[k]);
  return r;
}

template <int VEC>
__device__ __forceinline__ Pack<uint16_t, VEC> vmax(const Pack<uint16_t, VEC>& a,
                                                    const Pack<uint16_t, VEC>& b) {
  Pack<uint16_t, VEC> r;
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j)
      reinterpret_cast<__nv_bfloat162*>(r.v)[j] =
          __hmax2_nan(reinterpret_cast<const __nv_bfloat162*>(a.v)[j],
                      reinterpret_cast<const __nv_bfloat162*>(b.v)[j]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      r.v[k] = __bfloat16_as_ushort(
          __hmax_nan(__ushort_as_bfloat16(a.v[k]), __ushort_as_bfloat16(b.v[k])));
  }
  return r;
}

// the horizontal maximum of three neighbouring words of one tile row
template <typename P>
__device__ __forceinline__ P hmax3(const P* at, int stride) {
  return vmax(vmax(at[0], at[stride]), at[2 * stride]);
}

// acc[k] = acc[k] + (x[k] == y[k] ? g[k] : 0.0f) lane by lane, rounded to
// nearest: the comparison on the values (+0 == -0; a NaN equals nothing).
// bf16: one set.eq.bf16x2 mask a lane pair (__heq2_mask), g masked and
// widened to fp32 exactly; an unmatched lane adds +0.0, as the plain
// version's where(..., 0.0) does.
template <int VEC>
__device__ __forceinline__ void add_term(float (&acc)[VEC], const Pack<float, VEC>& x,
                                         const Pack<float, VEC>& y, const Pack<float, VEC>& g) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], x.v[k] == y.v[k] ? g.v[k] : 0.0f);
}

template <int VEC>
__device__ __forceinline__ void add_term(float (&acc)[VEC], const Pack<uint16_t, VEC>& x,
                                         const Pack<uint16_t, VEC>& y,
                                         const Pack<uint16_t, VEC>& g) {
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const unsigned m = __heq2_mask(reinterpret_cast<const __nv_bfloat162*>(x.v)[j],
                                     reinterpret_cast<const __nv_bfloat162*>(y.v)[j]);
      const unsigned s = reinterpret_cast<const unsigned*>(g.v)[j] & m;
      acc[2 * j] = __fadd_rn(acc[2 * j], __uint_as_float(s << 16));
      acc[2 * j + 1] = __fadd_rn(acc[2 * j + 1], __uint_as_float(s & 0xFFFF0000u));
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = __fadd_rn(acc[k], BF16::f(x.v[k]) == BF16::f(y.v[k]) ? BF16::f(g.v[k]) : 0.0f);
  }
}

// the sums rounded once to the storage dtype (round to nearest even);
// bf16 lane pairs in one conversion
template <int VEC>
__device__ __forceinline__ void round_out(const float (&acc)[VEC], Pack<float, VEC>& r) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) r.v[k] = acc[k];
}

template <int VEC>
__device__ __forceinline__ void round_out(const float (&acc)[VEC], Pack<uint16_t, VEC>& r) {
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j)
      reinterpret_cast<__nv_bfloat162*>(r.v)[j] =
          __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.v[k] = BF16::from(acc[k]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
maxpool_fwd_tile_kernel(const typename T::S* __restrict__ x, typename T::S* __restrict__ y,
                        const Tile t) {
  using S = typename T::S;
  using P = Pack<S, VEC>;
  extern __shared__ uint4 smem[];
  P* tile = reinterpret_cast<P*>(smem);
  const Where o = locate<VEC>(t);
  stage(tile, x, T::neg_max(), t, o, VEC);
  copies_done();
  __syncthreads();

  const int stride = 1 << o.shift;  // one tile column
  const int per_row = (o.cols + 2) << o.shift;
  const int mask = stride - 1;
  const int64_t row_step = (int64_t)t.W * t.C;
  for (int p = threadIdx.x; p < (o.cols << o.shift); p += blockDim.x) {
    const int u = p & mask, w = p >> o.shift;
    if (u >= o.units) continue;
    // tile column w is output column w's left neighbour: p indexes it in row 0
    const P* col = tile + p;
    int64_t off = (int64_t)o.n * t.H * row_step + (int64_t)o.h0 * row_step +
                  (int64_t)(o.w0 + w) * t.C + o.c0 + u * VEC;
    // horizontal maxima of tile rows r, r + 1, r + 2
    P a = hmax3(col, stride), b = hmax3(col + per_row, stride);
    for (int r = 0; r < o.rows; ++r) {
      const P c = hmax3(col + (r + 2) * per_row, stride);
      *reinterpret_cast<P*>(y + off) = vmax(vmax(a, b), c);
      off += row_step;
      a = b;
      b = c;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
maxpool_bwd_tile_kernel(const typename T::S* __restrict__ x, const typename T::S* __restrict__ y,
                        const typename T::S* __restrict__ g, typename T::S* __restrict__ dx,
                        const Tile t) {
  using S = typename T::S;
  using P = Pack<S, VEC>;
  extern __shared__ uint4 smem[];
  const Where o = locate<VEC>(t);
  P* ty = reinterpret_cast<P*>(smem);
  P* tg = ty + ((t.bh + 2) * (t.bw + 2) << o.shift);
  stage(ty, y, T::neg_max(), t, o, VEC);
  stage(tg, g, T::from(0.0f), t, o, VEC);
  copies_done();
  __syncthreads();

  const int stride = 1 << o.shift;
  const int per_row = (o.cols + 2) << o.shift;
  const int mask = stride - 1;
  const int64_t row_step = (int64_t)t.W * t.C;
  for (int p = threadIdx.x; p < (o.cols << o.shift); p += blockDim.x) {
    const int u = p & mask, w = p >> o.shift;
    if (u >= o.units) continue;
    const int64_t off = (int64_t)o.n * t.H * row_step + (int64_t)o.h0 * row_step +
                        (int64_t)(o.w0 + w) * t.C + o.c0 + u * VEC;
    // the window: three tile rows of y and g words, each at tile columns
    // w .. w + 2 (output columns w - 1 .. w + 1), and x at the thread's own
    // outputs, loaded two rows ahead of its use; the rows take turns as the
    // band is walked, so no word moves between registers
    P y0[3], g0[3], y1[3], g1[3], y2[3], g2[3], x0, x1, x2;
    auto load = [&](P (&wy)[3], P (&wg)[3], P& xs, int r) {  // tile row r, output row r
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        wy[dj] = ty[r * per_row + p + dj * stride];
        wg[dj] = tg[r * per_row + p + dj * stride];
      }
      if (r < o.rows)
        xs = load_global(reinterpret_cast<const P*>(x + off + (int64_t)r * row_step));
    };
    // output row r from tile rows r (ya, ga), r + 1 and r + 2: di outer, dj inner
    auto emit = [&](const P& xs, const P (&ya)[3], const P (&ga)[3], const P (&yb)[3],
                    const P (&gb)[3], const P (&yc)[3], const P (&gc)[3], int r) {
      const int64_t at = off + (int64_t)r * row_step;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) add_term(acc, xs, ya[dj], ga[dj]);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) add_term(acc, xs, yb[dj], gb[dj]);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) add_term(acc, xs, yc[dj], gc[dj]);
      P out;
      round_out(acc, out);
      *reinterpret_cast<P*>(dx + at) = out;
    };
    load(y0, g0, x0, 0);
    load(y1, g1, x1, 1);
    for (int r = 0; r < o.rows; r += 3) {
      load(y2, g2, x2, r + 2);
      emit(x0, y0, g0, y1, g1, y2, g2, r);
      if (r + 1 >= o.rows) break;
      load(y0, g0, x0, r + 3);
      emit(x1, y1, g1, y2, g2, y0, g0, r + 1);
      if (r + 2 >= o.rows) break;
      load(y1, g1, x1, r + 4);
      emit(x2, y2, g2, y0, g0, y1, g1, r + 2);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Above 48 KB of dynamic shared memory a kernel must be allowed it: once
// per instantiation (each call site keeps its own flags) and device.
template <typename K>
cudaError_t allow_smem(K kernel, bool (&done)[kMaxDevices], int device, int smem) {
  if (smem <= 48 * 1024 || (device < kMaxDevices && done[device])) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

struct Launch {
  int device, blocks, threads, smem;
  cudaStream_t stream;
};

// dtype codes shared with ops/kernels.py
enum { kF32 = 0, kBF16 = 1 };

template <typename T>
int launch_fwd(const void* x, void* y, const Tile& t, const Launch& l) {
  using S = typename T::S;
  constexpr int V = 16 / sizeof(S);
  if ((t.C * sizeof(S)) % 16 == 0 && aligned16(x) && aligned16(y)) {
    static bool done[kMaxDevices] = {};
    const cudaError_t err = allow_smem(maxpool_fwd_tile_kernel<T, V>, done, l.device, l.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_fwd_tile_kernel<T, V><<<l.blocks, l.threads, l.smem, l.stream>>>(
        (const S*)x, (S*)y, t);
  } else {
    static bool done[kMaxDevices] = {};
    const cudaError_t err = allow_smem(maxpool_fwd_tile_kernel<T, 1>, done, l.device, l.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_fwd_tile_kernel<T, 1><<<l.blocks, l.threads, l.smem, l.stream>>>(
        (const S*)x, (S*)y, t);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, void* dx, const Tile& t,
               const Launch& l) {
  using S = typename T::S;
  constexpr int V = 16 / sizeof(S);
  if ((t.C * sizeof(S)) % 16 == 0 && aligned16(x) && aligned16(y) && aligned16(g) &&
      aligned16(dx)) {
    static bool done[kMaxDevices] = {};
    const cudaError_t err = allow_smem(maxpool_bwd_tile_kernel<T, V>, done, l.device, l.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_bwd_tile_kernel<T, V><<<l.blocks, l.threads, l.smem, l.stream>>>(
        (const S*)x, (const S*)y, (const S*)g, (S*)dx, t);
  } else {
    static bool done[kMaxDevices] = {};
    const cudaError_t err = allow_smem(maxpool_bwd_tile_kernel<T, 1>, done, l.device, l.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_bwd_tile_kernel<T, 1><<<l.blocks, l.threads, l.smem, l.stream>>>(
        (const S*)x, (const S*)y, (const S*)g, (S*)dx, t);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmpi_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each takes the wrapper's launch plan (ops/pool.py: tile_plan) and
// returns cudaGetLastError() after the launch (0 = launched).
int tmpi_maxpool3x3_fwd(int device, int dtype, const void* x, void* y, int H, int W, int C,
                        int bh, int bw, int cb_log2, int bands, int ctiles, int cblocks,
                        int blocks, int threads, int smem, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Tile t{H, W, C, bh, bw, cb_log2, bands, ctiles, cblocks};
  const Launch l{device, blocks, threads, smem, (cudaStream_t)stream};
  if (dtype == kF32) return launch_fwd<F32>(x, y, t, l);
  if (dtype == kBF16) return launch_fwd<BF16>(x, y, t, l);
  return (int)cudaErrorInvalidValue;
}

int tmpi_maxpool3x3_bwd(int device, int dtype, const void* x, const void* y, const void* g,
                        void* dx, int H, int W, int C, int bh, int bw, int cb_log2, int bands,
                        int ctiles, int cblocks, int blocks, int threads, int smem,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Tile t{H, W, C, bh, bw, cb_log2, bands, ctiles, cblocks};
  const Launch l{device, blocks, threads, smem, (cudaStream_t)stream};
  if (dtype == kF32) return launch_bwd<F32>(x, y, g, dx, t, l);
  if (dtype == kBF16) return launch_bwd<BF16>(x, y, g, dx, t, l);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
