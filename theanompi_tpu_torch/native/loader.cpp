// Native input-pipeline kernels of the port: the row gather, random
// crop + mirror, and crop + mirror + normalize of an image batch.
//
// The port's own copy of theanompi_tpu/native/loader.cpp, the same
// functions and the same bits (reference hot path: lib/proc_load_mpi.py,
// per-batch load, img_mean subtract, random crop and mirror in numpy in a
// spawned loader process; SURVEY.md section 3.4). Here the hot loop is
// C++, multithreaded and single-pass, called from the prefetch thread
// through ctypes, which releases the interpreter lock for the call: the
// gather does not stall the thread that launches the card's kernels.
// Built with the host g++ at first use (native/__init__.py).
//
// Layout contract: images are uint8 NHWC, contiguous; outputs are
// contiguous NHWC. Each image i is cropped at (oy[i], ox[i]) and
// flipped horizontally iff flip[i]; the normalizing variant writes
// float32 out = (u8 - mean) * scale, where mean is either a scalar
// (mean_len == 1), a per-channel vector (mean_len == c), or a full
// crop-sized plane (mean_len == crop_h*crop_w*c).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// The w pixels of srow in reverse order into drow, a whole pixel (c
// bytes) a copy; RGB's 3 bytes known at compile time.
inline void mirror_row(const uint8_t* srow, uint8_t* drow, int64_t w, int64_t c) {
  if (c == 3) {
    const uint8_t* s = srow + (w - 1) * 3;
    for (int64_t x = 0; x < w; ++x, s -= 3, drow += 3) __builtin_memcpy(drow, s, 3);
    return;
  }
  for (int64_t x = 0; x < w; ++x)
    __builtin_memcpy(drow + x * c, srow + (w - 1 - x) * c, static_cast<size_t>(c));
}

}  // namespace

extern "C" {

// Crop + mirror + normalize a batch. Returns 0 on success.
int tmpi_crop_mirror_normalize(
    const uint8_t* in,      // [n, h, w, c]
    int64_t n, int64_t h, int64_t w, int64_t c,
    const int32_t* oy,      // [n] crop row offsets
    const int32_t* ox,      // [n] crop col offsets
    const uint8_t* flip,    // [n] 0/1 horizontal mirror
    int64_t crop_h, int64_t crop_w,
    const float* mean,      // see mean_len contract above
    int64_t mean_len,
    float scale,
    float* out,             // [n, crop_h, crop_w, c]
    int n_threads) {
  if (crop_h > h || crop_w > w) return 1;
  if (!(mean_len == 1 || mean_len == c || mean_len == crop_h * crop_w * c))
    return 2;

  const int64_t in_row = w * c;
  const int64_t in_img = h * in_row;
  const int64_t out_row = crop_w * c;
  const int64_t out_img = crop_h * out_row;

  const bool plane = mean_len == crop_h * crop_w * c;
  auto work = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const uint8_t* src = in + i * in_img + oy[i] * in_row + ox[i] * c;
      float* dst = out + i * out_img;
      const bool f = flip[i] != 0;
      for (int64_t y = 0; y < crop_h; ++y) {
        const uint8_t* srow = src + y * in_row;
        float* drow = dst + y * out_row;
        if (c == 3 && !plane) {
          // a whole RGB pixel a step, the mean's three values hoisted
          const float m0 = mean[0];
          const float m1 = mean_len == 1 ? mean[0] : mean[1];
          const float m2 = mean_len == 1 ? mean[0] : mean[2];
          for (int64_t x = 0; x < crop_w; ++x) {
            // mirrored reads keep writes sequential (write locality wins)
            const uint8_t* spix = srow + (f ? crop_w - 1 - x : x) * 3;
            float* dpix = drow + x * 3;
            dpix[0] = (static_cast<float>(spix[0]) - m0) * scale;
            dpix[1] = (static_cast<float>(spix[1]) - m1) * scale;
            dpix[2] = (static_cast<float>(spix[2]) - m2) * scale;
          }
          continue;
        }
        const float* mrow = plane ? mean + y * out_row : mean;
        for (int64_t x = 0; x < crop_w; ++x) {
          const uint8_t* spix = srow + (f ? crop_w - 1 - x : x) * c;
          float* dpix = drow + x * c;
          const float* mpix = plane ? mrow + x * c : mean;
          for (int64_t ch = 0; ch < c; ++ch) {
            const float m = (mean_len == 1) ? mean[0] : mpix[ch];
            dpix[ch] = (static_cast<float>(spix[ch]) - m) * scale;
          }
        }
      }
    }
  };

  if (n_threads <= 1 || n < 2) {
    work(0, n);
    return 0;
  }
  const int t = static_cast<int>(
      std::min<int64_t>(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  const int64_t per = (n + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    const int64_t i0 = k * per;
    const int64_t i1 = std::min<int64_t>(i0 + per, n);
    if (i0 >= i1) break;
    threads.emplace_back(work, i0, i1);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Crop + mirror only, uint8 -> uint8 (the device-normalize pipeline:
// normalization happens on-TPU, so the host ships 4x fewer bytes).
int tmpi_crop_mirror_u8(
    const uint8_t* in,      // [n, h, w, c]
    int64_t n, int64_t h, int64_t w, int64_t c,
    const int32_t* oy, const int32_t* ox, const uint8_t* flip,
    int64_t crop_h, int64_t crop_w,
    uint8_t* out,           // [n, crop_h, crop_w, c]
    int n_threads) {
  if (crop_h > h || crop_w > w) return 1;
  const int64_t in_row = w * c;
  const int64_t in_img = h * in_row;
  const int64_t out_row = crop_w * c;
  const int64_t out_img = crop_h * out_row;
  auto work = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const uint8_t* src = in + i * in_img + oy[i] * in_row + ox[i] * c;
      uint8_t* dst = out + i * out_img;
      const bool f = flip[i] != 0;
      for (int64_t y = 0; y < crop_h; ++y) {
        const uint8_t* srow = src + y * in_row;
        uint8_t* drow = dst + y * out_row;
        if (!f) {
          __builtin_memcpy(drow, srow, static_cast<size_t>(out_row));
        } else {
          mirror_row(srow, drow, crop_w, c);
        }
      }
    }
  };
  if (n_threads <= 1 || n < 2) {
    work(0, n);
    return 0;
  }
  const int t = static_cast<int>(std::min<int64_t>(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  const int64_t per = (n + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    const int64_t i0 = k * per;
    const int64_t i1 = std::min<int64_t>(i0 + per, n);
    if (i0 >= i1) break;
    threads.emplace_back(work, i0, i1);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Gather rows of a [n_total, row_bytes] array into a contiguous batch
// (mmap shard -> batch assembly without numpy fancy-indexing). Rows are
// bytes: any fixed-width dtype (uint8 images, float32 images, int32
// token windows) gathers through it.
int tmpi_gather_rows(
    const uint8_t* in, int64_t row_bytes,
    const int64_t* idx, int64_t n,
    uint8_t* out, int n_threads) {
  auto work = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const uint8_t* src = in + idx[i] * row_bytes;
      uint8_t* dst = out + i * row_bytes;
      __builtin_memcpy(dst, src, static_cast<size_t>(row_bytes));
    }
  };
  if (n_threads <= 1 || n < 2) {
    work(0, n);
    return 0;
  }
  const int t = static_cast<int>(std::min<int64_t>(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  const int64_t per = (n + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    const int64_t i0 = k * per;
    const int64_t i1 = std::min<int64_t>(i0 + per, n);
    if (i0 >= i1) break;
    threads.emplace_back(work, i0, i1);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
