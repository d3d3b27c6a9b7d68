// Host batch assembler of the port's data pipeline: fused gather + normalize
// + horizontal flip, and the one-time PIL-bilinear dataset resize.
//
// The port's own copy of the JAX package's C++ loader (the same entry points
// and arithmetic, so the two packages' batches and resized datasets are
// bit-equal).  Given the uint8 dataset resident in host RAM, it writes a
// normalized float32 batch ([-1, 1], NHWC) for the selected indices, with an
// optional per-sample horizontal flip, using all host cores.  Called through
// ctypes from vitgan_tpu_torch/data/native.py, which builds it with g++ into
// vitgan_tpu_torch/ops/_build/ on first use.  That build passes
// -ffp-contract=off, so no multiply-add is fused and every value is the one
// the numpy versions in data/pipeline.py and data/transforms.py compute.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -ffp-contract=off loader.cpp -o <lib>.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Job {
  const uint8_t* images;   // (N, H, W, C) contiguous
  const int64_t* indices;  // (B,)
  const uint8_t* flip;     // (B,) or nullptr
  float* out;              // (B, H, W, C)
  int64_t h, w, c;
};

inline void copy_row_normalize(const uint8_t* src, float* dst, int64_t n) {
  constexpr float kScale = 2.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]) * kScale - 1.0f;
}

void process_sample(const Job& job, int64_t b) {
  const int64_t hw = job.h * job.w;
  const int64_t sample_elems = hw * job.c;
  const uint8_t* src = job.images + job.indices[b] * sample_elems;
  float* dst = job.out + b * sample_elems;
  const bool do_flip = job.flip != nullptr && job.flip[b] != 0;
  if (!do_flip) {
    copy_row_normalize(src, dst, sample_elems);
    return;
  }
  // Horizontal flip: reverse the W axis of each row, keeping channels intact.
  constexpr float kScale = 2.0f / 255.0f;
  for (int64_t y = 0; y < job.h; ++y) {
    const uint8_t* row = src + y * job.w * job.c;
    float* orow = dst + y * job.w * job.c;
    for (int64_t x = 0; x < job.w; ++x) {
      const uint8_t* px = row + (job.w - 1 - x) * job.c;
      float* opx = orow + x * job.c;
      for (int64_t ch = 0; ch < job.c; ++ch)
        opx[ch] = static_cast<float>(px[ch]) * kScale - 1.0f;
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int gather_normalize(const uint8_t* images, const int64_t* indices, int64_t batch,
                     int64_t h, int64_t w, int64_t c, const uint8_t* flip,
                     float* out, int num_threads) {
  if (images == nullptr || indices == nullptr || out == nullptr) return 1;
  Job job{images, indices, flip, out, h, w, c};
  if (num_threads <= 1 || batch < 4) {
    for (int64_t b = 0; b < batch; ++b) process_sample(job, b);
    return 0;
  }
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= batch) return;
      process_sample(job, b);
    }
  };
  std::vector<std::thread> threads;
  const int n = std::min<int64_t>(num_threads, batch);
  threads.reserve(n);
  for (int i = 0; i < n; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-time dataset resize (PIL-BILINEAR semantics): separable antialiased
// triangle filter, identical coefficient math to Pillow's precompute_coeffs;
// the numpy version in vitgan_tpu_torch/data/transforms.py takes the same
// taps in the same order.  Runs at dataset-load time (ref Resize transform,
// ref:src/v1/utils.py:124-131).
// ---------------------------------------------------------------------------

namespace {

struct Taps {
  std::vector<int> lo;        // first input tap per output pixel
  std::vector<int> len;       // number of taps
  std::vector<double> weight; // (out, max_len) row-major, zero padded
  int max_len = 0;
};

Taps make_taps(int64_t in_size, int64_t out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = filterscale;  // bilinear kernel support = 1.0
  t.max_len = static_cast<int>(std::ceil(support) * 2 + 1);
  t.lo.resize(out_size);
  t.len.resize(out_size);
  t.weight.assign(out_size * t.max_len, 0.0);
  for (int64_t i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = std::max<int>(static_cast<int>(center - support + 0.5), 0);
    int hi = std::min<int>(static_cast<int>(center + support + 0.5), in_size);
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      double w = 1.0 - std::fabs((j + 0.5 - center) / filterscale);
      if (w < 0.0) w = 0.0;
      t.weight[i * t.max_len + (j - lo)] = w;
      sum += w;
    }
    if (sum > 0.0) {
      for (int j = 0; j < hi - lo; ++j) t.weight[i * t.max_len + j] /= sum;
      t.lo[i] = lo;
      t.len[i] = hi - lo;
    } else {
      t.lo[i] = std::min<int>(static_cast<int>(center), in_size - 1);
      t.len[i] = 1;
      t.weight[i * t.max_len] = 1.0;
    }
  }
  return t;
}

}  // namespace

extern "C" {

// (N,H,W,C) uint8 -> (N,oh,ow,C) uint8.  Returns 0 on success.
int resize_bilinear_u8(const uint8_t* src, int64_t n, int64_t h, int64_t w,
                       int64_t c, int64_t oh, int64_t ow, uint8_t* dst,
                       int num_threads) {
  if (src == nullptr || dst == nullptr || n < 0) return 1;
  const Taps th = make_taps(h, oh);
  const Taps tw = make_taps(w, ow);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> tmp(h * ow * c);  // horizontal pass buffer
    for (;;) {
      const int64_t img = next.fetch_add(1);
      if (img >= n) return;
      const uint8_t* in = src + img * h * w * c;
      // Horizontal: (h, w, c) -> (h, ow, c) in double.
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = in + y * w * c;
        double* orow = tmp.data() + y * ow * c;
        for (int64_t x = 0; x < ow; ++x) {
          const int lo = tw.lo[x], len = tw.len[x];
          const double* ws = &tw.weight[x * tw.max_len];
          for (int64_t ch = 0; ch < c; ++ch) {
            double acc = 0.0;
            for (int j = 0; j < len; ++j)
              acc += ws[j] * row[(lo + j) * c + ch];
            orow[x * c + ch] = acc;
          }
        }
      }
      // Vertical: (h, ow, c) -> (oh, ow, c), round + clamp to uint8.
      uint8_t* out = dst + img * oh * ow * c;
      for (int64_t y = 0; y < oh; ++y) {
        const int lo = th.lo[y], len = th.len[y];
        const double* ws = &th.weight[y * th.max_len];
        uint8_t* orow = out + y * ow * c;
        for (int64_t xc = 0; xc < ow * c; ++xc) {
          double acc = 0.0;
          for (int j = 0; j < len; ++j)
            acc += ws[j] * tmp[(lo + j) * ow * c + xc];
          const double r = std::nearbyint(acc);
          orow[xc] = static_cast<uint8_t>(r < 0.0 ? 0.0 : (r > 255.0 ? 255.0 : r));
        }
      }
    }
  };
  const int nt = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(num_threads, std::max<int64_t>(n, 1))));
  if (nt == 1) {
    worker();
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
