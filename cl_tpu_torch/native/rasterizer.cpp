// Native host-side synthetic rasterizer for the cl_tpu data layer.
//
// Role (SURVEY.md §1 L1): the host half of the input pipeline decodes/
// rasterizes to uint8 before the device-side fused augmentation. The numpy
// generator (cl_tpu/data/synthetic.py) allocates several S×S temporaries
// per image; at 512²-class rates the host becomes the bottleneck of an
// otherwise compute-bound TPU step. This C++ path rasterizes straight into
// the caller-provided uint8 buffers, one pass, multi-threaded across a
// batch.
//
// Determinism: its own splitmix64/xoshiro256++ stream seeded by
// (seed, index) — NOT numpy's MT19937. Parity with the torch oracle is
// unaffected because both frameworks consume the same dataset object
// (reference_impl imports cl_tpu's data layer); the native dataset is a
// separate `dataset=synthetic_native` config value, deterministic in
// (seed, index) like the numpy one.
//
// Built as a plain shared library (no pybind11 in this image); bound via
// ctypes in cl_tpu/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// ---- RNG: splitmix64 seeding + xoshiro256++ stream ------------------------
struct Rng {
  uint64_t s[4];

  static uint64_t splitmix(uint64_t &x) {
    x += 0x9E3779B97f4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }

  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) s[i] = splitmix(x);
  }

  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }

  uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // unbiased bounded integer in [lo, hi)
  int64_t randint(int64_t lo, int64_t hi) {
    uint64_t range = static_cast<uint64_t>(hi - lo);
    uint64_t x, r;
    do {
      x = next();
      r = x % range;
    } while (x - r > UINT64_MAX - range + 1);
    return lo + static_cast<int64_t>(r);
  }

  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
};

// Deterministic class color — same golden-ratio HSV walk as synthetic.py
// (visual statistics parity, byte-identical formula).
void class_color(int64_t cls, uint8_t rgb[3]) {
  double h = std::fmod(cls * 0.61803398875, 1.0);
  int i = static_cast<int>(h * 6);
  double f = h * 6 - i;
  double v = 0.9, sa = 0.75;
  double p = v * (1 - sa), q = v * (1 - f * sa), t = v * (1 - (1 - f) * sa);
  double r, g, b;
  switch (i % 6) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
  rgb[0] = static_cast<uint8_t>(r * 255);
  rgb[1] = static_cast<uint8_t>(g * 255);
  rgb[2] = static_cast<uint8_t>(b * 255);
}

inline uint8_t clip255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void rasterize_one(int64_t seed, int64_t index, int64_t size,
                   const int64_t *classes, int64_t n_classes,
                   int64_t max_shapes, uint8_t *img /* [S,S,3] */,
                   uint8_t *mask /* [S,S] */) {
  Rng rng(static_cast<uint64_t>(seed) * 1000003ULL +
          static_cast<uint64_t>(index) + 0x5bf03635ULL);
  const int64_t S = size;

  // Textured background: base tone + per-pixel noise, one pass.
  int base[3];
  for (int c = 0; c < 3; c++) base[c] = static_cast<int>(rng.randint(16, 72));
  for (int64_t p = 0; p < S * S; p++) {
    for (int c = 0; c < 3; c++) {
      img[p * 3 + c] =
          clip255(base[c] + static_cast<int>(rng.randint(-12, 13)));
    }
  }
  std::memset(mask, 0, static_cast<size_t>(S) * S);

  const int64_t n_shapes = rng.randint(1, max_shapes + 1);
  for (int64_t sidx = 0; sidx < n_shapes; sidx++) {
    const int64_t cls = classes[rng.randint(0, n_classes)];
    const int64_t cy = rng.randint(S / 8, S - S / 8);
    const int64_t cx = rng.randint(S / 8, S - S / 8);
    // max(1, ·): tiny sizes (<10 px) can draw a 0 radius → division by
    // zero in the ellipse test (empty shape); mirror of pyref.py.
    const int64_t ry = std::max<int64_t>(1, rng.randint(S / 10, S / 3));
    const int64_t rx = std::max<int64_t>(1, rng.randint(S / 10, S / 3));
    const bool ellipse = rng.uniform() < 0.5;
    uint8_t color[3];
    class_color(cls, color);
    int jitter[3];
    for (int c = 0; c < 3; c++)
      jitter[c] = static_cast<int>(rng.randint(-20, 21));

    const int64_t y0 = std::max<int64_t>(0, cy - ry);
    const int64_t y1 = std::min<int64_t>(S - 1, cy + ry);
    const int64_t x0 = std::max<int64_t>(0, cx - rx);
    const int64_t x1 = std::min<int64_t>(S - 1, cx + rx);
    const double inv_ry2 = 1.0 / (static_cast<double>(ry) * ry);
    const double inv_rx2 = 1.0 / (static_cast<double>(rx) * rx);
    for (int64_t y = y0; y <= y1; y++) {
      const double dy = static_cast<double>(y - cy);
      for (int64_t x = x0; x <= x1; x++) {
        const double dx = static_cast<double>(x - cx);
        bool inside = ellipse
            ? (dy * dy * inv_ry2 + dx * dx * inv_rx2 <= 1.0)
            : true;  // rectangle: the bounding box IS the shape
        if (!inside) continue;
        uint8_t *px = img + (y * S + x) * 3;
        for (int c = 0; c < 3; c++) px[c] = clip255(color[c] + jitter[c]);
        mask[y * S + x] = static_cast<uint8_t>(cls);
      }
    }
  }
}

}  // namespace

extern "C" {

// Rasterize one example. img: [size,size,3] uint8, mask: [size,size] uint8.
void cl_rasterize(int64_t seed, int64_t index, int64_t size,
                  const int64_t *classes, int64_t n_classes,
                  int64_t max_shapes, uint8_t *img, uint8_t *mask) {
  rasterize_one(seed, index, size, classes, n_classes, max_shapes, img, mask);
}

// Rasterize a batch of examples [indices[i]] into contiguous buffers,
// threaded across images. imgs: [n,size,size,3], masks: [n,size,size].
void cl_rasterize_batch(int64_t seed, const int64_t *indices, int64_t n,
                        int64_t size, const int64_t *classes,
                        int64_t n_classes, int64_t max_shapes, uint8_t *imgs,
                        uint8_t *masks, int64_t n_threads) {
  const int64_t img_stride = size * size * 3;
  const int64_t mask_stride = size * size;
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; i++) {
      rasterize_one(seed, indices[i], size, classes, n_classes, max_shapes,
                    imgs + i * img_stride, masks + i * mask_stride);
    }
    return;
  }
  const int64_t workers = std::min<int64_t>(n_threads, n);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(workers));
  for (int64_t w = 0; w < workers; w++) {
    pool.emplace_back([=]() {
      for (int64_t i = w; i < n; i += workers) {
        rasterize_one(seed, indices[i], size, classes, n_classes, max_shapes,
                      imgs + i * img_stride, masks + i * mask_stride);
      }
    });
  }
  for (auto &t : pool) t.join();
}

}  // extern "C"
