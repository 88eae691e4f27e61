// rso native host library: scalar reference kernels + batched helpers.
//
// The reference implements its pixel kernels in C++ (stereo_vo
// compute_SAD8.cpp, tracking_SAD.cpp, and MRPT's FASTER detector); this
// library provides freshly written equivalents with the same contracts so
// the JAX kernels can be cross-checked against an independent native
// implementation (the reference repo's own scalar-vs-SSE4 equivalence test
// pattern, computeSAD8_unittest.cpp:61-76, applied across languages).
//
// Exposed via plain C symbols for ctypes (no pybind11 in this toolchain).
// Build: native/build.sh  (or the CMakeLists.txt next to this file)

#include <cstdint>
#include <cstring>
#include <climits>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

// Sum of absolute differences over the 8x8 patch whose window is
// (x-3 .. x+4, y-3 .. y+4) — same window convention as the reference
// (compute_SAD8.cpp:71-97).  No bounds checking: callers keep keypoints
// >= 3px / <= dim-5 from the border, as the reference's stage-3 filter does.
uint32_t rso_compute_sad8(const uint8_t* img_a, const uint8_t* img_b,
                          int stride, int ax, int ay, int bx, int by) {
  uint32_t acc = 0;
  const uint8_t* pa = img_a + (ay - 3) * stride + (ax - 3);
  const uint8_t* pb = img_b + (by - 3) * stride + (bx - 3);
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) {
      int d = int(pa[c]) - int(pb[c]);
      acc += uint32_t(d < 0 ? -d : d);
    }
    pa += stride;
    pb += stride;
  }
  return acc;
}

// Batched all-pairs SAD: patches are pre-extracted [n, 64] u8 rows,
// out is [na, nb] u32 row-major.  Multi-threaded over rows of A.
void rso_sad_matrix(const uint8_t* patches_a, int na, const uint8_t* patches_b,
                    int nb, uint32_t* out, int n_threads) {
  auto work = [&](int r0, int r1) {
    for (int i = r0; i < r1; ++i) {
      const uint8_t* pa = patches_a + i * 64;
      uint32_t* row = out + size_t(i) * nb;
      for (int j = 0; j < nb; ++j) {
        const uint8_t* pb = patches_b + j * 64;
        uint32_t acc = 0;
        for (int k = 0; k < 64; ++k) {
          int d = int(pa[k]) - int(pb[k]);
          acc += uint32_t(d < 0 ? -d : d);
        }
        row[j] = acc;
      }
    }
  };
  if (n_threads <= 1) {
    work(0, na);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (na + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int r0 = t * chunk, r1 = r0 + chunk > na ? na : r0 + chunk;
    if (r0 >= r1) break;
    ts.emplace_back(work, r0, r1);
  }
  for (auto& t : ts) t.join();
}

// Batched Hamming distance over packed 256-bit descriptors ([n, 8] u32).
void rso_hamming_matrix(const uint32_t* da, int na, const uint32_t* db, int nb,
                        uint32_t* out) {
  for (int i = 0; i < na; ++i) {
    const uint32_t* a = da + i * 8;
    uint32_t* row = out + size_t(i) * nb;
    for (int j = 0; j < nb; ++j) {
      const uint32_t* b = db + j * 8;
      uint32_t acc = 0;
      for (int k = 0; k < 8; ++k) acc += uint32_t(__builtin_popcount(a[k] ^ b[k]));
      row[j] = acc;
    }
  }
}

// Exhaustive windowed min-SAD search of an 8x8 template over +-wx,+-wy
// around (cx, cy) — the reference's tracking_SAD contract
// (tracking_SAD.cpp:73-125).  Returns best SAD; best position via out params.
uint32_t rso_tracking_sad(const uint8_t* img, int stride, int width,
                          int height, const uint8_t* templ /*64*/, int cx,
                          int cy, int wx, int wy, int* best_x, int* best_y) {
  uint32_t best = UINT32_MAX;
  int bx = cx, by = cy;
  int x0 = cx - wx < 3 ? 3 : cx - wx;
  int x1 = cx + wx > width - 5 ? width - 5 : cx + wx;
  int y0 = cy - wy < 3 ? 3 : cy - wy;
  int y1 = cy + wy > height - 5 ? height - 5 : cy + wy;
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      const uint8_t* p = img + (y - 3) * stride + (x - 3);
      uint32_t acc = 0;
      for (int r = 0; r < 8; ++r) {
        for (int c = 0; c < 8; ++c) {
          int d = int(p[c]) - int(templ[r * 8 + c]);
          acc += uint32_t(d < 0 ? -d : d);
        }
        p += stride;
      }
      if (acc < best) {
        best = acc;
        bx = x;
        by = y;
      }
    }
  }
  *best_x = bx;
  *best_y = by;
  return best;
}

// Scalar FAST-N segment-test detector (the oracle for the dense JAX corner
// test).  Writes up to max_out (x, y) int32 pairs; returns the count of
// corners found (which may exceed max_out).
int rso_fast_detect(const uint8_t* img, int stride, int width, int height,
                    int threshold, int arc, int32_t* out_xy, int max_out) {
  static const int ox[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  static const int oy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  int n = 0;
  for (int y = 3; y < height - 3; ++y) {
    for (int x = 3; x < width - 3; ++x) {
      int c = img[y * stride + x];
      int hi = c + threshold, lo = c - threshold;
      unsigned bright = 0, dark = 0;
      for (int k = 0; k < 16; ++k) {
        int v = img[(y + oy[k]) * stride + (x + ox[k])];
        if (v > hi) bright |= (1u << k);
        if (v < lo) dark |= (1u << k);
      }
      bool corner = false;
      for (int set = 0; set < 2 && !corner; ++set) {
        unsigned bits = set ? dark : bright;
        unsigned wrap = bits | (bits << 16);  // circular
        for (int s = 0; s < 16; ++s) {
          unsigned window = (wrap >> s) & ((1u << arc) - 1);
          if (window == (1u << arc) - 1u) {
            corner = true;
            break;
          }
        }
      }
      if (corner) {
        if (n < max_out) {
          out_xy[2 * n] = x;
          out_xy[2 * n + 1] = y;
        }
        ++n;
      }
    }
  }
  return n;
}

// 2x2-mean pyramid downsample (u8 -> u8, truncating), for loader-side
// pyramid prebuild experiments.
void rso_downsample2x(const uint8_t* src, int stride, int width, int height,
                      uint8_t* dst) {
  int w2 = width / 2, h2 = height / 2;
  for (int y = 0; y < h2; ++y) {
    const uint8_t* r0 = src + (2 * y) * stride;
    const uint8_t* r1 = r0 + stride;
    uint8_t* d = dst + y * w2;
    for (int x = 0; x < w2; ++x) {
      d[x] = uint8_t((int(r0[2 * x]) + r0[2 * x + 1] + r1[2 * x] +
                      r1[2 * x + 1] + 2) / 4);
    }
  }
}

}  // extern "C"
