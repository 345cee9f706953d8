// Native domain-generation kernels.
//
// The reference implements these in native code too: OpenMP point-selection
// loops in the manager (manager_class.cpp:902-925, 1642-1660), thrust
// stream-compaction functors on the GPU (cuda_polygon.cu:586-655,
// cuda_polygon.cuh:180-292), and the polygon rasterizer (polygon_class.cpp).
// Here the host-side generators are C++ with OpenMP; the Python layer
// (correlation_jax.domains) falls back to NumPy when the shared library is
// not built.
//
// Build: make -C native   (produces libcorrelation_native.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float kTwoPi = 6.28318530717958647692f;

struct Pt {
  float x, y;
};

// Crossing-number test of a horizontal ray from (-1, y) to (x, y) against
// one polygon edge, mirroring the reference's signed-line-evaluation form
// (manager_class.cpp:1972-2016 / cuda_polygon.cuh:220-271).
inline bool edge_crosses(float px, float py, float ay, float by, float ea,
                         float eb, float ec) {
  if (ay > py && by > py) return false;
  if (ay < py && by < py) return false;
  const float temp = eb * py + ec;
  const float d1 = -ea + temp;  // ray start x = -1
  const float d2 = ea * px + temp;
  if (d1 > 0.f && d2 > 0.f) return false;
  if (d1 < 0.f && d2 < 0.f) return false;
  if (d1 == 0.f && d2 == 0.f) return false;  // collinear
  return true;
}

}  // namespace

extern "C" {

// Interior integer pixels of a polygon by crossing number.
// contour: [n*2] (x, y) pairs; out: capacity cap*2 floats.
// Returns the number of points written, or -(required) if cap is too small.
std::int64_t rasterize_polygon_crossing(const float* contour, std::int64_t n,
                                        float* out, std::int64_t cap) {
  if (n < 3) return 0;
  float minx = contour[0], maxx = contour[0];
  float miny = contour[1], maxy = contour[1];
  for (std::int64_t i = 1; i < n; ++i) {
    minx = std::min(minx, contour[2 * i]);
    maxx = std::max(maxx, contour[2 * i]);
    miny = std::min(miny, contour[2 * i + 1]);
    maxy = std::max(maxy, contour[2 * i + 1]);
  }
  const std::int64_t x0 = (std::int64_t)std::ceil(minx);
  const std::int64_t x1 = (std::int64_t)std::floor(maxx);
  const std::int64_t y0 = (std::int64_t)std::ceil(miny);
  const std::int64_t y1 = (std::int64_t)std::floor(maxy);
  if (x1 < x0 || y1 < y0) return 0;

  // Precomputed line equations (manager_class.cpp:1808-1834).
  std::vector<float> ea(n), eb(n), ec(n), ay(n), by(n);
  for (std::int64_t i = 0; i < n; ++i) {
    const std::int64_t j = (i + 1 == n) ? 0 : i + 1;
    const float xa = contour[2 * i], ya = contour[2 * i + 1];
    const float xb = contour[2 * j], yb = contour[2 * j + 1];
    ea[i] = yb - ya;
    eb[i] = xa - xb;
    ec[i] = xb * ya - xa * yb;
    ay[i] = ya;
    by[i] = yb;
  }

  std::atomic<std::int64_t> count{0};
  const std::int64_t rows = y1 - y0 + 1;
  const std::int64_t cols = x1 - x0 + 1;

#pragma omp parallel
  {
    std::vector<float> local;
    local.reserve(2 * cols);
#pragma omp for nowait
    for (std::int64_t r = 0; r < rows; ++r) {
      const float py = (float)(y0 + r);
      for (std::int64_t c = 0; c < cols; ++c) {
        const float px = (float)(x0 + c);
        int crossings = 0;
        for (std::int64_t i = 0; i < n; ++i) {
          crossings += edge_crosses(px, py, ay[i], by[i], ea[i], eb[i], ec[i]);
        }
        if (crossings & 1) {
          local.push_back(px);
          local.push_back(py);
        }
      }
    }
    const std::int64_t mine = (std::int64_t)local.size() / 2;
    const std::int64_t base = count.fetch_add(mine);
    if (base + mine <= cap) {
      std::copy(local.begin(), local.end(), out + 2 * base);
    }
  }
  const std::int64_t total = count.load();
  return (total <= cap) ? total : -total;
}

// Integer points of one annular sector; cpu_semantics mirrors the manager's
// cross-product wedge test with the 1.2x "cheap sag" bounding box
// (manager_class.cpp:846-925); otherwise the GPU functor's atan2 test
// (cuda_polygon.cuh:180-206).
std::int64_t annular_sector_points(float r, float dr, float a, float da,
                                   float cx, float cy, std::int64_t as,
                                   std::int64_t cpu_semantics, float* out,
                                   std::int64_t cap) {
  const float ro2 = (r + dr) * (r + dr);
  const float ri2 = r * r;
  std::int64_t x0, x1, y0, y1;
  float c00x = 0, c01x = 0, c10x = 0, c11x = 0;
  float c00y = 0, c01y = 0, c10y = 0, c11y = 0;
  if (as == 1) {
    x0 = (std::int64_t)(cx - (r + dr));
    x1 = (std::int64_t)(cx + (r + dr));
    y0 = (std::int64_t)(cy - (r + dr));
    y1 = (std::int64_t)(cy + (r + dr));
  } else {
    const float sin0 = std::sin(a), cos0 = std::cos(a);
    const float sin1 = std::sin(a + da), cos1 = std::cos(a + da);
    const float sin2 = std::sin(a + da / 2.f), cos2 = std::cos(a + da / 2.f);
    c00x = cx + r * cos0;
    c01x = cx + r * cos1;
    c10x = cx + (r + dr) * cos0 * 1.2f;
    c11x = cx + (r + dr) * cos1 * 1.2f;
    c00y = cy + r * sin0;
    c01y = cy + r * sin1;
    c10y = cy + (r + dr) * sin0 * 1.2f;
    c11y = cy + (r + dr) * sin1 * 1.2f;
    const float arcx = cx + (r + dr) * cos2;
    const float arcy = cy + (r + dr) * sin2;
    x0 = (std::int64_t)std::min({arcx, c00x, c01x, c10x, c11x});
    x1 = (std::int64_t)std::max({arcx, c00x, c01x, c10x, c11x});
    y0 = (std::int64_t)std::min({arcy, c00y, c01y, c10y, c11y});
    y1 = (std::int64_t)std::max({arcy, c00y, c01y, c10y, c11y});
  }

  std::int64_t count = 0;
  // x-major, y-minor order (manager_class.cpp:902-925).
  for (std::int64_t ix = x0; ix < x1; ++ix) {
    const float fx = (float)ix;
    for (std::int64_t iy = y0; iy < y1; ++iy) {
      const float fy = (float)iy;
      const float dx = fx - cx;
      const float dy = fy - cy;
      const float r2 = dx * dx + dy * dy;
      bool keep;
      if (cpu_semantics) {
        keep = (r2 > ri2) && (r2 < ro2);
        if (keep && as != 1) {
          const float cross1 =
              (c11x - fx) * (c01y - c11y) - (c11y - fy) * (c01x - c11x);
          const float cross2 =
              (c00x - fx) * (c10y - c00y) - (c00y - fy) * (c10x - c00x);
          keep = cross1 * cross2 > 0.f;
        }
      } else {
        keep = (r2 >= ri2) && (r2 <= ro2);
        if (keep && as != 1) {
          float ang = std::atan2(dy, dx);
          if (ang < 0.f) ang += kTwoPi;
          keep = (ang >= a) && (ang <= a + da);
        }
      }
      if (keep) {
        if (count < cap) {
          out[2 * count] = fx;
          out[2 * count + 1] = fy;
        }
        ++count;
      }
    }
  }
  return (count <= cap) ? count : -count;
}

// Per-level pyramid decimation: keep points whose rounded coordinates are
// divisible by 2^level, scaled by 2^-level (pyramid_class.cpp:301-322 /
// the thrust copyFunctor+scale2DFunctor, cuda_polygon.cuh:135-178).
std::int64_t decimate_points(const float* xy, std::int64_t n,
                             std::int64_t level, float* out,
                             std::int64_t cap) {
  const std::int64_t mag = (std::int64_t)1 << level;
  const float inv = 1.0f / (float)mag;
  std::int64_t count = 0;
  for (std::int64_t i = 0; i < n; ++i) {
    const float x = xy[2 * i];
    const float y = xy[2 * i + 1];
    const std::int64_t ix = (std::int64_t)(x + 0.5f);
    const std::int64_t iy = (std::int64_t)(y + 0.5f);
    if (ix % mag == 0 && iy % mag == 0) {
      if (count < cap) {
        out[2 * count] = x * inv;
        out[2 * count + 1] = y * inv;
      }
      ++count;
    }
  }
  return (count <= cap) ? count : -count;
}

}  // extern "C"
