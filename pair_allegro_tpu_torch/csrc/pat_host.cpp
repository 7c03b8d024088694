// Native host-side runtime of pair_allegro_tpu_torch: a copy of the JAX
// package's csrc/pat_host.cpp, kept with the port so that it builds alone.
//
// The upstream pair style marshals neighbors on the host every step
// (pair_nequip_allegro.cpp:457-650); here that hot path lives on the device,
// and what stays on the host is set-up work that grows with the system and
// gates the time to the first step: capacity estimation (binned neighbor
// statistics), spatial sort keys for shard load balance, and the first frame
// of an extxyz file.  Bound with ctypes in pair_allegro_tpu_torch/native.py,
// which keeps a numpy fallback for each function.
//
// Build: g++ -O3 -fPIC -std=c++17 -fopenmp -shared (native.py runs it on
// first use).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// 3x3 inverse; returns false when singular.
bool inv3(const double* m, double* out) {
  const double a = m[0], b = m[1], c = m[2];
  const double d = m[3], e = m[4], f = m[5];
  const double g = m[6], h = m[7], i = m[8];
  const double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::fabs(det) < 1e-14) return false;
  const double inv = 1.0 / det;
  out[0] = (e * i - f * h) * inv;
  out[1] = (c * h - b * i) * inv;
  out[2] = (b * f - c * e) * inv;
  out[3] = (f * g - d * i) * inv;
  out[4] = (a * i - c * g) * inv;
  out[5] = (c * d - a * f) * inv;
  out[6] = (d * h - e * g) * inv;
  out[7] = (b * g - a * h) * inv;
  out[8] = (a * e - b * d) * inv;
  return true;
}

// plane heights of the cell along each axis
void cell_heights(const double* cell, double* h) {
  const double* a0 = cell;
  const double* a1 = cell + 3;
  const double* a2 = cell + 6;
  double vol = a0[0] * (a1[1] * a2[2] - a1[2] * a2[1]) -
               a0[1] * (a1[0] * a2[2] - a1[2] * a2[0]) +
               a0[2] * (a1[0] * a2[1] - a1[1] * a2[0]);
  vol = std::fabs(vol);
  const double* rows[3] = {a0, a1, a2};
  for (int ax = 0; ax < 3; ++ax) {
    const double* u = rows[(ax + 1) % 3];
    const double* v = rows[(ax + 2) % 3];
    double cx = u[1] * v[2] - u[2] * v[1];
    double cy = u[2] * v[0] - u[0] * v[2];
    double cz = u[0] * v[1] - u[1] * v[0];
    double norm = std::sqrt(cx * cx + cy * cy + cz * cz);
    h[ax] = norm > 0 ? vol / norm : 0.0;
  }
}

}  // namespace

extern "C" {

// Binned neighbor statistics under full PBC (minimum image): writes the
// total directed edge count and the max per-atom neighbor count.
// Returns 0 on success, -1 when the box is too small to bin (< 3 bins on
// some axis; caller falls back to the exact python oracle).
int pat_neighbor_stats(const double* pos, int64_t n, const double* cell,
                       double cutoff, int64_t* out_total, int64_t* out_max) {
  if (n <= 0) {
    *out_total = 0;
    *out_max = 0;
    return 0;
  }
  double heights[3];
  cell_heights(cell, heights);
  int g[3];
  for (int a = 0; a < 3; ++a) {
    g[a] = (int)std::floor(heights[a] / cutoff);
    if (g[a] < 3) return -1;
  }
  double icell[9];
  if (!inv3(cell, icell)) return -1;

  const int gx = g[0], gy = g[1], gz = g[2];
  const int64_t ncell = (int64_t)gx * gy * gz;
  std::vector<double> frac(3 * n);
  std::vector<int> bin(3 * n);
  std::vector<int64_t> cid(n);
  std::vector<int64_t> counts(ncell, 0);
  for (int64_t k = 0; k < n; ++k) {
    const double x = pos[3 * k], y = pos[3 * k + 1], z = pos[3 * k + 2];
    // frac = pos @ inv(cell) with rows = lattice vectors (row-vector conv.)
    double fx = x * icell[0] + y * icell[3] + z * icell[6];
    double fy = x * icell[1] + y * icell[4] + z * icell[7];
    double fz = x * icell[2] + y * icell[5] + z * icell[8];
    fx -= std::floor(fx);
    fy -= std::floor(fy);
    fz -= std::floor(fz);
    frac[3 * k] = fx;
    frac[3 * k + 1] = fy;
    frac[3 * k + 2] = fz;
    int bx = std::min((int)(fx * gx), gx - 1);
    int by = std::min((int)(fy * gy), gy - 1);
    int bz = std::min((int)(fz * gz), gz - 1);
    bin[3 * k] = bx;
    bin[3 * k + 1] = by;
    bin[3 * k + 2] = bz;
    cid[k] = ((int64_t)bx * gy + by) * gz + bz;
    counts[cid[k]]++;
  }
  // bucket lists (CSR)
  std::vector<int64_t> starts(ncell + 1, 0);
  for (int64_t c = 0; c < ncell; ++c) starts[c + 1] = starts[c] + counts[c];
  std::vector<int64_t> order(n);
  std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
  for (int64_t k = 0; k < n; ++k) order[cursor[cid[k]]++] = k;

  const double cut2 = cutoff * cutoff;
  int64_t total = 0, maxc = 0;
#pragma omp parallel for reduction(+ : total) reduction(max : maxc) \
    schedule(static)
  for (int64_t k = 0; k < n; ++k) {
    int64_t cnt = 0;
    const double fx = frac[3 * k], fy = frac[3 * k + 1], fz = frac[3 * k + 2];
    for (int da = -1; da <= 1; ++da)
      for (int db = -1; db <= 1; ++db)
        for (int dc = -1; dc <= 1; ++dc) {
          int bx = (bin[3 * k] + da + gx) % gx;
          int by = (bin[3 * k + 1] + db + gy) % gy;
          int bz = (bin[3 * k + 2] + dc + gz) % gz;
          int64_t c = ((int64_t)bx * gy + by) * gz + bz;
          for (int64_t t = starts[c]; t < starts[c + 1]; ++t) {
            int64_t j = order[t];
            if (j == k) continue;
            double dfx = frac[3 * j] - fx;
            double dfy = frac[3 * j + 1] - fy;
            double dfz = frac[3 * j + 2] - fz;
            dfx -= std::round(dfx);
            dfy -= std::round(dfy);
            dfz -= std::round(dfz);
            const double dx = dfx * cell[0] + dfy * cell[3] + dfz * cell[6];
            const double dy = dfx * cell[1] + dfy * cell[4] + dfz * cell[7];
            const double dz = dfx * cell[2] + dfy * cell[5] + dfz * cell[8];
            if (dx * dx + dy * dy + dz * dz <= cut2) cnt++;
          }
        }
    total += cnt;
    if (cnt > maxc) maxc = cnt;
  }
  *out_total = total;
  *out_max = maxc;
  return 0;
}

// Spatial sort keys (z-major bin ids) for shard load balancing
// (the host side of parallel/sharded.py::spatial_sort).
int pat_spatial_keys(const double* pos, int64_t n, const double* cell,
                     int use_cell, int n_bins, int64_t* keys_out) {
  double icell[9];
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  if (use_cell) {
    if (!inv3(cell, icell)) return -1;
  } else {
    for (int64_t k = 0; k < n; ++k)
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], pos[3 * k + d]);
        hi[d] = std::max(hi[d], pos[3 * k + d]);
      }
  }
  for (int64_t k = 0; k < n; ++k) {
    double f[3];
    if (use_cell) {
      const double x = pos[3 * k], y = pos[3 * k + 1], z = pos[3 * k + 2];
      f[0] = x * icell[0] + y * icell[3] + z * icell[6];
      f[1] = x * icell[1] + y * icell[4] + z * icell[7];
      f[2] = x * icell[2] + y * icell[5] + z * icell[8];
      for (int d = 0; d < 3; ++d) f[d] -= std::floor(f[d]);
    } else {
      for (int d = 0; d < 3; ++d) {
        double span = std::max(hi[d] - lo[d], 1e-12);
        f[d] = (pos[3 * k + d] - lo[d]) / span;
      }
    }
    int b[3];
    for (int d = 0; d < 3; ++d) {
      int v = (int)(f[d] * n_bins);
      b[d] = v < 0 ? 0 : (v >= n_bins ? n_bins - 1 : v);
    }
    keys_out[k] = ((int64_t)b[2] * n_bins + b[1]) * n_bins + b[0];
  }
  return 0;
}

// First-frame extxyz atom count (for buffer allocation); -1 on error.
int64_t pat_extxyz_count(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[65536];
  int64_t n = -1;
  if (std::fgets(line, sizeof line, f)) n = std::strtoll(line, nullptr, 10);
  std::fclose(f);
  return n;
}

// Parse the first extxyz frame: positions (n*3), symbols (n*8 char, NUL
// padded).  Assumes Properties=species:S:1:pos:R:3[...] column order (the
// reference test-data convention).  Returns 0 ok, <0 error.
int pat_extxyz_read(const char* path, int64_t n, double* pos_out, char* sym_out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[65536];
  if (!std::fgets(line, sizeof line, f)) {
    std::fclose(f);
    return -2;
  }
  if (!std::fgets(line, sizeof line, f)) {  // comment line (parsed in python)
    std::fclose(f);
    return -3;
  }
  for (int64_t k = 0; k < n; ++k) {
    if (!std::fgets(line, sizeof line, f)) {
      std::fclose(f);
      return -4;
    }
    char sym[64];
    double x, y, z;
    if (std::sscanf(line, "%63s %lf %lf %lf", sym, &x, &y, &z) != 4) {
      std::fclose(f);
      return -5;
    }
    std::strncpy(sym_out + 8 * k, sym, 7);
    sym_out[8 * k + 7] = '\0';
    pos_out[3 * k] = x;
    pos_out[3 * k + 1] = y;
    pos_out[3 * k + 2] = z;
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
