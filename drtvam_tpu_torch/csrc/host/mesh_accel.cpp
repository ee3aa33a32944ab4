// Native mesh acceleration: XY-binned triangle grid + column casting.
//
// Host-side counterpart of the Embree/OptiX acceleration structures the
// reference gets from Mitsuba (README.md:97). Used for the geometry
// preprocessing stages — target voxelization (utils.py:83-128
// `discretize`) and surface-aware fractional volumes (sensor.py:47-110
// `compute_volume`) — where all rays are +z columns, so a 2D grid over
// (x, y) triangle AABBs beats a general BVH: candidate lookup is O(1)
// and construction is a single binning pass. Scales to multi-100k-
// triangle meshes (a real Benchy) where the JAX brute-force sweep is
// infeasible.
//
// Semantics are pinned to ops/voxelize.py: crossings along +z from
// z_start, merged when closer than 1e-4 + 1e-5*|t| (the f32 nudge the
// JAX path uses to step past a hit), parity pairing into inside
// intervals, occupancy = voxel-center-inside, fractional volume = exact
// z-overlap averaged over oversample^2 xy subcolumns.
//
// The port's own copy of the JAX package's drtvam_tpu/native/
// mesh_accel.cpp, unchanged below this header, so that the port reads
// no file of that package. Compiled on demand by
// drtvam_tpu_torch/native.py:
//   g++ -O3 -fopenmp -shared -fPIC mesh_accel.cpp -o libmesh_accel.so
// tests/test_torch_scene.py holds the occupancy it builds bitwise equal
// to the JAX package's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Grid2D {
  int nx, ny;
  float x0, y0, inv_cx, inv_cy;
  // CSR layout: cell c owns tri indices items[offsets[c] .. offsets[c+1])
  std::vector<int> offsets;
  std::vector<int> items;
};

// Bin triangle XY AABBs into an nx*ny grid sized to ~2 tris per cell.
Grid2D build_grid(const float *v0, const float *e1, const float *e2,
                  int n_tris) {
  Grid2D g;
  float xmin = 1e30f, xmax = -1e30f, ymin = 1e30f, ymax = -1e30f;
  for (int i = 0; i < n_tris; ++i) {
    const float ax = v0[3 * i], ay = v0[3 * i + 1];
    const float bx = ax + e1[3 * i], by = ay + e1[3 * i + 1];
    const float cx = ax + e2[3 * i], cy = ay + e2[3 * i + 1];
    xmin = std::fmin(xmin, std::fmin(ax, std::fmin(bx, cx)));
    xmax = std::fmax(xmax, std::fmax(ax, std::fmax(bx, cx)));
    ymin = std::fmin(ymin, std::fmin(ay, std::fmin(by, cy)));
    ymax = std::fmax(ymax, std::fmax(ay, std::fmax(by, cy)));
  }
  const float pad = 1e-5f + 1e-5f * std::fmax(xmax - xmin, ymax - ymin);
  xmin -= pad; xmax += pad; ymin -= pad; ymax += pad;
  int res = (int)std::ceil(std::sqrt((double)n_tris * 0.5));
  res = std::max(1, std::min(res, 1024));
  g.nx = res; g.ny = res;
  g.x0 = xmin; g.y0 = ymin;
  g.inv_cx = g.nx / std::fmax(xmax - xmin, 1e-20f);
  g.inv_cy = g.ny / std::fmax(ymax - ymin, 1e-20f);

  std::vector<int> counts(g.nx * g.ny + 1, 0);
  auto cell_range = [&](int i, int *cx0, int *cx1, int *cy0, int *cy1) {
    const float ax = v0[3 * i], ay = v0[3 * i + 1];
    const float bx = ax + e1[3 * i], by = ay + e1[3 * i + 1];
    const float cx = ax + e2[3 * i], cy = ay + e2[3 * i + 1];
    const float txmin = std::fmin(ax, std::fmin(bx, cx));
    const float txmax = std::fmax(ax, std::fmax(bx, cx));
    const float tymin = std::fmin(ay, std::fmin(by, cy));
    const float tymax = std::fmax(ay, std::fmax(by, cy));
    *cx0 = std::max(0, (int)((txmin - g.x0) * g.inv_cx));
    *cx1 = std::min(g.nx - 1, (int)((txmax - g.x0) * g.inv_cx));
    *cy0 = std::max(0, (int)((tymin - g.y0) * g.inv_cy));
    *cy1 = std::min(g.ny - 1, (int)((tymax - g.y0) * g.inv_cy));
  };
  for (int i = 0; i < n_tris; ++i) {
    int cx0, cx1, cy0, cy1;
    cell_range(i, &cx0, &cx1, &cy0, &cy1);
    for (int cy = cy0; cy <= cy1; ++cy)
      for (int cx = cx0; cx <= cx1; ++cx) counts[cy * g.nx + cx + 1]++;
  }
  for (size_t c = 1; c < counts.size(); ++c) counts[c] += counts[c - 1];
  g.offsets = counts;
  g.items.resize(g.offsets.back());
  std::vector<int> cursor(g.offsets.begin(), g.offsets.end() - 1);
  for (int i = 0; i < n_tris; ++i) {
    int cx0, cx1, cy0, cy1;
    cell_range(i, &cx0, &cx1, &cy0, &cy1);
    for (int cy = cy0; cy <= cy1; ++cy)
      for (int cx = cx0; cx <= cx1; ++cx)
        g.items[cursor[cy * g.nx + cx]++] = i;
  }
  return g;
}

// All +z crossings of the column at (x, y) starting at z_start, sorted,
// merged within the f32-nudge tolerance of ops/voxelize.py.
inline int column_hits(const Grid2D &g, const float *v0, const float *e1,
                       const float *e2, float x, float y, float z_start,
                       float *out, int max_k) {
  const int cx =
      std::max(0, std::min(g.nx - 1, (int)((x - g.x0) * g.inv_cx)));
  const int cy =
      std::max(0, std::min(g.ny - 1, (int)((y - g.y0) * g.inv_cy)));
  const int c = cy * g.nx + cx;
  int n = 0;
  float buf[256];
  for (int k = g.offsets[c]; k < g.offsets[c + 1]; ++k) {
    const int i = g.items[k];
    // Moller-Trumbore specialized for d = (0, 0, 1)
    const float ax = v0[3 * i], ay = v0[3 * i + 1], az = v0[3 * i + 2];
    const float e1x = e1[3 * i], e1y = e1[3 * i + 1], e1z = e1[3 * i + 2];
    const float e2x = e2[3 * i], e2y = e2[3 * i + 1], e2z = e2[3 * i + 2];
    // p = cross(d, e2) = (-e2y, e2x, 0)
    const float det = e1x * -e2y + e1y * e2x;
    if (std::fabs(det) < 1e-12f) continue;
    const float inv_det = 1.f / det;
    const float tx = x - ax, ty = y - ay, tz = z_start - az;
    const float u = (tx * -e2y + ty * e2x) * inv_det;
    if (u < 0.f || u > 1.f) continue;
    // q = cross(t, e1)
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = qz * inv_det;  // dot(d, q) with d = +z
    if (v < 0.f || u + v > 1.f) continue;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    if (t > 1e-6f && n < 256) buf[n++] = t;
  }
  std::sort(buf, buf + n);
  int m = 0;
  float prev_t = 0.f;
  for (int i = 0; i < n && m < max_k; ++i) {
    // merge in t-space (distance from z_start), matching the JAX
    // path's step-past-the-hit nudge
    if (m > 0 && buf[i] <= prev_t + 1e-4f + 1e-5f * std::fabs(prev_t))
      continue;
    prev_t = buf[i];
    out[m++] = z_start + buf[i];
  }
  return m;
}

}  // namespace

extern "C" {

// Binary occupancy (mode 0) or inside-fraction (mode 1) of a mesh on a
// (Z, Y, X) voxel grid. out has Z*Y*X floats (zeroed by the caller).
// Columns are cast at voxel xy centers (mode 0) or at oversample^2
// stratified xy offsets (mode 1); inside intervals come from crossing
// parity. Matches ops/voxelize.py::occupancy / fractional_volumes.
void voxelize_mesh(const float *v0, const float *e1, const float *e2,
                   int n_tris, const float *bbox_min, const float *bbox_max,
                   int X, int Y, int Z, int mode, int oversample,
                   float *out) {
  const Grid2D g = build_grid(v0, e1, e2, n_tris);
  const float vx = (bbox_max[0] - bbox_min[0]) / X;
  const float vy = (bbox_max[1] - bbox_min[1]) / Y;
  const float vz = (bbox_max[2] - bbox_min[2]) / Z;
  const float z0 = bbox_min[2];
  // start columns below the MESH, not the film bbox: a surface below
  // the film (mesh taller than the sensor volume) still flips parity
  float mesh_zmin = bbox_min[2];
  for (int i = 0; i < n_tris; ++i) {
    const float az = v0[3 * i + 2];
    const float bz = az + e1[3 * i + 2];
    const float cz = az + e2[3 * i + 2];
    mesh_zmin = std::min(mesh_zmin, std::min(az, std::min(bz, cz)));
  }
  const float z_start = mesh_zmin - 1.f;
  const int S = mode == 0 ? 1 : std::max(1, oversample);
  const float inv_ss = 1.f / (S * S);
  constexpr int kMaxK = 64;

#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 8)
#endif
  for (int ypix = 0; ypix < Y; ++ypix) {
    float cross[kMaxK];
    for (int xpix = 0; xpix < X; ++xpix) {
      for (int sy = 0; sy < S; ++sy) {
        for (int sx = 0; sx < S; ++sx) {
          const float fx = mode == 0 ? 0.5f : (sx + 0.5f) / S;
          const float fy = mode == 0 ? 0.5f : (sy + 0.5f) / S;
          const float x = bbox_min[0] + (xpix + fx) * vx;
          const float y = bbox_min[1] + (ypix + fy) * vy;
          const int m =
              column_hits(g, v0, e1, e2, x, y, z_start, cross, kMaxK);
          for (int p = 0; p + 1 <= m; p += 2) {
            const float t_in = cross[p];
            const float t_out = p + 1 < m ? cross[p + 1]
                                          : bbox_max[2] + 1.f;
            if (mode == 0) {
              // voxel-center parity: center z in [t_in, t_out)
              int k0 = (int)std::ceil((t_in - z0) / vz - 0.5f);
              int k1 = (int)std::floor((t_out - z0) / vz - 0.5f);
              if (z0 + (k1 + 0.5f) * vz >= t_out) k1--;
              k0 = std::max(k0, 0);
              k1 = std::min(k1, Z - 1);
              for (int k = k0; k <= k1; ++k)
                out[((size_t)k * Y + ypix) * X + xpix] = 1.f;
            } else {
              int k0 = std::max(0, (int)((t_in - z0) / vz));
              int k1 = std::min(Z - 1, (int)((t_out - z0) / vz));
              for (int k = k0; k <= k1; ++k) {
                const float lo = std::fmax(t_in, z0 + k * vz);
                const float hi = std::fmin(t_out, z0 + (k + 1) * vz);
                if (hi > lo)
                  out[((size_t)k * Y + ypix) * X + xpix] +=
                      (hi - lo) / vz * inv_ss;
              }
            }
          }
        }
      }
    }
  }
}

// Raw sorted crossing z's per query column — general building block for
// host-side mesh queries. out is (n_cols, max_k), pre-filled by the
// caller with +inf; entries beyond the hit count stay +inf.
void mesh_column_crossings(const float *v0, const float *e1,
                           const float *e2, int n_tris, const float *xy,
                           int n_cols, float z_start, int max_k,
                           float *out) {
  const Grid2D g = build_grid(v0, e1, e2, n_tris);
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int i = 0; i < n_cols; ++i) {
    const int m = column_hits(g, v0, e1, e2, xy[2 * i], xy[2 * i + 1],
                              z_start, out + (size_t)i * max_k, max_k);
    (void)m;
  }
}

}  // extern "C"
