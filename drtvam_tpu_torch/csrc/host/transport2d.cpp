// Native transport-field rasterizer for the ballistic engine.
//
// Replicates drtvam_tpu/ops/transport2d.py::build_transport bit-for-
// semantics (2D refracted ray fan through the analytic interface stack,
// Amanatides-Woo rasterization of the exact per-cell Beer-Lambert
// deposit) as host C++. This is the framework's native geometry-
// preprocessing stage — the counterpart of Mitsuba's C++ scene build /
// BVH construction in the reference stack: per-scene, not per-render,
// and embarrassingly parallel over angles (each angle owns its (Y, X)
// plane, so there are no atomics anywhere).
//
// The port's own copy of the JAX package's drtvam_tpu/native/
// transport2d.cpp, unchanged below this header, so that the port reads
// no file of that package. Compiled on demand by
// drtvam_tpu_torch/native.py:
//   g++ -O3 -fopenmp -shared -fPIC transport2d.cpp -o libtransport2d.so
// tests/test_torch_ballistic.py holds the fields it builds bitwise equal
// to the JAX engine's.
//
// Numerics note: computations are float64 internally where the JAX
// path uses float32 intermediates; the equivalence test
// (tests/test_native_transport.py) pins the two to ~1e-5 relative.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kRayEps = 1e-4f;

// surface kinds / bsdf kinds — must match models/geometry.py
constexpr int kCylinder = 0;
constexpr int kBox = 1;
constexpr int kDielectric = 0;
constexpr int kNull = 1;

struct Vec2 {
  float x, y;
};

static inline float dot(Vec2 a, Vec2 b) { return a.x * b.x + a.y * b.y; }

struct Hit {
  float t = kInf;
  Vec2 n{0.f, 0.f};
  int sid = -1;
};

struct Surface {
  int kind;
  int bsdf;
  int medium_side;
  float eta;
  float p0, p1, p2;  // cylinder: (r, z0, z1); box: (hx, hy, hz)
};

// 2D circle (cylinder at z=0) — mirrors ops/intersect.py::ray_cylinder
static inline float isect_circle(Vec2 o, Vec2 d, float tmin, float r,
                                 float z0, float z1, Vec2 *n) {
  if (z0 > 0.f || z1 < 0.f) return kInf;  // ray plane outside the tube
  float a = d.x * d.x + d.y * d.y;
  float b = 2.f * (o.x * d.x + o.y * d.y);
  float c = o.x * o.x + o.y * o.y - r * r;
  float disc = b * b - 4.f * a * c;
  if (disc < 0.f || a <= 1e-20f) return kInf;
  float sq = std::sqrt(disc);
  float inv2a = 0.5f / a;
  float t0 = (-b - sq) * inv2a;
  float t1 = (-b + sq) * inv2a;
  float t = kInf;
  if (t0 > tmin) t = t0;
  else if (t1 > tmin) t = t1;
  if (t == kInf) return kInf;
  float inv_r = 1.f / r;
  n->x = (o.x + t * d.x) * inv_r;
  n->y = (o.y + t * d.y) * inv_r;
  return t;
}

// 2D slab box — mirrors ops/intersect.py::ray_box at z=0
static inline float isect_box(Vec2 o, Vec2 d, float tmin, float hx,
                              float hy, float hz, Vec2 *n) {
  if (hz < 0.f) return kInf;  // z=0 always inside [-hz, hz] otherwise
  float inv_dx = 1.f / (std::fabs(d.x) > 1e-20f ? d.x : 1e-20f);
  float inv_dy = 1.f / (std::fabs(d.y) > 1e-20f ? d.y : 1e-20f);
  float tx0 = (-hx - o.x) * inv_dx, tx1 = (hx - o.x) * inv_dx;
  float ty0 = (-hy - o.y) * inv_dy, ty1 = (hy - o.y) * inv_dy;
  float tnx = std::fmin(tx0, tx1), tfx = std::fmax(tx0, tx1);
  float tny = std::fmin(ty0, ty1), tfy = std::fmax(ty0, ty1);
  float t_near = std::fmax(tnx, tny);
  float t_far = std::fmin(tfx, tfy);
  if (t_near > t_far) return kInf;
  float t;
  bool use_near;
  if (t_near > tmin) { t = t_near; use_near = true; }
  else if (t_far > tmin) { t = t_far; use_near = false; }
  else return kInf;
  int axis = use_near ? (tnx >= tny ? 0 : 1) : (tfx <= tfy ? 0 : 1);
  float px = o.x + t * d.x, py = o.y + t * d.y;
  if (axis == 0) { n->x = px >= 0.f ? 1.f : -1.f; n->y = 0.f; }
  else { n->x = 0.f; n->y = py >= 0.f ? 1.f : -1.f; }
  return t;
}

}  // namespace

extern "C" {

// Rasterize the A x (U * S) 2D ray fan into per-angle (Y, X) fields.
// W, UW: preallocated zeroed float32 buffers of size A*Y*X.
// surf_*: per-surface arrays of length n_surf.
void rasterize_fan(
    int A, int U, int S, int X, int Y,
    const int *surf_kind, const int *surf_bsdf, const int *surf_ms,
    const float *surf_eta, const float *surf_params /* n_surf x 3 */,
    int n_surf,
    float pixel_size_x, float motion_distance, int clockwise,
    float sigma_t, float albedo,
    float bbox_min_x, float bbox_min_y, float bbox_max_x, float bbox_max_y,
    float *W, float *UW) {
  const float ex = U * pixel_size_x;
  const float sa_over_st = 1.f - albedo;
  const float vs_x = (bbox_max_x - bbox_min_x) / X;
  const float vs_y = (bbox_max_y - bbox_min_y) / Y;
  const int max_bounce = 2 * n_surf + 2;
  const int max_steps = X + Y + 2;
  const float inv_S = 1.f / S;

#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int a = 0; a < A; ++a) {
    float *Wp = W + (size_t)a * Y * X;
    float *UWp = UW + (size_t)a * Y * X;
    double alpha = 2.0 * M_PI * a / A;
    if (clockwise) alpha = -alpha;
    const float ca = (float)std::cos(alpha), sa = (float)std::sin(alpha);
    const Vec2 origin{motion_distance * ca, motion_distance * sa};
    const Vec2 dir0{-ca, -sa};
    const Vec2 left{sa, -ca};  // cross(z_up, dir)

    for (int u = 0; u < U; ++u) {
      for (int s = 0; s < S; ++s) {
        const float s_u = (u + (s + 0.5f) * inv_S) / U;
        const float cam_x = (0.5f - s_u) * ex;
        const float u_val = u + (s + 0.5f) * inv_S - 0.5f;
        Vec2 o{origin.x + cam_x * left.x, origin.y + cam_x * left.y};
        Vec2 d = dir0;
        float amp = 1.f;
        float t_med = 0.f;
        bool in_medium = false;

        for (int bounce = 0; bounce < max_bounce; ++bounce) {
          // nearest surface
          Hit hit;
          for (int i = 0; i < n_surf; ++i) {
            Vec2 n;
            float t;
            if (surf_kind[i] == kCylinder)
              t = isect_circle(o, d, kRayEps, surf_params[3 * i],
                               surf_params[3 * i + 1],
                               surf_params[3 * i + 2], &n);
            else if (surf_kind[i] == kBox)
              t = isect_box(o, d, kRayEps, surf_params[3 * i],
                            surf_params[3 * i + 1],
                            surf_params[3 * i + 2], &n);
            else
              continue;  // meshes are stripped before the 2D trace
            if (t < hit.t) { hit.t = t; hit.n = n; hit.sid = i; }
          }
          if (hit.sid < 0) break;

          // ---- rasterize the medium segment [o, o + t*d] ------------
          if (in_medium && amp > 0.f) {
            const float safe_dx = std::fabs(d.x) > 1e-12f ? d.x : 1e-12f;
            const float safe_dy = std::fabs(d.y) > 1e-12f ? d.y : 1e-12f;
            float tx0 = (bbox_min_x - o.x) / safe_dx;
            float tx1 = (bbox_max_x - o.x) / safe_dx;
            float ty0 = (bbox_min_y - o.y) / safe_dy;
            float ty1 = (bbox_max_y - o.y) / safe_dy;
            float t_in = std::fmax(
                std::fmax(std::fmin(tx0, tx1), std::fmin(ty0, ty1)), 0.f);
            float t_out = std::fmin(
                std::fmin(std::fmax(tx0, tx1), std::fmax(ty0, ty1)), hit.t);
            if (t_in < t_out && std::isfinite(t_in) &&
                std::isfinite(t_out)) {
              const float sx = o.x + t_in * d.x, sy = o.y + t_in * d.y;
              int cx = (int)((sx - bbox_min_x) / vs_x);
              int cy = (int)((sy - bbox_min_y) / vs_y);
              cx = cx < 0 ? 0 : (cx > X - 1 ? X - 1 : cx);
              cy = cy < 0 ? 0 : (cy > Y - 1 ? Y - 1 : cy);
              const int step_x = d.x > 0.f ? 1 : -1;
              const int step_y = d.y > 0.f ? 1 : -1;
              float nx = bbox_min_x + (cx + step_x) * vs_x +
                         (d.x < 0.f ? vs_x : 0.f);
              float ny = bbox_min_y + (cy + step_y) * vs_y +
                         (d.y < 0.f ? vs_y : 0.f);
              float dtm_x = std::fabs(d.x) > 1e-9f ? (nx - sx) / safe_dx
                                                   : kInf;
              float dtm_y = std::fabs(d.y) > 1e-9f ? (ny - sy) / safe_dy
                                                   : kInf;
              if (dtm_x < 0.f) dtm_x = kInf;
              if (dtm_y < 0.f) dtm_y = kInf;
              const float tstep_x =
                  std::fabs(d.x) > 1e-9f ? vs_x / safe_dx * step_x : kInf;
              const float tstep_y =
                  std::fabs(d.y) > 1e-9f ? vs_y / safe_dy * step_y : kInf;
              const float base = amp * sa_over_st;
              float t = 0.f;
              float rem = t_out - t_in;
              const float t_base = t_med + t_in;
              for (int it = 0; it < max_steps; ++it) {
                const float dt = std::fmin(std::fmin(dtm_x, dtm_y), rem);
                const float contrib =
                    base * std::exp(-sigma_t * (t_base + t)) *
                    (1.f - std::exp(-sigma_t * std::fmax(dt, 0.f)));
                const size_t idx = (size_t)cy * X + cx;
                Wp[idx] += contrib;
                UWp[idx] += contrib * u_val;
                rem -= dt;
                if (rem <= 1e-7f) break;
                bool mx = dtm_x == dt, my = dtm_y == dt;
                dtm_x = mx ? tstep_x : dtm_x - dt;
                dtm_y = my ? tstep_y : dtm_y - dt;
                if (mx) cx += step_x;
                if (my) cy += step_y;
                if (cx < 0 || cx >= X || cy < 0 || cy >= Y) break;
                t += dt;
              }
            }
            t_med += hit.t;
          }

          // ---- transmission-only BSDF (ops/fresnel.py::refract) -----
          float w;
          Vec2 d_new = d;
          if (surf_bsdf[hit.sid] == kDielectric) {
            const float cos_i = -dot(d, hit.n);
            const bool outside = cos_i > 0.f;
            const float eta = surf_eta[hit.sid];
            const float eta_rel = outside ? eta : 1.f / eta;
            const Vec2 nl = outside ? hit.n : Vec2{-hit.n.x, -hit.n.y};
            const float ci = std::fabs(cos_i);
            const float sin_t2 = (1.f - ci * ci) / (eta_rel * eta_rel);
            if (sin_t2 >= 1.f) {
              w = 0.f;  // TIR kills transmission-only rays
            } else {
              const float ct = std::sqrt(1.f - sin_t2);
              const float r_par =
                  (eta_rel * ci - ct) / (eta_rel * ci + ct);
              const float r_perp = (ci - eta_rel * ct) / (ci + eta_rel * ct);
              const float F = 0.5f * (r_par * r_par + r_perp * r_perp);
              w = (1.f - F) / (eta_rel * eta_rel);
              const float inv_eta = 1.f / eta_rel;
              d_new.x = inv_eta * d.x + (inv_eta * ci - ct) * nl.x;
              d_new.y = inv_eta * d.y + (inv_eta * ci - ct) * nl.y;
            }
          } else if (surf_bsdf[hit.sid] == kNull) {
            w = 1.f;
          } else {
            w = 0.f;  // absorbing
          }

          o.x += hit.t * d.x;
          o.y += hit.t * d.y;
          d = d_new;
          amp *= w;

          const int ms = surf_ms[hit.sid];
          const float dn = dot(d, hit.n);
          in_medium = (ms == 1 && dn < 0.f) || (ms == 2 && dn > 0.f);
          if (amp <= 0.f) break;
        }
      }
    }
    if (S > 1) {
      for (size_t i = 0; i < (size_t)Y * X; ++i) {
        Wp[i] *= inv_S;
        UWp[i] *= inv_S;
      }
    }
  }
}

int transport2d_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
