// Triangle-mesh intersection for the wavefront template (wf_trace.cuh
// includes this inside namespace wf, after the analytic intersections
// whose helpers it uses): the nearest hit of a ray on one mesh surface,
// by brute force over its triangles below GRID_MIN_TRIS (96) triangles,
// else by a 3D-DDA walk over the mesh's uniform grid.
//
// Replaces drtvam_tpu/ops/intersect.py:79 ray_triangles and
// drtvam_tpu/ops/mesh_grid.py:117 ray_triangles_grid (XLA). The JAX
// package walks a wavefront of lanes in lock step, gathering each cell's
// triangle list in 8-wide chunks; here a thread walks its own lane's
// cells and tests the cell's triangles one by one, keeping the first of
// equal nearest hits in the cell's order, as the chunked argmin does.
// The operations are the plain version's (drtvam_tpu_torch/ops/
// mesh_grid.py, ops/intersect.py moller_trumbore): the walk's separately
// rounded (--fmad=false), the Moller-Trumbore test's cross products and
// three-term sums fused with fmaf exactly where XLA fuses them on the
// CPU, so a hit t agrees bitwise with the JAX package's.
//
// Bound on the H100: a triangle test is ~40 float32 operations and three
// 12-byte reads (the mesh's banks, a few tens of KB, stay in L1 / L2);
// a cell step ~20 operations. A lane that misses the grid's box pays its
// slab test only.

// The banks of the scene's mesh surfaces (ops/render.py WfMesh): the
// triangles (T, 3) floats each, the grids' CSR cell starts and triangle
// ids, their boxes (n_grids, 2, 3); per surface its triangles [tri_start,
// tri_start + tri_count) and its grid (grid_res[3 s] 0: none), all 4-byte
// ints after the 8-byte pointers
struct WfMesh {
  const float* v0;
  const float* e1;
  const float* e2;
  const float* n;
  const int* cell_start;
  const int* tri_ids;
  const float* grid_bbox;
  int tri_start[WF_MAX_SURF], tri_count[WF_MAX_SURF];
  int grid_res[3 * WF_MAX_SURF];
  int cell_offset[WF_MAX_SURF], ids_offset[WF_MAX_SURF];
  int n_ids[WF_MAX_SURF], bbox_row[WF_MAX_SURF];
};

// what a mesh intersection did, counted when COUNT: grid cells visited
// and triangles tested
struct MeshCount {
  unsigned long long cells, tris;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

// jnp.cross and jnp.sum(a * b, -1) as XLA computes them on the CPU
__device__ __forceinline__ V3 cross_fma(const V3& a, const V3& b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}
__device__ __forceinline__ float dot_fma(const V3& a, const V3& b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
}

// Moller-Trumbore of the ray against triangle (a0, a1 = e1, a2 = e2): its
// hit distance beyond RAY_EPS, or inf
__device__ __forceinline__ float moller_trumbore(const V3& o, const V3& d,
                                                 const V3& a0, const V3& a1,
                                                 const V3& a2) {
  const V3 pvec = cross_fma(d, a2);
  const float det = dot_fma(a1, pvec);
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const V3 tvec = {o.x - a0.x, o.y - a0.y, o.z - a0.z};
  const float u = dot_fma(tvec, pvec) * inv_det;
  const V3 qvec = cross_fma(tvec, a1);
  const float v = dot_fma(d, qvec) * inv_det;
  const float t = dot_fma(a2, qvec) * inv_det;
  return (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > RAY_EPS)
             ? t
             : inf();
}

// triangle id of mesh surface s (local to the surface) into the best hit
template <bool COUNT>
__device__ __forceinline__ void test_triangle(const WfMesh& M, int a, int id,
                                              const V3& o, const V3& d,
                                              float& t_best, int& i_best,
                                              MeshCount& c) {
  if (COUNT) ++c.tris;
  const float t = moller_trumbore(o, d, load3(M.v0, a + id),
                                  load3(M.e1, a + id), load3(M.e2, a + id));
  if (t < t_best) {
    t_best = t;
    i_best = id;
  }
}

// The 3D-DDA walk over the grid of mesh surface s (ops/mesh_grid.py
// ray_triangles_grid, lane by lane): enter the grid's box beyond RAY_EPS,
// test each cell's triangles, stop at the first cell whose exit plane lies
// beyond the best hit (t_best <= t_exit (1 + 1e-6) + 1e-6), else step the
// first axis of the nearest exit plane
template <bool COUNT>
__device__ float ray_mesh_grid(const WfMesh& M, int s, const V3& o,
                               const V3& d, int& tri, MeshCount& c) {
  const int a = M.tri_start[s];
  const int* __restrict__ cs = M.cell_start + M.cell_offset[s];
  const int* __restrict__ ids = M.tri_ids + M.ids_offset[s];
  const float* __restrict__ bb = M.grid_bbox + 6 * M.bbox_row[s];
  const int res[3] = {M.grid_res[3 * s], M.grid_res[3 * s + 1],
                      M.grid_res[3 * s + 2]};
  const float od[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  float bmin[3], cell_w[3], safe_d[3];
  float near = -inf(), far = inf();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bmin[k] = __ldg(bb + k);
    const float bmax = __ldg(bb + 3 + k);
    cell_w[k] = (bmax - bmin[k]) / (float)res[k];
    safe_d[k] = fabsf(dd[k]) > 1e-20f ? dd[k] : 1e-20f;
    const float b0 = (bmin[k] - od[k]) / safe_d[k];
    const float b1 = (bmax - od[k]) / safe_d[k];
    near = mx(near, mn(b0, b1));
    far = mn(far, mx(b0, b1));
  }
  const float t_enter = mx(near, RAY_EPS), t_exit = far;
  float t_best = inf();
  tri = -1;
  if (!(t_enter <= t_exit && isfinite(t_enter))) return t_best;

  const float eps_t = 1e-5f * mx(fabsf(t_enter), 1.0f);
  int iv[3], step[3];
  float tmaxv[3], tdelta[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p_in = od[k] + (t_enter + eps_t) * dd[k];
    const int v = (int)((p_in - bmin[k]) / cell_w[k]);
    iv[k] = v < 0 ? 0 : (v > res[k] - 1 ? res[k] - 1 : v);
    step[k] = dd[k] > 0.0f ? 1 : -1;
    const float next_b =
        bmin[k] + (float)(iv[k] + (step[k] > 0 ? 1 : 0)) * cell_w[k];
    tmaxv[k] = fabsf(dd[k]) > 1e-20f ? (next_b - od[k]) / safe_d[k] : inf();
    tdelta[k] = fabsf(cell_w[k] / safe_d[k]);
  }
  const int n_cells = res[0] * res[1] * res[2];
  for (;;) {
    if (COUNT) ++c.cells;
    int flat = iv[0] + res[0] * (iv[1] + res[1] * iv[2]);
    flat = flat < 0 ? 0 : (flat > n_cells - 1 ? n_cells - 1 : flat);
    const int e = __ldg(cs + flat + 1);
    for (int j = __ldg(cs + flat); j < e; ++j)
      test_triangle<COUNT>(M, a, __ldg(ids + j), o, d, t_best, tri, c);
    const float t_cell_exit = mn(mn(tmaxv[0], tmaxv[1]), tmaxv[2]);
    if (t_best <= t_cell_exit * 1.000001f + 1e-6f) break;
    const int axis =
        tmaxv[0] == t_cell_exit ? 0 : (tmaxv[1] == t_cell_exit ? 1 : 2);
    bool in_grid = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k != axis) continue;
      iv[k] += step[k];
      tmaxv[k] = tmaxv[k] + tdelta[k];
      in_grid = iv[k] >= 0 && iv[k] < res[k];
    }
    if (!in_grid || t_cell_exit > t_exit) break;
  }
  return t_best;
}

// Nearest hit on mesh surface s: (t, the surface-local triangle id; inf,
// -1 on a miss)
template <bool COUNT>
__device__ __forceinline__ float ray_mesh(const WfMesh& M, int s,
                                          const V3& o, const V3& d, int& tri,
                                          MeshCount& c) {
  if (M.grid_res[3 * s] > 0) return ray_mesh_grid<COUNT>(M, s, o, d, tri, c);
  float t_best = inf();
  tri = -1;
  const int a = M.tri_start[s];
  for (int id = 0; id < M.tri_count[s]; ++id)
    test_triangle<COUNT>(M, a, id, o, d, t_best, tri, c);
  return t_best;
}
