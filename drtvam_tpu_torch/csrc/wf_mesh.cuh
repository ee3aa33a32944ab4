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
// Bound on the H100: a triangle test is ~40 float32 operations (one
// IEEE reciprocal among them) and three 16-byte rows of the triangle
// banks; a cell step ~20 operations. A lane that misses the grid's box
// pays its slab test only. The banks are a few tens of KB (the bench
// target: 792 triangles, 5,596 cell entries), so the culling kernels
// (wf_cull.cuh) stage them in each CTA's shared memory where they fit
// its share of the SM, and read the global copies where they do not: the
// walk's chain of dependent loads (cell start, triangle id, the
// triangle's rows) then runs at shared memory's latency, not L1's, and a
// triangle's v0, e1, e2 are three 16-byte loads from one address, not
// nine 4-byte ones. A test returns at the first condition that fails
// (u, then v and u + v): each skipped part would have failed with the
// values it skips, so t and the hit are the full test's. (Measured on an
// H100 and left, PERF.md section 6: two tests interleaved, the next
// triangle's id or rows loaded ahead, and a rejection by bounds on the
// sums before the reciprocal: none faster.)

// the triangle test's early returns (moller_trumbore), on (1) unless a
// measurement build turns them off (tools/wf_variants.py cull)
#ifndef WF_MESH_EARLY_EXIT
#define WF_MESH_EARLY_EXIT 1
#endif

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
  // the merged banks' lengths: triangle rows (MeshBanks), cell starts and
  // triangle ids
  int n_rows, n_cell_start, n_tri_ids;
};

// The banks as a lane's mesh test reads them: each triangle as three
// 16-byte rows, v0, e1 and e2 (x, y, z, 0; ops/render.py cull_rows), at
// rows 3 i .. 3 i + 2 of triangle i of the merged bank, and the grids'
// cell starts and triangle ids, merged as in WfMesh. STAGED: they lie in
// the CTA's shared memory (stage_banks), else in global memory
struct MeshBanks {
  const float4* rows;
  const int* cell_start;
  const int* tri_ids;
};

// the bytes the staged banks take: the rows, then the cell starts and the
// triangle ids
inline size_t bank_bytes(int n_rows, int n_cell_start, int n_tri_ids) {
  return 16 * (size_t)n_rows + 4 * ((size_t)n_cell_start + (size_t)n_tri_ids);
}

// one 16-byte and one 4-byte copy into shared memory, and the wait for a
// thread's copies (cp.async on the card)
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy4(int* dst, const int* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The global banks G (n_rows rows, n_cs cell starts, n_ids triangle ids)
// staged in smem (bank_bytes): thread tid of n_threads copies its share
// and waits for its copies; the caller's barrier then publishes them.
// Returns the staged banks
__device__ __forceinline__ MeshBanks stage_banks(const MeshBanks& G,
                                                 int n_rows, int n_cs,
                                                 int n_ids, float4* smem,
                                                 int tid, int n_threads) {
  int* cs = reinterpret_cast<int*>(smem + n_rows);
  int* ids = cs + n_cs;
  for (int i = tid; i < n_rows; i += n_threads) copy16(smem + i, G.rows + i);
  for (int i = tid; i < n_cs; i += n_threads) copy4(cs + i, G.cell_start + i);
  for (int i = tid; i < n_ids; i += n_threads) copy4(ids + i, G.tri_ids + i);
  copy_wait();
  return {smem, cs, ids};
}

// what a mesh intersection did, counted when COUNT: grid cells visited,
// triangles tested, grid walks that entered their box, and tests of a
// triangle the walk had tested in an earlier cell (a triangle lies in
// every cell its box meets; counted over a walk's first WF_MESH_SEEN
// cells)
struct MeshCount {
  unsigned long long cells, tris, walks, repeats;
};
constexpr int WF_MESH_SEEN = 32;

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

// entry i of an int bank: a shared-memory load (STAGED: ld.shared,
// whatever the compiler can tell of the pointer) or a read-only global one
template <bool STAGED>
__device__ __forceinline__ int bank_int(const int* __restrict__ p, int i) {
#ifdef __CUDA_ARCH__
  if constexpr (STAGED) {
    int r;
    asm volatile("ld.shared.s32 %0, [%1];"
                 : "=r"(r)
                 : "r"((unsigned)__cvta_generic_to_shared(p) + 4u * i));
    return r;
  } else {
    return __ldg(p + i);
  }
#else
  return p[i];
#endif
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
// hit distance beyond RAY_EPS, or inf. The plain version's condition is
// ok && u >= 0 && v >= 0 && u + v <= 1 && t > RAY_EPS; EARLY: the test
// returns inf at the first part that fails (u > 1 fails it too, since
// u + v rounds to at least u for v >= 0), else it runs without a branch.
// Every early return is a rejection of the full test, so t and the hit
// are the full test's
template <bool EARLY>
__device__ __forceinline__ float moller_trumbore(const V3& o, const V3& d,
                                                 const V3& a0, const V3& a1,
                                                 const V3& a2) {
  const V3 pvec = cross_fma(d, a2);
  const float det = dot_fma(a1, pvec);
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const V3 tvec = {o.x - a0.x, o.y - a0.y, o.z - a0.z};
  const float u = dot_fma(tvec, pvec) * inv_det;
  if (EARLY && !(ok && u >= 0.0f && u <= 1.0f)) return inf();
  const V3 qvec = cross_fma(tvec, a1);
  const float v = dot_fma(d, qvec) * inv_det;
  if (EARLY && !(v >= 0.0f && u + v <= 1.0f)) return inf();
  const float t = dot_fma(a2, qvec) * inv_det;
  return (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > RAY_EPS)
             ? t
             : inf();
}

__device__ __forceinline__ V3 xyz(const float4& r) { return {r.x, r.y, r.z}; }

// triangle id's rows v0, e1, e2 (MeshBanks) from a bank whose first row is
// rows[0]: one address, three 16-byte loads at offsets 0, 16 and 32
template <bool STAGED>
__device__ __forceinline__ void tri_rows(const float4* __restrict__ rows,
                                         int id, V3& a0, V3& a1, V3& a2) {
  float4 r0, r1, r2;
#ifdef __CUDA_ARCH__
  if constexpr (STAGED) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(rows) + 48u * id;
    asm volatile(
        "ld.shared.v4.f32 {%0, %1, %2, %3}, [%12];\n\t"
        "ld.shared.v4.f32 {%4, %5, %6, %7}, [%12+16];\n\t"
        "ld.shared.v4.f32 {%8, %9, %10, %11}, [%12+32];"
        : "=f"(r0.x), "=f"(r0.y), "=f"(r0.z), "=f"(r0.w), "=f"(r1.x),
          "=f"(r1.y), "=f"(r1.z), "=f"(r1.w), "=f"(r2.x), "=f"(r2.y),
          "=f"(r2.z), "=f"(r2.w)
        : "r"(a));
  } else {
    const float4* __restrict__ r = rows + 3 * id;
    r0 = __ldg(r);
    r1 = __ldg(r + 1);
    r2 = __ldg(r + 2);
  }
#else
  r0 = rows[3 * id];
  r1 = rows[3 * id + 1];
  r2 = rows[3 * id + 2];
#endif
  a0 = xyz(r0);
  a1 = xyz(r1);
  a2 = xyz(r2);
}

// position k's triangle of a list: its id (IDS), or k itself
template <bool STAGED, bool IDS>
__device__ __forceinline__ int list_id(const int* __restrict__ ids, int k) {
  if constexpr (IDS) return bank_int<STAGED>(ids, k);
  return k;
}

// The triangles at positions [j, e) of a list (IDS: ids[j], else the
// positions themselves) of a surface whose first row is rows[0], in list
// order, into the best hit: a strict t < t_best keeps the first of equal
// hits
template <bool COUNT, bool STAGED, bool IDS>
__device__ __forceinline__ void test_triangles(
    const float4* __restrict__ rows, const int* __restrict__ ids, int j,
    int e, const V3& o, const V3& d, float& t_best, int& i_best,
    MeshCount& c) {
  if (COUNT) c.tris += (unsigned long long)(e > j ? e - j : 0);
  for (; j < e; ++j) {
    const int a = IDS ? bank_int<STAGED>(ids, j) : j;
    V3 a0, a1, a2;
    tri_rows<STAGED>(rows, a, a0, a1, a2);
    const float t = moller_trumbore<WF_MESH_EARLY_EXIT != 0>(o, d, a0, a1, a2);
    if (t < t_best) {
      t_best = t;
      i_best = a;
    }
  }
}

// The 3D-DDA walk over the grid of mesh surface s (ops/mesh_grid.py
// ray_triangles_grid, lane by lane): enter the grid's box beyond RAY_EPS,
// test each cell's triangles, stop at the first cell whose exit plane lies
// beyond the best hit (t_best <= t_exit (1 + 1e-6) + 1e-6), else step the
// first axis of the nearest exit plane
template <bool COUNT, bool STAGED>
__device__ __forceinline__ float ray_mesh_grid(const WfMesh& M,
                                               const MeshBanks& B, int s,
                                               const V3& o, const V3& d,
                                               int& tri, MeshCount& c) {
  const float4* __restrict__ rows = B.rows + 3 * M.tri_start[s];
  const int* __restrict__ cs = B.cell_start + M.cell_offset[s];
  const int* __restrict__ ids = B.tri_ids + M.ids_offset[s];
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
  if (COUNT) ++c.walks;

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
  // COUNT: the walk's earlier cells
  [[maybe_unused]] int seen[COUNT ? WF_MESH_SEEN : 1];
  [[maybe_unused]] int n_seen = 0;
  for (;;) {
    if (COUNT) ++c.cells;
    int flat = iv[0] + res[0] * (iv[1] + res[1] * iv[2]);
    flat = flat < 0 ? 0 : (flat > n_cells - 1 ? n_cells - 1 : flat);
    const int j0 = bank_int<STAGED>(cs, flat);
    const int e = bank_int<STAGED>(cs, flat + 1);
    if constexpr (COUNT) {
      for (int j = j0; j < e; ++j) {
        bool again = false;
        for (int q = 0; q < n_seen; ++q)
          for (int k = cs[seen[q]]; k < cs[seen[q] + 1]; ++k)
            again = again || ids[k] == ids[j];
        c.repeats += again ? 1 : 0;
      }
      if (n_seen < WF_MESH_SEEN) seen[n_seen++] = flat;
    }
    test_triangles<COUNT, STAGED, true>(rows, ids, j0, e, o, d, t_best, tri,
                                        c);
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
template <bool COUNT, bool STAGED>
__device__ __forceinline__ float ray_mesh(const WfMesh& M,
                                          const MeshBanks& B, int s,
                                          const V3& o, const V3& d, int& tri,
                                          MeshCount& c) {
  if (M.grid_res[3 * s] > 0)
    return ray_mesh_grid<COUNT, STAGED>(M, B, s, o, d, tri, c);
  float t_best = inf();
  tri = -1;
  test_triangles<COUNT, STAGED, false>(B.rows + 3 * M.tri_start[s], nullptr,
                                       0, M.tri_count[s], o, d, t_best, tri,
                                       c);
  return t_best;
}
