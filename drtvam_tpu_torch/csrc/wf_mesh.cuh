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

// The warp's walks (the residual's target path pass, wf_res_target.cuh):
// the 32 threads of a warp test one cell's triangles together, thread l
// positions j0 + l, j0 + l + 32, ... of the list. A thread's share keeps
// its least t (strictly less: its lowest position of equal hits); the
// shares combine to the least (t, position), so the cell's nearest hit is
// the one the list's order gives one thread. On the host (the tests' g++
// build) one thread runs the 32 shares in turn
constexpr int WARP_LANES = 32;

// the better of two shares' (t, position): the lesser t, ties to the
// lower position
__device__ __forceinline__ void pick_nearest(float& t, int& j, float t2,
                                             int j2) {
  if (t2 < t || (t2 == t && j2 < j)) {
    t = t2;
    j = j2;
  }
}

// thread l's share of the list's positions [j0, e) (IDS: ids[j], else the
// positions themselves): its least t and its position (inf and e when none
// hits)
template <bool STAGED, bool IDS>
__device__ __forceinline__ void share_nearest(const float4* __restrict__ rows,
                                              const int* __restrict__ ids,
                                              int j0, int e, int l,
                                              const V3& o, const V3& d,
                                              float& t, int& j) {
  t = inf();
  j = e;
  for (int k = j0 + l; k < e; k += WARP_LANES) {
    V3 a0, a1, a2;
    tri_rows<STAGED>(rows, list_id<STAGED, IDS>(ids, k), a0, a1, a2);
    const float tk =
        moller_trumbore<WF_MESH_EARLY_EXIT != 0>(o, d, a0, a1, a2);
    if (tk < t) {
      t = tk;
      j = k;
    }
  }
}

// the warp's nearest hit among positions [j0, e) of a list, the same on
// every thread: (t, position; inf, e when none hits)
template <bool STAGED, bool IDS>
__device__ __forceinline__ void cell_nearest(const float4* __restrict__ rows,
                                             const int* __restrict__ ids,
                                             int j0, int e, int lane,
                                             const V3& o, const V3& d,
                                             float& t, int& j) {
#ifdef __CUDA_ARCH__
  share_nearest<STAGED, IDS>(rows, ids, j0, e, lane, o, d, t, j);
  for (int off = 16; off > 0; off >>= 1)
    pick_nearest(t, j, __shfl_xor_sync(0xffffffffu, t, off),
                 __shfl_xor_sync(0xffffffffu, j, off));
#else
  (void)lane;
  share_nearest<STAGED, IDS>(rows, ids, j0, e, 0, o, d, t, j);
  for (int l = 1; l < WARP_LANES; ++l) {
    float t2;
    int j2;
    share_nearest<STAGED, IDS>(rows, ids, j0, e, l, o, d, t2, j2);
    pick_nearest(t, j, t2, j2);
  }
#endif
}

// A ray's walk through the grid of mesh surface s between two cells: its
// cell, its steps along each axis, the t of the next exit plane on each
// axis and their increments a cell, and the t where it leaves the box
struct GridWalk {
  int iv[3], step[3];
  float tmaxv[3], tdelta[3], t_exit;
};

// The walk's set-up (ops/mesh_grid.py ray_triangles_grid): enter the
// grid's box beyond RAY_EPS, the entry cell, the exit planes. false: the
// ray misses the box
__device__ __forceinline__ bool grid_walk_init(const WfMesh& M, int s,
                                               const V3& o, const V3& d,
                                               GridWalk& W) {
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
  const float t_enter = mx(near, RAY_EPS);
  W.t_exit = far;
  if (!(t_enter <= W.t_exit && isfinite(t_enter))) return false;
  const float eps_t = 1e-5f * mx(fabsf(t_enter), 1.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p_in = od[k] + (t_enter + eps_t) * dd[k];
    const int v = (int)((p_in - bmin[k]) / cell_w[k]);
    W.iv[k] = v < 0 ? 0 : (v > res[k] - 1 ? res[k] - 1 : v);
    W.step[k] = dd[k] > 0.0f ? 1 : -1;
    const float next_b =
        bmin[k] + (float)(W.iv[k] + (W.step[k] > 0 ? 1 : 0)) * cell_w[k];
    W.tmaxv[k] =
        fabsf(dd[k]) > 1e-20f ? (next_b - od[k]) / safe_d[k] : inf();
    W.tdelta[k] = fabsf(cell_w[k] / safe_d[k]);
  }
  return true;
}

// The walk's step past a cell whose nearest exit plane lies at
// t_cell_exit: on the first axis of that plane. false: the walk leaves
// the grid or its box
__device__ __forceinline__ bool grid_step(GridWalk& W, const int res[3],
                                          float t_cell_exit) {
  const int axis =
      W.tmaxv[0] == t_cell_exit ? 0 : (W.tmaxv[1] == t_cell_exit ? 1 : 2);
  bool in_grid = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k != axis) continue;
    W.iv[k] += W.step[k];
    W.tmaxv[k] = W.tmaxv[k] + W.tdelta[k];
    in_grid = W.iv[k] >= 0 && W.iv[k] < res[k];
  }
  return in_grid && !(t_cell_exit > W.t_exit);
}

// The warp's walk of one ray (every thread calls with the ray and its
// set-up W) through its cells from W on, as ray_mesh_grid walks them:
// each cell's triangles tested, the walk stopped at the first cell whose
// exit plane lies beyond the best hit, else stepped on the first axis of
// the nearest exit plane. The threads test each cell together, a thread
// its share (share_nearest): a thread keeps its first hit at its least t
// (strictly less: the earliest cell, then position), the warp the least t
// of all after each cell (the stop rule's t_best), and at the walk's end
// the triangle is the first hit at that t in cell then list order, the
// one ray_mesh_grid's list order gives. Returns t and the triangle (inf,
// -1 on a miss); cells and triangles counted by the thread that owns the
// ray (owner); rounds adds the warp's test rounds (up to 32 tests each)
template <bool COUNT, bool STAGED>
__device__ __forceinline__ float grid_walk_cells(
    const WfMesh& M, const MeshBanks& B, int s, const V3& o, const V3& d,
    GridWalk W, int& tri, MeshCount& c, int lane, bool owner,
    unsigned long long* rounds) {
  const float4* __restrict__ rows = B.rows + 3 * M.tri_start[s];
  const int* __restrict__ cs = B.cell_start + M.cell_offset[s];
  const int* __restrict__ ids = B.tri_ids + M.ids_offset[s];
  const int res[3] = {M.grid_res[3 * s], M.grid_res[3 * s + 1],
                      M.grid_res[3 * s + 2]};
  float t_best = inf();
  tri = -1;
  const int n_cells = res[0] * res[1] * res[2];
  // the shares' first hits at their least t: (t, cell, position); on the
  // card this thread's, on the host the 32 shares'
  unsigned cell = 0;
#ifdef __CUDA_ARCH__
  float t_own = inf();
  unsigned cell_own = 0, j_own = 0;
#else
  float t_own[WARP_LANES];
  unsigned cell_own[WARP_LANES], j_own[WARP_LANES];
  for (int l = 0; l < WARP_LANES; ++l) t_own[l] = inf();
#endif
  for (;;) {
    if (COUNT && owner) ++c.cells;
    int flat = W.iv[0] + res[0] * (W.iv[1] + res[1] * W.iv[2]);
    flat = flat < 0 ? 0 : (flat > n_cells - 1 ? n_cells - 1 : flat);
    const int j0 = bank_int<STAGED>(cs, flat);
    const int e = bank_int<STAGED>(cs, flat + 1);
    if (COUNT && owner) c.tris += (unsigned long long)(e > j0 ? e - j0 : 0);
    if (rounds != nullptr && e > j0)
      *rounds +=
          (unsigned long long)((e - j0 + WARP_LANES - 1) / WARP_LANES);
    float tc;
    int jc;
#ifdef __CUDA_ARCH__
    share_nearest<STAGED, true>(rows, ids, j0, e, lane, o, d, tc, jc);
    if (tc < t_own) {
      t_own = tc;
      cell_own = cell;
      j_own = (unsigned)jc;
    }
    // t > 0: its bits order as the floats
    t_best = __uint_as_float(
        __reduce_min_sync(0xffffffffu, __float_as_uint(t_own)));
#else
    (void)lane;
    for (int l = 0; l < WARP_LANES; ++l) {
      share_nearest<STAGED, true>(rows, ids, j0, e, l, o, d, tc, jc);
      if (tc < t_own[l]) {
        t_own[l] = tc;
        cell_own[l] = cell;
        j_own[l] = (unsigned)jc;
      }
      t_best = mn(t_best, t_own[l]);
    }
#endif
    ++cell;
    const float t_cell_exit = mn(mn(W.tmaxv[0], W.tmaxv[1]), W.tmaxv[2]);
    if (t_best <= t_cell_exit * 1.000001f + 1e-6f) break;
    if (!grid_step(W, res, t_cell_exit)) break;
  }
  if (t_best < inf()) {
    // the first hit at t_best: the least cell, then position
#ifdef __CUDA_ARCH__
    const bool at = t_own == t_best;
    const unsigned c_min =
        __reduce_min_sync(0xffffffffu, at ? cell_own : 0xffffffffu);
    const unsigned j_min = __reduce_min_sync(
        0xffffffffu, at && cell_own == c_min ? j_own : 0xffffffffu);
#else
    unsigned c_min = 0xffffffffu, j_min = 0xffffffffu;
    for (int l = 0; l < WARP_LANES; ++l)
      if (t_own[l] == t_best &&
          (cell_own[l] < c_min || (cell_own[l] == c_min && j_own[l] < j_min))) {
        c_min = cell_own[l];
        j_min = j_own[l];
      }
#endif
    tri = bank_int<STAGED>(ids, (int)j_min);
  }
  return t_best;
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
  const int res[3] = {M.grid_res[3 * s], M.grid_res[3 * s + 1],
                      M.grid_res[3 * s + 2]};
  float t_best = inf();
  tri = -1;
  GridWalk W;
  if (!grid_walk_init(M, s, o, d, W)) return t_best;
  if (COUNT) ++c.walks;
  const int n_cells = res[0] * res[1] * res[2];
  // COUNT: the walk's earlier cells
  [[maybe_unused]] int seen[COUNT ? WF_MESH_SEEN : 1];
  [[maybe_unused]] int n_seen = 0;
  for (;;) {
    if (COUNT) ++c.cells;
    int flat = W.iv[0] + res[0] * (W.iv[1] + res[1] * W.iv[2]);
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
    const float t_cell_exit = mn(mn(W.tmaxv[0], W.tmaxv[1]), W.tmaxv[2]);
    if (t_best <= t_cell_exit * 1.000001f + 1e-6f) break;
    if (!grid_step(W, res, t_cell_exit)) break;
  }
  return t_best;
}

// The warp's nearest hit of one ray on mesh surface s (every thread calls
// with the ray and, for a surface with a grid, its walk's set-up W:
// ray_mesh's t and triangle; counted by the owner, test rounds into
// rounds): the grid walked, or all its triangles tested together below
// GRID_MIN_TRIS
template <bool COUNT, bool STAGED>
__device__ __forceinline__ float ray_mesh_warp(
    const WfMesh& M, const MeshBanks& B, int s, const V3& o, const V3& d,
    const GridWalk& W, int& tri, MeshCount& c, int lane, bool owner,
    unsigned long long* rounds) {
  if (M.grid_res[3 * s] > 0) {
    if (COUNT && owner) ++c.walks;
    return grid_walk_cells<COUNT, STAGED>(M, B, s, o, d, W, tri, c, lane,
                                          owner, rounds);
  }
  const int n = M.tri_count[s];
  if (COUNT && owner) c.tris += (unsigned long long)n;
  if (rounds != nullptr && n > 0)
    *rounds += (unsigned long long)((n + WARP_LANES - 1) / WARP_LANES);
  float t;
  int j;
  cell_nearest<STAGED, false>(B.rows + 3 * M.tri_start[s], nullptr, 0, n,
                              lane, o, d, t, j);
  tri = t < inf() ? j : -1;
  return t;
}

// whether a ray's walk on mesh surface s tests any triangle, and its
// walk's set-up W: it enters the grid's box (grid_walk_init), or the
// surface has no grid
__device__ __forceinline__ bool mesh_walks(const WfMesh& M, int s,
                                           const V3& o, const V3& d,
                                           GridWalk& W) {
  if (M.grid_res[3 * s] <= 0) return true;
  return grid_walk_init(M, s, o, d, W);
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

#ifdef __CUDACC__
// The staged banks' dynamic shared memory for kernel k (the target forms,
// wf_target.cuh and wf_res_target.cuh), its limit raised to it; fits: they
// fit a CTA's share of the SM's shared memory at min_ctas CTAs an SM
// beside the kernel's static part
inline cudaError_t stage_shape(const void* k, const WfMesh& M, int min_ctas,
                               size_t& smem, bool& fits) {
  int dev, per_sm, optin, reserved;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return e;
  size_t budget = (size_t)per_sm / min_ctas - (size_t)reserved;
  if (budget > (size_t)optin) budget = (size_t)optin;
  smem = bank_bytes(M.n_rows, M.n_cell_start, M.n_tri_ids);
  fits = smem + fa.sharedSizeBytes <= budget;
  if (!fits) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
#endif  // __CUDACC__
