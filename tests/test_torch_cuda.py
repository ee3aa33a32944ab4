"""The CUDA kernels == their plain versions, on a card: the four
backprojection kernels, their bf16 operand forms, the wavefront pair
(wf_fwd, wf_bwd), the medium adjoint (wf_med), the residual pair
(wf_res_fwd, wf_res_bwd), their target instantiations (a surface-aware
film) and target forms (the residual's target path pass against the
one-pass instantiation), the culling renders (wf_radon, wf_corner) and
the ballistic engine's z-resample (zres). Free of
jax (the card's machine has none), so it runs there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On a machine without CUDA every test skips; chip_smoke.py phases 3, 7
and 7c run the same comparisons at the bench shapes and on more
scenes."""
import numpy as np
import pytest
import torch

from drtvam_tpu_torch.ops import backproject as bp
from drtvam_tpu_torch.ops import render as wf

from z_taps import z_taps

TOL = 1e-5  # f32 sums in another order than the plain versions


def _fields(seed, A=5, Y=64, X=128, U=300, Zf=40):
    """Banded u-geometry: u an affine projection of (x, y) per angle."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0
    ys, xs = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    scale = (U - 8) / np.hypot(Y, X) / 2
    Umap = np.empty((A, Y, X), np.float32)
    for a in range(A):
        th = 2 * np.pi * a / A
        proj = np.cos(th) * xs + np.sin(th) * ys
        Umap[a] = (proj - proj.min()) * scale + 3.0 + \
            rng.uniform(-0.4, 0.4, (Y, X))
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return [torch.from_numpy(x) for x in (Pz, W, Umap, dL)] + [U]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3 covers it")
    return torch.device("cuda")


def _close(out, ref):
    ref = ref.numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("banded", [False, True])
def test_kernels_match_plain(banded, cuda_device):
    Pz, W, Umap, dL, U = _fields(seed=11)
    assert bp.band_span_ok(W, Umap, U)
    cpu = bp.PackedFields(W, Umap, U, banded)
    gpu = bp.PackedFields(W.to(cuda_device), Umap.to(cuda_device), U,
                          banded)
    names = ("bp_fwd_band", "bp_bwd_band") if banded else \
        ("bp_fwd", "bp_bwd")
    before = dict(bp.launches)
    fwd = gpu.forward(Pz.to(cuda_device))
    bwd = gpu.adjoint(dL.to(cuda_device))
    torch.cuda.synchronize()
    for n in names:
        assert bp.launches[n] == before[n] + 1
    _close(fwd, cpu.forward(Pz))
    _close(bwd, cpu.adjoint(dL))


def _wide_fields(seed, A, Y, X, U, Zf):
    """Scattered u over [-1.5, U + 0.5): taps at -1 and U are dropped,
    and every tile's column window is about U wide."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0
    Umap = rng.uniform(-1.5, U + 0.5, (A, Y, X)).astype(np.float32)
    Umap[:, 0, :8] = U - 1
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return [torch.from_numpy(x) for x in (Pz, W, Umap, dL)] + [U]


# (A, Y, X, U, Zf): films that do not tile into 32x32, Zf off the
# z-chunks (bp_fwd 32, bp_bwd 128), windows wider than 256 columns
RAGGED = [(4, 40, 50, 70, 20), (3, 48, 80, 100, 30), (2, 33, 65, 700, 130),
          (3, 1, 37, 300, 1)]


@pytest.mark.parametrize("shape", RAGGED)
def test_dense_kernels_on_ragged_shapes(shape, cuda_device):
    A, Y, X, U, Zf = shape
    Pz, W, Umap, dL, U = _wide_fields(sum(shape), A, Y, X, U, Zf)
    cpu = bp.PackedFields(W, Umap, U, banded=False)
    gpu = bp.PackedFields(W.to(cuda_device), Umap.to(cuda_device), U,
                          banded=False)
    assert gpu.layout is not None
    Pzd, dLd = Pz.to(cuda_device), dL.to(cuda_device)
    before = dict(bp.launches)
    fwd, bwd = gpu.forward(Pzd), gpu.adjoint(dLd)
    fwd2, bwd2 = gpu.forward(Pzd), gpu.adjoint(dLd)
    torch.cuda.synchronize()
    assert bp.launches["bp_fwd"] == before["bp_fwd"] + 2
    assert bp.launches["bp_bwd"] == before["bp_bwd"] + 2
    _close(fwd, cpu.forward(Pz))
    _close(bwd, cpu.adjoint(dL))
    # no atomics: every output element is written once, in a fixed order
    assert torch.equal(fwd, fwd2) and torch.equal(bwd, bwd2)


def test_dense_kernels_without_a_layout(cuda_device):
    """fwd_dense / bwd_dense called on bare fields build their own
    layout (one-row film) and compute the same function."""
    Pz, W, Umap, dL, U = _fields(seed=3)
    F = bp._pack_fields(W, Umap)
    Fd = F.to(cuda_device)
    _close(bp.fwd_dense(Pz.to(cuda_device), Fd), bp.fwd_dense_plain(Pz, F))
    _close(bp.bwd_dense(dL.to(cuda_device), Fd, U),
           bp.bwd_dense_plain(dL, F, U))


# (A, Y, X, U, Zf): scattered u, so most (angle, block) bands drop taps;
# Zf off both kernels' z-chunks
BAND_SPAN_FAIL = [(3, 64, 128, 300, 30), (2, 32, 64, 700, 130)]


@pytest.mark.parametrize("shape", BAND_SPAN_FAIL)
def test_band_kernels_drop_out_of_band_taps_like_plain(shape, cuda_device):
    A, Y, X, U, Zf = shape
    Pz, W, Umap, dL, U = _wide_fields(sum(shape), A, Y, X, U, Zf)
    assert not bp.band_span_ok(W, Umap, U)
    cpu = bp.PackedFields(W, Umap, U, banded=True)
    gpu = bp.PackedFields(W.to(cuda_device), Umap.to(cuda_device), U,
                          banded=True)
    assert gpu.layout is not None and gpu.layout.windows[1] <= bp.BANDW
    Pzd, dLd = Pz.to(cuda_device), dL.to(cuda_device)
    before = dict(bp.launches)
    fwd, bwd = gpu.forward(Pzd), gpu.adjoint(dLd)
    fwd2, bwd2 = gpu.forward(Pzd), gpu.adjoint(dLd)
    torch.cuda.synchronize()
    assert bp.launches["bp_fwd_band"] == before["bp_fwd_band"] + 2
    assert bp.launches["bp_bwd_band"] == before["bp_bwd_band"] + 2
    _close(fwd, cpu.forward(Pz))
    _close(bwd, cpu.adjoint(dL))
    # no atomics: every output element is written once, in a fixed order
    assert torch.equal(fwd, fwd2) and torch.equal(bwd, bwd2)


@pytest.mark.parametrize("seed", [11, 12])
def test_band_kernels_equal_dense_where_span_ok(seed, cuda_device):
    """Where the bands cover their blocks, the band-masked layout is the
    dense one and both pairs run the same kernel templates on it, in the
    same order: the results are bitwise equal."""
    Pz, W, Umap, dL, U = _fields(seed=seed)
    assert bp.band_span_ok(W, Umap, U)
    Wd, Ud = W.to(cuda_device), Umap.to(cuda_device)
    dense = bp.PackedFields(Wd, Ud, U, banded=False)
    band = bp.PackedFields(Wd, Ud, U, banded=True)
    Pzd, dLd = Pz.to(cuda_device), dL.to(cuda_device)
    assert torch.equal(band.forward(Pzd), dense.forward(Pzd))
    assert torch.equal(band.adjoint(dLd), dense.adjoint(dLd))


def test_band_kernels_without_a_layout(cuda_device):
    """fwd_band / bwd_band called on bare fields build their own
    layout and compute the same function."""
    Pz, W, Umap, dL, U = _fields(seed=4)
    A, Y, X = W.shape
    F, u0 = bp._pack_fields_banded(W, Umap, U)
    Fd, u0d = F.to(cuda_device), u0.to(cuda_device)
    _close(bp.fwd_band(Pz.to(cuda_device), Fd, u0d, Y, X),
           bp.fwd_band_plain(Pz, F, u0, Y, X))
    _close(bp.bwd_band(dL.to(cuda_device), Fd, u0d, U, Y, X),
           bp.bwd_band_plain(dL, F, u0, U, Y, X))


def test_kernels_reject_cpu_cuda_mix(cuda_device):
    Pz, W, Umap, dL, U = _fields(seed=0)
    F = bp._pack_fields(W, Umap).to(cuda_device)
    with pytest.raises(ValueError):
        bp.fwd_dense(Pz, F)


# --------------------------------------------------------------------------
# the bf16 operand forms: the same templates with bfloat16 operands


BF16_CASES = [(False, None), (True, None)] + \
    [(False, shape) for shape in RAGGED] + \
    [(True, shape) for shape in BAND_SPAN_FAIL]


@pytest.mark.parametrize("banded,shape", BF16_CASES)
def test_bf16_kernels_match_plain(banded, shape, cuda_device):
    """bp_*_bf16 against the plain bf16 versions: banded geometry, then
    ragged films, Zf off the bf16 copy's 8-row padding, wide windows,
    and bands that drop taps."""
    if shape is None:
        Pz, W, Umap, dL, U = _fields(seed=13)
    else:
        A, Y, X, U, Zf = shape
        Pz, W, Umap, dL, U = _wide_fields(sum(shape) + 1, A, Y, X, U, Zf)
    cpu = bp.PackedFields(W, Umap, U, banded, bf16=True)
    gpu = bp.PackedFields(W.to(cuda_device), Umap.to(cuda_device), U,
                          banded, bf16=True)
    names = ("bp_fwd_band_bf16", "bp_bwd_band_bf16") if banded else \
        ("bp_fwd_bf16", "bp_bwd_bf16")
    Pzd, dLd = Pz.to(cuda_device), dL.to(cuda_device)
    before = dict(bp.launches)
    fwd, bwd = gpu.forward(Pzd), gpu.adjoint(dLd)
    fwd2, bwd2 = gpu.forward(Pzd), gpu.adjoint(dLd)
    torch.cuda.synchronize()
    for n in bp.KERNELS:
        assert bp.launches[n] == before[n] + (2 if n in names else 0)
    _close(fwd, cpu.forward(Pz))
    _close(bwd, cpu.adjoint(dL))
    assert torch.equal(fwd, fwd2) and torch.equal(bwd, bwd2)


# --------------------------------------------------------------------------
# the wavefront pair

# wf kernel vs plain version on the card: the same per-lane arithmetic,
# rounded op by op (no FMA contraction); the forward sums its deposits
# with atomics in another order than index_add_
WF_TOL = 1e-5


def _wf_scene(tmp_path, case):
    """Small scenes built by the port alone: (static, arr, spp)."""
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.mesh import make_box, save_ply
    path = str(tmp_path / "t.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    med = {"ior": 1.4849, "extinction": 0.1, "albedo": 0.0,
           "phase": {"type": "rayleigh"}}
    cfg = {
        "vial": {"type": "cylindrical", "r_ext": 8.385, "r_int": 7.665,
                 "height": 20.0, "ior": 1.514, "medium": med},
        "projector": {"type": "collimated", "n_patterns": 10, "resx": 24,
                      "resy": 16, "pixel_size": 16.77 / 24,
                      "motion": "circular", "distance": 25.0},
        "sensor": {"type": "dda", "scalex": 16.77, "scaley": 16.77,
                   "scalez": 16.77, "majorant": 10.0,
                   "film": {"type": "vfilm", "resx": 32, "resy": 32,
                            "resz": 32}},
        "target": {"filename": path, "size": 4.0}, "output": str(tmp_path)}
    transmission_only = True
    if case == "ratio_scattering_telecentric_reflecting":
        med["albedo"] = 0.5
        cfg["sensor"]["type"] = "ratio"
        cfg["projector"].update(type="telecentric", aperture_radius=0.2,
                                focus_distance=20.0)
        transmission_only = False
    static, arr = Scene(cfg).build(mode="volume", include_target=False,
                                   max_depth=8, rr_depth=3,
                                   transmission_only=transmission_only,
                                   sample_time=True)
    return static, arr, 4


def _wf_close(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=WF_TOL,
                               atol=WF_TOL * np.abs(ref).max())


WF_CASES = ["dda_absorbing", "ratio_scattering_telecentric_reflecting"]


@pytest.mark.parametrize("case", WF_CASES)
def test_wf_kernels_match_plain(case, tmp_path, cuda_device):
    from drtvam_tpu_torch.ops.march import scene_tensors
    static, arr, spp = _wf_scene(tmp_path, case)
    at = scene_tensors(arr, cuda_device)
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, static.projector.n_active)
                            .astype(np.float32)).to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    before = dict(wf.launches)
    dose = wf.forward(static, at, data, 7, spp)
    grad = wf.adjoint(static, at, 7, spp, wf.DEFAULT_CHUNK, dL)
    grad2 = wf.adjoint(static, at, 7, spp, wf.DEFAULT_CHUNK, dL)
    torch.cuda.synchronize()
    assert wf.launches["wf_fwd"] == before["wf_fwd"] + 1
    assert wf.launches["wf_bwd"] == before["wf_bwd"] + 2
    assert float(dose.abs().max()) > 0 and float(grad.abs().max()) > 0
    _wf_close(dose, wf._forward(static, at, data, 7, spp, wf.DEFAULT_CHUNK))
    _wf_close(grad, wf._adjoint(static, at, 7, spp, wf.DEFAULT_CHUNK, dL))
    # one write per pixel, lanes summed in a fixed order
    assert torch.equal(grad, grad2)


@pytest.mark.parametrize("case", WF_CASES + ["dda_first_scatter"])
def test_pixel_blocks_on_the_card(case, tmp_path, cuda_device):
    """A rank's block (parallel/shard.py pixel_block: the kernels' launch
    order over its pixels alone), three blocks of the store: each block's
    gradient bitwise the whole launch's on its pixels and 0 elsewhere,
    the blocks' doses summing to the whole dose to WF_TOL of the max."""
    from drtvam_tpu_torch.ops.march import scene_tensors
    from drtvam_tpu_torch.parallel.shard import block_range, pixel_block
    if case == "dda_first_scatter":
        static, at = _res_scene(tmp_path, "dda", "first_scatter")
        spp = 4
    else:
        static, arr, spp = _wf_scene(tmp_path, case)
        at = scene_tensors(arr, cuda_device)
    n = static.projector.n_active
    rng = np.random.default_rng(8)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)) \
        .to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    dose = wf.forward(static, at, data, 7, spp)
    grad = wf.adjoint(static, at, 7, spp, wf.DEFAULT_CHUNK, dL)
    total = torch.zeros_like(dose)
    for r in range(3):
        lo, hi = block_range(n, 3, r)
        st = pixel_block(static, lo, hi)
        total += wf.forward(st, at, data, 7, spp)
        g = wf.adjoint(st, at, 7, spp, wf.DEFAULT_CHUNK, dL)
        assert torch.equal(g[lo:hi], grad[lo:hi])
        assert not bool(g[:lo].any()) and not bool(g[hi:].any())
    assert float(grad.abs().max()) > 0
    _wf_close(total, dose)


def test_wf_cuda_tensors_never_take_the_plain_path(tmp_path, cuda_device,
                                                   monkeypatch):
    from drtvam_tpu_torch.ops.march import scene_tensors
    static, arr, spp = _wf_scene(tmp_path, "dda_absorbing")
    at = scene_tensors(arr, cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(wf, "_forward", refuse)
    monkeypatch.setattr(wf, "_adjoint", refuse)
    monkeypatch.setattr(wf, "trace_wavefront", refuse)
    data = torch.ones(static.projector.n_active, device=cuda_device,
                      requires_grad=True)
    vol = wf.render(static, at, data, 2.0, seed=1, spp=spp)
    (g,) = torch.autograd.grad(vol.sum(), data)
    torch.cuda.synchronize()
    assert vol.is_cuda and g.is_cuda and float(g.abs().sum()) > 0


@pytest.mark.parametrize("case", WF_CASES)
def test_med_kernel_matches_plain(case, tmp_path, cuda_device, monkeypatch):
    """The medium adjoint (csrc/wf_med.cu) against its plain version, on
    patterns with 40 % zeros: (stg, ssg) to 1e-4 relative (float32 sums in
    another order), two launches bitwise; autograd of a render on CUDA
    tensors launches it and never the plain version: in (sigma_t, albedo)
    alone it once and wf_bwd never, in the patterns too it once beside one
    wf_bwd whose pattern gradient it returns, with the same medium
    gradients."""
    import dataclasses
    from drtvam_tpu_torch.ops.march import scene_tensors
    static, arr, spp = _wf_scene(tmp_path, case)
    static = dataclasses.replace(static, medium_grads=True)
    at = scene_tensors(arr, cuda_device)
    rng = np.random.default_rng(8)
    n = static.projector.n_active
    data = rng.uniform(0.5, 1.5, n).astype(np.float32)
    data[rng.uniform(0.0, 1.0, n) < 0.4] = 0.0
    data = torch.from_numpy(data).to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    ref = wf._adjoint(static, at, 7, spp, wf.DEFAULT_CHUNK, dL, data=data)
    stg, ssg, part, _ = wf.wf_med(static, at, dL, data, 7, spp, True)
    stg2, ssg2, part2, _ = wf.wf_med(static, at, dL, data, 7, spp, True)
    assert torch.equal(part, part2)
    assert float(stg) == float(stg2) and float(ssg) == float(ssg2)
    for ours, plain in zip((stg, ssg), ref[1:]):
        assert abs(float(ours) - float(plain)) <= 1e-4 * abs(float(plain))
    bwd = wf.wf_bwd(static, at, dL, 7, spp)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(wf, "_adjoint", refuse)
    monkeypatch.setattr(wf, "trace_wavefront", refuse)
    for need in (False, True):
        st = at["sigma_t"].clone().requires_grad_(True)
        al = at["albedo"].clone().requires_grad_(True)
        d = data.clone().requires_grad_(need)
        before = dict(wf.launches)
        vol = wf.render(static, at, d, 1.0, 7, spp, medium=(st, al))
        g = torch.autograd.grad((vol.reshape(-1) * dL).sum(),
                                (d, st, al) if need else (st, al))
        assert wf.launches["wf_med"] == before["wf_med"] + 1
        assert wf.launches["wf_bwd"] == before["wf_bwd"] + int(need)
        if need:
            assert torch.equal(g[0], bwd)
        g_st, g_al = g[-2:]
        assert torch.equal(g_st, stg + at["albedo"] * ssg)
        assert torch.equal(g_al, at["sigma_t"] * ssg)


# the residual pair (the hybrid engine's scattered residual)

RES_CASES = [("delta", "fast_residual"), ("dda", "first_scatter"),
             ("ratio", "scattered_only")]


def _res_scene(tmp_path, estimator, mode):
    """_wf_scene's scene with albedo 0.5: the residual static and tensors
    of a ScatteringEngine on the card, in `mode`."""
    import dataclasses
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
    from drtvam_tpu_torch.ops.mesh import make_box, save_ply
    path = str(tmp_path / "t.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    cfg = {
        "vial": {"type": "cylindrical", "r_ext": 8.385, "r_int": 7.665,
                 "height": 20.0, "ior": 1.514,
                 "medium": {"ior": 1.4849, "extinction": 0.1,
                            "albedo": 0.5, "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": 10, "resx": 24,
                      "resy": 16, "pixel_size": 16.77 / 24,
                      "motion": "circular", "distance": 25.0},
        "sensor": {"type": estimator, "scalex": 16.77, "scaley": 16.77,
                   "scalez": 16.77, "majorant": 10.0,
                   "film": {"type": "vfilm", "resx": 32, "resy": 32,
                            "resz": 32}},
        "target": {"filename": path, "size": 4.0}, "output": str(tmp_path)}
    static, arr = Scene(cfg).build(mode="volume", include_target=False,
                                   max_depth=8, rr_depth=3, sample_time=True)
    eng = ScatteringEngine(static, arr, "cuda",
                           first_scatter=mode != "scattered_only")
    st = dataclasses.replace(eng.static_s,
                             fast_residual=mode == "fast_residual")
    return st, eng.arr


@pytest.mark.parametrize("estimator,mode", RES_CASES)
def test_res_kernels_match_plain(estimator, mode, tmp_path, cuda_device):
    """To WF_TOL of the max; a residual deposit follows a scatter event,
    a point: an event an ulp off may land in the next voxel, so up to
    0.2 % of the nonzero values may be off by more (chip_smoke.py phase
    7c measured none)."""
    st, at = _res_scene(tmp_path, estimator, mode)
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, st.projector.n_active)
                            .astype(np.float32)).to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, st.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    before = dict(wf.launches)
    dose = wf.forward(st, at, data, 7, 4)
    grad = wf.adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK, dL)
    grad2 = wf.adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK, dL)
    torch.cuda.synchronize()
    # the dda forward: a path pass and a walk pass in WALK_SLABS z-slabs
    # (one launch each) a batch of CTAs
    n_fwd = wf.launches["wf_res_fwd"] - before["wf_res_fwd"]
    n_walk = wf.launches["wf_res_walk"] - before["wf_res_walk"]
    if estimator == "dda":
        assert 1 <= n_walk <= wf.WALK_SLABS * n_fwd
        assert n_walk % wf.WALK_SLABS == 0
    else:
        assert (n_fwd, n_walk) == (1, 0)
    assert wf.launches["wf_res_bwd"] == before["wf_res_bwd"] + 2
    assert wf.launches["wf_fwd"] == before["wf_fwd"]
    assert float(dose.abs().max()) > 0 and float(grad.abs().max()) > 0
    for out, ref in ((dose, wf._forward(st, at, data, 7, 4,
                                         wf.DEFAULT_CHUNK)),
                     (grad, wf._adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK,
                                        dL))):
        off = (out - ref).abs() > WF_TOL * float(ref.abs().max())
        assert int(off.sum()) <= 2e-3 * int((ref != 0).sum())
    assert torch.equal(grad, grad2)


@pytest.mark.parametrize("estimator,mode", [("delta", "fast_residual"),
                                            ("dda", "first_scatter"),
                                            ("ratio", "first_scatter")])
def test_prologue_kernels_match_plain(estimator, mode, tmp_path,
                                      cuda_device):
    """The residual without its chord bank: the kernels' prologue
    instantiations (counted apart, no chord table built) against the
    plain prologue, to test_res_kernels_match_plain's tolerance; the
    adjoint bitwise on two launches."""
    st, at = _res_scene(tmp_path, estimator, mode)
    at = {k: v for k, v in at.items() if k != "chord_pack"}
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, st.projector.n_active)
                            .astype(np.float32)).to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, st.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    wf.reset_launches()
    dose = wf.forward(st, at, data, 7, 4)
    grad = wf.adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK, dL)
    grad2 = wf.adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK, dL)
    torch.cuda.synchronize()
    assert wf.form_launches["wf_res_fwd:prologue"] == \
        wf.launches["wf_res_fwd"] >= 1
    assert wf.form_launches["wf_res_bwd:prologue"] == 2
    assert wf.launches["wf_res_chords"] == 0
    for out, ref in ((dose, wf._forward(st, at, data, 7, 4,
                                         wf.DEFAULT_CHUNK)),
                     (grad, wf._adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK,
                                        dL))):
        assert float(ref.abs().max()) > 0
        off = (out - ref).abs() > WF_TOL * float(ref.abs().max())
        assert int(off.sum()) <= 2e-3 * int((ref != 0).sum())
    assert torch.equal(grad, grad2)


def test_hybrid_engine_never_takes_the_plain_path(tmp_path, cuda_device,
                                                  monkeypatch):
    st, at = _res_scene(tmp_path, "delta", "fast_residual")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(wf, "_forward", refuse)
    monkeypatch.setattr(wf, "_adjoint", refuse)
    monkeypatch.setattr(wf, "trace_wavefront", refuse)
    data = torch.ones(st.projector.n_active, device=cuda_device,
                      requires_grad=True)
    vol = wf.render(st, at, data, 2.0, seed=1, spp=4)
    (g,) = torch.autograd.grad(vol.sum(), data)
    torch.cuda.synchronize()
    assert vol.is_cuda and g.is_cuda and float(g.abs().sum()) > 0


def _cull_scene(tmp_path, mode):
    """A radon static (cylindrical vial) or the corner render's (square
    vial) with the 792-triangle box-with-hole target: its grid walk."""
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
    path = str(tmp_path / "box_hole.ply")
    save_ply(make_box_with_hole((2.0, 2.0, 1.0), 0.5, segments=99), path)
    vial = {"type": "cylindrical", "r_int": 2.6, "r_ext": 2.9} \
        if mode == "radon" else {"type": "square", "w_int": 4.6,
                                 "w_ext": 5.0}
    vial.update(ior=1.54, medium={"ior": 1.40, "extinction": 0.1,
                                  "albedo": 0.0})
    cfg = {"vial": vial,
           "projector": {"type": "collimated", "n_patterns": 8,
                         "resx": 64, "resy": 16, "pixel_size": 5.0 / 64,
                         "motion": "circular", "distance": 20},
           "sensor": {"type": "dda", "scalex": 5, "scaley": 5,
                      "scalez": 1.25,
                      "film": {"type": "vfilm", "resx": 48, "resy": 48,
                               "resz": 24}},
           "target": {"filename": path, "size": 1.5},
           "output": str(tmp_path)}
    if mode == "radon":
        return Scene(cfg).build(mode="radon", include_target=True,
                                max_depth=5, rr_depth=3)
    return Scene(cfg).build(mode="volume", include_target=True, max_depth=1,
                            regular_sampling=True)


def test_cull_kernels_match_plain(tmp_path, cuda_device):
    """wf_radon: bitwise equal to its plain version (CUDA's
    transcendentals on both sides, the mesh test's fused products rounded
    once on both), with the mesh banks staged in shared memory and read
    from global memory, and on two launches; wf_corner: the same keep
    image on both bank paths."""
    from drtvam_tpu_torch.ops.march import scene_tensors
    static, arr = _cull_scene(tmp_path, "radon")
    at = scene_tensors(arr, cuda_device)
    before = dict(wf.launches)
    img = wf.render_radon(static, at, seed=7, spp=2)
    img2 = wf.render_radon(static, at, seed=7, spp=2)
    img_g = wf.wf_radon(static, at, 7, 2, staged=False)
    ref = wf._radon(static, at, 7, 2, wf.DEFAULT_CHUNK)
    torch.cuda.synchronize()
    assert wf.launches["wf_radon"] == before["wf_radon"] + 3
    assert wf.cull_info("wf_radon", static, at, 2)["staged"] == 1
    assert wf.cull_info("wf_radon", static, at, 2, staged=False)[
        "staged"] == 0
    assert torch.equal(img, img2)
    assert torch.equal(img, ref) and torch.equal(img_g, ref)
    assert bool((ref > 0).any())
    static, arr = _cull_scene(tmp_path, "corner")
    at = scene_tensors(arr, cuda_device)
    keep = wf.render_corner(static, at, dist=2.5, radius=0.3)
    plain = wf._corner(static, at, 2.5, 0.3, 0, wf.DEFAULT_CHUNK)
    assert torch.equal(keep, plain)
    assert torch.equal(wf.wf_corner(static, at, 2.5, 0.3, staged=False),
                       plain)
    assert wf.launches["wf_corner"] == before["wf_corner"] + 2


def _target_scene(tmp_path, estimator, mode):
    """_res_scene's scene on a surface-aware film, the target kept: the
    analog static and tensors on the card (mode "analog"), or the
    residual's of a ScatteringEngine with the inside mask."""
    import dataclasses
    import json
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
    from drtvam_tpu_torch.ops.march import scene_tensors
    from drtvam_tpu_torch.ops.mesh import make_box, save_ply
    path = str(tmp_path / "t.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    film = {"type": "vfilm", "resx": 32, "resy": 32, "resz": 32}
    sensor = {"type": estimator, "scalex": 16.77, "scaley": 16.77,
              "scalez": 16.77, "majorant": 10.0}
    cfg = {
        "vial": {"type": "cylindrical", "r_ext": 8.385, "r_int": 7.665,
                 "height": 20.0, "ior": 1.514,
                 "medium": {"ior": 1.4849, "extinction": 0.1,
                            "albedo": 0.5, "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": 10, "resx": 24,
                      "resy": 16, "pixel_size": 16.77 / 24,
                      "motion": "circular", "distance": 25.0},
        "sensor": dict(sensor, film=dict(film, surface_aware=True)),
        "final_sensor": json.loads(json.dumps(dict(sensor, film=film))),
        "target": {"filename": path, "size": 4.0}, "output": str(tmp_path)}
    sc = Scene(cfg)
    static, arr = sc.build(mode="volume", include_target=True, max_depth=8,
                           rr_depth=3, sample_time=True)
    if mode == "analog":
        return static, scene_tensors(arr, "cuda")
    eng = ScatteringEngine(static, arr, "cuda", inside_mask=sc.sensor
                           .discretize(sc.target_bank()))
    st = dataclasses.replace(eng.static_s,
                             fast_residual=mode == "fast_residual")
    return st, eng.arr


@pytest.mark.parametrize("estimator,mode", [
    ("dda", "analog"), ("delta", "analog"), ("delta", "fast_residual"),
    ("dda", "first_scatter")])
def test_target_kernels_match_plain(estimator, mode, tmp_path, cuda_device):
    """The loop kernels' target instantiations on a two-channel film
    (the target mesh kept): each channel to WF_TOL of its max (up to
    0.2 % of a point estimator's values off by more), the adjoint
    bitwise on two launches, each launch counted by its form
    (chip_smoke.py phase 13 runs more scenes)."""
    st, at = _target_scene(tmp_path, estimator, mode)
    assert wf.target_mode(st) == 2
    rng = np.random.default_rng(8)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, st.projector.n_active)
                            .astype(np.float32)).to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, st.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    wf.reset_launches()
    dose = wf.forward(st, at, data, 7, 4)
    grad = wf.adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK, dL)
    grad2 = wf.adjoint(st, at, 7, 4, wf.DEFAULT_CHUNK, dL)
    torch.cuda.synchronize()
    fam = "wf" if mode == "analog" else "wf_res"
    assert wf.form_launches[f"{fam}_fwd:target2"] >= 1
    assert wf.form_launches[f"{fam}_bwd:target2"] == 2
    ref = wf._forward(st, at, data, 7, 4, wf.DEFAULT_CHUNK)
    for c in range(2):
        o, r = dose.reshape(-1, 2)[:, c], ref.reshape(-1, 2)[:, c]
        assert float(r.abs().max()) > 0
        off = (o - r).abs() > WF_TOL * float(r.abs().max())
        assert int(off.sum()) <= (2e-3 * int((r != 0).sum())
                                  if estimator != "dda" else 0)
    assert torch.equal(grad, grad2)


@pytest.mark.parametrize("estimator", ["dda", "ratio", "delta"])
def test_target_forms_equal_the_one_pass_kernels(estimator, tmp_path,
                                                 cuda_device, monkeypatch):
    """The analog pair's target forms (csrc/wf_target.cu: the staged
    adjoint; the dda and ratio forwards' path and walk passes, the delta
    forward's one pass) against the one-pass kernels the scene ran before
    (wf_fwd.cu / wf_bwd.cu with the target, the route forced off): the
    adjoint bitwise, the forward to WF_TOL of each channel's max with none
    off, the same iterations, steps and mesh work (the target's grid
    cells, triangles and walks); every forward on its estimator's form,
    launched and counted by it."""
    st, at = _target_scene(tmp_path, estimator, "analog")
    rng = np.random.default_rng(9)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, st.projector.n_active)
                            .astype(np.float32)).to(cuda_device)
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, st.sensor.n_cells)
                          .astype(np.float32)).to(cuda_device)
    libs = wf.build_kernels()
    assert wf.tgt_route(libs, "wf_fwd", st, at)
    assert wf.tgt_route(libs, "wf_bwd", st, at)
    wf.reset_launches()
    s_new, b_new = {}, {}
    dose = wf.wf_fwd(st, at, data, 7, 4, s_new)
    grad = wf.wf_bwd(st, at, dL, 7, 4, b_new)
    torch.cuda.synchronize()
    own = "wf_tgt_delta" if estimator == "delta" else "wf_tgt_walk"
    assert wf.launches[own] >= 1
    assert wf.form_launches[f"{own}:target2"] == \
        wf.form_launches["wf_fwd:target2"] >= 1
    monkeypatch.setattr(wf, "tgt_route", lambda *a: False)
    s_old, b_old = {}, {}
    dose_old = wf.wf_fwd(st, at, data, 7, 4, s_old)
    grad_old = wf.wf_bwd(st, at, dL, 7, 4, b_old)
    torch.cuda.synchronize()
    assert torch.equal(grad, grad_old)
    for k in ("iterations", "steps") + wf.MESH_COUNTERS:
        assert s_new[k] == s_old[k] and b_new[k] == b_old[k], k
    assert s_new["triangles"] > 0
    for c in range(2):
        o, r = dose.reshape(-1, 2)[:, c], dose_old.reshape(-1, 2)[:, c]
        assert float(r.abs().max()) > 0
        assert int(((o - r).abs() > WF_TOL * float(r.abs().max())).sum()) \
            == 0


def test_residual_target_path_equals_one_pass(tmp_path, cuda_device,
                                              monkeypatch):
    """The dda residual's target path pass (csrc/wf_res_target.cu: threads
    refilled lane by lane, the target's banks staged, and read from global
    memory with a staging limit of 0 bytes) against the one-pass
    instantiation it replaces (wf_res_path, the route forced off): the
    record sets bitwise equal, with the same bounce iterations and mesh
    work; then the whole forward through the target form against the
    plain version, to WF_TOL of each channel's max with none off and the
    plain version's counts, counted and (batches of 3 CTAs, a batch's walk
    beside the next one's path pass) uncounted. Each launch counted as
    wf_res_fwd's target form and apart."""
    st, at = _target_scene(tmp_path, "dda", "first_scatter")
    rng = np.random.default_rng(10)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, st.projector.n_active)
                            .astype(np.float32)).to(cuda_device)
    seed, spp = 7, 4
    libs = wf.build_kernels()
    assert wf.res_tgt_route(libs, st, at)
    n_ctas = len(wf._lanes_before(st, at, spp)) - 1
    cap = 16 * st.projector.n_active * spp
    at["_wf_res_split"] = (cap, torch.empty(cap * 8, device=cuda_device),
                           torch.zeros(2, dtype=torch.int32,
                                       device=cuda_device))

    def records(stats):
        recs = wf.res_path(libs, st, at, data, seed, spp, 0, n_ctas, stats)
        assert recs is not None and recs.shape[0] == stats["records"] > 0
        bits = recs.cpu().numpy().view(np.int32)
        return bits[np.lexsort(bits.T[::-1])]

    wf.reset_launches()
    s_new, s_glob, s_old = {}, {}, {}
    new = records(s_new)
    assert wf.launches["wf_res_tgt_path"] == 1
    assert wf.form_launches["wf_res_fwd:target2"] == 1
    with monkeypatch.context() as m:
        m.setattr(wf, "RES_TGT_SMEM_LIMIT", 0)
        glob = records(s_glob)
    with monkeypatch.context() as m:
        m.setattr(wf, "res_tgt_route", lambda *a: False)
        old = records(s_old)
    assert wf.launches["wf_res_tgt_path"] == 2
    assert np.array_equal(new, old) and np.array_equal(glob, old)
    for k in ("iterations", "records") + wf.MESH_COUNTERS:
        assert s_new[k] == s_glob[k] == s_old[k], k
    assert s_new["triangles"] > 0
    stats, ref_stats = {}, {}
    dose = wf.wf_res_fwd(st, at, data, seed, spp, stats)
    # uncounted: a batch's walk beside the next batch's path pass
    overlapped = wf.wf_res_fwd(st, at, data, seed, spp, batch_ctas=3)
    ref = wf._forward(st, at, data, seed, spp, wf.DEFAULT_CHUNK, ref_stats)
    assert {k: stats[k] for k in ref_stats} == ref_stats
    for out in (dose, overlapped):
        for c in range(2):
            o, r = out.reshape(-1, 2)[:, c], ref.reshape(-1, 2)[:, c]
            assert float(r.abs().max()) > 0
            assert int(((o - r).abs() > WF_TOL * float(r.abs().max()))
                       .sum()) == 0


# --------------------------------------------------------------------------
# the z-resample (csrc/zres.cu)


def _bits(t):
    return t.cpu().contiguous().view(torch.int32).numpy()


# (resy, Z, U, regular, pixel): the cells' tables at 7 angles and at their
# 400; jittered with 4 taps a film row; U not a multiple of 4; Zf > R
ZRES_CASES = {
    "cells_regular": (400, 256, 400, True, 0.025, 7),
    "cells_jittered": (400, 256, 400, False, 0.025, 7),
    "cells_full_size": (400, 256, 400, False, 0.025, 400),
    "four_taps_ragged_u": (400, 160, 397, False, 0.025, 5),
    "zf_above_r": (160, 256, 400, False, 0.0625, 6),
    "zf_above_r_regular_ragged_u": (160, 256, 398, True, 0.0625, 6),
}


@pytest.mark.parametrize("case", list(ZRES_CASES))
def test_zres_kernels_are_tap_contract_bitwise(case, cuda_device):
    """Both directions of the gather kernel == BallisticEngine._tap_contract
    bit for bit (the same taps in the same order, each product and sum
    rounded alone), on inputs with negatives and exact zeros; the
    padding taps read row 0 at weight 0."""
    from drtvam_tpu_torch.ops import zresample
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    resy, Z, U, regular, pixel, A = ZRES_CASES[case]
    taps = z_taps(resy, Z, regular, pixel)
    zt_i, zt_w, rt_i, rt_w = taps
    if not regular:
        assert int((zt_w > 0).sum(1).max()) >= (4 if Z == 160 else 2)
    rng = np.random.default_rng(3)
    P = rng.uniform(-1.0, 1.0, (A, resy, U)).astype(np.float32)
    P[rng.uniform(0.0, 1.0, P.shape) < 0.1] = 0.0
    Pz_bar = rng.uniform(-1.0, 1.0, (A, Z, U)).astype(np.float32)
    P, Pz_bar = torch.from_numpy(P), torch.from_numpy(Pz_bar)
    dev = [t.to(cuda_device) for t in taps]
    before = zresample.launches["zres"]
    fwd = zresample.gather(P.to(cuda_device), dev[0], dev[1])
    bwd = zresample.gather(Pz_bar.to(cuda_device), dev[2], dev[3])
    torch.cuda.synchronize()
    assert zresample.launches["zres"] == before + 2
    ref_f = BallisticEngine._tap_contract(P, zt_i, zt_w)
    ref_b = BallisticEngine._tap_contract(Pz_bar, rt_i, rt_w)
    assert fwd.shape == (A, Z, U) and bwd.shape == (A, resy, U)
    np.testing.assert_array_equal(_bits(fwd), _bits(ref_f))
    np.testing.assert_array_equal(_bits(bwd), _bits(ref_b))


def _ball_engines(tmp_path, device):
    """A small ballistic scene (cylindrical vial, jittered sampling): the
    engine on `device` and the plain one on the CPU."""
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    from drtvam_tpu_torch.ops.mesh import make_box, save_ply
    path = str(tmp_path / "t.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6,
                 "ior": 1.54,
                 "medium": {"ior": 1.40, "extinction": 0.1, "albedo": 0.0,
                            "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": 23, "resx": 40,
                      "resy": 16, "pixel_size": 0.1231,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29,
                   "film": {"type": "vfilm", "resx": 40, "resy": 36,
                            "resz": 20}},
        "target": {"filename": path, "size": 4.0}, "output": str(tmp_path)}
    scene = Scene(cfg)
    static, arr = scene.build(mode="volume", max_depth=10, rr_depth=32,
                              regular_sampling=False)
    inv_vol = float(scene.sensor.inv_volume())
    return (BallisticEngine(static, arr, device),
            BallisticEngine(static, arr, "cpu"), inv_vol,
            static.sensor.shape)


def test_render_vol_gradient_on_the_card(tmp_path, cuda_device):
    """Autograd through render_vol on the card (Backproject's and the
    resample's backward kernels) gives the plain route's gradient, and
    bitwise the engine's own pattern_grad on the card."""
    eng, plain, inv_vol, shape = _ball_engines(tmp_path, cuda_device)
    assert eng.z_taps is not None
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.uniform(0.5, 1.5, eng.n_active)
                         .astype(np.float32))
    v = torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32))
    pc = p.to(cuda_device).requires_grad_(True)
    vc = v.to(cuda_device)
    (g,) = torch.autograd.grad(eng.render_vol(pc, inv_vol), pc, vc)
    pg = p.clone().requires_grad_(True)
    (g_plain,) = torch.autograd.grad(plain.render_vol(pg, inv_vol), pg, v)
    assert float(g_plain.abs().max()) > 0
    _close(g, g_plain)
    with torch.no_grad():
        np.testing.assert_array_equal(_bits(g),
                                      _bits(eng.pattern_grad(vc, inv_vol)))


def test_cuda_engine_never_takes_tap_contract(tmp_path, cuda_device,
                                              monkeypatch):
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    eng, _, inv_vol, shape = _ball_engines(tmp_path, cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached _tap_contract")

    monkeypatch.setattr(BallisticEngine, "_tap_contract",
                        staticmethod(refuse))
    data = torch.ones(eng.n_active, device=cuda_device, requires_grad=True)
    vol = eng.render_vol(data, inv_vol)
    (g,) = torch.autograd.grad(vol.sum(), data)
    with torch.no_grad():
        g2 = eng.pattern_grad(torch.ones(shape, device=cuda_device),
                              inv_vol)
    torch.cuda.synchronize()
    assert float(g.abs().sum()) > 0 and float(g2.abs().sum()) > 0


def test_resample_launches_three_a_step(tmp_path, cuda_device):
    """optimize() on the card: one resample launch for each render and
    one for each pattern gradient, so three a step (the primal render,
    the direction render, the adjoint), and one for the final render;
    `launches` and the recorder's `resample_launches` agree."""
    from drtvam_tpu_torch.opt import optimize as opt
    from drtvam_tpu_torch.ops import zresample
    from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(tmp_path / "box_hole.ply"))
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 7, "r_ext": 8, "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": 0.1, "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 30, "resx": 48,
                      "resy": 12, "pixel_size": 0.104,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 40, "resy": 40,
                            "resz": 20}},
        "target": {"filename": "box_hole.ply", "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 3, "output": str(tmp_path / "out")}
    before = zresample.launches["zres"]
    t = {}
    opt.optimize(cfg, resolve_path=opt.make_resolver(str(tmp_path)),
                 device="cuda", timings=t)
    loss = np.load(tmp_path / "out" / "loss.npy")
    assert np.all(loss[:3] > 0.0)  # no step converged
    assert zresample.launches["zres"] - before == 3 * 3 + 1
    assert t["resample_launches"] == 3 * 3 + 1
