"""drtvam_tpu_torch utils == the JAX package's numpy utils: the EXR codec
reads what either package writes, and the histogram report finds the
same best IoU and threshold."""
import numpy as np

from drtvam_tpu.utils import io as jio
from drtvam_tpu.utils import metrics as jmetrics
from drtvam_tpu_torch.utils import io as tio
from drtvam_tpu_torch.utils import metrics as tmetrics


def test_exr_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    vol = rng.random((5, 6, 7, 1)).astype(np.float32)
    tio.save_vol(vol, str(tmp_path / "t.exr"))
    jio.save_vol(vol, str(tmp_path / "j.exr"))
    assert (tmp_path / "t.exr").read_bytes() == \
        (tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(jio.read_exr(str(tmp_path / "t.exr")),
                                  tio.reshape_grid(vol)[..., 0])
    img = rng.random((4, 9, 3)).astype(np.float32)
    tio.save_img(img, str(tmp_path / "rgb.exr"))
    np.testing.assert_array_equal(tio.read_exr(str(tmp_path / "rgb.exr")),
                                  img)


def test_histogram_report_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    target = (rng.random((12, 10, 8, 1)) > 0.7).astype(np.float32)
    vol = (0.6 * target + rng.normal(0.45, 0.2, target.shape)) \
        .astype(np.float32)
    ref = jmetrics.save_histogram(vol, target, str(tmp_path / "j.png"),
                                  0.3, 2.0, verbose=False)
    out = tmetrics.save_histogram(vol, target, str(tmp_path / "t.png"),
                                  0.3, 2.0, verbose=False)
    assert out == ref
    png = (tmp_path / "t.png").read_bytes()
    assert png.startswith(b"\x89PNG\r\n\x1a\n") and b"IEND" in png
    assert f"IoU = {ref[0]:.4f}".encode() in png
    for thr in (0.3, 0.5, 0.9):
        assert tmetrics.iou(vol, target, thr) == jmetrics.iou(vol, target,
                                                              thr)
