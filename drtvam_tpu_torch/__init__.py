"""drtvam_tpu_torch — the PyTorch and CUDA port of drtvam_tpu.

Differentiable tomographic rendering for volumetric additive
manufacturing (TVAM) pattern optimization on an NVIDIA GPU. The JAX
package `drtvam_tpu` is the reference; every module here has its
counterpart at the same path there and is tested against it.

It runs the pattern optimization end to end with Linear L-BFGS on
analytic vials, through the ballistic engine (the four backprojection
kernels, each in float32 and in its bf16 operand form) or the wavefront
path tracer (the wf_fwd / wf_bwd pair). The kernels are hand-written
CUDA (`csrc/`), built with nvcc at first use.

Layer map:
  core/     — transform math
  models/   — vials, projector, motion, sensor, scene assembly
  ops/      — mesh I/O, voxelization, 2D transport fields, the
              backprojection kernels and the ballistic engine
  opt/      — losses, Linear L-BFGS, the optimize() driver and CLI
  parallel/ — torch.distributed: the ray-sharded wavefront render and
              the angle-sharded ballistic engine, all-reduced over ranks
  utils/    — EXR/PNG I/O, IoU and histogram metrics
  native.py — g++/nvcc build-on-first-use and ctypes loading

The package imports torch and numpy, never jax and never drtvam_tpu.
"""

__version__ = "0.1.0"

from .models.geometry import geometries, register_geometry
from .models.motion import motions, register_motion
from .opt.loss import losses, register_loss

__all__ = [
    "geometries", "register_geometry",
    "motions", "register_motion",
    "losses", "register_loss",
]
