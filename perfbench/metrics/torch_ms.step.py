"""Layer: optimizer + loss (opt/device_lbfgs.py, opt/loss.py). The
device time of the operations that are not the port's own kernels
(PyTorch's elementwise ops, reductions, gathers, copies and cuBLAS) in
the program's trace of its loop, in milliseconds per optimizer step;
moves step_ms."""
import re

# every __global__ entry of drtvam_tpu_torch/csrc
PORT_KERNELS = re.compile(
    r"(?<![A-Za-z0-9_])(fwd_kernel|bwd_kernel|transpose_kernel|wf_kernel|"
    r"res_kernel|res_prologue_kernel|walk_kernel|chord_table_kernel|"
    r"tgt_path_kernel|tgt_ratio_path_kernel|tgt_walk_kernel|"
    r"tgt_ratio_walk_kernel|tgt_delta_kernel|res_tgt_path_kernel|"
    r"res_tgt_prologue_kernel|cull_kernel|cull_frames|med_kernel|med_sum)"
    r"(?![A-Za-z0-9_])")


def read(ctx):
    loop = ctx.loop
    if loop is None or loop["solve"].steps == 0:
        return None
    us = sum(v[1] for n, v in loop["summary"]["by_name"].items()
             if not PORT_KERNELS.search(n))
    return 1e-3 * us / loop["solve"].steps
