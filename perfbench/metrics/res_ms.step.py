"""Layer: residual kernels (ops/render.py wf_res_fwd / wf_res_bwd,
csrc/wf_res_fwd.cu, wf_res_bwd.cu, wf_res_target.cu, wf_residual.cuh).
The device time of the scattered residual's kernels in the program's
trace of its loop, in milliseconds per optimizer step; moves step_ms."""
import re

RESIDUAL = re.compile(
    r"(?<![A-Za-z0-9_])(res_kernel|res_prologue_kernel|walk_kernel|"
    r"chord_table_kernel|res_tgt_path_kernel|res_tgt_prologue_kernel)"
    r"(?![A-Za-z0-9_])")


def read(ctx):
    loop = ctx.loop
    if loop is None or loop["solve"].steps == 0:
        return None
    n, us = 0, 0.0
    for name, (count, t) in loop["summary"]["by_name"].items():
        if RESIDUAL.search(name):
            n += count
            us += t
    if n == 0:
        return None
    return 1e-3 * us / loop["solve"].steps
