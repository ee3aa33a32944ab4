#!/usr/bin/env python3
"""The card's rate of float atomic adds into a float32 grid.

    python3 tools/atomic_rate.py

run from the repo root on a machine with one NVIDIA GPU. Builds
tools/atomic_rate.cu (nvcc, into drtvam_tpu_torch/_build/) and times
its two address streams with CUDA events (median of 5 launches of 8 M
threads x 128 adds): uniformly scattered voxels, and straight lines of
voxels from random points in random directions (the dda walk's
stream), on a 256^3 grid (the bench film, 67 MB) and a 128^3 one (8 MB,
inside L2). Prints one JSON line: adds a second for each. The walk
pass's atomic floor is its deposits over the lines' rate (chip_smoke.py
phase 8b).
"""
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = ("scattered", "lines")


def build():
    """nvcc tools/atomic_rate.cu into the port's build directory; the
    loaded library."""
    sys.path.insert(0, REPO)
    from drtvam_tpu_torch.native import BUILD_DIR, nvcc_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, "libatomic_rate.so")
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    os.path.join(REPO, "tools", "atomic_rate.cu"), "-o", lib],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib)
    lib.atomic_adds.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                ctypes.c_void_p]
    lib.atomic_adds.restype = ctypes.c_int
    return lib


def rates(torch, lib=None, res=256, threads=1 << 23, per_thread=128,
          reps=5):
    """{stream: float atomic adds a second} on the current card."""
    import numpy as np
    lib = lib or build()
    grid = torch.zeros(res ** 3, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for kind, name in enumerate(STREAMS):
        times = []
        for rep in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.atomic_adds(kind, grid.data_ptr(), res, threads,
                                  per_thread, rep, stream)
            b.record()
            b.synchronize()
            if err != 0:
                raise RuntimeError(f"atomic_adds: cudaError_t {err}")
            if rep:  # the first launch warms up
                times.append(a.elapsed_time(b) * 1e-3)
        out[name] = threads * per_thread / float(np.median(times))
    if float(grid.double().sum()) != \
            float(reps + 1) * 2 * threads * per_thread:
        raise AssertionError("atomic_adds: adds lost")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("atomic_rate: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    lib = build()
    # 256^3: the bench film (67 MB, past the 50 MB L2); 128^3 (8 MB) fits
    print(json.dumps({"atomic_adds_per_s": {
        f"{res}^3": rates(torch, lib, res) for res in (256, 128)}}),
        flush=True)


if __name__ == "__main__":
    main()
