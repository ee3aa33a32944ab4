"""Multi-process launch helpers (counterpart of
drtvam_tpu/parallel/multihost.py).

One process a GPU: each rank joins a torch.distributed process group
and works on one explicit device, cuda:LOCAL_RANK. `init_multihost()`
reads torchrun's environment; `global_mesh()` gives the group and the
rank's device that parallel.shard takes. Doses and pattern gradients are
summed over the group by parallel.shard; nothing else knows of ranks.

Typical launch (torchrun --nproc_per_node=N script.py, one card a rank):

    from drtvam_tpu_torch.parallel import multihost, shard
    multihost.init_multihost()           # False, and nothing done, alone
    group, device = multihost.global_mesh()
    dose = shard.render_sharded(group, static, arr, data, inv_vol)
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the rank's device, set by init_multihost
_DEVICE = {"device": None}


def init_multihost(init_method=None, world_size=None, rank=None,
                   backend=None, device=None, timeout=None):
    """Join the process group from the arguments or torchrun's
    environment (MASTER_ADDR and MASTER_PORT: init_method "env://";
    WORLD_SIZE, RANK, LOCAL_RANK). With nothing configured it returns
    False and does nothing (one process). device: the rank's device,
    cuda:LOCAL_RANK (else cuda:rank) unless given ("cpu" for the CPU).
    backend: NCCL on a CUDA device and gloo on the CPU unless given.
    timeout: seconds a collective may wait (torch's default if None).
    Returns True once the group is up; raises if it cannot come up."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env and \
            "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError("init_multihost: an init method, a world size and "
                         "a rank are all needed (or torchrun's MASTER_ADDR, "
                         "MASTER_PORT, WORLD_SIZE and RANK)")
    if device is None:
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank), **kw)
    _DEVICE["device"] = device
    return True


def global_mesh():
    """(group, device): the process group over every rank of the job
    (None in a single process, which parallel.shard takes for a world of
    one) and this rank's device."""
    if not dist.is_initialized():
        return None, _DEVICE["device"]
    return dist.group.WORLD, _DEVICE["device"]


def is_coordinator():
    """Rank 0 of the job (a single process is its own coordinator)."""
    return not dist.is_initialized() or dist.get_rank() == 0
