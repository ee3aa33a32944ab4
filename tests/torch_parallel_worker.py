"""Rank processes of tests/test_torch_parallel.py: each joins a gloo
group on the CPU, runs the port's sharded render and sharded ballistic
engine on the inputs the test hands it (numpy, made from a seed), and
rank 0 saves what it got for the test to compare. Imports no jax, so
that a rank starts in a second or two."""
import os
import pickle

import torch


def _wavefront(shard, group, case):
    """(dose, gradient of <dose, dL>) of one sharded render."""
    from drtvam_tpu_torch.ops.march import scene_tensors
    at = scene_tensors(case["arr"], "cpu")
    p = torch.from_numpy(case["data"]).requires_grad_(True)
    v = shard.render_sharded(group, case["static"], at, p, case["inv_vol"],
                             seed=case["seed"], spp=case["spp"])
    (g,) = torch.autograd.grad(v, p, torch.from_numpy(case["dL"]))
    return v.detach().numpy(), g.numpy()


def _ballistic(shard, group, case):
    """(dose, pattern_grad, autograd gradient) of the sharded engine."""
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    eng = BallisticEngine(case["static"], case["arr"], "cpu",
                          impl=case["impl"])
    eng = shard.shard_ballistic_engine(eng, group)
    p = torch.from_numpy(case["data"]).requires_grad_(True)
    v = eng.render_vol(p, case["inv_vol"])
    dvol = torch.from_numpy(case["dvol"])
    (g_auto,) = torch.autograd.grad(v, p, dvol)
    g = eng.pattern_grad(dvol, case["inv_vol"])
    return v.detach().numpy(), g.numpy(), g_auto.numpy()


def _raises(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def run(rank, world, init, cases, out, torchrun=False):
    """One rank. init: the file:// rendezvous path, or with torchrun the
    localhost port, set as torchrun sets its variables."""
    torch.set_num_threads(1)
    from drtvam_tpu_torch.parallel import multihost, shard
    if torchrun:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(init),
                          WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank))
        assert multihost.init_multihost(device="cpu")
    else:
        assert multihost.init_multihost(init_method=f"file://{init}",
                                        world_size=world, rank=rank,
                                        device="cpu")
    group, dev = multihost.global_mesh()
    assert dev == torch.device("cpu") and shard.world(group) == (world, rank)
    res = {}
    for name, case in cases.items():
        if case["kind"] == "wavefront":
            res[name] = _wavefront(shard, group, case)
        elif case["kind"] == "ballistic":
            res[name] = _ballistic(shard, group, case)
        else:  # a call that must raise on every rank
            fn = {"ballistic": _ballistic, "wavefront": _wavefront}[
                case["of"]]
            res[name] = _raises(lambda: fn(shard, group, case["case"]))
    if multihost.is_coordinator():
        with open(out, "wb") as f:
            pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def spawn(world, init, cases, out, torchrun=False):
    """Run `run` on world ranks (torch.multiprocessing, spawned) and
    return rank 0's results."""
    import torch.multiprocessing as mp
    mp.start_processes(run, args=(world, init, cases, out, torchrun),
                       nprocs=world, start_method="spawn")
    with open(out, "rb") as f:
        return pickle.load(f)
