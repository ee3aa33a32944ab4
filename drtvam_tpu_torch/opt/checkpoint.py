"""Step checkpoints of the optimization (counterpart of
drtvam_tpu/opt/checkpoint.py).

One `checkpoint.npz` in the output directory holds what an interrupted
optimization needs to continue as the uninterrupted one would: the
step, the sparse pattern store (active_data, active_pixels), the loss
and timing histories, the optimizer's name and its state. The keys and
types are the JAX package's, so either package resumes the other's
file:
  * step (int64), active_data (float32), active_pixels (int32),
    loss_hist and timing_hist (float64), optim_type (bytes);
  * L-BFGS: opt_t, opt_p_old, opt_g_old, opt_S, opt_Yh, opt_ys,
    opt_head, opt_nvalid, opt_m (DeviceLinearLBFGS.state_dict; bfloat16
    rows as 2-byte void views of their bits);
  * Adam / SGD: opt_n_leaves and opt_leaf_<i>, optax's leaves in its
    order (opt/first_order.py);
  * optimize_medium: med_st and med_al (float32), med_n_leaves and
    med_leaf_<i>, the medium's optax Adam state over {"al", "st"} in
    optax's order: count, mu.al, mu.st, nu.al, nu.st.

Config: "checkpoint_every": N saves every N steps and at the last step;
"resume": true restores the file. Each step's seed is its index, so a
resumed run retraces the remaining steps.
"""
from __future__ import annotations

import os

import numpy as np

FILENAME = "checkpoint.npz"


def save_checkpoint(output, step, data, active_pixels, loss_hist,
                    timing_hist, optim_type, opt, med=None):
    """Write `checkpoint.npz` into `output` atomically (a temporary file,
    then os.replace). opt: the DeviceLinearLBFGS or FirstOrder
    optimizer; med: the calibrated medium (sigma_t, albedo, its optimizer
    leaves), or None."""
    if hasattr(data, "detach"):
        data = data.detach().cpu().numpy()
    d = {
        "step": np.int64(step),
        "active_data": np.asarray(data, np.float32),
        "active_pixels": np.asarray(active_pixels, np.int32),
        "loss_hist": np.asarray(loss_hist),
        "timing_hist": np.asarray(timing_hist),
        "optim_type": np.bytes_(optim_type.encode()),
    }
    if optim_type == "lbfgs":
        for k, v in opt.state_dict().items():
            d[f"opt_{k}"] = v
    else:
        leaves = opt.leaves()
        d["opt_n_leaves"] = np.int64(len(leaves))
        for i, leaf in enumerate(leaves):
            d[f"opt_leaf_{i}"] = leaf
    if med is not None:
        st, al, leaves = med
        d["med_st"], d["med_al"] = np.float32(st), np.float32(al)
        d["med_n_leaves"] = np.int64(len(leaves))
        for i, leaf in enumerate(leaves):
            d[f"med_leaf_{i}"] = leaf
    path = os.path.join(output, FILENAME)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **d)
    os.replace(tmp, path)


def load_checkpoint(output):
    """The checkpoint's arrays as a dict, or None when there is none."""
    path = os.path.join(output, FILENAME)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as f:
        return dict(f)


def check_optimizer(ckpt, optim_type):
    """Raise ValueError when another optimizer wrote the checkpoint."""
    saved = bytes(ckpt["optim_type"]).decode()
    if saved != optim_type:
        raise ValueError(f"Checkpoint was written by optimizer '{saved}', "
                         f"config now requests '{optim_type}'.")


def restore_opt_state(ckpt, optim_type, opt, data):
    """Restore the optimizer's state from the checkpoint, in place. data:
    the restored patterns, on the optimizer's device."""
    check_optimizer(ckpt, optim_type)
    if optim_type == "lbfgs":
        opt.load_state_dict(
            {k[4:]: v for k, v in ckpt.items() if k.startswith("opt_")},
            device=data.device)
        return
    n = int(ckpt["opt_n_leaves"])
    opt.load_leaves([ckpt[f"opt_leaf_{i}"] for i in range(n)], data)


def restore_med_state(ckpt):
    """The calibrated medium of the checkpoint, (sigma_t, albedo, its
    optimizer leaves), or None when the file has none (the medium then
    starts from the config, as in the JAX package)."""
    if "med_st" not in ckpt:
        return None
    n = int(ckpt["med_n_leaves"])
    return (np.float32(ckpt["med_st"]), np.float32(ckpt["med_al"]),
            [ckpt[f"med_leaf_{i}"] for i in range(n)])
