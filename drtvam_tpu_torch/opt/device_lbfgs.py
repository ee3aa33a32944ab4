"""Linear L-BFGS with its vectors on the device (counterpart of
drtvam_tpu/opt/device_lbfgs.py).

The dose is linear in the patterns, so a search direction z is rendered
once (dvol = render(z)) and every Armijo trial is a loss evaluation of
vol + alpha * dvol, with no further render.

Semantics of the JAX package's fused_linear_lbfgs:
  * history acceptance: ys > 1e-10 * max(|y| |s|, 1e-30), finite;
  * gamma scaling from the newest pair; m = 5 by default;
  * Armijo c1 = 1e-4, alpha halving, `search_it` trials; the alpha after
    a failed last trial is still halved;
  * the sparsity term of the loss is evaluated on the SEARCH DIRECTION
    during the line search (reference quirk);
  * patterns clamped >= 0 after the step;
  * the loop breaks once the loss is exactly 0.

Every vector stays on the device; the history rows are updated in
place. The host reads a few scalars per iteration: the stop test, the
history acceptance and each Armijo trial. Dot products and norms are
float32, as in JAX.

`history_dtype` stores the S / Yh rows in another type (bfloat16 halves
the 2 x m x n history: 2.56 GB -> 1.28 GB at n = 64 M, m = 5), at the
JAX package's rounding points: the curvature ys comes from the float32
s and y before they are rounded, the rows are rounded as they are
inserted, the two-loop recursion widens each row to float32 before its
dot products, and gamma's denominator is the rounded newest y row.
"""
from __future__ import annotations

import numpy as np
import torch


def history_dtype_of(dtype):
    """A torch floating dtype from a torch dtype or its name, the form a
    JSON config carries ("bfloat16", "float32", ...)."""
    dt = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not (isinstance(dt, torch.dtype) and dt.is_floating_point):
        raise ValueError(f"history_dtype {dtype!r} is not a floating "
                         "torch dtype")
    return dt


def rows_to_numpy(rows):
    """History rows -> numpy: float32 as they are, bfloat16 as 2-byte
    void ('|V2') views of their bits, the type numpy writes and reads
    back for the JAX package's ml_dtypes bfloat16 arrays."""
    rows = rows.detach().cpu().contiguous()
    if rows.dtype == torch.bfloat16:
        return rows.view(torch.int16).numpy().view("V2")
    return rows.numpy()


def is_bf16_bits(x):
    """A numpy array of 2-byte bfloat16 bits: void ('|V2', ml_dtypes'
    bfloat16) or a 16-bit integer type."""
    return x.dtype.itemsize == 2 and x.dtype.kind in "Vui"


def rows_from_numpy(x, dtype, shape, device="cpu"):
    """numpy history rows -> a torch tensor of `dtype` on `device`. Rows
    of a 2-byte type (void '|V2' as numpy reads a saved bfloat16 array,
    ml_dtypes' bfloat16, uint16 or int16) are bfloat16 bits; any other
    type is read as numbers. shape: the (m, n) the rows must have."""
    x = np.ascontiguousarray(x)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"history rows of shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if is_bf16_bits(x):
        t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x, np.float32))
    return t.to(device=device, dtype=dtype).contiguous()


def lbfgs_direction(g, S, Yh, ys, head, nvalid):
    """Two-loop recursion over the circular (m, n) history buffers.
    Slot k (0 = newest) lives at (head - 1 - k) mod m; only the nvalid
    newest slots take part. Rows are widened to float32 before use."""
    m = S.shape[0]
    q = g
    alphas = []
    for k in range(nvalid):
        slot = (head - 1 - k) % m
        a = torch.dot(S[slot].float(), q) / ys[slot]
        q = q - a * Yh[slot].float()
        alphas.append(a)
    if nvalid > 0:
        newest = (head - 1) % m
        y_new = Yh[newest].float()
        gamma = ys[newest] / torch.clamp(torch.dot(y_new, y_new),
                                         min=1e-30)
        z = gamma * q
    else:
        z = q
    for k in range(nvalid - 1, -1, -1):
        slot = (head - 1 - k) % m
        b = torch.dot(Yh[slot].float(), z) / ys[slot]
        z = z + (alphas[k] - b) * S[slot].float()
    return -z


def armijo_search(cand_fn, vol, dvol, z, loss, g_dot_z, search_it=20,
                  c1=1e-4):
    """Armijo halving search. cand_fn(vol, dvol, alpha, z) -> candidate
    loss. Returns alpha (a power of two)."""
    alpha = 1.0
    for _ in range(search_it):
        f_new = cand_fn(vol, dvol, alpha, z)
        if bool(f_new <= loss + c1 * alpha * g_dot_z):
            break
        alpha *= 0.5
    return alpha


def new_history(p0, m, history_dtype=torch.float32):
    n = p0.shape[0]
    zeros = dict(dtype=torch.float32, device=p0.device)
    rows = dict(dtype=history_dtype, device=p0.device)
    return dict(p_old=torch.zeros((n,), **zeros),
                g_old=torch.zeros((n,), **zeros),
                S=torch.zeros((m, n), **rows),
                Yh=torch.zeros((m, n), **rows),
                ys=torch.ones((m,), **zeros),
                head=0, nvalid=0)


def history_step(st, p, g, first):
    """Insert the pair (p - p_old, g - g_old) if it passes the curvature
    test (never on the first step), then return the direction z."""
    m = st["S"].shape[0]
    sv = p - st["p_old"]
    yv = g - st["g_old"]
    ysv = torch.dot(yv, sv)
    norm = torch.linalg.vector_norm(yv) * torch.linalg.vector_norm(sv)
    accept = not first and bool(
        torch.isfinite(ysv) & (ysv > 1e-10 * torch.clamp(norm, min=1e-30)))
    if accept:
        h = st["head"]
        st["S"][h] = sv.to(st["S"].dtype)
        st["Yh"][h] = yv.to(st["Yh"].dtype)
        st["ys"][h] = ysv
        st["head"] = (h + 1) % m
        st["nvalid"] = min(st["nvalid"] + 1, m)
    st["p_old"], st["g_old"] = p, g
    return lbfgs_direction(g, st["S"], st["Yh"], st["ys"], st["head"],
                           st["nvalid"])


def _update(p, alpha, z, clamp):
    p_new = p + alpha * z
    return torch.clamp(p_new, min=0.0) if clamp else p_new


def linear_lbfgs(value_grad_fn, dir_fn, cand_fn, p0, n_steps, m=5,
                 search_it=20, c1=1e-4, clamp=True,
                 history_dtype=torch.float32, state=None, stop_i=None,
                 return_state=False):
    """Run the Linear-L-BFGS loop.

    value_grad_fn: p -> (vol, loss, grad); dir_fn: z -> dvol;
    cand_fn: (vol, dvol, alpha, z) -> loss of vol + alpha * dvol with
    the sparsity term on z; history_dtype: the S / Yh rows' type, a
    torch dtype or its name. Returns (p, loss_hist, n_done), and the
    loop state with return_state=True; passing that state back resumes
    where the last call stopped, and stop_i caps a call at that
    iteration."""
    history_dtype = history_dtype_of(history_dtype)
    if state is None:
        state = dict(new_history(p0, m, history_dtype), i=0, done=False,
                     p=p0.to(torch.float32),
                     loss_hist=torch.zeros((n_steps,), dtype=torch.float32,
                                           device=p0.device))
    else:
        if state["S"].shape[0] != m:
            raise ValueError(f"resumed state has history size "
                             f"{state['S'].shape[0]}, expected m = {m}")
        if state["loss_hist"].shape[0] != n_steps:
            raise ValueError(f"resumed state was made for "
                             f"{state['loss_hist'].shape[0]} steps, "
                             f"expected n_steps = {n_steps}")
        if state["S"].dtype != history_dtype:
            raise ValueError(f"resumed state has a {state['S'].dtype} "
                             f"history, expected {history_dtype}")
        state = dict(state)
    stop = n_steps if stop_i is None else min(int(stop_i), n_steps)

    while state["i"] < stop and not state["done"]:
        i, p = state["i"], state["p"]
        vol, loss, g = value_grad_fn(p)
        state["loss_hist"][i] = loss
        done = bool(loss == 0.0)
        z = history_step(state, p, g, first=i == 0)
        dvol = dir_fn(z)
        g_dot_z = torch.dot(g, z)
        alpha = armijo_search(cand_fn, vol, dvol, z, loss, g_dot_z,
                              search_it, c1)
        if not done:
            state["p"] = _update(p, alpha, z, clamp)
        state["i"], state["done"] = i + 1, done

    if return_state:
        return state["p"], state["loss_hist"], state["i"], state
    return state["p"], state["loss_hist"], state["i"]


class DeviceLinearLBFGS:
    """Host-steppable Linear L-BFGS holding the history on the device,
    for drivers that need per-iteration control (timing artifacts)."""

    def __init__(self, dir_fn, cand_fn, m=5, search_it=20, c1=1e-4,
                 clamp=True, history_dtype=torch.float32):
        """dir_fn(z, *step_args) -> dvol; cand_fn(vol, dvol, alpha, z,
        *step_args) -> loss; history_dtype: the S / Yh rows' type, a torch
        dtype or its name (the optimizer config's "history_dtype")."""
        self.m = m
        self.history_dtype = history_dtype_of(history_dtype)
        self.search_it = search_it
        self.c1 = c1
        self.clamp = clamp
        self._state = None
        self.last_alpha = None
        self.rebind(dir_fn, cand_fn)

    def rebind(self, dir_fn, cand_fn):
        """Swap the render / loss closures (the progressive schedule's
        change of depth) and keep the history."""
        self._dir_fn = dir_fn
        self._cand_fn = cand_fn

    def step(self, p, g, vol, loss, step_args=()):
        """Returns the updated (clamped) patterns."""
        if self._state is None or self._state["p_old"].shape != p.shape:
            self._state = dict(new_history(p, self.m, self.history_dtype),
                               t=0)
        st = self._state
        z = history_step(st, p, g, first=st["t"] == 0)
        st["t"] += 1
        dvol = self._dir_fn(z, *step_args)

        def cand(vol, dvol, alpha, zz):
            return self._cand_fn(vol, dvol, alpha, zz, *step_args)

        alpha = armijo_search(cand, vol, dvol, z, loss, torch.dot(g, z),
                              self.search_it, self.c1)
        self.last_alpha = alpha
        return _update(p, alpha, z, self.clamp)

    # -- checkpointing: the JAX package's keys and types ------------------

    _INT_KEYS = ("t", "head", "nvalid")

    def state_dict(self):
        """The history as numpy, under the JAX package's keys (t, p_old,
        g_old, S, Yh, ys, head, nvalid, m); {"t": 0} before the first
        step. bfloat16 rows are written as 2-byte void views of their
        bits, as numpy saves the JAX package's bfloat16 arrays."""
        if self._state is None:
            return {"t": np.int64(0)}
        st = self._state
        d = {k: np.int32(st[k]) for k in self._INT_KEYS}
        for k in ("p_old", "g_old", "ys"):
            d[k] = st[k].detach().cpu().numpy()
        for k in ("S", "Yh"):
            d[k] = rows_to_numpy(st[k])
        d["m"] = np.int64(self.m)
        return d

    def load_state_dict(self, d, device="cpu"):
        """Restore a state_dict of either package onto `device`, the
        patterns' device. Rows are read back in this optimizer's history
        type, and their shape is checked against (m, n)."""
        if int(d.get("t", 0)) == 0:
            self._state = None
            return
        if "m" in d and int(d["m"]) != self.m:
            raise ValueError(f"the checkpoint's history has m = "
                             f"{int(d['m'])}, this optimizer m = {self.m}")
        n = int(np.asarray(d["p_old"]).shape[0])
        st = {k: int(d[k]) for k in self._INT_KEYS}
        for k in ("p_old", "g_old", "ys"):
            st[k] = torch.as_tensor(np.array(d[k], np.float32),
                                    device=device)
        for k in ("S", "Yh"):
            st[k] = rows_from_numpy(d[k], self.history_dtype, (self.m, n),
                                    device)
        self._state = st
