"""Multi-GPU scale-out on torch.distributed (counterpart of
drtvam_tpu/parallel/shard.py): one process a GPU, each with its own
device, inputs replicated on every rank, results summed by all_reduce.

  * The wavefront (`make_sharded_render`, `render_sharded`): rank r of W
    traces the active pixels [r per, min(n, (r + 1) per)), per =
    ceil(n / W), into a dose on its own device, and one all_reduce sums
    the doses; its adjoint writes the gradient of its pixels into the
    full (n_active,) vector, zero elsewhere, and one all_reduce sums
    those. A rank traces its block of the store (ProjectorStatic.block;
    the kernels take it as their launch order over the block's pixels,
    ops/render.py block_order), so every lane keeps its global id, lane
    = pixel * spp + k, and draws the stream it draws in a single-GPU
    render: the sharded dose is the single-GPU dose up to float
    reduction order, and the gradient, each pixel's lanes summed on one
    rank and exact zeros added by the others, is the single-GPU gradient
    bitwise. Every route `ops/render.py`
    `render` takes runs inside a rank: the analog pair, its target forms,
    the residual pair with its dda path and walk passes.
  * The ballistic engine (`shard_ballistic_engine`): the angles go to
    ranks in contiguous blocks; each rank packs its block of the
    transport fields, backprojects its angles' patterns and all_reduce
    sums the doses; the adjoint of each angle needs no collective, and
    its block is written into the full pattern vector, which one
    all_reduce gives every rank (so that every rank's optimizer sees the
    same gradient).

A group of None is a world of one: no collective. NCCL needs one card a
rank; gloo takes CUDA tensors too (staged through host memory), so two
ranks may share a card over gloo.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops import render as wavefront

# ROADMAP.md item 22: the sharded adjoint's medium cotangents
MEDIUM_GRADS_ITEM = 22


def world(group):
    """(size, rank) of the process group; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def block_range(n, size, rank):
    """[lo, hi): rank's contiguous block of n items over size ranks,
    ceil(n / size) each (the last ones shorter or empty)."""
    per = -(-n // size)
    lo = min(rank * per, n)
    return lo, min(n, lo + per)


def all_reduce(t, group):
    """t summed over the group in place (nothing for a group of None)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


# --------------------------------------------------------------------------
# the wavefront: active pixels -> ranks


def pixel_block(static, lo, hi):
    """The static that traces the active pixels [lo, hi) of its store
    (ProjectorStatic.block): the same lanes, with the same ids and random
    streams, that the whole render traces for them, on the same scene
    tensors and inputs."""
    p = static.projector
    if p.block is not None:
        raise ValueError(f"the static traces the block {p.block} already")
    return dataclasses.replace(static, projector=dataclasses.replace(
        p, block=(lo, hi)))


def local_block(group, static):
    """(static, lo, hi): this rank's block of the active pixels (the
    static itself where the rank holds all of them)."""
    if static.medium_grads:
        raise NotImplementedError(
            "the sharded render forms no medium cotangents (medium_grads), "
            "as the JAX package's sharded adjoint drops them: ROADMAP.md "
            f"item {MEDIUM_GRADS_ITEM}")
    n = static.projector.n_active
    lo, hi = block_range(n, *world(group))
    if (lo, hi) == (0, n):
        return static, lo, hi
    return pixel_block(static, lo, hi), lo, hi


def sharded_forward(group, static, arr, data, seed, spp, chunk):
    """The flat dose (n_cells,) of data (n_active,): this rank's block
    through ops/render.py `forward` (its kernels on the card, the plain
    version on the CPU), summed over the group."""
    st, lo, hi = local_block(group, static)
    if hi > lo:
        acc = wavefront.forward(st, arr, data, seed, spp, chunk)
    else:
        acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                          device=data.device)
    return all_reduce(acc, group)


def sharded_adjoint(group, static, arr, seed, spp, chunk, dL_flat):
    """The pattern gradient (n_active,) of dL_flat: this rank's block
    through ops/render.py `adjoint` (0 outside the block), summed over
    the group."""
    st, lo, hi = local_block(group, static)
    if hi > lo:
        pg = wavefront.adjoint(st, arr, seed, spp, chunk, dL_flat)
    else:
        pg = torch.zeros((static.projector.n_active,), dtype=torch.float32,
                         device=dL_flat.device)
    return all_reduce(pg, group)


class ShardedRenderRaw(torch.autograd.Function):
    """The flat dose accumulator summed over the group, differentiable in
    the patterns: the backward replays this rank's paths with the same
    seed and spp_grad lanes a pixel and sums the gradient over the group
    (ops/render.py RenderRaw's contract, without medium gradients)."""

    @staticmethod
    def forward(ctx, data, group, static, arr, seed, spp, spp_grad, chunk):
        ctx.args = (group, static, arr, seed, spp_grad, chunk)
        return sharded_forward(group, static, arr, data, seed, spp, chunk)

    @staticmethod
    def backward(ctx, ct):
        group, static, arr, seed, spp_grad, chunk = ctx.args
        pg = sharded_adjoint(group, static, arr, seed, spp_grad, chunk,
                             ct.contiguous())
        return pg, None, None, None, None, None, None, None


def make_sharded_render(group):
    """A `render_raw(static, arr, active_data, seed, spp, spp_grad,
    chunk)` whose forward dose and backward pattern gradient are summed
    over the group (ShardedRenderRaw). Inputs and result are replicated:
    every rank passes the same ones and gets the same dose."""

    def render_raw(static, arr, active_data, seed, spp, spp_grad, chunk):
        return ShardedRenderRaw.apply(active_data, group, static, arr, seed,
                                      spp, spp_grad, chunk)

    return render_raw


def render_sharded(group, static, arr, active_data, inv_vol, seed=0, spp=1,
                   spp_grad=None, chunk=None):
    """Sharded counterpart of ops/render.py `render`: the dose volume
    (Z, Y, X, C), differentiable in active_data."""
    raw = make_sharded_render(group)(
        static, arr, active_data, seed, spp,
        spp if spp_grad is None else spp_grad,
        wavefront.DEFAULT_CHUNK if chunk is None else chunk)
    return raw.reshape(static.sensor.shape) * inv_vol


# --------------------------------------------------------------------------
# the ballistic engine: angles -> ranks


class _Summed(torch.autograd.Function):
    """x summed over the group; its gradient passes as it is (every rank
    holds the same cotangent of the summed value)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """x as it is; its gradient summed over the group (each rank's holds
    the part of its own angles)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class AngleShard:
    """A rank's block [lo, hi) of a ballistic engine's angles and its
    group: what BallisticEngine's render_vol and pattern_grad consult
    (`eng.shard`) to take their angles and sum over the ranks."""

    def __init__(self, group, lo, hi):
        self.group, self.lo, self.hi = group, lo, hi

    def replicated(self, active_data):
        return _Replicated.apply(active_data, self.group)

    def summed(self, dose):
        return _Summed.apply(dose, self.group)

    def full(self, block, n_angles):
        """(n_angles, ...) zeros with this rank's block in place."""
        out = block.new_zeros((n_angles,) + tuple(block.shape[1:]))
        out[self.lo:self.hi] = block
        return out

    def sum(self, g):
        return all_reduce(g, self.group)


def shard_ballistic_engine(eng, group):
    """Point a BallisticEngine at its rank's block of the angles and sum
    over the group: the rank's block of W_host / U_host packed in the
    engine's layout (the dense or banded pair chosen once, on the full
    fields, so that every rank runs the same pair, float32 or bf16), its
    angles' patterns backprojected and the doses all-reduced; the adjoint
    of its angles written into the full pattern vector and all-reduced.
    The angle count must divide over the ranks. Returns the same engine,
    mutated (its full packed fields dropped)."""
    from ..ops.backproject import PackedFields
    size, rank = world(group)
    A = eng.W_host.shape[0]
    if A % size:
        raise ValueError(f"{A} angles do not divide over {size} devices")
    per = A // size
    lo, hi = rank * per, (rank + 1) * per
    if eng.shard is not None:
        raise ValueError("the engine is sharded already")
    dev, U = eng.device, eng.fields.U
    eng.fields = None
    eng.fields = PackedFields(
        torch.from_numpy(eng.W_host[lo:hi]).to(dev),
        torch.from_numpy(eng.U_host[lo:hi]).to(dev), U,
        "_band" in eng.impl, eng.impl.endswith("_bf16"))
    eng.shard = AngleShard(group, lo, hi)
    return eng
