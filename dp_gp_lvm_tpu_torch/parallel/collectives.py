r"""The collectives of the sharded programs: `psum` (the reference's
`jax.lax.psum` inside shard_map), the loss's per-rank share, the gradient
and norm reductions the optimizer needs across ranks, and `all_gather`,
which joins the blocks of a cut array (no gradient).

How a gradient comes out right. Every rank evaluates the same replicated
loss L from its local shards and all-reduced partial sums. Let each rank
back-propagate its share L / W (W ranks, `share`), `psum`'s backward
all-reduce the cotangents over its axis, and, after backward, every
leaf's gradient be summed over the axes that leaf is not cut over
(`reduce_grads`): rows of q(X) over "model", atom leaves over "data",
replicated leaves over both. Then every rank holds the gradient of L
with respect to its own part of the logical parameters, the one the
single-device program gives. This counts both kinds of term once:
a term every rank computes whole (the DP stick terms, the hyperprior of
the Bayesian GP-LVM and MRD, KL[q(X)] on each model rank) reaches its
leaves as W shares of 1/W, and a partial contribution (phi_local .
f_local, psummed over "model") reaches each summand's leaves through the
psum's all-reduced cotangent.

`torch.distributed.nn.functional.all_reduce` would not do as the psum:
its backward all-reduces the cotangent of a loss every rank holds whole,
which makes each rank's gradient W times its share.

An axis of size 1 needs no collective: `psum` and `reduce_grads` skip
it, and the optimizer (`train/loop.py::GPOptimizer`) takes its
single-device norm and finiteness test on one rank, so a 1 x 1 mesh
runs the single-device arithmetic.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from dp_gp_lvm_tpu_torch.parallel.mesh import AXES, Mesh


def _all_reduce_flat(xs, group):
    """One all-reduce (sum) of all `xs` packed into one buffer; the sums
    come back in the tensors' own shapes and dtypes."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


class _Psum(torch.autograd.Function):
    """All-reduce (sum) of tensors over one group.

    Backward: an all-reduce (sum) of the cotangents over the same group.
    Rank r's summand x_r enters the replicated sum y on every rank of the
    group, so the gradient of the ranks' shares of the loss with respect
    to x_r is the sum over the group of the cotangents of y."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_all_reduce_flat(xs, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_all_reduce_flat([g.contiguous() for g in gs],
                                        ctx.group))


def psum(xs, mesh: Mesh, axis: str):
    """Sum of a tensor, or of each tensor of a list or tuple, over the
    ranks of `axis` (one collective for all of them); differentiable."""
    one = torch.is_tensor(xs)
    if mesh.size(axis) == 1:
        return xs
    out = _Psum.apply(mesh.group(axis), *([xs] if one else xs))
    return out[0] if one else type(xs)(out)


class _Share(torch.autograd.Function):
    """Identity forward; backward scales the cotangent by `scale`."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def share(loss, mesh: Mesh):
    """The replicated value `loss`, whose backward is this rank's share,
    1 / W of it: `reduce_grads` adds the W shares."""
    if mesh.world_size == 1:
        return loss
    return _Share.apply(loss, 1.0 / mesh.world_size)


def _summed_over(placement, mesh: Mesh) -> tuple:
    """The axes of size > 1 a leaf of `placement` is not cut over."""
    return tuple(a for a in AXES
                 if a != placement.axis and mesh.size(a) > 1)


def _group_of(axes: tuple, mesh: Mesh):
    return mesh.group(None) if len(axes) == 2 else mesh.group(axes[0])


@torch.no_grad()
def reduce_grads(grads: dict, placement: dict, mesh: Mesh) -> dict:
    """The gradients of the logical parameters from every rank's share:
    each leaf's gradient summed over the axes its `placement` does not
    cut (one all-reduce for all leaves of each set of axes). `grads` and
    `placement` are flat dicts with the same keys."""
    by_axes = {}
    for k in grads:
        axes = _summed_over(placement[k], mesh)
        if axes:
            by_axes.setdefault(axes, []).append(k)
    out = dict(grads)
    for axes, keys in by_axes.items():
        summed = _all_reduce_flat([grads[k] for k in keys],
                                  _group_of(axes, mesh))
        out.update(zip(keys, summed))
    return out


@torch.no_grad()
def global_norm(grads: dict, placement: dict, mesh: Mesh) -> torch.Tensor:
    """optax's global norm of the logical gradient tree: every shard of a
    cut leaf counted once (one representative rank of the other axis
    contributes it), every replicated leaf once. One all-reduce over all
    ranks, so every rank gets the same bits."""
    whole, cut = [], []
    for k, g in grads.items():
        axis = placement[k].axis
        sq = torch.sum(g * g)
        if axis is None:
            whole.append(sq)
            continue
        others = [a for a in AXES if a != axis]
        # the shard lives on every rank of the other axis: count one copy
        cut.append(sq if all(mesh.coordinate(a) == 0 for a in others)
                   else torch.zeros_like(sq))
    total = sum(whole)
    if cut:
        parts = torch.stack(cut)
        dist.all_reduce(parts)
        total = total + torch.sum(parts)
    return torch.sqrt(total)


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The blocks of `x` of every rank of `axis` joined along dim 0 in the
    order of their coordinates (the reference's shard_map output cut over
    that axis); no gradient. `x` itself, copied, on an axis of size 1."""
    if mesh.size(axis) == 1:
        return x.detach().clone()
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts)


def barrier(mesh: Mesh) -> None:
    """Every rank waits for every other (nothing to wait for on one)."""
    if mesh.world_size > 1:
        dist.barrier()


@torch.no_grad()
def all_true(flag: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A 0-d bool that is True on every rank where `flag` is True on
    every rank."""
    bad = (~flag).to(torch.int32).reshape(1)
    dist.all_reduce(bad)
    return bad[0] == 0
