"""Placement tables of the full-batch families (counterpart of
`dp_gp_lvm_tpu/parallel/auto.py`), and `place` / `gather`, which cut a
parameter tree to a rank's shards and put it back together.

A table maps each leaf to a `parallel.mesh.Placement`: rows over "data",
atoms over "model", or whole on every rank. Unlike the reference's
NamedShardings a tag names an axis, not a mesh, so the tables take none.
The explicit programs of `parallel/sharded_elbo.py` take the shards
`place` cuts by these tables, and the optimizer (`train/loop.py::
GPOptimizer` with a mesh) reads them to reduce gradients and norms
across ranks.

The reference's `auto_sharded_value_and_grad` has no torch twin: it is a
GSPMD annotation (jit with NamedSharding constraints on the plain model
code, XLA inserting the collectives). torch.distributed has no
partitioner that would turn the single-device model into the sharded
program, so the port runs the explicit programs only. The tables stand
in for the annotation: the same layout, the same losses.

The SVI layouts (`svi_shardings`, `dp_svi_shardings`) are not ported
yet.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from dp_gp_lvm_tpu_torch.parallel.mesh import (
    ATOM_SHARDED,
    DATA_SHARDED,
    REPLICATED,
    Mesh,
)


def bgplvm_shardings():
    """(params table, data placement) of the Bayesian GP-LVM: q(X) and Y
    row-sharded over "data", everything else whole."""
    params = {
        "qx_mean": DATA_SHARDED,
        "raw_qx_var": DATA_SHARDED,
        "z": REPLICATED,
        "raw_variance": REPLICATED,
        "raw_ard": REPLICATED,
        "raw_noise": REPLICATED,
    }
    return params, DATA_SHARDED


def dp_shardings(learn_alpha: bool = False):
    """The DP-GP-LVM's: rows over "data", the atom-stacked leaves over
    "model", the assignments and sticks whole, and `raw_alpha` whole where
    alpha is learned (the reference's table has no such leaf)."""
    params = {
        "qx_mean": DATA_SHARDED,
        "raw_qx_var": DATA_SHARDED,
        "z": ATOM_SHARDED,
        "raw_variance": ATOM_SHARDED,
        "raw_ard": ATOM_SHARDED,
        "raw_noise": ATOM_SHARDED,
        "phi_logits": REPLICATED,
        "raw_gamma1": REPLICATED,
        "raw_gamma2": REPLICATED,
    }
    if learn_alpha:
        params["raw_alpha"] = REPLICATED
    return params, DATA_SHARDED


def mrd_shardings(num_views: int):
    """MRD's: q(X) and every view's rows over "data"; each view's kernel
    and inducing leaves whole."""
    view = {"z": REPLICATED, "raw_variance": REPLICATED,
            "raw_ard": REPLICATED, "raw_noise": REPLICATED}
    params = {
        "qx_mean": DATA_SHARDED,
        "raw_qx_var": DATA_SHARDED,
        "views": [dict(view) for _ in range(num_views)],
    }
    return params, DATA_SHARDED


def _tree_map(fn, tree, table, path=""):
    """`fn(path, leaf, placement)` over a params tree (a dict, MRD's with
    its `views` list of dicts) and its table of the same structure."""
    if isinstance(tree, dict):
        if set(tree) != set(table):
            raise ValueError(f"{path or 'params'}: keys {sorted(tree)} do "
                             f"not match the table's {sorted(table)}")
        return {k: _tree_map(fn, v, table[k], f"{path}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, p, f"{path}{i}.")
                for i, (v, p) in enumerate(zip(tree, table))]
    return fn(path.rstrip("."), tree, table)


def shard(x: torch.Tensor, placement, mesh: Mesh, name: str = "array"):
    """This rank's block of `x`: its leading dim cut evenly over the
    placement's axis (a view), or `x` itself when whole."""
    if placement.axis is None:
        return x
    size = mesh.size(placement.axis)
    n = x.shape[0]
    if n % size:
        raise ValueError(
            f"{name}: leading dim {n} is not evenly divisible by the "
            f"{placement.axis!r} axis of size {size}")
    k = n // size
    return x.narrow(0, mesh.coordinate(placement.axis) * k, k)


def place(params, table, mesh: Mesh):
    """The rank's local parameters: each leaf cut by its placement into a
    new leaf tensor (an `nn.Parameter` of its own, contiguous), so an
    optimizer over them updates this rank's shards in place."""
    return _tree_map(
        lambda name, x, p: nn.Parameter(
            shard(x.detach(), p, mesh, name).clone()),
        params, table)


@torch.no_grad()
def gather(params, table, mesh: Mesh):
    """The inverse of `place`: the full tree on every rank (plain tensors),
    each cut leaf's shards joined along its leading dim in the order of
    their coordinates."""
    def join(name, x, p):
        x = x.detach()
        if p.axis is None or mesh.size(p.axis) == 1:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(mesh.size(p.axis))]
        dist.all_gather(parts, x.contiguous(), group=mesh.group(p.axis))
        return torch.cat(parts)

    return _tree_map(join, params, table)
