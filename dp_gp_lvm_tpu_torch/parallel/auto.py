"""Placement tables of every family (counterpart of
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

The SVI families cut no rows of their parameters: the q(X) table (or the
encoder) stays whole and each step gathers its batch rows by index, so
the batch, not the dataset, is what the step programs cut over "data"
(`parallel/sharded_elbo.py`). Their data placement is whole too.
"""
from __future__ import annotations

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.parallel.collectives import all_gather
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


def _table_like(params, placement_of):
    """A table of the structure of `params` (a dict, MRD's with its
    `views` list of dicts): `placement_of(key)` for each leaf."""
    return {k: ([{kk: placement_of(kk) for kk in view} for view in v]
                if k == "views" else placement_of(k))
            for k, v in params.items()}


def svi_shardings(params):
    """(params table, data placement) of the SVI-GPLVM, amortized or not,
    and of the MRD-SVI (each view's leaves too): every leaf whole, and the
    data whole (rows are gathered by index each step)."""
    return _table_like(params, lambda k: REPLICATED), REPLICATED


# the DP-SVI's atom-stacked leaves: hypers, inducing inputs, q(u | t)
DP_SVI_ATOM_LEAVES = ("z", "raw_variance", "raw_ard", "raw_noise", "u_h",
                      "u_lam")


def dp_svi_shardings(params):
    """The minibatch DP-GP-LVM's: the atom-stacked hypers, inducing inputs
    and q(u | t) naturals over "model"; the q(X) table or the encoder,
    phi, the sticks and a learned alpha whole; the data whole."""
    return _table_like(params, lambda k: (
        ATOM_SHARDED if k in DP_SVI_ATOM_LEAVES else REPLICATED)), REPLICATED


def check_divides(n: int, axis: str, mesh: Mesh, name: str) -> None:
    """Raise where `n` rows or atoms do not cut evenly over `axis`."""
    if n % mesh.size(axis):
        raise ValueError(
            f"{name}: leading dim {n} is not evenly divisible by the "
            f"{axis!r} axis of size {mesh.size(axis)}")


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
    check_divides(x.shape[0], placement.axis, mesh, name)
    k = x.shape[0] // mesh.size(placement.axis)
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
        if p.axis is None:
            return x.detach().clone()
        return all_gather(x, mesh, p.axis)

    return _tree_map(join, params, table)
