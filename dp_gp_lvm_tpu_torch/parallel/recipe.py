"""The multi-rank recipe (counterpart of `dp_gp_lvm_tpu/parallel/recipe.py`)
the runner's `--mesh DATA[,MODEL]` takes: `sharded_setup` gives, for a
full-batch family, the sharded loss and the rank's shards of the
parameters and data; `place_svi` gives, for a minibatch family, the
rank's parameters and their table, and its step factory takes the mesh
(`make_svi_natgrad_step(mesh=)`, `make_dp_svi_step(mesh=)`). The caller's
training loop is the single-device one, with the mesh and the placement
table handed to `gp_optimizer`, which reduces the gradients across ranks
after each backward.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from dp_gp_lvm_tpu_torch.parallel import auto
from dp_gp_lvm_tpu_torch.parallel.mesh import Mesh
from dp_gp_lvm_tpu_torch.parallel.sharded_elbo import (
    bgplvm_loss_sharded,
    dp_loss_sharded,
    mrd_loss_sharded,
)


def parse_mesh(spec: str) -> tuple[int, int]:
    """"4,2" -> (data=4, model=2); "8" -> (8, 1)."""
    parts = [int(p) for p in spec.split(",")]
    if len(parts) == 1:
        return parts[0], 1
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be DATA[,MODEL], got {spec!r}")
    return parts[0], parts[1]


class ShardedSetup(NamedTuple):
    loss_fn: Callable     # loss_fn(params, *data): the sharded loss
    params: dict          # the rank's shards, new leaf tensors
    data: tuple           # the rank's rows of each data array
    placement: dict       # the params' table (parallel/auto.py)


def sharded_setup(model: str, params, data: tuple, config,
                  mesh: Mesh) -> ShardedSetup:
    """The sharded loss and the rank's shards for a full-batch family
    ("bgplvm", "dp_gp_lvm" or "mrd") on `mesh`, from the full `params`
    and `data` (a tuple of arrays: MRD's views, else the one Y). The loss
    is the exact sharded equivalent of the single-device one; the rows of
    `data` and q(X) must divide evenly over "data", the DP atoms over
    "model", else it raises.

    The SVI families take `place_svi`: their step factories take the
    mesh themselves (the batch, not the dataset, is cut)."""
    if model == "bgplvm":
        loss_fn = lambda p, y: bgplvm_loss_sharded(p, y, config, mesh)
        table, row = auto.bgplvm_shardings()
    elif model == "dp_gp_lvm":
        loss_fn = lambda p, y: dp_loss_sharded(p, y, config, mesh)
        table, row = auto.dp_shardings("raw_alpha" in params)
    elif model == "mrd":
        loss_fn = lambda p, *ys: mrd_loss_sharded(p, list(ys), config, mesh)
        table, row = auto.mrd_shardings(len(data))
    else:
        raise ValueError(f"no sharded recipe for model {model!r}")
    data = tuple(auto.shard(y, row, mesh, f"data[{i}]")
                 for i, y in enumerate(data))
    return ShardedSetup(loss_fn, auto.place(params, table, mesh), data,
                        table)


class SviPlacement(NamedTuple):
    params: dict          # the rank's parameters, new leaf tensors
    data: tuple           # the data arrays, whole
    placement: dict       # the params' table (parallel/auto.py)


def place_svi(model: str, params, data: tuple, mesh: Mesh) -> SviPlacement:
    """The SVI families' placement on `mesh` from the full `params`:
    "dp_svi" cuts its atom leaves over "model" (T must divide it, else
    ValueError), "svi_gplvm" (amortized or not) and "mrd_svi" keep every
    leaf whole. The data stays whole on every rank: each step gathers its
    batch rows by index and cuts the batch over "data". The table goes to
    `gp_optimizer(..., mesh=, placement=)`, which reduces the gradients."""
    if model == "dp_svi":
        table, _ = auto.dp_svi_shardings(params)
    elif model in ("svi_gplvm", "mrd_svi"):
        table, _ = auto.svi_shardings(params)
    else:
        raise ValueError(f"not an SVI family: {model!r}")
    return SviPlacement(auto.place(params, table, mesh), tuple(data), table)
