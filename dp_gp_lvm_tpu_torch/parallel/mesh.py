"""The device mesh and its axis conventions (counterpart of
`dp_gp_lvm_tpu/parallel/mesh.py`), over `torch.distributed`.

Axes:
  - "data":  shards N (data rows). The psi statistics, the data-fit
             quadratics and KL[q(X)] are sums over n, so each reduces with
             one all-reduce over this axis.
  - "model": shards T (the DP atoms): per-atom statistics and Cholesky
             factors are independent given the shared q(X).

The reference lays a `jax.sharding.Mesh` over devices and runs shard_map
programs on it. Here every rank is a process: `make_mesh` lays the ranks
out as `init_device_mesh(device_type, (data, model), mesh_dim_names=(
"data", "model"))` does, data-major (rank = data coordinate * model +
model coordinate), as the reference reshapes its devices, and the
sharded ELBOs (`parallel/sharded_elbo.py`) all-reduce over one axis's
group at a time. Backends: gloo on the CPU, NCCL on the card, one rank
per card. NCCL refuses two ranks on one GPU, so on a one-card machine the
mesh is 1 x 1 at world size 1.

A leaf's placement is a tag (the reference's `data_sharding`,
`atom_sharding` and `replicated`): its leading dim cut over "data" or
"model", or the whole leaf on every rank.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


class Placement(NamedTuple):
    """The mesh axis a leaf's leading dim is cut over; None: the whole
    leaf on every rank."""
    axis: str | None


DATA_SHARDED = Placement(DATA_AXIS)     # rows: (N, ...) arrays
ATOM_SHARDED = Placement(MODEL_AXIS)    # the atom axis: (T, ...) arrays
REPLICATED = Placement(None)


def init_distributed(device_type: str = "cuda") -> None:
    """Open the default process group if none is open: NCCL for the card,
    gloo for the CPU. Under `torchrun` it takes the rank, world size and
    address the launcher sets in the environment; without them it opens a
    group of one rank over an in-process store (no address, no port)."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def close_distributed() -> None:
    """Close the default process group if one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """A (data, model) grid over every rank of the default process group:
    this rank's coordinate on each axis, and each axis's size and group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = tuple(device_mesh.shape)
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        self._coordinates = {a: device_mesh.get_local_rank(a) for a in AXES}

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def coordinate(self, axis: str) -> int:
        return self._coordinates[axis]

    def group(self, axis: str | None = None):
        """The process group of `axis`; every rank's (the default group)
        for None."""
        return None if axis is None else self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[0]}, model={self.shape[1]}, "
                f"rank={self.rank})")


def make_mesh(data: int | None = None, model: int = 1,
              device_type: str = "cuda") -> Mesh:
    """Mesh over every rank, the process group opened if needed; the data
    axis absorbs the remainder."""
    init_distributed(device_type)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} != {n} ranks; pass explicit axes"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device_type, (data, model),
                                 mesh_dim_names=AXES))
