"""Checkpoint and resume of a training state, and a portable .npz export
of parameters (counterpart of `dp_gp_lvm_tpu/train/checkpoint.py`, which
writes through orbax).

A checkpoint holds everything a step reads: the parameters, the Adam
moments, every optimizer group's count of applied steps (its schedule's
position), the non-finite count and the global step. A run interrupted at
a checkpoint and resumed continues bit for bit as the uninterrupted run.
On a device mesh a checkpoint holds the full state, gathered from the
ranks' shards, and a restore cuts it by the optimizer's placement table
again, so a resumed mesh run continues on the bits of the straight one.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.parallel import auto, collectives
from dp_gp_lvm_tpu_torch.train.loop import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """Save and restore a `TrainState` in `directory`, one file a step
    (`ckpt_<step>.pt`, written under a temporary name and renamed into
    place), keeping the newest `keep`."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, state: TrainState, force: bool = False) -> None:
        """Write the state at its step; an existing checkpoint of that step
        is kept unless `force`. On a mesh (the optimizer's) the state is
        the full one, gathered from every rank's shards, and rank 0 writes
        it while the others wait."""
        path = self._path(state.step)
        if os.path.exists(path) and not force:
            return
        opt = state.optimizer
        blob = {"step": state.step,
                **{k: _to_cpu(v) for k, v in _full_state(opt).items()}}
        if opt.mesh is None or opt.mesh.rank == 0:
            tmp = path + ".tmp"
            torch.save(blob, tmp)
            os.replace(tmp, path)
            for old in self._steps()[:-self.keep]:
                os.remove(self._path(old))
        if opt.mesh is not None:
            collectives.barrier(opt.mesh)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState) -> TrainState | None:
        """The latest checkpoint copied into `template`'s tensors (on their
        device), with its step; None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        blob = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        opt = template.optimizer
        if opt.mesh is not None:      # the rank's shards of the full state
            blob.update({k: _cut(blob[k], opt.placement, opt.mesh)
                         for k in _CUT})
        opt.load_state_dict(blob)
        template.step = int(blob["step"])
        return template

    def close(self) -> None:
        """Saves are synchronous; nothing is left to flush."""


# the state's trees laid out as the parameters are, one table for all
_CUT = ("params", "mu", "nu")


def _full_state(opt) -> dict:
    """`opt.state_dict()`, its parameters and Adam moments gathered from
    every rank's shards by the optimizer's table on a mesh."""
    state = opt.state_dict()
    if opt.mesh is None:
        return state
    return {**state, **{
        k: auto.gather(state[k], {n: opt.placement[n] for n in state[k]},
                       opt.mesh) for k in _CUT}}


def _cut(tree: dict, placement: dict, mesh) -> dict:
    """The rank's block of each tensor of a flat tree, by its table."""
    return {k: auto.shard(v, placement[k], mesh, k) for k, v in tree.items()}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def export_npz(path: str, params: dict[str, Any]) -> None:
    """Portable dump of a (possibly nested) dict of tensors or arrays;
    nested keys are joined with '/'."""
    flat = {}

    def add(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                add(f"{prefix}{k}/", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                add(f"{prefix}{i}/", v)
        else:
            if torch.is_tensor(obj):
                obj = obj.detach().cpu().numpy()
            flat[prefix.rstrip("/")] = np.asarray(obj)

    add("", params)
    np.savez(path, **flat)


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
