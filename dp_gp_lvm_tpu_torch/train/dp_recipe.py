"""The staged split-init recipe of the minibatch DP-GP-LVM (c7), with
stage-boundary checkpoints (counterpart of `dp_gp_lvm_tpu/train/dp_recipe.py`,
whose docstring gives the measurements behind each stage).

Cold multi-atom starts sit on a symmetric saddle: with near-uniform phi
every atom gets the same phi-weighted gradient and the mixture collapses to
one atom. So:

1. **stage1**: train the fit once at truncation 1 (60% of the budget);
2. **split**: clone the atom over a noise ladder at the per-dim residual
   quantiles of that fit (`dp_svi.split_single_atom(residuals=...)`);
3. **stage2 warmup**: phi frozen and zero learning rates, so only the
   q(u | t) blend acts and each clone settles at its own noise level;
4. **stage2b assignment**: latents, inducing inputs, ARD and signal
   variances frozen (`gp_optimizer(freeze=...)`), damped CAVI forms the
   assignments while each atom's noise follows its own dims;
5. **stage2c**: everything trains, phi locked (`phi_update="frozen"`).

With `ckpt_dir` each finished stage writes its parameters as
`<ckpt_dir>/<stage>.npz`, under a temporary name renamed into place. With
`resume=True` the recipe restarts after the last boundary written and
draws the same keys for the stages it skips, so a resumed run ends on the
bits of an uninterrupted one.
"""
from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.models import dp_svi
from dp_gp_lvm_tpu_torch.parallel import auto, collectives
from dp_gp_lvm_tpu_torch.parallel.recipe import place_svi
from dp_gp_lvm_tpu_torch.train.loop import TrainState, gp_optimizer

# stage2b's freeze set: the manifold and the kernel hypers but the noise
FROZEN_MANIFOLD = frozenset(
    {"qx_mean", "raw_qx_var", "z", "raw_variance", "raw_ard"}
)


def _frozen_manifold_for(params) -> frozenset:
    """FROZEN_MANIFOLD with a recognition network's leaves, which are the
    manifold of an amortized model."""
    return FROZEN_MANIFOLD | frozenset(k for k in params
                                       if k.startswith("enc_"))


RECIPE = (
    "split-init: T=1 warm start + residual-quantile clone "
    "+ frozen-phi q(u) warmup + fixed-manifold CAVI "
    "assignment + locked-phi joint fine-tune"
)

# stage-boundary checkpoint names, in the order the stages finish
STAGE_SPLIT = "stage1_split"       # the split full-T parameters
STAGE_WARM = "stage2_warm"         # after the warmup
STAGE_ASSIGN = "stage2b_assign"    # after the assignment
_BOUNDARIES = (STAGE_SPLIT, STAGE_WARM, STAGE_ASSIGN)


def plan(steps: int, chunk: int) -> dict[str, int]:
    """Step budget of each stage (stage 1 and the assignment in whole
    chunks)."""
    s1_steps = max(chunk, (int(steps * 0.6) // chunk) * chunk)
    s2_steps = max(chunk, steps - s1_steps)
    warm = max(50, min(250, s2_steps // 5))
    s2_assign = max(chunk, ((s2_steps - warm) // 2 // chunk) * chunk)
    s2_joint = max(chunk, s2_steps - warm - s2_assign)
    return {"s1_steps": s1_steps, "s2_steps": s2_steps, "warm": warm,
            "s2_assign": s2_assign, "s2_joint": s2_joint}


def _path(ckpt_dir: str, stage: str) -> str:
    return os.path.join(ckpt_dir, f"{stage}.npz")


def _save_boundary(ckpt_dir: str | None, stage: str, params,
                   mesh=None, table=None) -> None:
    """Write the stage's parameters; on a mesh the full tree, gathered
    from every rank's atoms, written by rank 0 while the others wait."""
    if ckpt_dir is None:
        return
    if table is not None:
        params = auto.gather(params, table, mesh)
    if mesh is None or mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = _path(ckpt_dir, stage) + ".tmp"
        with open(tmp, "wb") as f:    # a file handle: np.savez must not
            np.savez(f, **{k: v.detach().cpu().numpy()   # add .npz
                           for k, v in params.items()})
        os.replace(tmp, _path(ckpt_dir, stage))
    if mesh is not None:
        collectives.barrier(mesh)


def _load_boundary(ckpt_dir: str, stage: str, device) -> dict:
    with np.load(_path(ckpt_dir, stage)) as f:
        return {k: nn.Parameter(torch.from_numpy(f[k]).to(device))
                for k in f.files}


def _latest_boundary(ckpt_dir: str | None) -> str | None:
    if ckpt_dir is None:
        return None
    done = [s for s in _BOUNDARIES if os.path.exists(_path(ckpt_dir, s))]
    return done[-1] if done else None


def staged_dp_svi(
    key,
    key_run,
    Y,
    config: dp_svi.Config,
    n_total: int,
    *,
    steps: int,
    chunk: int,
    lr: float,
    ngd_lr: float | None,
    drive: Callable,
    mesh=None,
    ckpt_dir: str | None = None,
    resume: bool = False,
    log: Callable[[str], None] = lambda s: print(s, flush=True),
):
    """Run the staged split-init schedule on the resident Y. `key` draws
    the stage-1 init, `key_run` every stage's minibatches (keys of
    `core/prng.py`). Returns (state, optimizer, info): the final stage's
    `TrainState` and optimizer, and per-stage step counts, the recipe,
    `per_step` (stage 2c's seconds a step), `seconds` and, on a resume,
    `resumed_from`.

    `drive(step_fn, state, n_steps, key, Y, label=...)` runs n_steps of a
    `dp_svi.make_dp_svi_step` step from `state` (step t drawing its rows
    from the key `fold_in(key, t)` in the runner's drive) and returns
    (state, seconds a step, wall seconds).

    `mesh`: stage 1 and the split run whole on every rank (a T = 1 model
    has no atoms to cut); the split parameters, or those a resume loads,
    are then placed (`parallel.recipe.place_svi("dp_svi", ...)`) and
    stages 2a-2c step on the mesh, each rank its T / model atoms and its
    block of every batch. The boundaries hold the full parameters; the
    state returned holds the rank's (`parallel.auto.dp_svi_shardings`
    gives their table)."""
    p = plan(steps, chunk)
    start_after = _latest_boundary(ckpt_dir) if resume else None
    info: dict = {"stage1_steps": p["s1_steps"],
                  "stage2_steps": p["s2_steps"], "recipe": RECIPE}
    if start_after is not None:
        info["resumed_from"] = start_after
        log(f"  [resume] skipping ahead: {start_after} checkpoint found in "
            f"{ckpt_dir}")

    config1 = config._replace(truncation=1)
    # the ORDER of the splits is part of the contract: a resume draws the
    # same splits for the stages it skips
    key_run, r1, r2 = prng.split(key_run, 3)
    seconds1 = 0.0
    if start_after is None:
        params1 = dp_svi.init_params(key, Y, config1)
        opt1 = gp_optimizer(params1, lr=lr, decay_steps=p["s1_steps"],
                            ngd_lr=ngd_lr)
        step1 = dp_svi.make_dp_svi_step(config1, n_total, opt1, rho=0.3)
        _, _, seconds1 = drive(step1, TrainState(opt1), p["s1_steps"], r1, Y,
                               label="[stage1 T=1] ")
        # the noise ladder from the per-dim residual quantiles of the
        # stage-1 fit (one pass over every row)
        with torch.no_grad():
            resid = dp_svi.expected_residuals(params1, Y, config1)
        params = dp_svi.split_single_atom(params1, config, residuals=resid)
        _save_boundary(ckpt_dir, STAGE_SPLIT, params, mesh)
    else:
        params = _load_boundary(ckpt_dir, start_after, Y.device)
    table = None
    if mesh is not None:
        params, _, table = place_svi("dp_svi", params, (Y,), mesh)
    on_mesh = dict(mesh=mesh, placement=table)

    t2 = time.perf_counter()
    key_run, rw = prng.split(key_run)
    if start_after in (None, STAGE_SPLIT):
        opt_w = gp_optimizer(params, lr=0.0, hyper_lr=0.0, **on_mesh)
        warm_step = dp_svi.make_dp_svi_step(config, n_total, opt_w, rho=0.5,
                                            phi_update="frozen", mesh=mesh)
        idx = warm_step.indices(prng.split(rw, p["warm"]))
        losses = torch.stack([warm_step(i, idx[i], Y)
                              for i in range(p["warm"])])
        log(f"  [stage2 warmup] {p['warm']} frozen-phi steps, loss "
            f"{float(losses[-1]):.4g}")
        _save_boundary(ckpt_dir, STAGE_WARM, params, mesh, table)

    if start_after in (None, STAGE_SPLIT, STAGE_WARM):
        opt_a = gp_optimizer(params, lr=lr, decay_steps=p["s2_assign"],
                             freeze=_frozen_manifold_for(params), **on_mesh)
        assign_step = dp_svi.make_dp_svi_step(
            config, n_total, opt_a, rho=0.3, rho_phi=0.2, phi_update="cavi",
            mesh=mesh)
        drive(assign_step, TrainState(opt_a), p["s2_assign"], r2, Y,
              label=f"[stage2b assign T={config.truncation}] ")
        _save_boundary(ckpt_dir, STAGE_ASSIGN, params, mesh, table)

    opt2 = gp_optimizer(params, lr=lr, decay_steps=p["s2_joint"],
                        ngd_lr=ngd_lr, **on_mesh)
    nat_step = dp_svi.make_dp_svi_step(config, n_total, opt2, rho=0.3,
                                       phi_update="frozen", mesh=mesh)
    key_run, r2c = prng.split(key_run)
    state, per_step, _ = drive(
        nat_step, TrainState(opt2), p["s2_joint"], r2c, Y,
        label=f"[stage2c joint T={config.truncation}] ")
    info["per_step"] = per_step
    info["seconds"] = seconds1 + (time.perf_counter() - t2)
    return state, opt2, info
