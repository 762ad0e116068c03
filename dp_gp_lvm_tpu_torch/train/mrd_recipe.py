"""The two-phase structure-then-recalibrate recipe of the minibatch MRD
(c9), with its phase boundary checkpointed (counterpart of
`dp_gp_lvm_tpu/train/mrd_recipe.py`, whose docstring gives the
measurements behind it).

Calm rates never separate the views' ARD weights; hot rates separate them
but collapse the likelihood's temperature (sigma_f^2 and the noise fall,
and the cross-view predictive turns overconfident), a collapse the bound
prefers. So:

1. **phase A** (2/3 of the budget): the whole model runs hot (`hot_lr`,
   the hypers at hot_lr / 10 after a warmup of a tenth of the phase), and
   the relevance signature separates;
2. **phase B** (the rest): `recalibrated` resets each view's sigma_f^2 and
   noise to calibrated levels (the q(u^v) mean rescaled so that the
   predictive mean stays put) and floors the resident q(X) variance; then
   everything but the frozen `raw_ard` and `raw_variance` retrains at the
   calm rate.

With `ckpt_dir` the phase-A parameters are written as
`<ckpt_dir>/phaseA.npz` (keys `views/<i>/<leaf>` for the views' leaves),
under a temporary name renamed into place; `resume=True` restarts at phase
B from it on the same key splits, and ends on the bits of an
uninterrupted run. On a device mesh (`mesh=`) both phases cut their batch
rows over "data".
"""
from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import (
    MIN_VARIATIONAL_VAR,
    positive,
    positive_inverse,
)
from dp_gp_lvm_tpu_torch.models import mrd_svi
from dp_gp_lvm_tpu_torch.parallel import auto, collectives
from dp_gp_lvm_tpu_torch.parallel.recipe import place_svi
from dp_gp_lvm_tpu_torch.train.loop import TrainState, gp_optimizer

RECIPE = (
    "structure-then-recalibrate: hot-hyper ARD separation + frozen-ARD "
    "variance-reset calm recalibration"
)

PHASE_A = "phaseA"

# phase B's freeze set: the separated relevance signature must not drift,
# and the likelihood's temperature must not collapse again
FROZEN_STRUCTURE = frozenset({"raw_ard", "raw_variance"})


def plan(steps: int, chunk: int, phase_a_frac: float = 2.0 / 3.0):
    """Step budget of each phase (phase A in whole chunks)."""
    a = max(chunk, (int(steps * phase_a_frac) // chunk) * chunk)
    b = max(chunk, steps - a)
    return {"phase_a_steps": a, "phase_b_steps": b}


def _path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, f"{PHASE_A}.npz")


def _save_boundary(ckpt_dir: str | None, params, mesh=None,
                   table=None) -> None:
    """Write the phase-A parameters; on a mesh the gathered tree, written
    by rank 0 while the others wait."""
    if ckpt_dir is None:
        return
    if mesh is not None:
        params = auto.gather(params, table, mesh)
        if mesh.rank != 0:
            collectives.barrier(mesh)
            return
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    for k, v in params.items():
        if k == "views":
            for i, vp in enumerate(v):
                for kk, vv in vp.items():
                    flat[f"views/{i}/{kk}"] = vv.detach().cpu().numpy()
        else:
            flat[k] = v.detach().cpu().numpy()
    tmp = _path(ckpt_dir) + ".tmp"
    with open(tmp, "wb") as f:        # a file handle: np.savez must not
        np.savez(f, **flat)           # add .npz to the name
    os.replace(tmp, _path(ckpt_dir))
    if mesh is not None:
        collectives.barrier(mesh)


def _load_boundary(ckpt_dir: str, device) -> dict:
    with np.load(_path(ckpt_dir)) as f:
        views: dict[int, dict] = {}
        out: dict = {}
        for k in f.files:
            t = torch.from_numpy(f[k]).to(device)
            if k.startswith("views/"):
                _, i, leaf = k.split("/", 2)
                views.setdefault(int(i), {})[leaf] = t
            else:
                out[k] = t
        out["views"] = [views[i] for i in sorted(views)]
        return out


@torch.no_grad()
def recalibrated(params, reset_variance: float, reset_noise: float,
                 qx_reexpand: float = 0.05):
    """Phase B's boundary surgery (new tensors): per view, sigma_f^2 and
    the noise reset to calibrated levels, and the whitened q(u^v) mean
    scaled by sqrt(old / new) so that the predictive mean is unchanged (f
    ~ Psi1 K_uu^{-1/2} m ~ sigma_f m). The resident q(X) variance is
    floored at `qx_reexpand`: the hot phase leaves the latents nearly
    interpolating, and with sigma_f^2 frozen the noise, the one
    temperature left, ran away without it in the reference's runs."""
    params = dict(params)
    if qx_reexpand and "raw_qx_var" in params:
        raw = params["raw_qx_var"]
        floor = positive_inverse(torch.tensor(
            qx_reexpand - MIN_VARIATIONAL_VAR, dtype=raw.dtype,
            device=raw.device))
        params["raw_qx_var"] = torch.maximum(raw, floor)
    views = []
    for vp in params["views"]:
        u_mean = vp["u_mean"]
        var_new = torch.tensor(reset_variance, dtype=u_mean.dtype,
                               device=u_mean.device)
        scale = torch.sqrt(positive(vp["raw_variance"]) / var_new)
        views.append({
            **vp,
            "raw_variance": positive_inverse(var_new),
            "raw_noise": positive_inverse(torch.tensor(
                reset_noise, dtype=u_mean.dtype, device=u_mean.device)),
            "u_mean": u_mean * scale.to(u_mean.dtype),
        })
    return {**params, "views": views}


def _as_parameters(params):
    return {k: ([{kk: nn.Parameter(vv.detach().clone())
                  for kk, vv in view.items()} for view in v]
                if k == "views" else nn.Parameter(v.detach().clone()))
            for k, v in params.items()}


def staged_mrd_svi(
    key,
    key_run,
    Ys,
    config: mrd_svi.Config,
    n_total: int,
    *,
    steps: int,
    chunk: int,
    lr: float,
    drive: Callable,
    mesh=None,
    ckpt_dir: str | None = None,
    resume: bool = False,
    hot_lr: float = 2e-2,
    phase_a_frac: float = 2.0 / 3.0,
    reset_variance: float = 0.4,
    reset_noise: float = 0.25,
    rho: float = 0.2,
    log: Callable[[str], None] = lambda s: print(s, flush=True),
):
    """Run the two-phase schedule on the resident views Ys. `key` draws
    the init, `key_run` splits into the phases' minibatch keys (keys of
    `core/prng.py`). Returns (state, optimizer, info): phase B's
    `TrainState` and optimizer, and the phases' step counts, the recipe,
    `hot_lr`, `reset_variance`, `reset_noise`, `per_step` (phase B's
    seconds a step), `seconds` and, on a resume, `resumed_from`.

    `drive(step_fn, state, n_steps, key, Ys, label=...)` runs n_steps of a
    `mrd_svi.make_svi_natgrad_step` step from `state` (step t drawing its
    rows from fold_in(key, t) in the runner's drive) and returns (state,
    seconds a step, wall seconds), as for `dp_recipe.staged_dp_svi`.

    `mesh`: the parameters are placed after the init, or after a phase-A
    resume loads them (`parallel.recipe.place_svi("mrd_svi", ...)`: every
    leaf whole), and both phases step on the mesh, each rank its block of
    every batch. The phase-A boundary is gathered before it is
    written."""
    p = plan(steps, chunk, phase_a_frac)
    sa, sb = p["phase_a_steps"], p["phase_b_steps"]
    info: dict = {"phase_a_steps": sa, "phase_b_steps": sb,
                  "recipe": RECIPE, "hot_lr": hot_lr,
                  "reset_variance": reset_variance,
                  "reset_noise": reset_noise}
    resume_b = resume and ckpt_dir is not None and os.path.exists(
        _path(ckpt_dir))
    # the split is drawn whether or not phase A runs: a resume reads the
    # same phase-B key
    _, ra, rb = prng.split(key_run, 3)
    seconds_a = 0.0
    def placed(params):
        """(the rank's parameters, their table; None without a mesh)."""
        if mesh is None:
            return params, None
        params, _, table = place_svi("mrd_svi", params, tuple(Ys), mesh)
        return params, table

    if not resume_b:
        params, table = placed(mrd_svi.init_params(key, list(Ys), config))
        opt_a = gp_optimizer(params, lr=hot_lr, hyper_lr=hot_lr / 10.0,
                             decay_steps=sa, hyper_warmup=max(1, sa // 10),
                             mesh=mesh, placement=table)
        step_a = mrd_svi.make_svi_natgrad_step(config, n_total, opt_a,
                                               rho=rho, mesh=mesh)
        _, _, seconds_a = drive(step_a, TrainState(opt_a), sa, ra, tuple(Ys),
                                label="[phaseA hot] ")
        _save_boundary(ckpt_dir, params, mesh, table)
    else:
        info["resumed_from"] = PHASE_A
        log(f"  [resume] phaseA checkpoint found in {ckpt_dir}")
        params, table = placed(_load_boundary(ckpt_dir, Ys[0].device))

    tb = time.perf_counter()
    with torch.no_grad():
        ard = mrd_svi.ard_relevance(params).cpu().numpy()
    log(f"  [phaseB] boundary relevance {np.round(ard, 3).tolist()}; "
        f"freezing raw_ard+raw_variance, reset sigma_f^2={reset_variance} "
        f"noise={reset_noise}")
    params = _as_parameters(recalibrated(params, reset_variance,
                                         reset_noise))
    opt_b = gp_optimizer(params, lr=lr, decay_steps=sb,
                         freeze=FROZEN_STRUCTURE, mesh=mesh, placement=table)
    step_b = mrd_svi.make_svi_natgrad_step(config, n_total, opt_b, rho=rho,
                                           mesh=mesh)
    state, per_step, _ = drive(step_b, TrainState(opt_b), sb, rb, tuple(Ys),
                               label="[phaseB recal] ")
    info["per_step"] = per_step
    info["seconds"] = seconds_a + (time.perf_counter() - tb)
    return state, opt_b, info
