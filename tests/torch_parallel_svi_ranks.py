"""The rank side of `tests/test_torch_parallel_svi.py`: what each of the
gloo ranks computes with the port's mesh for the minibatch families
(`dp_gp_lvm_tpu_torch.parallel`, the SVI-GPLVM, its amortized q(X), the
MRD-SVI and the DP-SVI).

The ranks are started by `torch.multiprocessing` with the spawn method,
which imports this module in every rank, so it imports torch and the port
only: no JAX. `main` runs every case on the inputs the test wrote
(`torch.save`: the reference's data, initial parameters and minibatch
indices, float64) and saves each rank's results to `<out>/rank<r>.pt`; the
test compares them with the JAX package's single-device oracles and with
the port's own single-device steps, which each rank also takes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.config import CONFIGS
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.models import dp_svi, mrd_svi, svi_gplvm
from dp_gp_lvm_tpu_torch.parallel import auto, collectives, recipe
from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
from dp_gp_lvm_tpu_torch.parallel import sharded_elbo as se
from dp_gp_lvm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DATA_SHARDED,
    MODEL_AXIS,
    REPLICATED,
)
from dp_gp_lvm_tpu_torch.train import dp_recipe, loop, mrd_recipe
from dp_gp_lvm_tpu_torch.train.checkpoint import Checkpointer

WORLD = 4
MESHES = ((4, 1), (2, 2))
STEPS = 3                     # the reference's mesh step cases take 3
# the reference's test configs (tests/test_svi.py, test_amortized.py,
# test_mrd_svi.py, test_parallel.py, test_stream.py, test_dp_recipe.py)
SVI = svi_gplvm.Config(num_latent=2, num_inducing=8, batch=16)
AMORTIZED = SVI._replace(amortized=True, encoder_hidden=16)
MRD = mrd_svi.Config(num_latent=3, num_inducing=8, num_views=2, batch=16)
DP = dp_svi.Config(num_latent=3, num_inducing=8, truncation=4, batch=16)
DP_FLOOR = DP._replace(noise_floor=0.05)
DP_HP_ALPHA = DP._replace(hyperprior_std=1.0, learn_alpha=True)
SVI_STEPS = svi_gplvm.Config(num_latent=3, num_inducing=8, batch=16)
DP_AMORTIZED = dp_svi.Config(num_latent=2, num_inducing=8, truncation=2,
                             batch=16, amortized=True, encoder_hidden=8)
DP_STREAM = dp_svi.Config(num_latent=2, num_inducing=8, truncation=2,
                          batch=8)
MRD_AMORTIZED = MRD._replace(amortized=True, encoder_hidden=8,
                             view_dims=(5, 7))
RECIPE = dp_svi.Config(num_latent=2, num_inducing=8, truncation=4, batch=16)
C6 = CONFIGS["c6_svi_bigN"]


def _flat(tree):
    return {k: v.detach().clone() for k, v in loop.flat_leaves(tree).items()}


def _value_and_grads(loss_fn, params, table, mesh):
    """(ELBO, the full gradient of the loss, flat) of a sharded loss over
    the rank's `params`: the gradient reduced across ranks and
    gathered."""
    leaves = loop.flat_leaves(params)
    loss = loss_fn(params)
    flat_table = loop.flat_leaves(table)
    grads = collectives.reduce_grads(
        dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))),
        flat_table, mesh)
    return -loss.detach(), auto.gather(grads, flat_table, mesh)


def _sharded_value(model, fn, params, data, idx, n, cfg):
    """fn's value and gradient on each of MESHES (the DP-SVI's on 2 x 2
    and 4 x 1, whose model axes cut its atoms), from the reference's full
    parameters: the batch rows `idx` of `data`, cut over "data"."""
    out = {}
    for d, m in MESHES:
        mesh = mesh_lib.make_mesh(d, m, "cpu")
        p, _, table = recipe.place_svi(model, params_from_jax(params, "cpu"),
                                       (), mesh)
        block = auto.shard(idx, DATA_SHARDED, mesh, "batch")
        ys = ([y[block] for y in data] if model == "mrd_svi"
              else data[block])
        out[f"{d}x{m}"] = _value_and_grads(
            lambda q: -fn(q, ys, block, n, cfg, mesh), p, table, mesh)
    return out


def case_values(inp):
    """The sharded bounds and gradients at the reference's batches: the
    SVI-GPLVM (test_svi.py), the amortized one (test_amortized.py), the
    MRD-SVI (test_mrd_svi.py), the DP-SVI with and without a noise floor
    that binds (test_parallel.py), and with the hyperprior (summed over
    "model") and a learned alpha."""
    idx32, idx16 = torch.arange(32), torch.arange(16)
    return {
        "svi": _sharded_value("svi_gplvm", se.svi_elbo_sharded,
                              inp["svi_params"], inp["svi_y"], idx32, 64,
                              SVI),
        "amortized": _sharded_value(
            "svi_gplvm", se.svi_elbo_sharded, inp["amortized_params"],
            inp["svi_y"], idx32, 64, AMORTIZED),
        "mrd_svi": _sharded_value(
            "mrd_svi", se.mrd_svi_elbo_sharded, inp["mrd_params"],
            [inp["view1"], inp["view2"]], idx32, 48, MRD),
        "dp_svi": _sharded_value("dp_svi", se.dp_svi_elbo_sharded,
                                 inp["dp_params"], inp["toy"], idx16, 48,
                                 DP),
        "dp_svi_floor": _sharded_value(
            "dp_svi", se.dp_svi_elbo_sharded, inp["dp_floor_params"],
            inp["toy"], idx16, 48, DP_FLOOR),
        "dp_svi_hp_alpha": _sharded_value(
            "dp_svi", se.dp_svi_elbo_sharded, inp["dp_hp_alpha_params"],
            inp["toy"], idx16, 48, DP_HP_ALPHA),
    }


def _run_steps(model, make_step, params, data, idx, mesh=None, lr=1e-2,
               ngd_lr=None):
    """len(idx) steps from the reference's `params` on the resident
    `data`, on `mesh` or on one device: (losses, full flat parameters,
    this rank's whole leaves)."""
    p = params_from_jax(params, "cpu")
    table = None
    if mesh is not None:
        p, _, table = recipe.place_svi(model, p, (), mesh)
    opt = loop.gp_optimizer(p, lr=lr, ngd_lr=ngd_lr, mesh=mesh,
                            placement=table)
    step = make_step(opt, mesh)
    losses = torch.stack([step(t, i, data) for t, i in enumerate(idx)])
    if mesh is None:
        return losses, _flat(opt.params), {}
    flat_table = loop.flat_leaves(table)
    whole = {k: v.detach().clone() for k, v in opt.params.items()
             if flat_table[k] is REPLICATED}
    return losses, auto.gather(opt.params, flat_table, mesh), whole


def _steps_both(model, make_step, params, data, idx, meshes, **kw):
    """The steps on each mesh and on one device."""
    out = {"single": _run_steps(model, make_step, params, data, idx, **kw)}
    for d, m in meshes:
        out[f"{d}x{m}"] = _run_steps(model, make_step, params, data, idx,
                                     mesh_lib.make_mesh(d, m, "cpu"), **kw)
    return out


def case_steps(inp):
    """STEPS natural-gradient steps on the mesh and on one device, at the
    reference's minibatches: the DP-SVI (test_parallel.py, its gradient
    phi and the "cavi" phi that reads every atom's free energies), the
    SVI-GPLVM (test_parallel.py), the MRD-SVI (test_mrd_svi.py, one step)
    and the amortized DP-SVI (test_amortized.py)."""
    return {
        "dp_svi": _steps_both(
            "dp_svi", lambda opt, mesh: dp_svi.make_dp_svi_step(
                DP, 48, opt, rho=0.5, mesh=mesh),
            inp["dp_init"], inp["toy"], inp["dp_step_idx"], MESHES,
            ngd_lr=1.0),
        "dp_svi_cavi": _steps_both(
            "dp_svi", lambda opt, mesh: dp_svi.make_dp_svi_step(
                DP, 48, opt, rho=0.5, phi_update="cavi", rho_phi=0.3,
                blend_at="updated", mesh=mesh),
            inp["dp_init"], inp["toy"], inp["dp_step_idx"], ((2, 2),),
            ngd_lr=1.0),
        "svi": _steps_both(
            "svi_gplvm", lambda opt, mesh: svi_gplvm.make_svi_natgrad_step(
                SVI_STEPS, 48, opt, rho=0.5, mesh=mesh),
            inp["svi_step_params"], inp["toy"], inp["svi_step_idx"],
            ((4, 1),), ngd_lr=1.0),
        "mrd_svi": _steps_both(
            "mrd_svi", lambda opt, mesh: mrd_svi.make_svi_natgrad_step(
                MRD, 48, opt, rho=0.3, mesh=mesh),
            inp["mrd_init"], [inp["view1"], inp["view2"]],
            torch.arange(16)[None], ((4, 1), (2, 2)), lr=2e-2),
        "dp_amortized": _steps_both(
            "dp_svi", lambda opt, mesh: dp_svi.make_dp_svi_step(
                DP_AMORTIZED, 40, opt, rho=0.5, mesh=mesh),
            inp["dp_amortized_params"], inp["grouped40"],
            torch.arange(16)[None].expand(STEPS, 16), ((2, 2),)),
    }


def _streamed_and_resident(model, make_step, params, data, idx, rows, mesh):
    """One step on `mesh` resident (rows gathered from `data` by idx) and
    one streamed (the host's (idx, rows) pair) from the same parameters:
    (loss, gathered flat parameters) of each."""
    out = {}
    for streaming in (False, True):
        p, _, table = recipe.place_svi(
            model, params_from_jax(params, "cpu"), (), mesh)
        opt = loop.gp_optimizer(p, lr=1e-2, mesh=mesh, placement=table)
        step = make_step(opt, mesh, streaming)
        loss = step(0, (idx, rows)) if streaming else step(0, idx, data)
        out["streamed" if streaming else "resident"] = (
            loss, auto.gather(opt.params, loop.flat_leaves(table), mesh))
    return out


def case_stream(inp):
    """The host-fed step on the mesh against the resident mesh step at
    equal rows: the DP-SVI (test_stream.py), the amortized DP-SVI
    (test_amortized.py) and the amortized MRD-SVI (test_mrd_svi.py)."""
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    idx8 = torch.tensor([7, 7, 2, 95, 40, 1, 64, 9])
    idx8b = torch.tensor([7, 7, 2, 31, 20, 1, 14, 9])
    idx16 = torch.tensor([7, 7, 2, 31, 20, 1, 14, 9, 3, 40, 11, 5, 28, 33,
                          0, 19])
    views = [inp["view1"], inp["view2"]]
    return {
        "dp_svi": _streamed_and_resident(
            "dp_svi", lambda opt, mesh, s: dp_svi.make_dp_svi_step(
                DP_STREAM, 96, opt, rho=0.3, mesh=mesh, streaming=s),
            inp["stream_params"], inp["stream_y"], idx8,
            inp["stream_y"][idx8], mesh),
        "dp_amortized": _streamed_and_resident(
            "dp_svi", lambda opt, mesh, s: dp_svi.make_dp_svi_step(
                DP_AMORTIZED._replace(batch=8), 40, opt, rho=0.3, mesh=mesh,
                streaming=s),
            inp["dp_amortized_params"], inp["grouped40"], idx8b,
            inp["grouped40"][idx8b], mesh),
        "mrd_amortized": _streamed_and_resident(
            "mrd_svi", lambda opt, mesh, s: mrd_svi.make_svi_natgrad_step(
                MRD_AMORTIZED, 48, opt, rho=0.3, mesh=mesh, streaming=s),
            inp["mrd_amortized_params"], views, idx16,
            torch.cat([y[idx16] for y in views], dim=1), mesh),
    }


def _recipe_drive(step_fn, state, n_steps, key, Y, label=""):
    """The port's recipe drive of its tests: step i on the i-th key of
    split(key, n_steps), every rank the same full batch."""
    idx = step_fn.indices(prng.split(key, n_steps))
    losses = torch.stack([step_fn(state.step + i, idx[i], Y)
                          for i in range(n_steps)])
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}loss not finite")
    state.step += n_steps
    return state, float("nan"), 0.0


def case_recipe(inp):
    """The staged recipe (test_dp_recipe.py's mesh case, T = 4) on 2 x 2
    and on one device: the final ELBO over every row and the gathered
    parameters; and the mesh run's boundaries, which hold the full
    parameters."""
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(3), n=64,
                                     dims_per_group=(4, 4), q=2, noise=0.01,
                                     dtype=torch.float64, device="cpu")
    out = {}
    for name, mesh in (("single", None),
                       ("2x2", mesh_lib.make_mesh(2, 2, "cpu"))):
        state, _, _ = dp_recipe.staged_dp_svi(
            prng.PRNGKey(1), prng.PRNGKey(101), Y, RECIPE, Y.shape[0],
            steps=20, chunk=5, lr=1e-2, ngd_lr=None, drive=_recipe_drive,
            mesh=mesh, log=lambda s: None,
            # every rank runs the single-device recipe: it writes nothing
            ckpt_dir=(None if mesh is None
                      else os.path.join(inp["out"], "stages")))
        params = state.params
        if mesh is not None:
            params = auto.gather(params, auto.dp_svi_shardings(params)[0],
                                 mesh)
        with torch.no_grad():
            out[name] = {"elbo": dp_svi.elbo(params, Y, RECIPE),
                         "params": _flat(params)}
    with np.load(os.path.join(inp["out"], "stages",
                              dp_recipe.STAGE_ASSIGN + ".npz")) as f:
        out["boundary_atoms"] = f["u_h"].shape[0]
    return out


def case_mrd_recipe(inp):
    """The staged MRD-SVI recipe (phase A hot, phase B recalibrating;
    MRD's test config, 12 steps in chunks of 4) on 2 x 2 and on one
    device, from the reference's data: the final parameters (every leaf
    whole), and the mesh run's phase-A boundary, gathered before it was
    written, against the single-device run's."""
    Ys = (inp["view1"], inp["view2"])
    out = {}
    for name, mesh in (("single", None),
                       ("2x2", mesh_lib.make_mesh(2, 2, "cpu"))):
        state, _, _ = mrd_recipe.staged_mrd_svi(
            prng.PRNGKey(2), prng.PRNGKey(100), Ys, MRD, 48, steps=12,
            chunk=4, lr=1e-2, drive=_recipe_drive, mesh=mesh,
            log=lambda s: None,
            ckpt_dir=os.path.join(inp["out"], f"mrd_stages_{name}")
            if mesh is not None or dist.get_rank() == 0 else None)
        out[name] = _flat(state.params)
    for name in ("single", "2x2"):
        if name == "single" and dist.get_rank() != 0:
            continue
        with np.load(os.path.join(inp["out"], f"mrd_stages_{name}",
                                  mrd_recipe.PHASE_A + ".npz")) as f:
            out[f"boundary_{name}"] = {k: torch.from_numpy(f[k])
                                       for k in f.files}
    return out


def _dp_opt_and_step(params, mesh):
    p, _, table = recipe.place_svi("dp_svi", params_from_jax(params, "cpu"),
                                   (), mesh)
    opt = loop.gp_optimizer(p, lr=1e-2, ngd_lr=1.0, mesh=mesh,
                            placement=table)
    return opt, dp_svi.make_dp_svi_step(DP, 48, opt, rho=0.5,
                                        phi_update="cavi", mesh=mesh)


def case_checkpoint(inp):
    """A DP-SVI state on 2 x 2 (its atoms and Adam moments cut over
    "model"): saved after two steps (gathered, rank 0 writes), restored
    into a fresh optimizer (cut by the table again); and a resume from
    that checkpoint, whose next two steps must end on the bits of the
    straight run's."""
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    Y, idx = inp["toy"], inp["dp_step_idx"]
    ck = Checkpointer(os.path.join(inp["out"], "ckpt"))
    opt, step = _dp_opt_and_step(inp["dp_init"], mesh)
    state = loop.TrainState(opt)
    for t in range(2):
        step(t, idx[t], Y)
    state.step = 2
    ck.save(state)
    saved = {k: {n: v.clone() for n, v in opt.state_dict()[k].items()}
             for k in ("params", "mu", "nu")}
    for t in range(2, 4):
        step(t, idx[t % STEPS], Y)
    straight = {k: v.detach().clone() for k, v in opt.params.items()}

    opt2, step2 = _dp_opt_and_step(inp["dp_init"], mesh)
    state2 = ck.restore(loop.TrainState(opt2))
    restored_equal = all(torch.equal(saved[k][n], opt2.state_dict()[k][n])
                         for k in saved for n in saved[k])
    for t in range(state2.step, 4):
        step2(t, idx[t % STEPS], Y)
    blob = torch.load(os.path.join(inp["out"], "ckpt", "ckpt_2.pt"),
                      weights_only=True)
    return {
        "restored_step": state2.step,
        "restored_equal": restored_equal,
        "file_shapes": {k: tuple(v.shape) for k, v in blob["mu"].items()},
        "local_shapes": {k: tuple(v.shape) for k, v in opt.mu.items()},
        "resumed_equal": all(torch.equal(straight[k], opt2.params[k])
                             for k in straight),
    }


def case_gather_order(inp):
    """all_gather over each axis of 2 x 2: the blocks in coordinate
    order."""
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    mine = torch.tensor([[float(mesh.coordinate(DATA_AXIS)),
                          float(mesh.coordinate(MODEL_AXIS))]])
    return {axis: collectives.all_gather(mine, mesh, axis)
            for axis in (DATA_AXIS, MODEL_AXIS)}


def case_refusals(inp):
    """The messages the mesh gives: a batch that does not cut over "data"
    (the runner's c6 at batch 30 on 4 ranks), T = 6 atoms over a model
    axis of 4 (place_svi), a mesh step whose optimizer has no mesh."""
    out = {}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runner.run(dataclasses.replace(C6, n=64), steps=2, batch=30,
                       device="cpu", dtype=torch.float64, mesh="4")
        out["batch"] = "no error"
    except ValueError as err:
        out["batch"] = str(err)
    mesh = mesh_lib.make_mesh(1, 4, "cpu")
    params = params_from_jax(inp["dp_params"], "cpu")
    params = {k: (v.repeat_interleave(2, 0)[:6] if k in
                  auto.DP_SVI_ATOM_LEAVES else v) for k, v in params.items()}
    try:
        recipe.place_svi("dp_svi", params, (), mesh)
        out["atoms"] = "no error"
    except ValueError as err:
        out["atoms"] = str(err)
    mesh = mesh_lib.make_mesh(4, 1, "cpu")
    try:
        svi_gplvm.make_svi_natgrad_step(
            SVI, 64, loop.gp_optimizer(params_from_jax(inp["svi_params"],
                                                       "cpu")), mesh=mesh)
        out["optimizer"] = "no error"
    except ValueError as err:
        out["optimizer"] = str(err)
    try:
        recipe.place_svi("bgplvm", {}, (), mesh)
        out["family"] = "no error"
    except ValueError as err:
        out["family"] = str(err)
    return out


CASES = {"values": case_values, "steps": case_steps, "stream": case_stream,
         "recipe": case_recipe, "mrd_recipe": case_mrd_recipe,
         "checkpoint": case_checkpoint,
         "gather_order": case_gather_order, "refusals": case_refusals}


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """One rank: join the gloo group at the file store, wait for the
    inputs, run every case, save the results (a case that raises records
    its traceback)."""
    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = str(world)     # what torchrun would set
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        # the test writes the inputs while the ranks start
        while not os.path.exists(inputs):
            time.sleep(0.05)
        inp = torch.load(inputs)
        inp["out"] = out
        results = {}
        for name, case in CASES.items():
            try:
                results[name] = case(inp)
            except Exception:   # every rank records it; the test reports
                results[name] = {"error": traceback.format_exc()}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
