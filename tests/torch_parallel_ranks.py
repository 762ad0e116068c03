"""The rank side of `tests/test_torch_parallel.py`: what each of the gloo
ranks computes with the port's mesh (`dp_gp_lvm_tpu_torch.parallel`).

The ranks are started by `torch.multiprocessing` with the spawn method,
which imports this module in every rank, so it imports torch and the port
only: no JAX. `main` runs every case on the inputs the test wrote
(`torch.save`: the reference's data and initial parameters, float64) and
saves each rank's results to `<out>/rank<r>.pt`; the test compares them
with the JAX package's single-device oracles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import traceback

import torch
import torch.distributed as dist

from dp_gp_lvm_tpu_torch.core.config import CONFIGS
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, mrd
from dp_gp_lvm_tpu_torch.parallel import auto, collectives, recipe
from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
from dp_gp_lvm_tpu_torch.parallel.mesh import DATA_AXIS, REPLICATED
from dp_gp_lvm_tpu_torch.train import loop

WORLD = 4
DP_MESHES = ((4, 1), (2, 2), (1, 4))
Q, M, T = 3, 8, 4
HP_BG, HP_DP = 0.7, 1.0
C4 = CONFIGS["c4_dp_mocap"]
OPT_STEPS = 5
CLIP = 1.0          # binds: the gradient's global norm at init is far above


def bg_config(hp=0.0):
    return bgplvm.Config(num_latent=Q, num_inducing=M, hyperprior_std=hp)


def dp_config(hp=0.0, learn_alpha=False, use_fused="auto"):
    return dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T,
                            hyperprior_std=hp, learn_alpha=learn_alpha,
                            use_fused=use_fused)


def mrd_config(hp=0.0, use_fused="auto"):
    return mrd.Config(num_latent=Q, num_inducing=M, num_views=2,
                      hyperprior_std=hp, use_fused=use_fused)


def dp_optimizer(params, **kw):
    """c4's optimizer over `params` for OPT_STEPS steps, with a clip that
    binds."""
    return loop.gp_optimizer(params, lr=C4.lr, ngd_lr=C4.ngd_lr,
                             decay_steps=OPT_STEPS, clip=CLIP, **kw)


def _value_and_grads(setup, mesh):
    """(ELBO, the full gradient of the loss) of a sharded setup, the
    gradient reduced across ranks and gathered, flat."""
    leaves = loop.flat_leaves(setup.params)
    loss = setup.loss_fn(setup.params, *setup.data)
    table = loop.flat_leaves(setup.placement)
    grads = collectives.reduce_grads(
        dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))),
        table, mesh)
    return -loss.detach(), auto.gather(grads, table, mesh)


def _setup(model, params, data, config, mesh):
    return recipe.sharded_setup(model, params_from_jax(params, "cpu"),
                                data, config, mesh)


def case_bgplvm(inp):
    mesh = mesh_lib.make_mesh(4, 1, "cpu")
    Y = (inp["toy"],)
    elbo, grads = _value_and_grads(
        _setup("bgplvm", inp["bg_params"], Y, bg_config(), mesh), mesh)
    elbo_hp, _ = _value_and_grads(
        _setup("bgplvm", inp["bg_params"], Y, bg_config(HP_BG), mesh), mesh)
    return {"elbo": elbo, "grads": grads, "elbo_hp": elbo_hp}


def case_dp(inp):
    out = {}
    for d, m in DP_MESHES:
        mesh = mesh_lib.make_mesh(d, m, "cpu")
        elbo, grads = _value_and_grads(
            _setup("dp_gp_lvm", inp["dp_params"], (inp["toy"],),
                   dp_config(), mesh), mesh)
        out[f"{d}x{m}"] = {"elbo": elbo, "grads": grads}
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    elbo, grads = _value_and_grads(
        _setup("dp_gp_lvm", inp["dp_alpha_params"], (inp["toy"],),
               dp_config(HP_DP, learn_alpha=True), mesh), mesh)
    out["hp_alpha"] = {"elbo": elbo, "grads": grads}
    # the fused ops inside the mesh program (their plain versions on the
    # CPU, the kernels' pullbacks as the card runs them)
    elbo, grads = _value_and_grads(
        _setup("dp_gp_lvm", inp["dp_params"], (inp["toy"],),
               dp_config(use_fused=True), mesh), mesh)
    out["fused"] = {"elbo": elbo, "grads": grads}
    return out


def case_mrd(inp):
    mesh = mesh_lib.make_mesh(4, 1, "cpu")
    Ys = (inp["view1"], inp["view2"])
    elbo, grads = _value_and_grads(
        _setup("mrd", inp["mrd_params"], Ys, mrd_config(), mesh), mesh)
    elbo_hp, _ = _value_and_grads(
        _setup("mrd", inp["mrd_params"], Ys, mrd_config(HP_BG), mesh), mesh)
    elbo_fused, grads_fused = _value_and_grads(
        _setup("mrd", inp["mrd_params"], Ys, mrd_config(use_fused=True),
               mesh), mesh)
    return {"elbo": elbo, "grads": grads, "elbo_hp": elbo_hp,
            "fused": {"elbo": elbo_fused, "grads": grads_fused}}


def case_roundtrip(inp):
    """place, then gather: the largest difference from the full tree, and
    whether the local shards have the shape the mesh gives them."""
    out = {}
    for model, key, (tab, _), (d, m) in (
            ("bgplvm", "bg_params", auto.bgplvm_shardings(), (4, 1)),
            ("dp_gp_lvm", "dp_params", auto.dp_shardings(), (2, 2)),
            ("mrd", "mrd_params", auto.mrd_shardings(2), (4, 1))):
        mesh = mesh_lib.make_mesh(d, m, "cpu")
        full = params_from_jax(inp[key], "cpu")
        local = auto.place(full, tab, mesh)
        back = loop.flat_leaves(auto.gather(local, tab, mesh))
        full = loop.flat_leaves(full)
        out[model] = {
            "max_diff": max(float((back[k] - full[k].detach()).abs().max())
                            for k in full),
            "local_rows": loop.flat_leaves(local)["qx_mean"].shape[0],
            "is_leaf": all(v.is_leaf and v.requires_grad
                           for v in loop.flat_leaves(local).values()),
        }
    return out


def case_steps(inp):
    """OPT_STEPS of c4's optimizer on a 2 x 2 mesh: the gathered params,
    the logical gradient norm of each step, and this rank's whole leaves
    (every rank must hold the same bits)."""
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    setup = _setup("dp_gp_lvm", inp["dp_params"], (inp["toy"],),
                   dp_config(), mesh)
    opt = dp_optimizer(setup.params, mesh=mesh, placement=setup.placement)
    step = loop.make_step_fn(lambda _, *d: setup.loss_fn(setup.params, *d),
                             opt)
    norms = [step(*setup.data)["grad_norm"] for _ in range(OPT_STEPS)]
    table = loop.flat_leaves(setup.placement)
    return {
        "params": auto.gather(opt.params, table, mesh),
        "grad_norms": torch.stack(norms),
        "whole": {k: v.detach().clone() for k, v in opt.params.items()
                  if table[k] is REPLICATED},
    }


def case_skip(inp):
    """A NaN in one rank's gradient of its q(X) rows: every rank must skip
    the step and keep every parameter."""
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    setup = _setup("dp_gp_lvm", inp["dp_params"], (inp["toy"],),
                   dp_config(), mesh)
    opt = dp_optimizer(setup.params, mesh=mesh, placement=setup.placement)
    keys = list(opt.params)
    loss = setup.loss_fn(setup.params, *setup.data)
    grads = opt.reduce(dict(zip(keys, torch.autograd.grad(
        loss, [opt.params[k] for k in keys]))))
    if mesh.rank == WORLD - 1:
        grads["qx_mean"] = grads["qx_mean"].clone()
        grads["qx_mean"][0, 0] = float("nan")
    before = {k: v.detach().clone() for k, v in opt.params.items()}
    applied = opt.step(grads)
    return {"applied": bool(applied),
            "unchanged": all(torch.equal(before[k], opt.params[k])
                             for k in keys)}


def case_psum_rule(inp):
    """loss = (sum over the ranks of theta * y_r)^2, theta whole: the
    rank's share of the gradient before the reduction and the gradient
    after it."""
    mesh = mesh_lib.make_mesh(4, 1, "cpu")
    theta = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    y = torch.tensor(float(mesh.rank + 1), dtype=torch.float64)
    total = collectives.psum(theta * y, mesh, DATA_AXIS)
    loss = collectives.share(total ** 2, mesh)
    (g,) = torch.autograd.grad(loss, [theta])
    reduced = collectives.reduce_grads({"theta": g}, {"theta": REPLICATED},
                                       mesh)["theta"]
    return {"loss": loss.detach(), "share": g, "grad": reduced}


def case_runner_uneven(inp):
    """The runner on a mesh whose axes do not divide the rows (c4 at
    n = 63 on 2 x 2) or the atoms (T = 6 on 1 x 4): the message each
    raises."""
    out = {}
    for name, cfg, spec in (
            ("rows", dataclasses.replace(C4, n=63), "2,2"),
            ("atoms", dataclasses.replace(C4, n=64, t=6), "1,4")):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                runner.run(cfg, steps=1, device="cpu", dtype=torch.float64,
                           mesh=spec)
            out[name] = "no error"
        except ValueError as err:
            out[name] = str(err)
    return out


CASES = {"bgplvm": case_bgplvm, "dp": case_dp, "mrd": case_mrd,
         "roundtrip": case_roundtrip,
         "steps": case_steps, "skip": case_skip,
         "psum_rule": case_psum_rule, "runner_uneven": case_runner_uneven}


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """One rank: join the gloo group at the file store, run every case,
    save the results (a case that raises records its traceback)."""
    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = str(world)     # what torchrun would set
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(inputs)
        results = {}
        for name, case in CASES.items():
            try:
                results[name] = case(inp)
            except Exception:   # every rank records it; the test reports
                results[name] = {"error": traceback.format_exc()}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
