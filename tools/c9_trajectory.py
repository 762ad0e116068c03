#!/usr/bin/env python3
"""Hold c9_mrd_svi_bigN's float32 training on the card against float64.

    python3 tools/c9_trajectory.py trajectory [--n N] [--chunks K]
    python3 tools/c9_trajectory.py full [--seed S] [--dtype float64]
                                        [--draw float32] [--n N] [--steps K]

`trajectory`: from one float64 init (data and PCA drawn in float64, then
rounded for the float32 copy), phase A's step of the two-phase recipe
(`train/mrd_recipe.py`: the hot optimizer) runs on the same minibatches
twice: float32 through K1 and K2 (`use_fused="auto"`) and float64 on the
plain path (`use_fused=False`), at the same jitter. One JSON line per
chunk of 250 steps: both losses, the largest relative difference of each
group of leaves (scaled by the float64 leaf's largest magnitude), and
both runs' ARD relevance.

`full`: the whole gated schedule (24000 steps through the runner's
recipe and drive) at the given dtype and seed, float64 on the plain path,
then the gated ELBO and the cross-view metrics as the runner computes
them; one JSON line with the gates' verdicts. The data are drawn at
`--draw` (default: the run's dtype) and then cast: the reference's stream
draws float32 and float64 values from different bits, so the float32 run's
data (the gated run's) are another draw than the float64 run's of the
same seed. `--draw bf16` draws float32 with the two products of
`two_view_big` (X @ freq and features @ amplitudes) taken from operands
rounded to bfloat16 and accumulated in float32, as XLA's default matmul
precision computes float32 products on a TPU (the reference's artifact was
drawn there; the port's products are full float32): another dataset at
the percent level; it prints the largest difference from the port's
float32 draw first. The runner itself refuses
float64 on the card (its kernels take float32 only): this is the
precision check of its float32 run, not another way to train.

Runs on the card unless `--device cpu`; prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dp_gp_lvm_tpu_torch.core import config as config_lib  # noqa: E402
from dp_gp_lvm_tpu_torch.core import prng  # noqa: E402
from dp_gp_lvm_tpu_torch.core.types import (  # noqa: E402
    JitterPolicy,
    pin_full_f32,
)
from dp_gp_lvm_tpu_torch.experiments import run as runner  # noqa: E402
from dp_gp_lvm_tpu_torch.models import mrd_svi  # noqa: E402
from dp_gp_lvm_tpu_torch.train import mrd_recipe  # noqa: E402
from dp_gp_lvm_tpu_torch.train.loop import (  # noqa: E402
    flat_leaves,
    gp_optimizer,
)

GROUPS = ("qx_mean", "raw_qx_var", "z", "raw_ard", "raw_variance",
          "raw_noise", "u_mean", "raw_u_scale")


def _group_errors(p32, p64):
    """Per group of leaves, the largest |f32 - f64| over max |f64|."""
    out = {}
    for k, v in flat_leaves(p64).items():
        g = k.rsplit(".", 1)[-1]
        w = flat_leaves(p32)[k].detach().double()
        err = float((w - v.detach()).abs().max()
                    / v.detach().abs().max().clamp_min(1e-30))
        out[g] = max(out.get(g, 0.0), err)
    return {g: out[g] for g in GROUPS}


def trajectory(device, n: int, chunks: int, chunk: int, seed: int):
    cfg = dataclasses.replace(config_lib.get("c9_mrd_svi_bigN"), seed=seed)
    mcfg = runner._model_config(cfg, None)
    Y1, Y2, _ = mrd_svi_data(cfg, n, torch.float64, device)
    Ys64 = (Y1, Y2)
    Ys32 = tuple(y.float() for y in Ys64)
    p64 = mrd_svi.init_params(prng.PRNGKey(seed), Ys64, mcfg)
    p32 = mrd_recipe._as_parameters({k: ([{kk: vv.float() for kk, vv in
                                           view.items()} for view in v]
                                         if k == "views" else v.float())
                                     for k, v in p64.items()})
    same = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    steps = {}
    sa = mrd_recipe.plan(cfg.steps, chunk)["phase_a_steps"]
    for name, p, c in (("f32", p32, mcfg),
                       ("f64", p64, mcfg._replace(use_fused=False))):
        # phase A's optimizer, as `staged_mrd_svi` builds it
        opt = gp_optimizer(p, lr=2e-2, hyper_lr=2e-3, decay_steps=sa,
                           hyper_warmup=max(1, sa // 10))
        steps[name] = mrd_svi.make_svi_natgrad_step(c, n, opt, rho=0.2,
                                                    policy=same)
    _, ra, _ = prng.split(prng.PRNGKey(seed + 100), 3)
    for k in range(chunks):
        keys = prng.fold_in(ra, torch.arange(k * chunk, (k + 1) * chunk))
        idx = steps["f32"].indices(keys)
        t0 = time.perf_counter()
        l32 = torch.stack([steps["f32"](k * chunk + i, idx[i], Ys32)
                           for i in range(chunk)])
        l64 = torch.stack([steps["f64"](k * chunk + i, idx[i], Ys64)
                           for i in range(chunk)])
        with torch.no_grad():
            ard32 = mrd_svi.ard_relevance(p32).tolist()
            ard64 = mrd_svi.ard_relevance(p64).tolist()
        print(json.dumps(dict(
            chunk=k, steps=(k + 1) * chunk, n=n,
            loss_f32=float(l32[-1]), loss_f64=float(l64[-1]),
            loss_rel_diff=float(abs(l32[-1].double() - l64[-1])
                                / abs(l64[-1])),
            leaf_errors=_group_errors(p32, p64),
            ard_f32=ard32, ard_f64=ard64,
            seconds=time.perf_counter() - t0)), flush=True)


def mrd_svi_data(cfg, n, dtype, device):
    from dp_gp_lvm_tpu_torch.data.synthetic import two_view_big

    return two_view_big(prng.PRNGKey(cfg.seed), n=n, d1=cfg.views[0],
                        d2=cfg.views[1], q_shared=2, q_private=1,
                        private_weight=0.5, dtype=dtype, device=device)


@contextlib.contextmanager
def _bf16_products():
    """While the block runs, `a @ b` of float32 tensors multiplies their
    bfloat16 roundings and accumulates in float32."""
    original = torch.Tensor.__matmul__

    def matmul(a, b):
        if a.dtype == torch.float32:
            return original(a.bfloat16().float(), b.bfloat16().float())
        return original(a, b)

    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = original


def _draw(cfg, draw, device):
    """c9's views (n + 512 rows) drawn at `draw`: a dtype or "bf16"."""
    if draw != "bf16":
        return runner.load_data(cfg, draw, device)[0]
    with _bf16_products():
        Ys = runner.load_data(cfg, torch.float32, device)[0]
    port = runner.load_data(cfg, torch.float32, device)[0]
    print(json.dumps({"bf16_draw_max_abs_diff": [
        float((a - b).abs().max()) for a, b in zip(Ys, port)],
        "bf16_draw_rms_diff": [float((a - b).pow(2).mean().sqrt())
                               for a, b in zip(Ys, port)]}), flush=True)
    return Ys


def full(device, seed: int, dtype, n: int, steps: int, draw=None):
    """The gated schedule at `dtype` (float64: the plain path) through the
    runner's recipe and drive on data drawn at `draw` (None: `dtype`), then
    its metrics and gates."""
    cfg = dataclasses.replace(config_lib.get("c9_mrd_svi_bigN"), seed=seed,
                              n=n, steps=steps)
    Ys = tuple(y.to(dtype) for y in _draw(cfg, draw or dtype, device))
    Y_train = tuple(y[:cfg.n] for y in Ys)
    Ys_test = tuple(y[cfg.n:] for y in Ys)
    mcfg = runner._model_config(cfg, None)
    if dtype == torch.float64:
        mcfg = mcfg._replace(use_fused=False)
    logger = runner.JsonlLogger(None)
    t0 = time.perf_counter()
    trained, per_step, total, extra = runner._train_staged(
        cfg, Y_train, mcfg, cfg.steps, device=device, log_every=50,
        logger=logger, out=None, resume=False, inject_nonfinite_at=None)
    with torch.no_grad():
        result = {"config": cfg.name, "dtype": str(dtype), "seed": seed,
                  "draw": str(draw or dtype),
                  "seconds": time.perf_counter() - t0,
                  "ms_per_step": per_step * 1e3,
                  "elbo": float(mrd_svi.elbo(trained, list(Y_train), mcfg)),
                  **extra}
    result.update(runner._cross_view(trained, Y_train, Ys_test, mcfg,
                                      runner.MRD_SVI_PREDICT_STEPS))
    result["failures"] = config_lib.evaluate_checks(cfg.name, result)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("trajectory", "full"))
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--steps", type=int, default=24000,
                    help="full: the schedule's steps (the config's 24000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--draw", choices=("float32", "float64", "bf16"),
                    default=None,
                    help="full: the dtype the data are drawn at (default: "
                         "--dtype; bf16: float32 with bfloat16 products)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        pin_full_f32()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    if args.mode == "trajectory":
        trajectory(device, args.n, args.chunks, args.chunk, args.seed)
    else:
        full(device, args.seed, getattr(torch, args.dtype), args.n,
             args.steps, args.draw if args.draw in (None, "bf16")
             else getattr(torch, args.draw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
