"""Run a named config end to end on the full-batch path (counterpart of
`experiments/run.py` for the Bayesian GP-LVM and the DP-GP-LVM): data ->
init -> chunked training with restarts -> metrics, a JSONL log, a
`result.json`, and the committed regression gates with `--check`.

    python -m dp_gp_lvm_tpu_torch.experiments.run c4_dp_mocap --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c5_dp_missing \\
        --device cpu --f64 --n 128 --steps 40

It runs f32 on the card unless `--device cpu` is given. `--f64` is the
CPU parity mode: the CUDA kernels take float32 only, so it is refused on
the card. Data and initial parameters are drawn from CPU
`torch.Generator`s seeded from the config, so a draw does not depend on
the device; it is not the reference's `jax.random` draw.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.core import config as config_lib
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.core.types import pin_full_f32, resolve_device
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, prediction
from dp_gp_lvm_tpu_torch.train.logging import JsonlLogger
from dp_gp_lvm_tpu_torch.train.loop import (
    gp_optimizer,
    make_multi_step_fn,
    make_step_fn,
    time_steps,
)

ROOT = pathlib.Path(__file__).resolve().parents[2]
MODELS = {"bgplvm": bgplvm, "dp_gp_lvm": dp_gp_lvm}


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def load_data(cfg, dtype, device):
    """(Y, source tag) of the config's dataset. The oil-flow surrogate is
    drawn from seed 0 whatever the config's seed, and at its fixed
    1000 x 12, as the reference's loader does without a data directory."""
    kw = dict(dtype=dtype, device=device)
    if cfg.dataset == "toy_gplvm":
        Y, _ = synthetic.toy_gplvm(_generator(cfg.seed), n=cfg.n, d=cfg.d,
                                   q_true=2, q_total=cfg.q, **kw)
        return Y, "toy_gplvm"
    if cfg.dataset == "oil_flow":
        Y, _, _ = synthetic.oil_flow_like(_generator(0), n=1000, d=12, **kw)
        return Y, "synthetic:oil_flow_like"
    if cfg.dataset == "pose":
        Y, _, _ = synthetic.pose_like(_generator(cfg.seed), n=cfg.n, **kw)
        return Y, "synthetic:pose_like"
    if cfg.dataset == "mocap":
        Y, _ = synthetic.mocap_like(_generator(cfg.seed), n=cfg.n, d=cfg.d,
                                    **kw)
        return Y, "synthetic:mocap_like"
    raise ValueError(f"dataset {cfg.dataset!r} is not ported")


def holdout_split(Y):
    """The missing-data protocol: every 8th row is held out (interpolation,
    not extrapolation), and both splits are standardized with the train
    split's statistics only (numpy, ddof 0, + 1e-8). numpy in, numpy out:
    (Y_train, Y_test)."""
    Y_all = np.asarray(Y)
    keep = np.ones(Y_all.shape[0], bool)
    keep[7::8] = False
    Y_train, Y_test = Y_all[keep], Y_all[~keep]
    mu = Y_train.mean(axis=0)
    sd = Y_train.std(axis=0) + 1e-8
    return (Y_train - mu) / sd, (Y_test - mu) / sd


def ard_metrics(ard) -> dict:
    """The ARD-pruning gate's metrics: the toy generator drives Y with the
    first 2 latent dims only, so the learned ARD weights must rank those
    two first (recall) and stand well above the rest (separation)."""
    a = ard.detach().cpu().numpy()
    top2 = {int(i) for i in np.argsort(-a, kind="stable")[:2]}
    return {
        "ard_weights": [round(float(x), 6) for x in a],
        "ard_recall_top2": len(top2 & {0, 1}) / 2.0,
        "ard_separation_ratio": float(
            np.min(a[:2]) / np.maximum(np.max(a[2:]), 1e-12)),
    }


def _scalar_terms(terms) -> dict:
    return {k: float(v) for k, v in terms.items()
            if not torch.is_tensor(v) or v.ndim == 0}


def _impute(params, Y_train, Y_test, mcfg, missing_fraction) -> dict:
    """The missing-data metrics: the last `missing_fraction` of the dims
    of every held-out row are masked and imputed."""
    d = Y_test.shape[1]
    n_miss = int(d * missing_fraction)
    mask = torch.ones_like(Y_test)
    mask[:, -n_miss:] = 0.0
    t0 = time.perf_counter()
    mean, var, *_ = prediction.impute_dp(params, Y_train, mcfg, Y_test, mask,
                                         num_steps=200)
    if mean.is_cuda:
        torch.cuda.synchronize(mean.device)
    seconds = time.perf_counter() - t0
    miss = 1.0 - mask
    with torch.no_grad():
        mse = float(torch.sum(((mean - Y_test) ** 2) * miss) / torch.sum(miss))
        pll = float(prediction.gaussian_predictive_loglik(
            Y_test, mean, var, miss) / torch.sum(miss))
        mean_var = float(torch.sum(var * miss) / torch.sum(miss))
    return {
        "imputation_mse": mse,
        "predictive_loglik_per_dim": pll,
        "calibration_ratio": mse / mean_var,
        "imputation_seconds": round(seconds, 3),
        "imputation_rows": int(Y_test.shape[0]),
    }


def run(cfg, *, steps: int | None = None, device=None,
        dtype=torch.float32, data=None, params=None, out=None,
        log_every: int = 50, hyper_lr: float | None = None,
        ngd_lr: float | None = None) -> dict:
    """Train `cfg` and return its result dict (the reference's keys).

    `data` replaces the config's dataset (Y before any holdout) and
    `params` the first restart's initial parameters, both as numpy (for
    example the JAX package's, to hold the two packages together). With
    `out`, `train.jsonl` and `result.json` are written there."""
    device = resolve_device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the CUDA kernels take float32 only; --f64 is the "
                         "CPU parity mode (--device cpu)")
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r} is not ported to the runner")
    if device.type == "cuda":
        pin_full_f32()
    steps = steps or cfg.steps
    model = MODELS[cfg.model]
    if out is not None:
        os.makedirs(out, exist_ok=True)
    logger = JsonlLogger(os.path.join(out, "train.jsonl") if out else None)

    if data is None:
        Y, tag = load_data(cfg, dtype, device)
    else:
        Y, tag = torch.tensor(np.asarray(data), dtype=dtype,
                              device=device), f"given:{cfg.dataset}"
    if cfg.model == "bgplvm":
        mcfg = bgplvm.Config(num_latent=cfg.q, num_inducing=cfg.m,
                             psi2_block=cfg.psi2_block)
    else:
        mcfg = dp_gp_lvm.Config(num_latent=cfg.q, num_inducing=cfg.m,
                                truncation=cfg.t, alpha=cfg.alpha,
                                psi2_block=cfg.psi2_block)
    imputing = cfg.model == "dp_gp_lvm" and cfg.missing_fraction > 0
    if imputing:
        Y_train, Y_test = (torch.as_tensor(y, dtype=dtype, device=device)
                           for y in holdout_split(Y.cpu().numpy()))
    else:
        Y_train = Y

    def init(r):
        if r == 0 and params is not None:
            return params_from_jax(params, device, dtype)
        return model.init_params(_generator(cfg.seed + r), Y_train, mcfg)

    def loss_fn(p, y):
        return model.loss(p, y, mcfg)

    print(f"[{cfg.name}] data={tag} model={cfg.model} steps={steps} "
          f"device={device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)
    ngd_lr = cfg.ngd_lr if ngd_lr is None else ngd_lr
    # one host read per chunk; the reference's loop runs whole chunks, so
    # it runs past `steps` where the chunk does not divide it
    chunk = max(1, min(log_every, steps))

    def train_from(p0, label):
        opt = gp_optimizer(p0, lr=cfg.lr, hyper_lr=hyper_lr,
                           ard_lr=cfg.ard_lr, decay_steps=steps,
                           ngd_lr=ngd_lr)
        multi_step = make_multi_step_fn(loss_fn, opt, chunk)
        done = 0
        while done < steps:
            losses = multi_step(Y_train)
            done += chunk
            elbo_now = -float(losses[-1])
            logger.log(done - 1, elbo=elbo_now)
            print(f"  step {done - 1}{label}: elbo={elbo_now:.3f}",
                  flush=True)
        return opt, elbo_now

    # non-convex models train from cfg.restarts init seeds; the best final
    # ELBO is kept
    t0 = time.perf_counter()
    opt, best_elbo = train_from(init(0), " [r0]" if cfg.restarts > 1 else "")
    restart_elbos = [best_elbo]
    for r in range(1, cfg.restarts):
        opt_r, elbo_r = train_from(init(r), f" [r{r}]")
        restart_elbos.append(elbo_r)
        if elbo_r > best_elbo:
            opt, best_elbo = opt_r, elbo_r
    total = time.perf_counter() - t0
    per_step = time_steps(make_step_fn(loss_fn, opt), (Y_train,), 10)
    print(f"[{cfg.name}] done in {total:.1f}s; {per_step * 1e3:.2f} ms/step",
          flush=True)
    logger.close()

    trained = opt.params
    with torch.no_grad():
        terms = _scalar_terms(model.elbo_terms(trained, Y_train, mcfg))
    result = {"config": cfg.name, "data": tag, "steps": steps,
              "seconds": round(total, 2),
              "ms_per_step": round(per_step * 1e3, 3), **terms}
    if cfg.restarts > 1:
        result["restart_elbos"] = [round(e, 3) for e in restart_elbos]
    if cfg.model == "bgplvm" and cfg.dataset == "toy_gplvm":
        result.update(ard_metrics(bgplvm.constrain(trained)["ard"]))
        print(f"[{cfg.name}] ard={result['ard_weights']} "
              f"recall={result['ard_recall_top2']} "
              f"sep={result['ard_separation_ratio']:.1f}", flush=True)
    if imputing:
        result.update(_impute(trained, Y_train, Y_test, mcfg,
                              cfg.missing_fraction))
        print(f"[{cfg.name}] imputation mse={result['imputation_mse']:.4f} "
              f"pll={result['predictive_loglik_per_dim']:.4f} "
              f"({result['imputation_seconds']:.2f}s for "
              f"{result['imputation_rows']} rows)", flush=True)
    if out is not None:
        with open(os.path.join(out, "result.json"), "w") as fh:
            json.dump(result, fh, indent=2)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="name from core/config.py")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="override config.lr")
    ap.add_argument("--hyper-lr", type=float, default=None,
                    help="override the kernel-hyper Adam rate (lr/10)")
    ap.add_argument("--ngd-lr", type=float, default=None,
                    help="override config.ngd_lr (natural-gradient rate "
                         "of the q(X) parameters)")
    ap.add_argument("--restarts", type=int, default=None,
                    help="override the config's restart count")
    ap.add_argument("--n", type=int, default=None,
                    help="override the config's data size")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the config's seed (its data and init "
                         "draws)")
    ap.add_argument("--out", default=None,
                    help="output directory (default build/runs/<config>)")
    ap.add_argument("--f64", action="store_true",
                    help="float64: the CPU parity mode")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu for the parity mode)")
    ap.add_argument("--check", action="store_true",
                    help="assert the regression gates (core/config.CHECKS) "
                         "on the finished run; exit 1 on any failure")
    args = ap.parse_args(argv)

    cfg = config_lib.get(args.config)
    overrides = {k: v for k, v in (("n", args.n), ("restarts", args.restarts),
                                   ("lr", args.lr)) if v}
    if args.seed is not None:
        overrides["seed"] = args.seed
    cfg = dataclasses.replace(cfg, **overrides)
    out = args.out or str(ROOT / "build" / "runs" / cfg.name)
    result = run(cfg, steps=args.steps, device=args.device,
                 dtype=torch.float64 if args.f64 else torch.float32,
                 out=out, log_every=args.log_every, hyper_lr=args.hyper_lr,
                 ngd_lr=args.ngd_lr)
    if args.check:
        failures = config_lib.evaluate_checks(cfg.name, result)
        if failures:
            print(f"[{cfg.name}] REGRESSION GATES FAILED:", flush=True)
            for f in failures:
                print(f"  FAIL {f}", flush=True)
            return 1
        print(f"[{cfg.name}] all {len(config_lib.CHECKS.get(cfg.name, {}))} "
              "regression gates pass", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
