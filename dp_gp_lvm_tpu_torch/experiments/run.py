"""Run a named config end to end (counterpart of `experiments/run.py` for
the Bayesian GP-LVM, MRD, the DP-GP-LVM, the minibatch SVI-GPLVM, also
with its amortized q(X), the minibatch DP-GP-LVM and the minibatch MRD):
data -> init -> chunked training (restarts for the full-batch models, the
SVI loop with checkpoints for `svi_gplvm`, the DP-SVI at T = 1 and the
MRD-SVI with `--staged off`, the staged split-init recipe with
stage-boundary checkpoints for the DP-SVI at T > 1, the two-phase recipe
with its phase-A checkpoint for the MRD-SVI) -> metrics, a JSONL log, a
`result.json`, a `params.npz`, and the committed regression gates with
`--check`.

    python -m dp_gp_lvm_tpu_torch.experiments.run c4_dp_mocap --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c3_mrd_twoview --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c3_mrd_twoview \
        --device cpu --f64 --n 64 --steps 40 --restarts 1
    python -m dp_gp_lvm_tpu_torch.experiments.run c6_svi_bigN --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c5_dp_missing \\
        --device cpu --f64 --n 128 --steps 40
    python -m dp_gp_lvm_tpu_torch.experiments.run c6_svi_bigN --device cpu \\
        --f64 --n 128 --steps 8 --batch 32 --log-every 2 --stop-after 4 \\
        --ckpt-every 2 --out build/runs/c6   # then again with --resume
    python -m dp_gp_lvm_tpu_torch.experiments.run c6_svi_bigN --stream \\
        --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c7_dp_svi --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c8_amortized_svi --check \
        [--stream]
    python -m dp_gp_lvm_tpu_torch.experiments.run c8_amortized_svi \
        --device cpu --f64 --n 128 --steps 8 --batch 32 [--stream]
    python -m dp_gp_lvm_tpu_torch.experiments.run c7_dp_svi --check \\
        --resume      # after an interruption: from <out>/stages
    python -m dp_gp_lvm_tpu_torch.experiments.run c7_dp_svi --device cpu \\
        --f64 --n 256 --steps 40 --batch 32
    python -m dp_gp_lvm_tpu_torch.experiments.run c9_mrd_svi_bigN --check
    python -m dp_gp_lvm_tpu_torch.experiments.run c9_mrd_svi_bigN --check \\
        --resume      # after an interruption: phase B from <out>/stages
    python -m dp_gp_lvm_tpu_torch.experiments.run c9_mrd_svi_bigN \\
        --staged off [--stream] --check     # one phase, the config's rates
    python -m dp_gp_lvm_tpu_torch.experiments.run c9_mrd_svi_bigN \\
        --device cpu --f64 --n 256 --steps 40 --batch 32
    python -m dp_gp_lvm_tpu_torch.experiments.run c4_dp_mocap \\
        --data-dir DIR [--plots] [--ard-lr 0.05] [--debug-nans]

`--data-dir` trains c2 on DIR's `DataTrn.txt` and the mocap configs on
its first `.amc` file. It runs f32 on the card unless `--device cpu` is
given. `--f64` is the CPU parity mode: the CUDA kernels take float32
only, so it is refused on the card. Data, initial parameters and the SVI minibatches are the
reference's draws: its `jax.random` keys in its order, through
`core/prng.py`, on the CPU (a draw does not depend on the device).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import sys
import time

import numpy as np
import torch

from dp_gp_lvm_tpu_torch import viz
from dp_gp_lvm_tpu_torch.core import config as config_lib
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.core.types import pin_full_f32, resolve_device
from dp_gp_lvm_tpu_torch.data import mocap, oil_flow, synthetic
from dp_gp_lvm_tpu_torch.data import stream as stream_lib
from dp_gp_lvm_tpu_torch.models import (
    amortized,
    bgplvm,
    dp_gp_lvm,
    dp_svi,
    eval_f64,
    mrd,
    mrd_svi,
    prediction,
    svi_gplvm,
)
from dp_gp_lvm_tpu_torch.parallel import auto as parallel_auto
from dp_gp_lvm_tpu_torch.parallel import collectives
from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
from dp_gp_lvm_tpu_torch.parallel import recipe as parallel_recipe
from dp_gp_lvm_tpu_torch.train import dp_recipe, mrd_recipe
from dp_gp_lvm_tpu_torch.train.checkpoint import Checkpointer, export_npz
from dp_gp_lvm_tpu_torch.train.logging import JsonlLogger
from dp_gp_lvm_tpu_torch.train.loop import (
    MinibatchChunks,
    NonFiniteGuard,
    TrainState,
    gp_optimizer,
    make_multi_step_fn,
    make_streaming_scan_fn,
    replayed,
    time_steps,
)

ROOT = pathlib.Path(__file__).resolve().parents[2]
MODELS = {"bgplvm": bgplvm, "mrd": mrd, "dp_gp_lvm": dp_gp_lvm,
          "svi_gplvm": svi_gplvm, "dp_svi": dp_svi, "mrd_svi": mrd_svi}
SVI_MODELS = ("svi_gplvm", "dp_svi", "mrd_svi")
SVI_BATCH = 1024        # rows a step of the SVI configs (the reference's)
DP_SVI_BATCH = 2048     # rows a step of the DP-SVI configs (the reference's)
SVI_TEST_ROWS = 256     # held-out rows the SVI imputation metric reads
GROUPED_TEST_ROWS = 512  # held-out rows drawn beside c7's training rows
MRD_PREDICT_STEPS = 400  # latent-inference steps of the cross-view metric
MRD_SVI_TEST_ROWS = 512  # held-out rows drawn beside c9's training rows
MRD_SVI_PREDICT_STEPS = 300  # the minibatch MRD's cross-view inference


def _first_amc(data_dir: str | None) -> str | None:
    """The first `.amc` file of `data_dir` by name, or None."""
    if not data_dir:
        return None
    amcs = sorted(f for f in os.listdir(data_dir) if f.endswith(".amc"))
    return os.path.join(data_dir, amcs[0]) if amcs else None


def load_data(cfg, dtype, device, data_dir: str | None = None):
    """(Y, source tag) of the config's dataset, drawn from the reference's
    key `PRNGKey(cfg.seed)`; Y is the tuple of views for MRD (c9's with
    its 512 held-out rows last, from the same draw). With `data_dir` the
    oil-flow configs read its `DataTrn.txt` and the mocap configs its
    first `.amc` file (`data/oil_flow.py`, `data/mocap.py`: every frame,
    D what the channel preprocessing keeps), each falling back to its
    surrogate where the file is missing, as the reference does. The
    oil-flow surrogate is drawn from key 0 whatever the config's seed, and
    at its fixed 1000 x 12."""
    kw = dict(dtype=dtype, device=device)
    key = prng.PRNGKey(cfg.seed)
    if cfg.dataset == "two_view":
        # the shared-dominant generator of c3's calibration
        Y1, Y2, _ = synthetic.two_view(key, n=cfg.n, d1=cfg.views[0],
                                       d2=cfg.views[1], q_shared=2,
                                       private_weight=0.5, **kw)
        return (Y1, Y2), "two_view"
    if cfg.dataset == "toy_gplvm":
        Y, _ = synthetic.toy_gplvm(key, n=cfg.n, d=cfg.d, q_true=2,
                                   q_total=cfg.q, **kw)
        return Y, "toy_gplvm"
    if cfg.dataset == "oil_flow":
        Y, _, tag = oil_flow.load_oil_flow(data_dir, **kw)
        return Y, tag
    if cfg.dataset == "pose":
        Y, _, _ = synthetic.pose_like(key, n=cfg.n, **kw)
        return Y, "synthetic:pose_like"
    if cfg.dataset == "mocap":
        return mocap.load_mocap(_first_amc(data_dir), n=cfg.n, d=cfg.d,
                                rng=key, **kw)
    if cfg.dataset == "grouped_big":
        # cfg.n training rows and the held-out rows from ONE draw (a
        # second draw would be another function, unimputable)
        Y, _, _ = synthetic.grouped_dims_big(
            key, n=cfg.n + GROUPED_TEST_ROWS,
            dims_per_group=grouped_dims_per_group(cfg.d), q=cfg.q, **kw)
        return Y, "synthetic:grouped_big"
    if cfg.dataset == "two_view_big":
        # the held-out rows are the last MRD_SVI_TEST_ROWS of one draw,
        # at the views' own standardization
        Y1, Y2, _ = synthetic.two_view_big(
            key, n=cfg.n + MRD_SVI_TEST_ROWS, d1=cfg.views[0],
            d2=cfg.views[1], q_shared=2, q_private=1, private_weight=0.5,
            **kw)
        return (Y1, Y2), "synthetic:two_view_big"
    raise ValueError(f"dataset {cfg.dataset!r} is not ported")


def grouped_dims_per_group(d: int) -> tuple[int, ...]:
    """c7's four planted groups of output dims, the last taking the rest."""
    per = d // 4
    return (per, per, per, d - 3 * per)


def _holdout_rows(n: int):
    """The row holdout of the missing-data and cross-view protocols: every
    8th row is a test row. A boolean mask of the kept (training) rows."""
    keep = np.ones(n, bool)
    keep[7::8] = False
    return keep


def holdout_split(Y):
    """The missing-data protocol: every 8th row is held out (interpolation,
    not extrapolation), and both splits are standardized with the train
    split's statistics only (numpy, ddof 0, + 1e-8). numpy in, numpy out:
    (Y_train, Y_test)."""
    Y_all = np.asarray(Y)
    keep = _holdout_rows(Y_all.shape[0])
    Y_train, Y_test = Y_all[keep], Y_all[~keep]
    mu = Y_train.mean(axis=0)
    sd = Y_train.std(axis=0) + 1e-8
    return (Y_train - mu) / sd, (Y_test - mu) / sd


def ard_cross_private_ratio(rel) -> float:
    """MRD's shared/private signature as one gateable scalar: per view, the
    weakest ARD weight (the other view's private dim, which the generator
    weights 0) over the mean of the two strongest (the shared dims), the
    max over views. Truth on the two_view generator: 0; flat relevance: 1.
    numpy float64."""
    rel = np.asarray(rel, dtype=np.float64)
    ratios = []
    for row in rel:
        w = np.sort(row)[::-1]
        ratios.append(w[-1] / max(w[:2].mean(), 1e-30))
    return float(max(ratios))


def _cross_view(trained, Ys_train, Ys_test, mcfg, num_steps) -> dict:
    """The cross-view metrics on the held-out rows: observe view 0, predict
    view 1; the baseline predicts the training split's mean of view 1. MRD
    rebuilds its posterior caches from the training views; the minibatch
    MRD serves from its q(u^v) alone."""
    Y1_test, Y2_test = Ys_test
    t0 = time.perf_counter()
    if isinstance(mcfg, mrd_svi.Config):
        mean, var, *_ = mrd_svi.cross_view_predict(
            trained, {0: Y1_test}, 1, mcfg, num_steps=num_steps)
    else:
        mean, var, *_ = prediction.predict_view_from_views(
            trained, list(Ys_train), mcfg, observed={0: Y1_test},
            target_view=1, num_steps=num_steps)
    if mean.is_cuda:
        torch.cuda.synchronize(mean.device)
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        ones = torch.ones_like(Y2_test)
        mse = float(torch.mean((mean - Y2_test) ** 2))
        base = float(torch.mean((Ys_train[1].mean(dim=0) - Y2_test) ** 2))
        pll = float(prediction.gaussian_predictive_loglik(
            Y2_test, mean, var, ones) / ones.numel())
        rel = (mrd_svi if isinstance(mcfg, mrd_svi.Config)
               else mrd).ard_relevance(trained).cpu().numpy()
    return {
        "cross_view_mse": mse,
        "cross_view_mse_baseline": base,
        "cross_view_mse_ratio": mse / base,
        "cross_view_pll_per_dim": pll,
        "cross_view_seconds": round(seconds, 3),
        "calibration_ratio": mse / float(torch.mean(var)),
        "ard_relevance": [[round(float(a), 6) for a in row] for row in rel],
        "ard_cross_private_ratio": ard_cross_private_ratio(rel),
    }


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


def _last_dims_missing(Y_test, missing_fraction):
    """The missing-data protocol's mask (1 = observed): the last
    `missing_fraction` of the dims of every held-out row are missing."""
    n_miss = int(Y_test.shape[1] * missing_fraction)
    mask = torch.ones_like(Y_test)
    mask[:, -n_miss:] = 0.0
    return mask


def _impute(impute_fn, Y_test, mask, baseline: bool = False) -> dict:
    """The missing-data metrics of the held-out rows, their dims where
    `mask` is 0 imputed by `impute_fn(Y_test, mask) -> (mean, var, ...)`;
    with `baseline`, also the mse of predicting 0 (the training mean of
    standardized data)."""
    t0 = time.perf_counter()
    mean, var, *_ = impute_fn(Y_test, mask)
    if mean.is_cuda:
        torch.cuda.synchronize(mean.device)
    seconds = time.perf_counter() - t0
    miss = 1.0 - mask
    with torch.no_grad():
        mse = float(torch.sum(((mean - Y_test) ** 2) * miss) / torch.sum(miss))
        pll = float(prediction.gaussian_predictive_loglik(
            Y_test, mean, var, miss) / torch.sum(miss))
        mean_var = float(torch.sum(var * miss) / torch.sum(miss))
        base = float(torch.sum(Y_test ** 2 * miss) / torch.sum(miss))
    return {
        "imputation_mse": mse,
        **({"imputation_mse_baseline": base} if baseline else {}),
        "predictive_loglik_per_dim": pll,
        "calibration_ratio": mse / mean_var,
        "imputation_seconds": round(seconds, 3),
        "imputation_rows": int(Y_test.shape[0]),
    }


def _model_config(cfg, batch):
    if cfg.model == "bgplvm":
        return bgplvm.Config(num_latent=cfg.q, num_inducing=cfg.m,
                             psi2_block=cfg.psi2_block)
    if cfg.model == "mrd":
        return mrd.Config(num_latent=cfg.q, num_inducing=cfg.m,
                          num_views=len(cfg.views),
                          psi2_block=cfg.psi2_block)
    if cfg.model == "dp_gp_lvm":
        return dp_gp_lvm.Config(num_latent=cfg.q, num_inducing=cfg.m,
                                truncation=cfg.t, alpha=cfg.alpha,
                                psi2_block=cfg.psi2_block)
    if cfg.model == "dp_svi":
        # ARD at 1/Q keeps the cold init's kernel distances O(1), so that
        # stage 1's ARD pruning reaches the data's scale in its budget
        return dp_svi.Config(num_latent=cfg.q, num_inducing=cfg.m,
                             truncation=cfg.t, alpha=cfg.alpha,
                             batch=batch or DP_SVI_BATCH,
                             psi2_block=cfg.psi2_block,
                             ard_init=1.0 / cfg.q, amortized=cfg.amortized,
                             noise_floor=cfg.noise_floor,
                             qx_var_floor=cfg.qx_var_floor)
    if cfg.model == "mrd_svi":
        return mrd_svi.config_from_experiment(cfg, batch)
    return svi_gplvm.Config(num_latent=cfg.q, num_inducing=cfg.m,
                            batch=batch or SVI_BATCH,
                            psi2_block=cfg.psi2_block,
                            amortized=cfg.amortized,
                            noise_floor=cfg.noise_floor,
                            qx_var_floor=cfg.qx_var_floor)


def _svi_chunk(device, log_every, steps, stop_after):
    """Steps between host reads of the SVI loop, the reference's rule: at
    least 250 off the CPU, at least two chunks, --stop-after reached
    exactly. The step keys do not depend on it."""
    floor = 1 if device.type == "cpu" else 250
    chunk = max(1, min(max(log_every, floor), steps))
    if chunk >= steps:
        chunk = max(1, steps // 2)
    if stop_after:
        chunk = max(1, min(chunk, stop_after))
    return chunk


def _resident_chunks(step_fn, key, chunk, batch, Y, eager=False,
                     mesh=None):
    """run_chunk(done) -> (chunk,) losses of the steps done, ...,
    done + chunk - 1 on the resident Y (the tuple of aligned views for the
    MRD-SVI): step t draws its rows with `randint(fold_in(key, t),
    (batch,), 0, N)` (int32), so the sequence depends on neither the chunk
    size nor a restart; a chunk's indices are drawn on the host in one
    call and copied once, and `train.loop.MinibatchChunks` runs the chunk
    (replayed from a CUDA graph on the card unless `eager` or a `mesh`)."""
    first = Y[0] if isinstance(Y, tuple) else Y
    chunks = MinibatchChunks(step_fn, Y, eager=eager, mesh=mesh)

    def run_chunk(done):
        keys = prng.fold_in(key, torch.arange(done, done + chunk))
        idx = dp_svi.minibatch_indices(keys, batch, first.shape[0]).to(
            first.device)
        return chunks(done, idx)
    return run_chunk


def _say_steps(cfg, device, mesh, eager, debug_nans) -> None:
    if device.type != "cuda":
        return
    if replayed(device, mesh, eager):
        how = "captured once per step function, replayed from CUDA graphs"
    else:
        why = ("a mesh (no graph capture there yet)" if mesh is not None
               else "--debug-nans" if debug_nans else "--eager")
        how = f"eager, one PyTorch call at a time ({why})"
    print(f"[{cfg.name}] steps: {how}", flush=True)


def _raise_nonfinite(cfg, losses, done):
    """--debug-nans: raise at the first non-finite loss of a chunk whose
    first step is `done`."""
    bad = (~torch.isfinite(losses)).nonzero()
    if bad.numel():
        i = int(bad[0])
        raise FloatingPointError(f"[{cfg.name}] --debug-nans: non-finite "
                                 f"loss {float(losses[i])} at step {done + i}")


def _chunk_loop(cfg, run_chunk, start, n_steps, chunk, *, out, logger,
                inject_nonfinite_at, label="", on_chunk_end=None,
                debug_nans=False):
    """Whole chunks of steps from `start` until `n_steps` is reached (past
    it where the chunk does not divide it, as the reference's loop), one
    host read of the chunk's losses each; the abort (exit 3) after three
    chunks with a non-finite loss, or with `debug_nans` a
    FloatingPointError at the first. Returns (steps done, seconds a step
    after the first chunk (NaN with one chunk), seconds)."""
    guard = NonFiniteGuard()
    t0 = time.perf_counter()
    t_post = None
    done = start
    while done < n_steps:
        losses = run_chunk(done).cpu()            # the host read
        if t_post is None:
            t_post = time.perf_counter()      # the first chunk builds
        if inject_nonfinite_at is not None:   # fault injection (tests)
            losses[max(0, inject_nonfinite_at - done):] = math.nan
        if debug_nans:
            _raise_nonfinite(cfg, losses, done)
        if guard.update(losses, done):
            _abort_nonfinite(cfg, out, guard, done + chunk)
        done += chunk
        elbo_now = -float(losses[-1])
        logger.log(done - 1, elbo_estimate=elbo_now)
        print(f"  {label}step {done - 1}: elbo_estimate={elbo_now:.4g}",
              flush=True)
        if on_chunk_end is not None:
            on_chunk_end(done)
    timed = done - start - chunk
    per_step = ((time.perf_counter() - t_post) / timed if timed > 0
                else math.nan)
    return done, per_step, time.perf_counter() - t0


def _rows_per_sec(batch, per_step):
    return round(batch / max(per_step, 1e-9)) if per_step == per_step \
        else None


def _svi_step(cfg, mcfg, n_total, opt, stream, mesh=None):
    if cfg.model == "dp_svi":
        return dp_svi.make_dp_svi_step(mcfg, n_total, opt, rho=0.3,
                                       rho_phi=0.1, streaming=stream,
                                       mesh=mesh)
    if cfg.model == "mrd_svi":
        # one K1 and one K2 a view and step: the blend reads the gradient
        # pass's statistics
        return mrd_svi.make_svi_natgrad_step(
            mcfg, n_total, opt, rho=0.2, streaming=stream, mesh=mesh,
            qu_trust=100.0 if cfg.amortized else None)
    # the amortized model's q(u) blend in a trust region (G's RMS
    # eigenvalue and the mean's step capped at 100)
    return svi_gplvm.make_svi_natgrad_step(
        mcfg, n_total, opt, rho=0.2, streaming=stream, mesh=mesh,
        qu_trust=100.0 if cfg.amortized else None)


def _svi_table(cfg, params):
    """The placement table of an SVI config's (rank's) parameters."""
    if cfg.model == "dp_svi":
        return parallel_auto.dp_svi_shardings(params)[0]
    return parallel_auto.svi_shardings(params)[0]


def _train_svi(cfg, Y, mcfg, p0, steps, *, device, log_every, hyper_lr,
               ngd_lr, logger, out, ckpt_every, resume, stop_after,
               inject_nonfinite_at, stream, debug_nans=False, mesh=None,
               work_dir=None, eager=False):
    """The single-stage SVI loop (the SVI-GPLVM; the DP-SVI at T = 1; the
    MRD-SVI with `--staged off`, Y the tuple of its aligned views): q(u)
    by stochastic natural gradient, the rest by `gp_optimizer`, in chunks
    of steps with one host read each.

    Resident (the default): `_resident_chunks` with the key r1, the second
    half of `split(PRNGKey(seed + 100))`; the step gathers its rows from Y
    on the device. Streamed (`stream`): Y is written to `out/y_stream.f32`
    and a `data.stream.ChunkStream` (seed + 7, the native loader on the
    card) draws and gathers each chunk on the host; the step gets the rows,
    never Y (the MRD-SVI's views concatenated column-wise, which its step
    splits again).

    On a `mesh` p0 is placed (`parallel.recipe.place_svi`) and every rank
    draws the same full batches, resident or streamed, and steps on its
    block of rows; the checkpoints in `work_dir/ckpt` hold the full state
    (`train/checkpoint.py`). `out` is where rank 0 writes, `work_dir` the
    run's directory on every rank (default `out`). Returns (params, s per
    step after the first chunk, seconds, result keys); on a mesh the
    rank's parameters."""
    Y_flat = torch.cat(Y, dim=1) if isinstance(Y, tuple) else Y
    n_total = Y_flat.shape[0]
    work_dir = work_dir or out
    table = None
    if mesh is not None:
        p0, _, table = parallel_recipe.place_svi(cfg.model, p0, (Y,), mesh)
    # amortized: inducing points at the full rate cluster under the
    # encoder's compressed latent cloud and drive cond(K_uu) past the f32
    # whitening limit; at the hyper rate they keep it conditioned
    opt = gp_optimizer(p0, lr=cfg.lr, hyper_lr=hyper_lr, ard_lr=cfg.ard_lr,
                       decay_steps=steps, ngd_lr=ngd_lr,
                       slow=frozenset({"z"}) if cfg.amortized else frozenset(),
                       mesh=mesh, placement=table)
    step_fn = _svi_step(cfg, mcfg, n_total, opt, stream, mesh)
    chunk = _svi_chunk(device, log_every, steps, stop_after)
    state = TrainState(opt)
    ck = None
    if ckpt_every or resume or stream:
        if work_dir is None:
            raise ValueError("--ckpt-every, --resume and --stream need an "
                             "output directory")
    if ckpt_every or resume:
        ck = Checkpointer(os.path.join(work_dir, "ckpt"))
        if resume and ck.restore(state) is not None:
            print(f"[{cfg.name}] resumed at step {state.step}", flush=True)
    loop_steps = min(steps, stop_after or steps)
    if loop_steps % chunk:
        print(f"[{cfg.name}] note: the loop runs chunks of {chunk}; it "
              f"stops at the next multiple of {chunk} past {loop_steps}",
              flush=True)
    if ckpt_every and ckpt_every % chunk:
        print(f"[{cfg.name}] note: --ckpt-every {ckpt_every} is not a "
              f"multiple of the chunk {chunk}; checkpoints are written only "
              f"at chunk ends divisible by it", flush=True)
    start = state.step
    extra = {"batch": mcfg.batch}
    with contextlib.ExitStack() as feed:
        if stream:
            if start % chunk:
                raise SystemExit(
                    f"--resume at step {start}: the streaming Philox "
                    f"fast-forward needs a chunk-multiple checkpoint "
                    f"(chunk={chunk})")
            y_path = os.path.join(work_dir, "y_stream.f32")
            if mesh is None or mesh.rank == 0:
                stream_lib.write_rows(y_path, Y_flat.cpu().numpy())
            if mesh is not None:       # every rank streams rank 0's file
                collectives.barrier(mesh)
            # the card's feed is the native gather, never the numpy one
            loader = (stream_lib.StreamLoader if device.type == "cuda"
                      else stream_lib.open_loader)(y_path, n_total,
                                                   Y_flat.shape[1])
            cs = feed.enter_context(stream_lib.ChunkStream(
                loader, batch=mcfg.batch, chunk=chunk, seed=cfg.seed + 7,
                skip_chunks=start // chunk, device=device))
            scan_chunk = make_streaming_scan_fn(step_fn, eager=eager,
                                                mesh=mesh)
            extra.update(streamed=True, native_loader=isinstance(
                loader, stream_lib.StreamLoader))

            def run_chunk(done):
                idx, y = cs.next_chunk()
                return scan_chunk(state, idx, y.to(Y_flat.dtype))[1]
        else:
            _, r1 = prng.split(prng.PRNGKey(cfg.seed + 100))
            run_chunk = _resident_chunks(step_fn, r1, chunk, mcfg.batch, Y,
                                         eager, mesh)

        def on_chunk_end(done):
            state.step = done
            if ck is not None and ckpt_every and done % ckpt_every == 0:
                ck.save(state)

        done, per_step, total = _chunk_loop(
            cfg, run_chunk, start, loop_steps, chunk, out=out, logger=logger,
            inject_nonfinite_at=inject_nonfinite_at,
            on_chunk_end=on_chunk_end, debug_nans=debug_nans)
    extra["rows_per_sec"] = _rows_per_sec(mcfg.batch, per_step)
    feed_note = ""
    if stream:
        chunks = max((done - start) // chunk, 1)
        extra["feed_wait_ms_per_chunk"] = 1e3 * cs.wait_s / chunks
        feed_note = (f"; the feed's gather held the host "
                     f"{extra['feed_wait_ms_per_chunk']:.3f} ms a chunk "
                     f"(native loader: {extra['native_loader']})")
    print(f"[{cfg.name}] done in {total:.1f}s; {per_step * 1e3:.2f} ms/step "
          f"after the first chunk, {extra['rows_per_sec']} rows/s"
          f"{feed_note}", flush=True)
    return opt.params, per_step, total, extra


def _train_staged(cfg, Y, mcfg, steps, *, device, log_every, logger, out,
                  resume, inject_nonfinite_at, debug_nans=False, mesh=None,
                  work_dir=None, eager=False, **recipe_kw):
    """A staged recipe on the resident rows: the DP-SVI at T > 1 through
    `train/dp_recipe.py` (a boundary after each stage), or the MRD-SVI, Y
    its tuple of views, through `train/mrd_recipe.py` (the phase-A
    boundary). The init is drawn from PRNGKey(seed), the minibatches from
    PRNGKey(seed + 100); the boundaries are written to `out/stages`, and
    with `resume` the recipe restarts after the last one. `recipe_kw`
    goes to the recipe. On a `mesh` the recipe steps sharded and its
    boundaries go to `work_dir/stages` (default `out`, where rank 0
    writes). Returns (params, the last stage's s per step, seconds, result
    keys); on a mesh the rank's parameters."""
    work_dir = work_dir or out
    chunk = _svi_chunk(device, log_every, steps, None)
    every_chunk = {}

    def drive(step_fn, state, n_steps, key, Y_cur, label=""):
        """The recipe's drive. Its seconds a step skip the stage's first
        chunk, which captures the stage's step on the card (the
        reference skips it too: it compiles there); a stage of one chunk
        counts that chunk. `every_chunk` keeps the last stage's wall
        seconds a step over all its chunks."""
        start = state.step
        state.step, per_step, wall = _chunk_loop(
            cfg, _resident_chunks(step_fn, key, chunk, mcfg.batch, Y_cur,
                                  eager, mesh),
            start, n_steps, chunk, out=out, logger=logger,
            inject_nonfinite_at=inject_nonfinite_at, label=label,
            debug_nans=debug_nans)
        every_chunk["per_step"] = wall / (state.step - start)
        if per_step != per_step:               # one chunk: NaN
            per_step = every_chunk["per_step"]
        return state, per_step, wall

    mrd_views = cfg.model == "mrd_svi"
    recipe, last = ((mrd_recipe.staged_mrd_svi, "phase B") if mrd_views
                    else (dp_recipe.staged_dp_svi, "stage 2c"))
    state, _, info = recipe(
        prng.PRNGKey(cfg.seed), prng.PRNGKey(cfg.seed + 100), Y, mcfg,
        (Y[0] if mrd_views else Y).shape[0], steps=steps, chunk=chunk,
        lr=cfg.lr, drive=drive,
        mesh=mesh, resume=resume, **recipe_kw,
        # the DP recipe's warmup runs outside the drive
        **({} if mrd_views else {"eager": eager}),
        ckpt_dir=(os.path.join(work_dir, "stages") if work_dir is not None
                  else None))
    per_step, total = info.pop("per_step"), info.pop("seconds")
    extra = {"batch": mcfg.batch, **info,
             "rows_per_sec": _rows_per_sec(mcfg.batch, per_step)}
    print(f"[{cfg.name}] done in {total:.1f}s; {per_step * 1e3:.2f} ms/step "
          f"in {last}, {extra['rows_per_sec']} rows/s (over every chunk of "
          f"{last}: {every_chunk['per_step'] * 1e3:.3f} ms/step, "
          f"{_rows_per_sec(mcfg.batch, every_chunk['per_step'])} rows/s)",
          flush=True)
    params = mrd_svi.nested(state.params) if mrd_views else state.params
    return params, per_step, total, extra


def group_recovery(phi, labels) -> dict:
    """The planted-group metrics: each group's purity (the share of its
    dims whose most likely atom is the group's most common one), their
    minimum, and how many distinct atoms the groups' most common atoms
    are. numpy in, floats out."""
    hard = np.asarray(phi).argmax(axis=1)
    labels = np.asarray(labels)
    purities, tops = [], []
    for g in np.unique(labels):
        counts = np.bincount(hard[labels == g], minlength=phi.shape[1])
        purities.append(counts.max() / counts.sum())
        tops.append(int(counts.argmax()))
    return {"group_purity_min": float(min(purities)),
            "group_purities": [round(float(p), 4) for p in purities],
            "distinct_atoms_for_groups": len(set(tops)),
            "num_groups": int(len(np.unique(labels)))}


def _abort_nonfinite(cfg, out, guard, done):
    """Mark the run failed and exit 3: k consecutive chunks held a
    non-finite loss."""
    failed = {"config": cfg.name, "aborted_nonfinite": True,
              "aborted_at_step": int(done),
              "first_nonfinite_step": int(guard.first_bad_step or done)}
    if out is not None:
        with open(os.path.join(out, "result.json"), "w") as fh:
            json.dump(failed, fh, indent=2)
    print(f"[{cfg.name}] ABORT: {guard.k} consecutive chunks with non-finite "
          f"losses (first at step ~{guard.first_bad_step}); run marked "
          f"failed", flush=True)
    raise SystemExit(3)


def open_mesh(spec: str, device: torch.device):
    """The runner's mesh from `--mesh DATA[,MODEL]`: its size must be the
    world size `torchrun` started (1 without it), and on the card it is
    1 x 1 (NCCL takes one rank per card)."""
    data, model = parallel_recipe.parse_mesh(spec)
    if device.type == "cuda" and data * model > 1:
        raise ValueError(
            f"--mesh {spec}: NCCL runs one rank per card and refuses two "
            "ranks on one GPU, so on a one-card machine the mesh is 1 or "
            "1,1; run a larger mesh on the CPU (--device cpu) under "
            "torchrun")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if data * model != world:
        raise ValueError(
            f"--mesh {spec} is {data * model} ranks, and {world} run: start "
            f"it under torchrun --nproc-per-node {data * model}")
    return mesh_lib.make_mesh(data, model, device.type)


def run(cfg, *, steps: int | None = None, device=None,
        dtype=torch.float32, data=None, params=None, out=None,
        log_every: int = 50, hyper_lr: float | None = None,
        ngd_lr: float | None = None, batch: int | None = None,
        ckpt_every: int = 0, resume: bool = False,
        stop_after: int | None = None,
        inject_nonfinite_at: int | None = None,
        impute_steps: int = 200, stream: bool = False,
        staged: bool | None = None, data_dir: str | None = None,
        plots: bool = False, debug_nans: bool = False,
        mesh: str | None = None, eager: bool = False) -> dict:
    """Train `cfg` and return its result dict (the reference's keys).

    `data` replaces the config's dataset (Y before any holdout, a tuple of
    views for MRD) and `params` the first restart's initial parameters,
    both as numpy (for example the JAX package's, to hold the two packages
    together). With
    `out`, `train.jsonl`, `result.json` and `params.npz` are written
    there. The SVI configs take `batch` (rows a step), `ckpt_every` and
    `resume` (checkpoints in `out/ckpt`), `stop_after` (stop the loop
    early; the schedules still span `steps`) and `inject_nonfinite_at`
    (treat losses from that step on as NaN: the abort, exit 3) and
    `stream` (feed the minibatches from the host, `data/stream.py`: Y is
    written to `out/y_stream.f32`); `impute_steps` sizes the imputation's
    latent inference. MRD's cross-view prediction takes 400 inference
    steps, the minibatch MRD's 300, the reference's. `staged` (the
    MRD-SVI: the config's `staged` when None) trains through the two-phase
    recipe, with `resume` from its phase-A boundary in `out/stages`.
    `data_dir` holds the oil-flow or AMC files (`load_data`). `plots`
    draws the latent scatter, the ARD weights and, for the DP-GP-LVM, the
    assignments and sticks into `out` (matplotlib, asked for before
    training). `debug_nans` raises FloatingPointError at the first
    non-finite loss: every full-batch step's (one host read a step), every
    SVI chunk's; `main --debug-nans` also trains under autograd's anomaly
    mode. `mesh` ("DATA[,MODEL]") trains on a mesh of ranks under
    `torchrun --nproc-per-node DATA*MODEL` (gloo on the CPU; on the card
    only "1" or "1,1", over NCCL): the full-batch configs c1-c5 the
    rank's shards of the sharded loss (`parallel/recipe.py`), every
    restart placed anew; the SVI configs c6-c9 each batch's block of rows
    (the DP-SVI's atoms over MODEL), streamed or resident, staged or not,
    with checkpoints of the full state. The metrics read the gathered
    parameters. Only rank 0 writes to `out` (`main` also keeps the other
    ranks quiet); every rank reads the checkpoints there.

    On the card every chunk of steps (full batch, SVI resident or
    streamed, each stage of a staged recipe) is replayed from a CUDA
    graph captured at its first step (`train.loop.StepGraph`), the
    counterpart of the reference's jitted chunk; `eager` runs the steps
    one PyTorch call at a time instead (debugging; a mesh and
    `debug_nans` do too). A failed capture raises; nothing falls back."""
    if plots:
        if out is None:
            raise ValueError("--plots needs an output directory")
        viz.require_matplotlib()
    device = resolve_device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the CUDA kernels take float32 only; --f64 is the "
                         "CPU parity mode (--device cpu)")
    if cfg.model not in MODELS:
        raise ValueError(f"model {cfg.model!r} is not ported to the runner")
    svi = cfg.model in SVI_MODELS
    staged_dp = cfg.model == "dp_svi" and cfg.t > 1
    staged_mrd = cfg.model == "mrd_svi" and (
        cfg.staged if staged is None else staged)
    if stream and not svi:
        raise ValueError("--stream feeds the SVI configs only")
    single_stage_only = (stream or ckpt_every or stop_after
                         or params is not None)
    if staged_dp and single_stage_only:
        raise ValueError(
            "the staged DP-SVI recipe (T > 1) runs on the resident rows from "
            "its own T = 1 init and checkpoints at its stage boundaries: "
            "--stream, --ckpt-every, --stop-after and given parameters "
            "take the single-stage loop only")
    if staged_mrd and single_stage_only:
        raise ValueError(
            "the staged MRD-SVI recipe runs on the resident views from its "
            "own init and checkpoints at its phase boundary: --stream, "
            "--ckpt-every, --stop-after and given parameters take the "
            "single-phase loop only (--staged off)")
    if device.type == "cuda":
        pin_full_f32()
    work_dir = out       # the run's directory: checkpoints, stream, stages
    if mesh is not None:
        spec, mesh = mesh, open_mesh(mesh, device)
        if mesh.rank != 0:
            out, plots = None, False
    steps = steps or cfg.steps
    model = MODELS[cfg.model]
    if out is not None:
        os.makedirs(out, exist_ok=True)
    if mesh is not None:     # rank 0 made it before any rank writes there
        collectives.barrier(mesh)
    logger = JsonlLogger(os.path.join(out, "train.jsonl") if out else None)

    views = cfg.model in ("mrd", "mrd_svi")
    if data is None:
        Y, tag = load_data(cfg, dtype, device, data_dir)
    else:
        def given(y):
            return torch.tensor(np.asarray(y), dtype=dtype, device=device)

        Y = tuple(map(given, data)) if views else given(data)
        tag = f"given:{cfg.dataset}"
    mcfg = _model_config(cfg, batch)
    imputing = cfg.model not in ("bgplvm", "mrd") and cfg.missing_fraction > 0
    grouped = cfg.dataset == "grouped_big"
    if grouped:
        # the first cfg.n rows train; the rest are the held-out rows
        Y_train, Y_test = Y[:cfg.n], Y[cfg.n:]
    elif cfg.dataset == "two_view_big":
        # the same for each view: the held-out rows are the draw's last
        Y_train = tuple(y[:cfg.n] for y in Y)
        Ys_test = tuple(y[cfg.n:] for y in Y)
    elif imputing:
        Y_train, Y_test = (torch.as_tensor(y, dtype=dtype, device=device)
                           for y in holdout_split(Y.cpu().numpy()))
        if svi:
            Y_test = Y_test[:SVI_TEST_ROWS]
    elif views:
        # the views were standardized over the whole series; the split
        # keeps that scale (no re-standardization, unlike the imputation)
        keep = torch.as_tensor(_holdout_rows(Y[0].shape[0]), device=device)
        Y_train = tuple(y[keep] for y in Y)
        Ys_test = tuple(y[~keep] for y in Y)
    else:
        Y_train = Y
    # what a training step takes: each view, or the one Y
    step_data = Y_train if views else (Y_train,)

    def init(r):
        if r == 0 and params is not None:
            return params_from_jax(params, device, dtype)
        # the first restart draws its init from the data's key, as the
        # reference does
        return model.init_params(prng.PRNGKey(cfg.seed + r), Y_train, mcfg)

    def checked(loss):
        if debug_nans and not bool(torch.isfinite(loss)):
            raise FloatingPointError(
                f"[{cfg.name}] --debug-nans: non-finite loss "
                f"{float(loss.detach())}")
        return loss

    def loss_fn(p, *ys):
        return checked(model.loss(p, list(ys) if views else ys[0], mcfg))

    print(f"[{cfg.name}] data={tag} model={cfg.model} steps={steps} "
          f"device={device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f" mesh={spec}" if mesh is not None else ""), flush=True)
    # anomaly mode and the per-step loss check read the host: eager steps
    eager = eager or debug_nans
    _say_steps(cfg, device, mesh, eager, debug_nans)
    ngd_lr = cfg.ngd_lr if ngd_lr is None else ngd_lr
    # one host read per chunk; the reference's loop runs whole chunks, so
    # it runs past `steps` where the chunk does not divide it
    chunk = max(1, min(log_every, steps))

    def train_from(p0, label):
        """(p0 trained in place, its optimizer, the last ELBO, and the
        step's loss and data). The optimizer holds the leaves flat (MRD's
        views too); the loss closes over p0 itself. On a mesh p0 is placed
        first: the rank's shards train on the sharded loss."""
        loss, data, placement = loss_fn, step_data, None
        if mesh is not None:
            sharded, p0, data, placement = parallel_recipe.sharded_setup(
                cfg.model, p0, step_data, mcfg, mesh)
            loss = lambda p, *ys: checked(sharded(p, *ys))
        opt = gp_optimizer(p0, lr=cfg.lr, hyper_lr=hyper_lr,
                           ard_lr=cfg.ard_lr, decay_steps=steps,
                           ngd_lr=ngd_lr, mesh=mesh, placement=placement)
        step_loss = lambda _, *d: loss(p0, *d)
        multi_step = make_multi_step_fn(step_loss, opt, chunk, eager=eager)
        done = 0
        while done < steps:
            losses = multi_step(*data)
            done += chunk
            elbo_now = -float(losses[-1])
            logger.log(done - 1, elbo=elbo_now)
            print(f"  step {done - 1}{label}: elbo={elbo_now:.3f}",
                  flush=True)
        return p0, opt, elbo_now, (multi_step, data, placement)

    extra, restart_elbos = {}, []
    if staged_dp or staged_mrd:
        trained, per_step, total, extra = _train_staged(
            cfg, Y_train, mcfg, steps, device=device, log_every=log_every,
            logger=logger, out=out, resume=resume,
            inject_nonfinite_at=inject_nonfinite_at, debug_nans=debug_nans,
            mesh=mesh, work_dir=work_dir, eager=eager,
            **({"ngd_lr": ngd_lr} if staged_dp else {}))
    elif svi:
        trained, per_step, total, extra = _train_svi(
            cfg, Y_train, mcfg, init(0), steps, device=device,
            log_every=log_every, hyper_lr=hyper_lr, ngd_lr=ngd_lr,
            logger=logger, out=out, ckpt_every=ckpt_every, resume=resume,
            stop_after=stop_after, inject_nonfinite_at=inject_nonfinite_at,
            stream=stream, debug_nans=debug_nans, mesh=mesh,
            work_dir=work_dir, eager=eager)
        if cfg.model == "mrd_svi":
            trained = mrd_svi.nested(trained)
    if svi and mesh is not None:
        # every metric below reads the whole parameters
        trained = parallel_auto.gather(trained, _svi_table(cfg, trained),
                                       mesh)
    if cfg.model == "mrd_svi":
        logger.close()
        # the reference's gated ELBO: the bound in the run's dtype over
        # every training row (on the card K1 over all rows of each view)
        with torch.no_grad():
            terms = {"elbo": float(mrd_svi.elbo(trained, list(Y_train),
                                                mcfg)),
                     "noise_min": float(torch.min(torch.stack([
                         c["noise"] for c in mrd_svi.constrain_views(
                             trained, mcfg)])))}
    elif cfg.model == "dp_svi":
        logger.close()
        # the reference's gated ELBO: the model's own bound (f32 on the
        # card) over every training row, one K1 launch
        with torch.no_grad():
            terms = {"elbo": float(dp_svi.elbo(trained, Y_train, mcfg)),
                     "noise_min": float(torch.min(
                         dp_svi.constrain(trained, mcfg)["noise"]))}
    elif svi:
        logger.close()
        # the gated ELBO in host float64 over every training row
        with torch.no_grad():
            noise = float(svi_gplvm.constrain(trained, mcfg)["noise"])
        terms = {"elbo": eval_f64.elbo_f64(trained, Y_train, mcfg),
                 "noise": noise}
    else:
        # non-convex models train from cfg.restarts init seeds; the best
        # final ELBO is kept
        t0 = time.perf_counter()
        trained, opt, best_elbo, stepping = train_from(
            init(0), " [r0]" if cfg.restarts > 1 else "")
        restart_elbos = [best_elbo]
        for r in range(1, cfg.restarts):
            p_r, opt_r, elbo_r, stepping_r = train_from(init(r), f" [r{r}]")
            restart_elbos.append(elbo_r)
            if elbo_r > best_elbo:
                trained, opt, best_elbo, stepping = (p_r, opt_r, elbo_r,
                                                     stepping_r)
        total = time.perf_counter() - t0
        if cfg.restarts > 1:
            print(f"[{cfg.name}] restart elbos: "
                  f"{[round(e, 2) for e in restart_elbos]} -> best "
                  f"{best_elbo:.2f}", flush=True)
        multi_step, data, placement = stepping
        per_step = time_steps(multi_step, data, 10)
        print(f"[{cfg.name}] done in {total:.1f}s; {per_step * 1e3:.2f} "
              "ms/step", flush=True)
        logger.close()
        if mesh is not None:
            # every metric below reads the whole parameters
            trained = parallel_auto.gather(trained, placement, mesh)
        with torch.no_grad():
            terms = _scalar_terms(model.elbo_terms(trained, Y_train, mcfg))
    result = {"config": cfg.name, "data": tag, "steps": steps,
              "seconds": round(total, 2),
              # None (valid JSON), not NaN, where no step was timed
              "ms_per_step": (round(per_step * 1e3, 3)
                              if per_step == per_step else None),
              **terms, **extra}
    if cfg.restarts > 1:
        result["restart_elbos"] = [round(e, 3) for e in restart_elbos]
    if cfg.model == "bgplvm" and cfg.dataset == "toy_gplvm":
        result.update(ard_metrics(bgplvm.constrain(trained)["ard"]))
        print(f"[{cfg.name}] ard={result['ard_weights']} "
              f"recall={result['ard_recall_top2']} "
              f"sep={result['ard_separation_ratio']:.1f}", flush=True)
    if views:
        result.update(_cross_view(
            trained, Y_train, Ys_test, mcfg,
            MRD_SVI_PREDICT_STEPS if svi else MRD_PREDICT_STEPS))
        print(f"[{cfg.name}] cross-view mse={result['cross_view_mse']:.4f} "
              f"(baseline {result['cross_view_mse_baseline']:.4f}, ratio "
              f"{result['cross_view_mse_ratio']:.3f}) "
              f"pll={result['cross_view_pll_per_dim']:.4f} "
              f"calib={result['calibration_ratio']:.2f} "
              f"sig={result['ard_cross_private_ratio']:.4f} "
              f"({result['cross_view_seconds']:.2f}s)", flush=True)
    if imputing:
        if svi:
            def impute_fn(y, mask):
                return svi_gplvm.impute(trained, y, mask, mcfg,
                                        num_steps=impute_steps)
        else:
            def impute_fn(y, mask):
                return prediction.impute_dp(trained, Y_train, mcfg, y, mask,
                                            num_steps=impute_steps)
        result.update(_impute(impute_fn, Y_test,
                              _last_dims_missing(Y_test,
                                                 cfg.missing_fraction)))
        print(f"[{cfg.name}] imputation mse={result['imputation_mse']:.4f} "
              f"pll={result['predictive_loglik_per_dim']:.4f} "
              f"({result['imputation_seconds']:.2f}s for "
              f"{result['imputation_rows']} rows)", flush=True)
    if cfg.model == "dp_svi" and grouped:
        # the even dims observed (every group keeps some, so its latent
        # stays identifiable), the odd ones imputed from the phi-weighted
        # q(u | t) mixture alone
        mask = torch.zeros_like(Y_test)
        mask[:, ::2] = 1.0
        result.update(_impute(
            lambda y, m: dp_svi.impute(trained, y, m, mcfg,
                                       num_steps=impute_steps),
            Y_test, mask, baseline=True))
        labels = np.repeat(np.arange(4), grouped_dims_per_group(cfg.d))
        with torch.no_grad():
            phi = dp_svi.expected_assignments(trained).cpu().numpy()
        result.update(group_recovery(phi, labels))
        print(f"[{cfg.name}] imputation mse={result['imputation_mse']:.4f} "
              f"(baseline {result['imputation_mse_baseline']:.4f}) "
              f"pll={result['predictive_loglik_per_dim']:.4f} "
              f"({result['imputation_seconds']:.2f}s, "
              f"{result['imputation_rows']} rows); group purities "
              f"{result['group_purities']}, distinct atoms "
              f"{result['distinct_atoms_for_groups']}/"
              f"{result['num_groups']}", flush=True)
    if out is not None:
        # the SVI and MRD exports are of the raw parameters, which their
        # serving entry points take; the other collapsed models export
        # constrained values
        export_npz(os.path.join(out, "params.npz"),
                   dict(trained) if svi or views
                   else model.constrain(trained))
        with open(os.path.join(out, "result.json"), "w") as fh:
            json.dump(result, fh, indent=2)
    if plots:
        _plot(cfg, trained, Y_train, out)
    print(json.dumps(result), flush=True)
    return result


def _plot(cfg, trained, Y_train, out):
    """The reference's --plots: the latent scatter (an amortized model's
    encoded training rows, at most 4096), the ARD weights and, for the
    DP-GP-LVM, the assignments and the sticks, as PNGs in `out`."""
    def host(x):
        return x.detach().cpu().numpy()

    with torch.no_grad():
        if "qx_mean" in trained:
            qx = trained["qx_mean"]
        else:
            ys = Y_train if isinstance(Y_train, tuple) else (Y_train,)
            qx, _ = amortized.encode(trained, torch.cat(
                [y[:4096] for y in ys], dim=1))
        viz.plot_latent_scatter(host(qx),
                                path=os.path.join(out, "latent.png"))
        ard = os.path.join(out, "ard.png")
        if cfg.model == "bgplvm":
            viz.plot_ard_weights(host(bgplvm.constrain(trained)["ard"]),
                                 path=ard)
        elif cfg.model in ("mrd", "mrd_svi"):
            viz.plot_ard_weights(host(MODELS[cfg.model].ard_relevance(
                trained)), path=ard)
        elif cfg.model == "dp_gp_lvm":
            hyp = dp_gp_lvm.constrain(trained)
            viz.plot_ard_weights(host(hyp["ard"]), path=ard)
            viz.plot_assignment_matrix(
                host(hyp["phi"]), path=os.path.join(out, "assignments.png"))
            if hyp["gamma1"].numel():
                viz.plot_stick_weights(
                    host(hyp["gamma1"]), host(hyp["gamma2"]),
                    path=os.path.join(out, "sticks.png"))
    print(f"plots saved to {out}", flush=True)


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
    ap.add_argument("--batch", type=int, default=None,
                    help="SVI configs: rows a step (default 1024; the "
                         "DP-SVI's 2048)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="SVI configs: checkpoint every this many steps, "
                         "in <out>/ckpt (a multiple of the chunk)")
    ap.add_argument("--resume", action="store_true",
                    help="SVI configs: resume from the latest checkpoint "
                         "in <out>/ckpt (the staged DP-SVI: after the last "
                         "stage boundary in <out>/stages; the staged "
                         "MRD-SVI: phase B from <out>/stages/phaseA.npz); "
                         "the run continues bit for bit")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="SVI configs: stop the loop after this many steps "
                         "(schedules still span --steps)")
    ap.add_argument("--inject-nonfinite-at", type=int, default=None,
                    metavar="STEP",
                    help="SVI configs, fault injection: treat chunk losses "
                         "as NaN from this step on (the abort, exit 3)")
    ap.add_argument("--stream", action="store_true",
                    help="SVI configs: feed the minibatches from the host "
                         "(data/stream.py: an mmap of <out>/y_stream.f32 "
                         "and a native gather into pinned buffers) instead "
                         "of gathering them from a resident Y (the MRD-SVI "
                         "with --staged off only)")
    ap.add_argument("--data-dir", default=None,
                    help="directory with real oil-flow (DataTrn.txt, "
                         "DataTrnLbls.txt) or AMC files; without the files "
                         "the surrogate is drawn")
    ap.add_argument("--ard-lr", type=float, default=None,
                    help="override config.ard_lr (raw_ard's own Adam rate)")
    ap.add_argument("--plots", action="store_true",
                    help="save latent/ARD/assignment plots to the out dir "
                         "(needs matplotlib; checked before training)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly mode and a finite check of every "
                         "step's loss: raise at the first non-finite one")
    ap.add_argument("--eager", action="store_true",
                    help="on the card, run every step one PyTorch call at "
                         "a time instead of replaying the chunks from CUDA "
                         "graphs (debugging)")
    ap.add_argument("--staged", choices=("on", "off"), default=None,
                    help="mrd_svi: the two-phase recipe of "
                         "train/mrd_recipe.py (on) or one phase at the "
                         "config's rates (off); default: the config's "
                         "`staged`")
    ap.add_argument("--mesh", default=None, metavar="DATA[,MODEL]",
                    help="train on a mesh of ranks, rows (the SVI "
                         "configs: each batch's rows) over DATA, DP atoms "
                         "over MODEL, under torchrun --nproc-per-node "
                         "DATA*MODEL (gloo on the CPU; on the card 1 or "
                         "1,1, over NCCL)")
    args = ap.parse_args(argv)

    cfg = config_lib.get(args.config)
    overrides = {k: v for k, v in (("n", args.n), ("restarts", args.restarts),
                                   ("lr", args.lr)) if v}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.ard_lr is not None:
        overrides["ard_lr"] = args.ard_lr
    cfg = dataclasses.replace(cfg, **overrides)
    out = args.out or str(ROOT / "build" / "runs" / cfg.name)
    with contextlib.ExitStack() as stack:
        if args.mesh:
            stack.callback(mesh_lib.close_distributed)
        if args.mesh and int(os.environ.get("RANK", 0)) != 0:
            # on a mesh rank 0 prints; the other ranks train quietly
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        stack.enter_context(
            torch.autograd.set_detect_anomaly(args.debug_nans))
        result = run(cfg, steps=args.steps, device=args.device,
                     dtype=torch.float64 if args.f64 else torch.float32,
                     out=out, log_every=args.log_every,
                     hyper_lr=args.hyper_lr, ngd_lr=args.ngd_lr,
                     batch=args.batch, ckpt_every=args.ckpt_every,
                     resume=args.resume, stop_after=args.stop_after,
                     inject_nonfinite_at=args.inject_nonfinite_at,
                     stream=args.stream,
                     staged=(None if args.staged is None
                             else args.staged == "on"),
                     data_dir=args.data_dir, plots=args.plots,
                     debug_nans=args.debug_nans, mesh=args.mesh,
                     eager=args.eager)
        if not args.check:
            return 0
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
