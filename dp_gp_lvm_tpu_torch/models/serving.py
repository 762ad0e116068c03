"""Build-once serving closures for trained models (counterpart of
`dp_gp_lvm_tpu/models/serving.py`: the Bayesian GP-LVM's, the
DP-GP-LVM's and the minibatch DP-GP-LVM's imputers, the amortized models'
one-pass encoder imputer, MRD's cross-view predictor and the minibatch
MRD's q(u)-only one).

Serving means repeated missing-data imputation against a FIXED trained
model. A factory does all the train-data-dependent work once (the
posterior cache, through the fused kernels on the card), closes over it,
and returns a plain function:

    imputer = make_dp_imputer(params, Y_train, config, num_steps=150)
    mean, var = imputer(y_batch, mask_batch)

Nothing is compiled or captured: each request runs eagerly.
"""
from __future__ import annotations

from typing import Callable

import torch

from dp_gp_lvm_tpu_torch.core.types import (
    JitterPolicy,
    pin_full_f32,
    resolve_device,
)
from dp_gp_lvm_tpu_torch.models import (
    amortized,
    bgplvm,
    dp_gp_lvm,
    dp_svi,
    mrd,
    mrd_svi,
    prediction,
    svi_gplvm,
)

# tol="auto" serves a batch of at most TOL_MAX_BATCH rows with early
# stopping and a larger one with the fixed unroll. The crossover is
# inherited from the reference, where it was measured on another
# accelerator; it is part of what `_resolve` returns and so is carried,
# but it has NOT been measured on the H100. Here the early-stopping loop
# also costs one host sync per step (`prediction._fit_variational`).
TOL_MAX_BATCH = 4
AUTO_TOL = 1e-5
AUTO_TOL_CAP = 300      # step cap in tol mode (early exit governs)


def _resolve(tol, num_steps, batch: int):
    """(tol, num_steps) for one batch size. tol="auto" picks by batch
    size; an explicit float or None is honored as given."""
    if tol == "auto":
        if batch <= TOL_MAX_BATCH:
            return AUTO_TOL, max(num_steps, AUTO_TOL_CAP)
        return None, num_steps
    return tol, num_steps


def _on_device(params, Y, device):
    device = resolve_device(device)
    if device.type == "cuda":
        pin_full_f32()
    return ({k: v.detach().to(device) for k, v in params.items()},
            Y.to(device), device)


def _mrd_on_device(params, Ys, device):
    """MRD's parameters (with their `views` list) and views on `device`."""
    top = {k: v for k, v in params.items() if k != "views"}
    top, _, device = _on_device(top, Ys[0], device)
    top["views"] = [{k: v.detach().to(device) for k, v in vp.items()}
                    for vp in params["views"]]
    return top, [Y.to(device) for Y in Ys], device


def make_bgplvm_imputer(params, Y, config: bgplvm.Config,
                        num_steps: int = 150, lr: float = 0.05,
                        tol: float | str | None = "auto",
                        device=None) -> Callable:
    """Returns `impute(y_star, mask) -> (mean, var)` on `device` (the card
    unless the caller says "cpu"). tol="auto" picks the latent-inference
    mode per batch size; a float forces early stopping, None the fixed
    unroll (num_steps stays the cap either way)."""
    params, Y, device = _on_device(params, Y, device)
    cache = prediction.bgplvm_posterior(params, Y, config)
    qx_mean = params["qx_mean"]

    def impute(y_star, mask):
        y_star, mask = y_star.to(device), mask.to(device)
        t, steps = _resolve(tol, num_steps, y_star.shape[0])
        m0 = prediction.init_latent_from_nearest(qx_mean, Y, y_star, mask)
        m_s, s_s, _ = prediction.infer_latent(
            cache, y_star, mask, m0, steps, lr, kernel=config.kernel, tol=t)
        with torch.no_grad():
            return prediction.predict_from_latent(cache, m_s, s_s,
                                                  kernel=config.kernel)

    return impute


def make_dp_imputer(params, Y, config: dp_gp_lvm.Config,
                    num_steps: int = 150, lr: float = 0.05,
                    tol: float | str | None = "auto",
                    device=None) -> Callable:
    """Returns `impute(y_star, mask) -> (mean, var)` mixing atoms, on
    `device` (the card unless the caller says "cpu")."""
    params, Y, device = _on_device(params, Y, device)
    caches, phi = prediction.dp_posterior(params, Y, config)
    qx_mean = params["qx_mean"]

    def impute(y_star, mask):
        y_star, mask = y_star.to(device), mask.to(device)
        t, steps = _resolve(tol, num_steps, y_star.shape[0])
        m0 = prediction.init_latent_from_nearest(qx_mean, Y, y_star, mask)
        m_s, s_s, _ = prediction.dp_infer_latent(
            caches, phi, y_star, mask, m0, steps, lr, kernel=config.kernel,
            tol=t)
        with torch.no_grad():
            return prediction.dp_predict_from_latent(caches, phi, m_s, s_s,
                                                     kernel=config.kernel)

    return impute


def make_dp_svi_imputer(params, config: dp_svi.Config, num_steps: int = 150,
                        lr: float = 0.05, tol: float | str | None = "auto",
                        device=None) -> Callable:
    """Returns `impute(y_star, mask) -> (mean, var)` for the minibatch
    DP-GP-LVM on `device` (the card unless the caller says "cpu"), from
    its explicit per-atom q(u | t) alone: no training Y. The build factors
    the atoms' K_uu (one host read) and predicts the nearest-latent init's
    candidates, every (N // 2048)-th training latent (an amortized model
    has none: its encoder's pass over a request's rows is the init); a
    request then runs latent inference and the mixture predictive with no
    factorization."""
    device = resolve_device(device)
    if device.type == "cuda":
        pin_full_f32()
    params = {k: v.detach().to(device) for k, v in params.items()}
    pred = dp_svi._predictive(params, config)
    candidates = dp_svi._candidates(pred)

    def impute(y_star, mask):
        y_star, mask = y_star.to(device), mask.to(device)
        t, steps = _resolve(tol, num_steps, y_star.shape[0])
        m0 = dp_svi._nearest(candidates, y_star, mask, pred.c)
        m_s, s_s, _ = dp_svi._infer(pred, y_star, mask, m0, steps, lr, t)
        with torch.no_grad():
            return dp_svi._mixture(pred, m_s, s_s)

    return impute


def make_encoder_imputer(params, config, model: str = "svi_gplvm",
                         refine_steps: int = 0, lr: float = 0.05,
                         device=None) -> Callable:
    """One-pass serving of an amortized model (`models/amortized.py`, the
    SVI-GPLVM's or, with model="dp_svi", the DP-SVI's): returns
    `impute(y_star, mask) -> (mean, var)` on `device` (the card unless the
    caller says "cpu"). A request encodes its rows with the missing dims
    filled at the encoder's centre, q(x*) = encode(y*), and predicts every
    dim from q(u): no inference loop. With refine_steps > 0 that many
    masked expected-log-likelihood steps of latent inference (the fixed
    unroll, no host sync) start from the encoded means first.

    As in the reference, the encoded variance is served without the
    model's `qx_var_floor` (its leaves are constrained with no config),
    while the predictive binds the config's noise floor. The build
    constrains the parameters and factors K_uu once (one host read)."""
    if model not in ("svi_gplvm", "dp_svi"):
        raise ValueError(f"model must be 'svi_gplvm'|'dp_svi', got {model!r}")
    device = resolve_device(device)
    if device.type == "cuda":
        pin_full_f32()
    params = {k: v.detach().to(device) for k, v in params.items()}
    if "enc_mean" not in params:
        raise ValueError("make_encoder_imputer needs amortized parameters "
                         "(Config.amortized=True); got a resident q(X) table")
    enc = amortized.encoder_leaves(params)              # no config: no floor
    if model == "svi_gplvm":
        c = svi_gplvm._detached(params, config)
        L = svi_gplvm._kuu_factor(c, config, JitterPolicy())

        def infer(y_star, mask, m0):
            return svi_gplvm._infer(c, L, y_star, mask, m0, config,
                                    refine_steps, lr, None)[:2]

        def predict(m_s, s_s):
            return svi_gplvm._predict(c, L, m_s, s_s, config)
    else:
        pred = dp_svi._predictive(params, config)

        def infer(y_star, mask, m0):
            return dp_svi._infer(pred, y_star, mask, m0, refine_steps, lr,
                                 None)[:2]

        def predict(m_s, s_s):
            return dp_svi._mixture(pred, m_s, s_s)

    def impute(y_star, mask):
        y_star, mask = y_star.to(device), mask.to(device)
        with torch.no_grad():
            y_fill = torch.where(mask > 0, y_star, enc["enc_mean"][None, :])
            m_s, s_s = amortized.encode(enc, y_fill)
        if refine_steps:
            m_s, s_s = infer(y_star, mask, m_s)
        with torch.no_grad():
            return predict(m_s, s_s)

    return impute


def make_mrd_cross_view_predictor(params, Ys, config: mrd.Config,
                                  observed_view: int, target_view: int,
                                  num_steps: int = 150, lr: float = 0.05,
                                  tol: float | str | None = "auto",
                                  device=None) -> Callable:
    """Returns `predict(y_observed_view) -> (mean, var)` of the target view
    on `device` (the card unless the caller says "cpu"). The per-view
    posterior caches are built once; tol="auto" picks the latent-inference
    mode per batch size."""
    params, Ys, device = _mrd_on_device(params, Ys, device)
    caches = prediction.mrd_posterior(params, Ys, config)
    qx_mean = params["qx_mean"]
    Y_obs_train = Ys[observed_view]

    def predict(y_obs):
        y_obs = y_obs.to(device)
        t, steps = _resolve(tol, num_steps, y_obs.shape[0])
        m0 = prediction.init_latent_from_nearest(
            qx_mean, Y_obs_train, y_obs, torch.ones_like(y_obs))
        m_s, s_s, _ = prediction.mrd_infer_latent(
            caches, {observed_view: y_obs}, m0, steps, lr,
            kernel=config.kernel, tol=t)
        with torch.no_grad():
            return prediction.predict_from_latent(
                caches[target_view], m_s, s_s, kernel=config.kernel)

    return predict


def make_mrd_svi_predictor(params, config: mrd_svi.Config,
                           observed_view: int, target_view: int,
                           num_steps: int = 150, lr: float = 0.05,
                           tol: float | str | None = "auto",
                           device=None) -> Callable:
    """Cross-view serving of the minibatch MRD (`models/mrd_svi.py`):
    returns `predict(y_observed_view) -> (mean, var)` of the target view on
    `device` (the card unless the caller says "cpu"), from the explicit
    q(u^v) alone, with no training data in the closure. The build puts
    the parameters on the device once, factors the two views' K_uu (a
    host read each) and, for a resident q(X), predicts the nearest-latent
    init's candidate table of the observed view; a request then runs the
    latent inference and the target view's predictive, with no
    factorization. tol="auto" picks the inference mode per batch size."""
    device = resolve_device(device)
    if device.type == "cuda":
        pin_full_f32()
    params = mrd_svi.on_device(params, device)
    policy = mrd_svi._policy(config, None)
    obs = mrd_svi._view_cache(params, observed_view, config, policy)
    c_t, L_t = mrd_svi._view_cache(params, target_view, config, policy)
    init_table = (None if "qx_mean" not in params
                  else mrd_svi.candidate_table(params, observed_view, config))
    scfg = mrd_svi._svi_config(config)

    def predict(y_obs):
        y_obs = y_obs.to(device)
        t, steps = _resolve(tol, num_steps, y_obs.shape[0])
        m0 = mrd_svi._latent_init(params, {observed_view: y_obs}, config,
                                  init_table)
        m_s, s_s, _ = mrd_svi._infer([(obs, y_obs)], m0, config, steps, lr,
                                     t)
        with torch.no_grad():
            return svi_gplvm._predict(c_t, L_t, m_s, s_s, scfg)

    return predict
