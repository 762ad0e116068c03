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

The reference jits that function once per batch shape; here each batch
size gets its own `_Shape`: static input buffers that a request copies
its rows into, and three steps on them, the latent init, the inference's
Adam step (`prediction.VariationalFit`) and the predictive. On the card
each is captured once as a CUDA graph (`train/loop.py::StepGraph`) on the
first request of that size and replayed by every later one: the fixed
unroll reads nothing back to the host, early stopping reads the
converged flag once a chunk of steps. `eager=True` (and the CPU) runs
the same steps one PyTorch call at a time; `train/loop.py::replayed`
decides which. Every request returns fresh tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_variational_var,
)
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
from dp_gp_lvm_tpu_torch.train.loop import StepGraph, replayed

# tol="auto" serves a batch of at most TOL_MAX_BATCH rows with early
# stopping and a larger one with the fixed unroll. The crossover is
# inherited from the reference, where it was measured on another
# accelerator; it is part of what `_resolve` returns and so is carried,
# but it has NOT been measured on the H100. Here the early-stopping loop
# also reads its converged flag back to the host once every
# `prediction.TOL_CHUNK` steps.
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


class _Plan(NamedTuple):
    """A request's computation on its static inputs. `init()` gives the
    latent means the inference starts from (or, with no `objective`, the
    q(x*) moments themselves); `objective` is the inference's
    (`VariationalFit`); `predict(m*, s*)` gives (mean, var), with s* =
    `s_of(raw_s)`."""

    init: Callable
    objective: Callable | None
    predict: Callable
    s_of: Callable = positive


class _Shape:
    """A server at one batch size: the static inputs, the inference's
    `VariationalFit` and the latent init and predictive as `StepGraph`s,
    all three graphs in one memory pool (they replay in turn). The first
    call of each step allocates what it writes: the fit's carry and the
    answer's buffers."""

    def __init__(self, plan: Callable, inputs, tol, num_steps: int,
                 lr: float, graphed: bool):
        self.inputs = [x.clone() for x in inputs]
        self.plan = plan(*self.inputs)
        pool = torch.cuda.graph_pool_handle() if graphed else None
        self.fit = None if self.plan.objective is None else \
            prediction.VariationalFit(self.plan.objective, num_steps, lr,
                                      tol, graphed=graphed, pool=pool)
        self.out = None
        self.init = StepGraph(self._init, graphed, pool)
        self.predict = StepGraph(self._predict, graphed, pool)

    def _init(self) -> None:
        m0 = self.plan.init()
        self.fit.load(prediction._latent_var_params(m0,
                                                    self.inputs[0].dtype))

    def _predict(self) -> None:
        if self.fit is None:
            moments = self.plan.init()
        else:
            vp = self.fit.vp
            moments = (vp["m"].detach(), self.plan.s_of(vp["raw_s"].detach()))
        answer = self.plan.predict(*moments)
        if self.out is None:
            self.out = tuple(a.clone() for a in answer)
        else:
            for o, a in zip(self.out, answer):
                o.copy_(a)

    def __call__(self, *inputs):
        with torch.no_grad():
            for buf, x in zip(self.inputs, inputs):
                if x.shape != buf.shape:
                    raise ValueError(f"a request of shape {tuple(x.shape)} "
                                     f"for a server of {tuple(buf.shape)}")
                buf.copy_(x)
        if self.fit is not None:
            self.init.run(1)
            self.fit.run()
        with torch.no_grad():
            self.predict.run(1)
        return tuple(o.clone() for o in self.out)


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


def _server(plan: Callable, device, tol, num_steps: int, lr: float,
            eager: bool) -> Callable:
    """The request function of a factory: `plan(*static_inputs) -> _Plan`
    on the rows of a request (batch first), one `_Shape` per batch size,
    replayed from CUDA graphs on the card unless `eager`."""
    shapes = {}
    graphed = replayed(device, None, eager)

    def serve(*inputs):
        batch = inputs[0].shape[0]
        if batch not in shapes:
            shapes[batch] = _Shape(plan, [x.to(device) for x in inputs],
                                   *_resolve(tol, num_steps, batch), lr,
                                   graphed)
        return shapes[batch](*inputs)

    serve.shapes = shapes
    return serve


def make_bgplvm_imputer(params, Y, config: bgplvm.Config,
                        num_steps: int = 150, lr: float = 0.05,
                        tol: float | str | None = "auto",
                        device=None, eager: bool = False) -> Callable:
    """Returns `impute(y_star, mask) -> (mean, var)` on `device` (the card
    unless the caller says "cpu"). tol="auto" picks the latent-inference
    mode per batch size; a float forces early stopping, None the fixed
    unroll (num_steps stays the cap either way). `eager` runs requests
    without CUDA graphs."""
    params, Y, device = _on_device(params, Y, device)
    cache = prediction.bgplvm_posterior(params, Y, config)
    qx_mean = params["qx_mean"]

    def plan(y_star, mask):
        return _Plan(
            lambda: prediction.init_latent_from_nearest(qx_mean, Y, y_star,
                                                        mask),
            prediction._latent_objective(cache, y_star, mask, config.kernel),
            lambda m, s: prediction.predict_from_latent(
                cache, m, s, kernel=config.kernel))

    return _server(plan, device, tol, num_steps, lr, eager)


def make_dp_imputer(params, Y, config: dp_gp_lvm.Config,
                    num_steps: int = 150, lr: float = 0.05,
                    tol: float | str | None = "auto",
                    device=None, eager: bool = False) -> Callable:
    """Returns `impute(y_star, mask) -> (mean, var)` mixing atoms, on
    `device` (the card unless the caller says "cpu")."""
    params, Y, device = _on_device(params, Y, device)
    caches, phi = prediction.dp_posterior(params, Y, config)
    qx_mean = params["qx_mean"]

    def plan(y_star, mask):
        return _Plan(
            lambda: prediction.init_latent_from_nearest(qx_mean, Y, y_star,
                                                        mask),
            prediction._dp_objective(caches, phi, y_star, mask,
                                     config.kernel),
            lambda m, s: prediction.dp_predict_from_latent(
                caches, phi, m, s, kernel=config.kernel))

    return _server(plan, device, tol, num_steps, lr, eager)


def make_dp_svi_imputer(params, config: dp_svi.Config, num_steps: int = 150,
                        lr: float = 0.05, tol: float | str | None = "auto",
                        device=None, eager: bool = False) -> Callable:
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

    def plan(y_star, mask):
        return _Plan(
            lambda: dp_svi._nearest(candidates, y_star, mask, pred.c),
            dp_svi._objective(pred, y_star, mask),
            lambda m, s: dp_svi._mixture(pred, m, s),
            positive_variational_var)

    return _server(plan, device, tol, num_steps, lr, eager)


def make_encoder_imputer(params, config, model: str = "svi_gplvm",
                         refine_steps: int = 0, lr: float = 0.05,
                         device=None, eager: bool = False) -> Callable:
    """One-pass serving of an amortized model (`models/amortized.py`, the
    SVI-GPLVM's or, with model="dp_svi", the DP-SVI's): returns
    `impute(y_star, mask) -> (mean, var)` on `device` (the card unless the
    caller says "cpu"). A request encodes its rows with the missing dims
    filled at the encoder's centre, q(x*) = encode(y*), and predicts every
    dim from q(u): no inference loop. With refine_steps > 0 that many
    masked expected-log-likelihood steps of latent inference (the fixed
    unroll) start from the encoded means first.

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

        def objective(y_star, mask):
            return svi_gplvm._objective(c, L, y_star, mask, config)

        def predict(m_s, s_s):
            return svi_gplvm._predict(c, L, m_s, s_s, config)
    else:
        pred = dp_svi._predictive(params, config)

        def objective(y_star, mask):
            return dp_svi._objective(pred, y_star, mask)

        def predict(m_s, s_s):
            return dp_svi._mixture(pred, m_s, s_s)

    def plan(y_star, mask):
        def encoded():
            y_fill = torch.where(mask > 0, y_star, enc["enc_mean"][None, :])
            moments = amortized.encode(enc, y_fill)
            return moments[0] if refine_steps else moments

        return _Plan(encoded,
                     objective(y_star, mask) if refine_steps else None,
                     predict, positive_variational_var)

    return _server(plan, device, None, refine_steps, lr, eager)


def make_mrd_cross_view_predictor(params, Ys, config: mrd.Config,
                                  observed_view: int, target_view: int,
                                  num_steps: int = 150, lr: float = 0.05,
                                  tol: float | str | None = "auto",
                                  device=None, eager: bool = False
                                  ) -> Callable:
    """Returns `predict(y_observed_view) -> (mean, var)` of the target view
    on `device` (the card unless the caller says "cpu"). The per-view
    posterior caches are built once; tol="auto" picks the latent-inference
    mode per batch size."""
    params, Ys, device = _mrd_on_device(params, Ys, device)
    caches = prediction.mrd_posterior(params, Ys, config)
    qx_mean = params["qx_mean"]
    Y_obs_train = Ys[observed_view]

    def plan(y_obs):
        return _Plan(
            lambda: prediction.init_latent_from_nearest(
                qx_mean, Y_obs_train, y_obs, torch.ones_like(y_obs)),
            prediction._mrd_objective(caches, {observed_view: y_obs},
                                      config.kernel),
            lambda m, s: prediction.predict_from_latent(
                caches[target_view], m, s, kernel=config.kernel))

    return _server(plan, device, tol, num_steps, lr, eager)


def make_mrd_svi_predictor(params, config: mrd_svi.Config,
                           observed_view: int, target_view: int,
                           num_steps: int = 150, lr: float = 0.05,
                           tol: float | str | None = "auto",
                           device=None, eager: bool = False) -> Callable:
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

    def plan(y_obs):
        return _Plan(
            lambda: mrd_svi._latent_init(params, {observed_view: y_obs},
                                         config, init_table),
            mrd_svi._objective([(obs, y_obs)], config),
            lambda m, s: svi_gplvm._predict(c_t, L_t, m, s, scfg),
            positive_variational_var)

    return _server(plan, device, tol, num_steps, lr, eager)
