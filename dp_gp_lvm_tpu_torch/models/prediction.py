r"""Test-time latent inference, missing-data prediction and MRD's
cross-view prediction (counterpart of `dp_gp_lvm_tpu/models/prediction.py`).

Given a trained model and test points y* with only a subset of output dims
observed (mask = 1 where observed):

  1. hold the model fixed and fit q(x*) = N(m*, diag(s*)) per test point by
     Adam on the uncollapsed variational objective (expected log-likelihood
     of the observed dims under the trained optimal q(u), minus
     KL[q(x*) || N(0, I)]);
  2. predict every dim from the psi-statistic moments of q(x*):

        E[y*_d]   = psi1* w_d
        Var[y*_d] = sigma^2 + psi0* - tr(K^{-1} psi2*) + tr(Sigma_B psi2*)
                    + w_d^T psi2* w_d - (psi1* w_d)^2.

For DP-GP-LVM the cache carries a leading atom dim T and the predictions
mix over atoms with the assignment posterior phi. Every function below is
batch-polymorphic over that leading dim instead of vmapped: one
broadcasting call serves the (T, N*, M, M) stack. For MRD there is one
cache per view; the observed views' expected log-likelihoods fit the
shared q(x*), and the target view's cache predicts from it.

The posterior caches are built once per served model and go through the
fused CUDA kernels on the card (K6 and K5 for the Bayesian GP-LVM and for
each MRD view, K1 for the DP stack). The per-request psi statistics of
the test points are plain torch, as they are plain JAX outside any kernel
in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_inverse,
    positive_variational_var,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.distributions import gaussian
from dp_gp_lvm_tpu_torch.kernels import ard_rbf, linear
from dp_gp_lvm_tpu_torch.linalg import tri_solve
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, mrd
from dp_gp_lvm_tpu_torch.models.bound import (
    SuffStats,
    optimal_qu,
    suff_stats_from_psi,
)
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.train.loop import StepGraph, replayed

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam defaults


class PosteriorCache(NamedTuple):
    """Trained-model quantities reused across all test-time computation
    (detached); a DP cache carries a leading atom dim T on every field."""

    w: torch.Tensor         # (M, D) K_uu^{-1} m_u per dim
    L: torch.Tensor         # (M, M) chol(K_uu)
    LB: torch.Tensor        # (M, M) chol(I + beta L^{-1} Psi2 L^{-T})
    variance: torch.Tensor  # ()
    ard: torch.Tensor       # (Q,)
    z: torch.Tensor         # (M, Q)
    noise: torch.Tensor     # ()


@torch.no_grad()
def bgplvm_posterior(params, Y, config: bgplvm.Config,
                     policy: JitterPolicy = JitterPolicy()) -> PosteriorCache:
    hyp = bgplvm.constrain(params)
    p0, p1, p2 = dispatch.psi_stats(
        hyp["variance"], hyp["ard"], hyp["qx_mean"], hyp["qx_var"],
        hyp["z"], block_n=config.psi2_block, use_fused=config.use_fused,
        kernel=config.kernel,
    )
    kuu = dispatch.gram(hyp["variance"], hyp["ard"], hyp["z"],
                        kernel=config.kernel)
    stats = suff_stats_from_psi(p0, p1, p2, Y)
    w, L, LB = optimal_qu(kuu, stats, hyp["noise"], policy)
    return PosteriorCache(
        w=w, L=L, LB=LB, variance=hyp["variance"], ard=hyp["ard"],
        z=hyp["z"].detach(), noise=hyp["noise"],
    )


def _test_psi(cache: PosteriorCache, m_star, s_star, kernel="ard_rbf"):
    """Per-point psi statistics of the test points (no sum over n):
    psi0* (..., N*), psi1* (..., N*, M), psi2* (..., N*, M, M)."""
    if dispatch._kernel(kernel) is linear:
        v, ard = cache.variance, cache.ard
        p1 = linear.psi1(v, ard, m_star, s_star, cache.z)
        # per point: sigma_f^4 (Z A) (m m^T + diag(s)) (Z A)^T
        za = (cache.z * ard[..., None, :])[..., None, :, :]
        second = (m_star[:, :, None] * m_star[:, None, :]
                  + torch.diag_embed(s_star))
        p2 = (v * v)[..., None, None, None] * ((za @ second) @ za.mT)
        p0 = v[..., None] * torch.sum(
            ard[..., None, :] * (m_star * m_star + s_star), dim=-1)
        return p0, p1, p2
    p1 = ard_rbf.psi1(cache.variance, cache.ard, m_star, s_star, cache.z)
    # per-point psi2: the block formulation with each point its own block
    _, _, expo = ard_rbf._forward_pieces(
        cache.variance, cache.ard, m_star, s_star, cache.z,
        ard_rbf._log_e(cache.ard, cache.z),
    )
    v2 = (cache.variance * cache.variance)[..., None, None, None]
    p2 = v2 * torch.exp(torch.clamp(expo, max=0.0))
    p0 = cache.variance[..., None] * torch.ones(
        m_star.shape[0], dtype=m_star.dtype, device=m_star.device)
    return p0, p1, p2


def _trace_terms(cache: PosteriorCache, p2_star):
    """tr(K^{-1} psi2*) and tr(Sigma_B psi2*) per test point (..., N*):
    four triangular solves that broadcast the (..., 1, M, M) factors
    against the (..., N*, M, M) stack."""
    L, LB = cache.L[..., None, :, :], cache.LB[..., None, :, :]
    half = tri_solve(L, p2_star)                    # L^{-1} psi2*
    a = tri_solve(L, half.mT)                       # L^{-1} psi2* L^{-T}
    b = tri_solve(LB, a)
    c = tri_solve(LB, b.mT)                         # LB^{-1} . LB^{-T}
    return (torch.diagonal(a, dim1=-2, dim2=-1).sum(-1),
            torch.diagonal(c, dim1=-2, dim2=-1).sum(-1))


def _moments(cache: PosteriorCache, m_star, s_star, kernel):
    """(mean, quad, common): psi1* w (..., N*, D), w^T psi2* w (..., N*, D)
    and psi0* - tr(K^{-1} psi2*) + tr(Sigma_B psi2*) (..., N*, 1)."""
    p0, p1, p2 = _test_psi(cache, m_star, s_star, kernel)
    mean = p1 @ cache.w
    tr_kinv, tr_sigma_b = _trace_terms(cache, p2)
    quad = torch.einsum("...nij,...id,...jd->...nd", p2, cache.w, cache.w)
    return mean, quad, (p0 - tr_kinv + tr_sigma_b)[..., None]


def predict_from_latent(cache: PosteriorCache, m_star, s_star,
                        kernel="ard_rbf"):
    """Predictive mean (..., N*, D) and per-dim variance incl. noise."""
    mean, quad, common = _moments(cache, m_star, s_star, kernel)
    var = cache.noise[..., None, None] + common + quad - mean * mean
    return mean, torch.clamp(var, min=1e-12)


def _expected_loglik_terms(cache: PosteriorCache, y, m_star, s_star,
                           kernel="ard_rbf"):
    """E_{q(x*) q(u)}[log N(y_d | f_d, noise)] per (point, dim):
    (..., N*, D)."""
    mean, quad, common = _moments(cache, m_star, s_star, kernel)
    noise = cache.noise[..., None, None]
    # E[(y - a(x)^T u)^2] = y^2 - 2 y psi1 w + w^T psi2 w + tr(Sigma_B psi2)
    # + the conditional-GP variance correction (psi0 - tr(K^{-1} psi2))
    sq = y * y - 2.0 * y * mean + quad + common
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(noise)
                   + (1.0 / noise) * sq)


def _expected_loglik(cache: PosteriorCache, y, mask, m_star, s_star,
                     kernel="ard_rbf"):
    """The expected log-likelihood summed over the observed dims."""
    return torch.sum(
        _expected_loglik_terms(cache, y, m_star, s_star, kernel) * mask)


def init_latent_from_nearest(qx_mean, Y, y_star, mask):
    """m* init: latent mean of the masked-nearest training point."""
    d2 = torch.sum(
        mask[:, None, :] * (y_star[:, None, :] - Y[None, :, :]) ** 2, dim=-1
    )  # (N*, N)
    return qx_mean[torch.argmin(d2, dim=-1)]


# steps a tol-mode fit replays between two reads of its converged flag
# (`VariationalFit.run`). A read costs tens of µs; each step replayed
# after convergence costs a whole step (0.5-1.4 ms at batch 1 on an
# H100), so the chunk is short: at batch 1 of the c5 and M = 256 DP
# servers 5 measured from 0.3% slower to 2.2% faster than 10 and 2.5-6.9%
# faster than 25 (`chip_smoke.py`, serve_dp and m256, two runs).
TOL_CHUNK = 5


class VariationalFit:
    """Adam (optax's, no clip) on a test-time variational objective, the
    reference's scan (`dp_gp_lvm_tpu/models/prediction.py::
    _fit_variational`) with its whole carry in device tensors that stay put
    from one fit to the next: the variational parameters, Adam's mu and nu,
    a step counter t, the objective trace (num_steps,) and, in tol mode,
    the previous value, the streak, the converged flag and the count k of
    active steps. `load` starts a fit, `run` takes its steps; one step is
    a `StepGraph` body (captured once and replayed where `graphed`), and
    no step reads anything back to the host.

    tol=None: exactly num_steps steps.
    tol=r: early stopping once the relative objective change stays <= r
    for `patience` CONSECUTIVE steps. A step is the reference's
    `lax.cond(done, frozen, active)`: the active update is computed and
    every carry leaf, and the trace entry, is selected by the converged
    flag, so a frozen step passes the carry through to the bit. `run`
    reads the flag once every TOL_CHUNK steps and stops at the first
    chunk boundary after convergence; the trace repeats the last value
    from there, as the reference's does.

    anneal=True: cosine-decay the rate lr -> 0 over num_steps. The rate
    and Adam's bias corrections are computed in float64 from k (the
    reference's optax count, which frozen steps do not advance) and cast
    to the parameters' dtype."""

    def __init__(self, objective, num_steps: int, lr: float, tol=None,
                 patience: int = 5, anneal: bool = False,
                 graphed: bool = False, pool=None):
        self.objective, self.num_steps, self.lr = objective, num_steps, lr
        self.tol, self.patience, self.anneal = tol, patience, anneal
        self.vp = None
        self.graph = StepGraph(self._step, graphed, pool)

    def load(self, var_params) -> None:
        """Starts a fit at (a copy of) `var_params`. The first load
        allocates the carry; later ones write into it."""
        with torch.no_grad():
            if self.vp is None:
                self.vp = {k: v.detach().clone().requires_grad_()
                           for k, v in var_params.items()}
                any_p = next(iter(self.vp.values()))
                dev = any_p.device
                self.mu = {k: torch.zeros_like(v) for k, v in self.vp.items()}
                self.nu = {k: torch.zeros_like(v) for k, v in self.vp.items()}
                self.t = torch.zeros((), dtype=torch.int64, device=dev)
                self.k = self.t if self.tol is None else torch.zeros_like(
                    self.t)
                self.trace = torch.zeros(self.num_steps, dtype=any_p.dtype,
                                         device=dev)
                self.prev = torch.zeros((), dtype=any_p.dtype, device=dev)
                self.streak = torch.zeros_like(self.t)
                self.done = torch.zeros((), dtype=torch.bool, device=dev)
            for key, v in var_params.items():
                self.vp[key].copy_(v)
                self.mu[key].zero_()
                self.nu[key].zero_()
            for counter in (self.t, self.k, self.streak):
                counter.zero_()
            self.prev.fill_(math.inf)
            self.done.fill_(False)

    def _step(self) -> None:
        vp = self.vp
        keys = list(vp)
        with torch.enable_grad():
            val = self.objective(vp)
            grads = torch.autograd.grad(val, [vp[key] for key in keys])
        with torch.no_grad():
            # the trace keeps the parameters' dtype, whatever the
            # objective's (a request in another dtype than the model's)
            val = val.detach().to(self.trace.dtype)
            dtype = val.dtype
            count = self.k.to(torch.float64)
            rate = self.lr
            if self.anneal:
                rate = (self.lr * 0.5 * (1.0 + torch.cos(
                    math.pi * count / max(self.num_steps, 1)))).to(dtype)
            bc1 = (1.0 - B1 ** (count + 1.0)).to(dtype)
            bc2 = (1.0 - B2 ** (count + 1.0)).to(dtype)
            new = {}
            for key, g in zip(keys, grads):
                mu = (1.0 - B1) * g + B1 * self.mu[key]
                nu = (1.0 - B2) * (g * g) + B2 * self.nu[key]
                new[key] = (vp[key] - rate * (mu / bc1) / (
                    torch.sqrt(nu / bc2) + EPS), mu, nu)
            if self.tol is None:
                for key, (p, mu, nu) in new.items():
                    vp[key].copy_(p)
                    self.mu[key].copy_(mu)
                    self.nu[key].copy_(nu)
                self.trace.index_copy_(0, self.t.view(1), val.reshape(1))
                self.t.add_(1)
                return
            done, prev = self.done, self.prev
            small = torch.abs(prev - val) <= self.tol * (torch.abs(prev) + 1.0)
            streak = torch.where(small, self.streak + 1, 0)
            for key, (p, mu, nu) in new.items():
                vp[key].copy_(torch.where(done, vp[key], p))
                self.mu[key].copy_(torch.where(done, self.mu[key], mu))
                self.nu[key].copy_(torch.where(done, self.nu[key], nu))
            val = torch.where(done, prev, val)
            self.trace.index_copy_(0, self.t.view(1), val.reshape(1))
            self.prev.copy_(val)
            self.streak.copy_(torch.where(done, self.streak, streak))
            self.k.add_((~done).to(self.k.dtype))
            self.done.copy_(done | (streak >= self.patience))
            self.t.add_(1)

    def run(self) -> None:
        """The loaded fit's steps: num_steps of them, or in tol mode chunks
        of TOL_CHUNK with one read of the converged flag after each, until
        it is set or the cap is reached."""
        if self.tol is None:
            self.graph.run(self.num_steps)
            return
        ran = 0
        while ran < self.num_steps:
            n = min(TOL_CHUNK, self.num_steps - ran)
            self.graph.run(n)
            ran += n
            if bool(self.done):                  # the chunk's host read
                break
        with torch.no_grad():
            self.trace[ran:].copy_(self.prev.expand(self.num_steps - ran))


def _fit_variational(objective, var_params, num_steps, lr, tol=None,
                     patience: int = 5, anneal: bool = False):
    """One `VariationalFit` from `var_params`, run eagerly (see there for
    tol, patience and anneal). Returns (fitted_params, objective_trace
    (num_steps,), steps_taken as a 0-d device tensor)."""
    fit = VariationalFit(objective, num_steps, lr, tol, patience, anneal)
    fit.load(var_params)
    fit.run()
    return {key: v.detach() for key, v in fit.vp.items()}, fit.trace, fit.k


def _latent_var_params(m_init, dtype):
    return {
        "m": m_init.to(dtype),
        "raw_s": positive_inverse(0.1 * torch.ones_like(m_init)).to(dtype),
    }


def _latent_objective(cache: PosteriorCache, y_star, mask, kernel):
    """The negative test-time ELBO of q(x*) given the rows `y_star`
    observed where `mask` is 1."""

    def objective(vp):
        s = positive(vp["raw_s"])
        ell = _expected_loglik(cache, y_star, mask, vp["m"], s, kernel)
        return -(ell - gaussian.kl_to_standard_normal(vp["m"], s))

    return objective


def infer_latent(cache: PosteriorCache, y_star, mask, m_init,
                 num_steps: int = 200, lr: float = 0.05,
                 kernel: str = "ard_rbf", tol: float | None = None):
    """Optimize q(x*) = N(m*, diag(s*)) by Adam; `tol` enables early
    stopping on the relative objective change, num_steps stays the cap.
    Returns (m*, s*, objective trace)."""
    vp, trace, _ = _fit_variational(
        _latent_objective(cache, y_star, mask, kernel),
        _latent_var_params(m_init, y_star.dtype), num_steps, lr, tol)
    return vp["m"], positive(vp["raw_s"]), -trace


def impute_bgplvm(params, Y, config: bgplvm.Config, y_star, mask,
                  num_steps: int = 200, lr: float = 0.05,
                  tol: float | None = None):
    """Config-5 pipeline for the Bayesian GP-LVM: infer q(x*), predict all
    dims; returns (mean, var, m*, s*, objective trace)."""
    cache = bgplvm_posterior(params, Y, config)
    m0 = init_latent_from_nearest(params["qx_mean"].detach(), Y, y_star, mask)
    m_s, s_s, trace = infer_latent(cache, y_star, mask, m0, num_steps, lr,
                                   kernel=config.kernel, tol=tol)
    mean, var = predict_from_latent(cache, m_s, s_s, kernel=config.kernel)
    return mean, var, m_s, s_s, trace


# ---------------------------------------------------------------------------
# DP-GP-LVM: per-atom caches, phi-mixed predictions
# ---------------------------------------------------------------------------


@torch.no_grad()
def dp_posterior(params, Y, config: dp_gp_lvm.Config,
                 policy: JitterPolicy = JitterPolicy()):
    """PosteriorCache batched over atoms (leading dim T) and phi (D, T).
    The per-atom Psi2 and Psi1^T Y are K1's outputs on the card."""
    hyp = dp_gp_lvm.constrain(params)
    p0, p1y, p2, yty, n = dispatch.dp_batched_suffstats(
        hyp["variance"], hyp["ard"], hyp["qx_mean"], hyp["qx_var"], hyp["z"],
        Y, block_n=config.psi2_block, use_fused=config.use_fused,
        kernel=config.kernel,
    )
    kuu = dispatch.gram(hyp["variance"], hyp["ard"], hyp["z"],
                        kernel=config.kernel)
    stats = SuffStats(psi0=p0, psi1T_y=p1y, psi2=p2, yty=yty, n=n)
    # one batched optimal_qu: the safe Cholesky repairs the whole stack
    w, L, LB = optimal_qu(kuu, stats, hyp["noise"], policy)
    caches = PosteriorCache(
        w=w, L=L, LB=LB, variance=hyp["variance"], ard=hyp["ard"],
        z=hyp["z"].detach(), noise=hyp["noise"],
    )
    return caches, hyp["phi"]


def dp_predict_from_latent(caches: PosteriorCache, phi, m_star, s_star,
                           kernel="ard_rbf"):
    """Mixture predictive: mean/var (N*, D) mixing atoms by phi (D, T)."""
    means, vars_ = predict_from_latent(caches, m_star, s_star, kernel)
    w = phi.T[:, None, :]                                # (T, 1, D)
    mean = torch.sum(w * means, dim=0)
    # cancellation-free mixture variance (not E[m^2] - mean^2): every term
    # is non-negative by construction
    dev = means - mean[None]
    return mean, torch.clamp(torch.sum(w * (vars_ + dev * dev), dim=0),
                             min=1e-12)


def _dp_objective(caches: PosteriorCache, phi, y_star, mask, kernel):
    """The negative test-time ELBO under the DP mixture: the
    phi-weighted expected log-likelihood of the observed dims."""
    phi_t = phi.T[:, None, :]

    def objective(vp):
        s = positive(vp["raw_s"])
        ll_t = _expected_loglik_terms(caches, y_star, vp["m"], s, kernel)
        ell = torch.sum(torch.sum(ll_t * phi_t, dim=0) * mask)
        return -(ell - gaussian.kl_to_standard_normal(vp["m"], s))

    return objective


def dp_infer_latent(caches: PosteriorCache, phi, y_star, mask, m_init,
                    num_steps: int = 200, lr: float = 0.05,
                    kernel: str = "ard_rbf", tol: float | None = None):
    """q(x*) inference under the DP mixture: phi-weighted expected
    log-likelihood. Returns (m*, s*, objective trace)."""
    vp, trace, _ = _fit_variational(
        _dp_objective(caches, phi, y_star, mask, kernel),
        _latent_var_params(m_init, m_init.dtype), num_steps, lr, tol)
    return vp["m"], positive(vp["raw_s"]), -trace


def impute_dp(params, Y, config: dp_gp_lvm.Config, y_star, mask,
              num_steps: int = 200, lr: float = 0.05,
              tol: float | None = None):
    """Config-5 pipeline for DP-GP-LVM."""
    caches, phi = dp_posterior(params, Y, config)
    m0 = init_latent_from_nearest(params["qx_mean"].detach(), Y, y_star, mask)
    m_s, s_s, trace = dp_infer_latent(caches, phi, y_star, mask, m0,
                                      num_steps, lr, kernel=config.kernel,
                                      tol=tol)
    mean, var = dp_predict_from_latent(caches, phi, m_s, s_s,
                                       kernel=config.kernel)
    return mean, var, m_s, s_s, trace


# ---------------------------------------------------------------------------
# MRD: infer the shared latent from the observed views, predict another
# ---------------------------------------------------------------------------


def _expected_loglik_per_point(cache: PosteriorCache, y, mask, m_star,
                               s_star, kernel="ard_rbf"):
    """(N*,) per-point sums of the expected log-likelihood: q(x*) factorizes
    over test points, so each point's value scores its own restarts."""
    return torch.sum(
        _expected_loglik_terms(cache, y, m_star, s_star, kernel) * mask,
        dim=-1)


def init_latent_knn(qx_mean, Y, y_star, mask, k: int):
    """(k, N*, Q) inits: the latent means of the k masked-nearest training
    rows, nearest first (ties to the lower row, as `lax.top_k` breaks
    them)."""
    d2 = torch.sum(
        mask[:, None, :] * (y_star[:, None, :] - Y[None, :, :]) ** 2, dim=-1
    )  # (N*, N)
    idx = torch.sort(d2, dim=-1, stable=True).indices[:, :k]     # (N*, k)
    return qx_mean[idx].transpose(0, 1)


@torch.no_grad()
def mrd_posterior(params, Ys, config: mrd.Config,
                  policy: JitterPolicy = JitterPolicy()):
    """One PosteriorCache per view (a list: the views' D differ). On the
    card each view's psi statistics are K6 and K5, one launch each."""
    mu = params["qx_mean"]
    s = positive_variational_var(params["raw_qx_var"])
    caches = []
    for vp, Y in zip(params["views"], Ys):
        hyp = mrd.constrain_view(vp)
        p0, p1, p2 = dispatch.psi_stats(
            hyp["variance"], hyp["ard"], mu, s, hyp["z"],
            block_n=config.psi2_block, use_fused=config.use_fused,
            kernel=config.kernel,
        )
        kuu = dispatch.gram(hyp["variance"], hyp["ard"], hyp["z"],
                            kernel=config.kernel)
        stats = suff_stats_from_psi(p0, p1, p2, Y)
        w, L, LB = optimal_qu(kuu, stats, hyp["noise"], policy)
        caches.append(PosteriorCache(
            w=w, L=L, LB=LB, variance=hyp["variance"], ard=hyp["ard"],
            z=hyp["z"].detach(), noise=hyp["noise"],
        ))
    return caches


def _mrd_objective(caches, observed: dict, kernel):
    """The negative test-time ELBO of the shared q(x*) given the observed
    views (`observed`: view index -> (N*, D_v))."""
    items = sorted(observed.items())

    def objective(vp):
        s = positive(vp["raw_s"])
        ell = 0.0
        for v_idx, y in items:
            ell = ell + _expected_loglik(caches[v_idx], y,
                                         torch.ones_like(y), vp["m"], s,
                                         kernel)
        return -(ell - gaussian.kl_to_standard_normal(vp["m"], s))

    return objective


def mrd_infer_latent(caches, observed: dict, m_init, num_steps: int = 200,
                     lr: float = 0.05, kernel: str = "ard_rbf",
                     tol: float | None = None, anneal: bool = False):
    """Fit q(x*) from the observed views (`observed`: view index ->
    (N*, D_v)). Returns (m*, s*, objective trace)."""
    vp, trace, _ = _fit_variational(
        _mrd_objective(caches, observed, kernel),
        _latent_var_params(m_init, m_init.dtype), num_steps, lr, tol,
        anneal=anneal)
    return vp["m"], positive(vp["raw_s"]), -trace


def _per_point_objective(caches, items, m, s, kernel):
    """(N*,) separable test-time ELBO: sum_v ELL_v(n) - KL(n)."""
    ell = 0.0
    for v_idx, y in items:
        ell = ell + _expected_loglik_per_point(caches[v_idx], y,
                                               torch.ones_like(y), m, s,
                                               kernel)
    kl = 0.5 * torch.sum(m * m + s - torch.log(s) - 1.0, dim=-1)
    return ell - kl


def mrd_infer_latent_restarts(caches, observed: dict, m_inits,
                              num_steps: int = 200, lr: float = 0.05,
                              kernel: str = "ard_rbf",
                              tol: float | None = None,
                              anneal: bool = False):
    """Latent inference from each of the (K, N*, Q) `m_inits`, the best
    restart kept per point by its own test-time ELBO (the joint objective
    is separable over points). The restarts share one `VariationalFit`:
    on the card its step is captured once and replayed for every restart.
    Returns (m (N*, Q), s (N*, Q), per-point objective (N*,))."""
    items = sorted(observed.items())
    fit = VariationalFit(_mrd_objective(caches, observed, kernel), num_steps,
                         lr, tol, anneal=anneal,
                         graphed=replayed(m_inits.device, None, False))
    ms, ss, objs = [], [], []
    for k in range(m_inits.shape[0]):
        fit.load(_latent_var_params(m_inits[k], m_inits.dtype))
        fit.run()
        m_k = fit.vp["m"].detach().clone()
        s_k = positive(fit.vp["raw_s"].detach())
        with torch.no_grad():
            objs.append(_per_point_objective(caches, items, m_k, s_k,
                                             kernel))
        ms.append(m_k)
        ss.append(s_k)
    ms, ss, objs = torch.stack(ms), torch.stack(ss), torch.stack(objs)
    best = torch.argmax(objs, dim=0)                     # (N*,)
    n_idx = torch.arange(ms.shape[1], device=ms.device)
    return ms[best, n_idx], ss[best, n_idx], objs[best, n_idx]


def predict_view_from_views(params, Ys, config: mrd.Config, observed: dict,
                            target_view: int, num_steps: int = 200,
                            lr: float = 0.05, tol: float | None = None,
                            restarts: int = 0, anneal: bool = False):
    """MRD cross-view prediction: observe some views of new points, infer
    the shared q(x*), and predict the target view's mean and variance.
    The inference starts from the nearest training row in the first
    observed view; restarts=K > 0 runs K + 1 inferences (the K nearest
    rows' latents and the prior mean) and keeps the best per point.
    anneal cosine-decays the inner Adam rate.
    Returns (mean, var, m*, s*, trace)."""
    caches = mrd_posterior(params, Ys, config)
    qx_mean = params["qx_mean"].detach()
    v0, y0 = sorted(observed.items())[0]
    ones = torch.ones_like(y0)
    if restarts > 0:
        m_knn = init_latent_knn(qx_mean, Ys[v0], y0, ones, restarts)
        m_inits = torch.cat([m_knn, torch.zeros_like(m_knn[:1])], dim=0)
        m_s, s_s, trace = mrd_infer_latent_restarts(
            caches, observed, m_inits, num_steps, lr, kernel=config.kernel,
            tol=tol, anneal=anneal)
    else:
        m0 = init_latent_from_nearest(qx_mean, Ys[v0], y0, ones)
        m_s, s_s, trace = mrd_infer_latent(
            caches, observed, m0, num_steps, lr, kernel=config.kernel,
            tol=tol, anneal=anneal)
    with torch.no_grad():
        mean, var = predict_from_latent(caches[target_view], m_s, s_s,
                                        kernel=config.kernel)
    return mean, var, m_s, s_s, trace


def gaussian_predictive_loglik(y_true, mean, var, mask):
    """Moment-matched per-dim predictive log-likelihood, summed over the
    entries selected by mask (mask = 1 - observed_mask for imputation)."""
    var = torch.clamp(var, min=1e-10)   # a non-positive variance upstream
    #   must never turn the metric into NaN silently
    ll = -0.5 * (math.log(2.0 * math.pi) + torch.log(var)
                 + (y_true - mean) ** 2 / var)
    return torch.sum(ll * mask)
