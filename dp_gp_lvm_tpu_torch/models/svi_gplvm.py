r"""Stochastic (minibatch) variational GP-LVM: the uncollapsed Hensman
bound, whitened (counterpart of `dp_gp_lvm_tpu/models/svi_gplvm.py`, whose
docstring holds the algebra; Hensman et al. 2013).

With u = L v, L = chol(K_uu), q(v_d) = N(m_d, S) (one S for every output
dim), a = L^{-1} Psi1^T Y and A2 = L^{-1} Psi2 L^{-T}:

    fit_d = -n/2 log(2 pi s2) - beta/2 [ yty_d - 2 m_d^T a_d
            + m_d^T A2 m_d + tr(S A2) + psi0 - tr(A2) ]
    KL_u  = sum_d 1/2 [ ||m_d||^2 - M ] + D/2 [ tr(S) - logdet S ]
    ELBO  = sum_d fit_d - KL_u - KL(q(X) || N(0, I))

Every data term is a sum over rows, so a minibatch estimate scales the
batch's sufficient statistics (`dispatch.suff_stats`: K1 at T = 1 with K2
in its backward on the card) and its rows' KL(q(X)) by N/B.

q(X) is an (N, Q) table on the device, or, with `Config.amortized` (c8),
a recognition network that encodes each minibatch row
(`models/amortized.py`): then no q(X) state on the device grows with N. Y
is either resident there too, or streamed from the host a chunk at a time
(`data/stream.py`, the step's `streaming=True`). On a device mesh
(`parallel/`) each rank takes its block of the batch rows and the step's
bound sums their statistics over "data" (`make_svi_natgrad_step(mesh=)`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import (
    MIN_NOISE,
    positive,
    positive_inverse,
    positive_noise,
    positive_variational_var,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy, pin_full_f32
from dp_gp_lvm_tpu_torch.distributions import gaussian
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.kernels.ard_rbf_vjp import psi1_weighted
from dp_gp_lvm_tpu_torch.linalg import safe_cholesky, tri_solve
from dp_gp_lvm_tpu_torch.models import amortized
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.parallel.auto import check_divides, shard
from dp_gp_lvm_tpu_torch.parallel.mesh import DATA_AXIS, DATA_SHARDED
from dp_gp_lvm_tpu_torch.train.init import inducing_from_latents, pca_latents
from dp_gp_lvm_tpu_torch.train.loop import STEPS

LOG2PI = math.log(2.0 * math.pi)
# q(u) moves by natural gradient, not by the optimizer
QU_NAMES = ("u_mean", "raw_u_scale")


class Config(NamedTuple):
    num_latent: int
    num_inducing: int
    batch: int = 256               # minibatch rows per step
    psi2_block: int | None = None  # chunk size over N of the plain Psi2
    # True | False | "auto": K1 with K2 in its backward (ops/psi.py);
    # "auto" takes them for tensors on the card where they take the shape
    use_fused: bool | str = "auto"
    kernel: str = "ard_rbf"
    # a recognition network in place of the (N, Q) q(X) table
    # (models/amortized.py); encoder_hidden = 0 is the linear encoder
    amortized: bool = False
    encoder_hidden: int = 64
    # lower bound on the noise variance (0: the MIN_NOISE floor alone);
    # the amortized model needs one: a shared encoder can drive the noise
    # to its floor, where the f32 bound cancels beta ~ 1e6 terms
    noise_floor: float = 0.0
    # additive lower bound on the amortized q(X) variance (the table is
    # untouched): collapsed encoder variances make the batch psi
    # statistics hyper-local and the natural-gradient q(u) recursion
    # diverge at c8's scale
    qx_var_floor: float = 0.0


def init_params(key, Y, config: Config):
    """PCA latents (full N), inducing points from the latents drawn with
    `key` (a key of the reference's stream, `core/prng.py`), whitened q(u)
    at the prior (m = 0, S = I). Parameters on Y's device. With
    `config.amortized` the q(X) table becomes encoder leaves whose
    encode(Y) is the table's init, drawn from fold_in(key, 7), so that z0
    is the resident init's to the bit."""
    dtype, device = Y.dtype, Y.device
    m, q, d = config.num_inducing, config.num_latent, Y.shape[1]
    x0 = pca_latents(Y, q)
    z0 = inducing_from_latents(key, x0, m)

    def const(value, shape=()):
        return torch.full(shape, value, dtype=dtype, device=device)

    eye = torch.eye(m, dtype=dtype, device=device)
    params = {
        **amortized.qx_leaves_or_encoder(prng.fold_in(key, 7), Y, x0,
                                         config),
        "z": z0,
        "raw_variance": positive_inverse(const(1.0)),
        "raw_ard": positive_inverse(const(1.0, (q,))),
        "raw_noise": positive_inverse(const(0.1)),
        # whitened q(u): mean (M, D); S = Ls Ls^T with Ls = tril(raw),
        # its diagonal through softplus (S = I at init)
        "u_mean": const(0.0, (m, d)),
        "raw_u_scale": const(0.0, (m, m)) + eye * positive_inverse(
            const(1.0)),
    }
    return {k: nn.Parameter(v.contiguous()) for k, v in params.items()}


def constrain(params, config: Config | None = None):
    """Constrained values; `config` binds its noise floor and its q(X)
    variance floor (None: the MIN_NOISE floor alone, no q(X) floor). The
    encoder's leaves pass through raw."""
    raw = params["raw_u_scale"]
    ls = torch.tril(raw, -1) + torch.diag(positive(torch.diagonal(raw)))
    floor = config.noise_floor if config is not None else 0.0
    floor = max(floor, MIN_NOISE) if floor else 0.0
    c = {
        "z": params["z"],
        "variance": positive(params["raw_variance"]),
        "ard": positive(params["raw_ard"]),
        "noise": (positive(params["raw_noise"], floor) if floor
                  else positive_noise(params["raw_noise"])),
        "u_mean": params["u_mean"],
        "u_scale": ls,                 # chol factor of the whitened S
    }
    if "qx_mean" in params:            # the resident q(X) table
        c["qx_mean"] = params["qx_mean"]
        c["qx_var"] = positive_variational_var(params["raw_qx_var"])
    c.update(amortized.encoder_leaves(params, config))
    return c


def _whitened_terms(c, stats, policy, kernel: str = "ard_rbf"):
    """(a, A2, L) from SuffStats in whitened coordinates."""
    kuu = dispatch.gram(c["variance"], c["ard"], c["z"], kernel=kernel)
    L, _ = safe_cholesky(kuu, policy)
    a = tri_solve(L, stats.psi1T_y)                    # (M, D)
    half = tri_solve(L, stats.psi2)
    A2 = tri_solve(L, half.T)                          # (M, M), symmetric
    return a, 0.5 * (A2 + A2.T), L


def _bound_and_whitened(c, stats, kl_x, policy, kernel: str = "ard_rbf"):
    """(bound, a, A2): the whitened Hensman bound from (possibly scaled)
    SuffStats and KL(q(X)), with the whitened statistics it was built
    from."""
    beta = 1.0 / c["noise"]
    a, A2, _ = _whitened_terms(c, stats, policy, kernel)
    mu, ls = c["u_mean"], c["u_scale"]                 # (M, D), (M, M)
    d = mu.shape[1]
    tr_sa2 = torch.sum((A2 @ ls) * ls)                 # tr(S A2)
    quad = torch.sum(mu * (A2 @ mu), dim=0)
    # the GP conditional-variance correction is the same for every dim
    shared = (-0.5 * stats.n * (LOG2PI + torch.log(c["noise"]))
              - 0.5 * beta * (tr_sa2 + stats.psi0
                             - torch.diagonal(A2).sum()))
    per_dim = shared - 0.5 * beta * (
        stats.yty - 2.0 * torch.sum(mu * a, dim=0) + quad)
    kl_u = 0.5 * torch.sum(mu * mu) + 0.5 * d * (
        torch.sum(ls * ls) - mu.shape[0]
        - 2.0 * torch.sum(torch.log(torch.diagonal(ls))))
    return torch.sum(per_dim) - kl_u - kl_x, a, A2


def _bound_from_stats(c, stats, kl_x, policy, kernel: str = "ard_rbf"):
    return _bound_and_whitened(c, stats, kl_x, policy, kernel)[0]


def _stats(c, y, idx, config: Config):
    """SuffStats and KL(q(X)) of the rows y (their table rows `idx`, None:
    every row; the encoder reads y itself)."""
    if y.device.type == "cuda":
        pin_full_f32()
    mu, s = _qx_batch(c, y, idx)
    stats = dispatch.suff_stats(
        c["variance"], c["ard"], mu, s, c["z"], y,
        block_n=config.psi2_block, use_fused=config.use_fused,
        kernel=config.kernel)
    return stats, gaussian.kl_to_standard_normal(mu, s)


def _qx_batch(c, y, idx):
    """q(X) moments of data rows: the table's rows `idx` (None: every row)
    or the encoder's forward pass of y (`amortized.qx_batch`)."""
    return amortized.qx_batch(c, y, idx)


def _scale_stats(stats, kl_x, scale):
    """SuffStats and KL(q(X)) of B rows scaled to N rows (scale = N/B)."""
    stats = stats._replace(
        psi0=stats.psi0 * scale, psi1T_y=stats.psi1T_y * scale,
        psi2=stats.psi2 * scale, yty=stats.yty * scale, n=stats.n * scale)
    return stats, scale * kl_x


def _scaled_batch_stats(c, y_b, idx, n_total: int, config: Config):
    """(N/B)-scaled SuffStats and q(X)-KL of a minibatch."""
    stats, kl_x = _stats(c, y_b, idx, config)
    return _scale_stats(stats, kl_x, n_total / y_b.shape[0])


def elbo_minibatch(params, y_batch, idx, n_total: int, config: Config,
                   policy: JitterPolicy = JitterPolicy()):
    """Unbiased minibatch estimate of the full-data ELBO. y_batch (B, D)
    rows of Y, idx (B,) their row indices, n_total the full N."""
    c = constrain(params, config)
    stats, kl_x = _scaled_batch_stats(c, y_batch, idx, n_total, config)
    return _bound_from_stats(c, stats, kl_x, policy,
                             config.kernel)


def elbo(params, Y, config: Config, policy: JitterPolicy = JitterPolicy()):
    """Full-batch whitened Hensman bound (testing, small N)."""
    c = constrain(params, config)
    stats, kl_x = _stats(c, Y, None, config)
    return _bound_from_stats(c, stats, kl_x, policy,
                             config.kernel)


def loss(params, Y, config: Config):
    return -elbo(params, Y, config)


def loss_minibatch(params, y_batch, idx, n_total: int, config: Config):
    return -elbo_minibatch(params, y_batch, idx, n_total, config)


def optimal_qu(params, Y, config: Config,
               policy: JitterPolicy = JitterPolicy()):
    """Closed-form optimal whitened q(u) at full-batch statistics:
    (m*, chol(S*)) with S* = (I + beta A2)^{-1}, m* = beta S* a."""
    c = constrain(params, config)
    stats, _ = _stats(c, Y, None, config)
    a, A2, _ = _whitened_terms(c, stats, policy,
                               config.kernel)
    return optimal_qu_from_whitened(a, A2, 1.0 / c["noise"])


def _chol_nan(A):
    """Unjittered Cholesky, NaN where it fails (JAX's convention)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info != 0, torch.full_like(L, math.nan), L)


def optimal_qu_from_whitened(a, A2, beta):
    """(m*, chol(S*)) from whitened statistics. B = I + beta A2 has
    eigenvalues >= 1, so it is factored unjittered: the collapsed-bound
    identity needs S* to invert exactly the B of the bound."""
    eye = torch.eye(A2.shape[0], dtype=A2.dtype, device=A2.device)
    LB = _chol_nan(eye + beta * A2)
    b_inv = tri_solve(LB, eye)
    s_star = b_inv.T @ b_inv                           # B^{-1}
    return beta * (s_star @ a), _chol_nan(s_star)


def _raw_scale(ls):
    """raw_u_scale of a lower-triangular factor with a positive diagonal."""
    return torch.tril(ls, -1) + torch.diag(
        positive_inverse(torch.diagonal(ls)))


def set_optimal_qu(params, Y, config: Config):
    """params with q(u) at the full-batch optimum (new tensors)."""
    m_star, ls_star = optimal_qu(params, Y, config)
    return {**params, "u_mean": m_star, "raw_u_scale": _raw_scale(ls_star)}


def _row_psi2(variance, ard, mu, s, Z):
    """Per-row Psi2 (N*, M, M), plain torch."""
    _, _, expo = ard_rbf._forward_pieces(variance, ard, mu, s, Z,
                                         ard_rbf._log_e(ard, Z))
    return (variance * variance) * torch.exp(torch.clamp(expo, max=0.0))


def _latent_row_pieces(c, L, x_mean, x_var, config: Config):
    """Per-row psi-moment contractions of the q(u)-serving paths:
    phi (N*, M) = L^{-1} psi1_n, gp_var (N*,) = E[k_nn] - tr(A2_n) +
    tr(S A2_n), m_quad (N*, D) = m_d^T A2_n m_d, with A2_n = L^{-1} Psi2_n
    L^{-T} (plain torch, as the reference runs them off its kernels)."""
    dispatch._kernel(config.kernel)
    p1 = psi1_weighted(c["variance"], c["ard"], x_mean, x_var, c["z"])
    phi = tri_solve(L, p1.T).T                         # (N*, M)
    p2 = _row_psi2(c["variance"], c["ard"], x_mean, x_var, c["z"])
    half = tri_solve(L, p2)
    a2n = tri_solve(L, half.mT)                        # (N*, M, M)
    ls, mu_u = c["u_scale"], c["u_mean"]
    t_s = torch.sum((a2n @ ls) * ls, dim=(1, 2))
    m_quad = torch.sum(mu_u * (a2n @ mu_u), dim=1)     # (N*, D)
    trace = torch.diagonal(a2n, dim1=1, dim2=2).sum(-1)
    k_diag = dispatch.expected_gram_diag(c["variance"], c["ard"], x_mean,
                                         x_var, kernel=config.kernel)
    return phi, t_s - trace + k_diag, m_quad


def _detached(params, config: Config):
    with torch.no_grad():
        return {k: v.detach() for k, v in constrain(params, config).items()}


def _kuu_factor(c, config: Config, policy: JitterPolicy):
    kuu = dispatch.gram(c["variance"], c["ard"], c["z"], kernel=config.kernel)
    return safe_cholesky(kuu, policy)[0]


def predict_from_latent(params, x_mean, x_var, config: Config,
                        policy: JitterPolicy = JitterPolicy()):
    """Predictive mean and variance at q(x*) = N(x_mean, diag(x_var)),
    from the explicit q(u) alone:
    Var_nd = sigma^2 + E[k_nn] - tr(A2_n) + tr(S A2_n) + m_d^T A2_n m_d
             - (phi_n^T m_d)^2, floored at sigma^2."""
    c = _detached(params, config)
    return _predict(c, _kuu_factor(c, config, policy), x_mean, x_var, config)


def _predict(c, L, x_mean, x_var, config: Config):
    """`predict_from_latent` from the detached constrained parameters `c`
    and the factor L of their K_uu."""
    phi, gp_var, m_quad = _latent_row_pieces(c, L, x_mean, x_var, config)
    mean = phi @ c["u_mean"]
    var = gp_var[:, None] + m_quad - mean * mean + c["noise"]
    return mean, torch.maximum(var, c["noise"])


def make_svi_step(config: Config, n_total: int, optimizer):
    """Plain SVI step: the minibatch ELBO's gradient for every parameter,
    q(u) included, through `optimizer` (updated in place). Returns
    step(t, idx, Y) -> loss; idx are the (B,) minibatch rows of the
    resident Y (the reference draws them with replacement)."""
    params = optimizer.params
    keys = list(params)
    leaves = [params[k] for k in keys]

    def step(t: int, idx, Y):
        loss = loss_minibatch(params, Y[idx], idx, n_total, config)
        optimizer.step(dict(zip(keys, torch.autograd.grad(loss, leaves))))
        STEPS["taken"] += 1
        return loss.detach()

    return step


def infer_latent(params, y_star, mask, m_init, config: Config,
                 num_steps: int = 200, lr: float = 0.05,
                 tol: float | None = None,
                 policy: JitterPolicy = JitterPolicy()):
    """Fit q(x*) = N(m*, diag(s*)) for new rows against the masked expected
    log-likelihood under the explicit q(u) (mask (N*, D), 1 = observed),
    with the Adam of `prediction._fit_variational`. Returns (m*, s*,
    objective trace)."""
    c = _detached(params, config)
    return _infer(c, _kuu_factor(c, config, policy), y_star, mask, m_init,
                  config, num_steps, lr, tol)


def _infer(c, L, y_star, mask, m_init, config: Config, num_steps: int,
           lr: float, tol: float | None):
    """`infer_latent` from the detached constrained parameters `c` and the
    factor L of their K_uu."""
    from dp_gp_lvm_tpu_torch.models.prediction import _fit_variational

    mu_u, noise = c["u_mean"], c["noise"]
    beta = 1.0 / noise
    dtype = y_star.dtype
    var_params = {
        "m": m_init.to(dtype),
        "raw_s": positive_inverse(0.1 * torch.ones_like(m_init)).to(dtype),
    }

    def objective(vp):
        s = positive_variational_var(vp["raw_s"])
        phi, gp_var, m_quad = _latent_row_pieces(c, L, vp["m"], s, config)
        f_mean = phi @ mu_u                            # (N*, D)
        sq = (y_star * y_star - 2.0 * y_star * f_mean + m_quad
              + gp_var[:, None])
        ell = torch.sum(mask * (-0.5 * (LOG2PI + torch.log(noise))
                                - 0.5 * beta * sq))
        return -(ell - gaussian.kl_to_standard_normal(vp["m"], s))

    vp, trace, _ = _fit_variational(objective, var_params, num_steps, lr,
                                    tol)
    return vp["m"], positive_variational_var(vp["raw_s"]), -trace


def _nearest_latent_init(params, y_star, mask, config: Config):
    """q(x*) means from the training latent whose q(u)-predicted mean best
    matches the observed dims, over at most ~4096 strided candidates. An
    amortized model has no table: its encoder gives them in one pass, the
    missing dims filled at its centre."""
    c = _detached(params, config)
    if "qx_mean" not in c:
        with torch.no_grad():
            return amortized.encoder_fill_init(c, y_star, mask)
    n = c["qx_mean"].shape[0]
    take = torch.arange(0, n, max(1, n // 4096), device=c["qx_mean"].device)
    cand, cand_var = c["qx_mean"][take], c["qx_var"][take]
    mean, _ = predict_from_latent(params, cand, cand_var, config)
    d2 = torch.sum(((y_star[:, None, :] - mean[None, :, :]) ** 2)
                   * mask[:, None, :], dim=-1)
    return cand[torch.argmin(d2, dim=1)]


def impute(params, y_star, mask, config: Config, num_steps: int = 200,
           lr: float = 0.05, tol: float | None = None):
    """Missing-data pipeline: infer q(x*) from the observed dims, predict
    every dim from q(u). Returns (mean, var, m*, s*, objective trace)."""
    m0 = _nearest_latent_init(params, y_star, mask, config)
    m_s, s_s, trace = infer_latent(params, y_star, mask, m0, config,
                                   num_steps, lr, tol)
    mean, var = predict_from_latent(params, m_s, s_s, config)
    return mean, var, m_s, s_s, trace


def _natural_from_params(c):
    """Whitened q(u) natural parameters (h, Lambda): Lambda = S^{-1},
    h = Lambda m."""
    ls = c["u_scale"]
    eye = torch.eye(ls.shape[0], dtype=ls.dtype, device=ls.device)
    ls_inv = tri_solve(ls, eye)
    lam = ls_inv.T @ ls_inv
    return lam @ c["u_mean"], lam


def _params_from_natural(h, lam):
    """(u_mean, raw_u_scale) from natural parameters: S = Lambda^{-1} by
    Cholesky, m = S h."""
    eye = torch.eye(lam.shape[0], dtype=lam.dtype, device=lam.device)
    l_inv = tri_solve(_chol_nan(0.5 * (lam + lam.T)), eye)
    s = l_inv.T @ l_inv
    ls = _chol_nan(0.5 * (s + s.T))
    return s @ h, _raw_scale(ls)


def natgrad_blend_qu(u_mean, ls, a, A2, beta, rho,
                     policy: JitterPolicy = JitterPolicy(),
                     trust: float | None = None):
    r"""One natural-gradient step of length rho on the whitened q(u),
    without forming the natural parameters (the reference's docstring
    derives it): with G = ls^T (I + beta A2) ls and C = (1 - rho) I +
    rho G, S' = ls C^{-1} ls^T, re-triangularized through the QR of
    Lc^{-1} ls^T, and m' = m + rho ls C^{-1} ls^T (beta a - Bhat m).
    `trust` caps G's RMS eigenvalue and the m increment (None: the exact
    natural gradient). C is factored unjittered, and by `safe_cholesky`'s
    ladder where that fails, the choice made on the device (no host
    read). Returns (u_mean', raw_u_scale')."""
    m = ls.shape[0]
    eye = torch.eye(m, dtype=ls.dtype, device=ls.device)
    G = ls.T @ (ls + beta * (A2 @ ls))                 # ls^T Bhat ls
    if trust is not None:
        g_rms = torch.sqrt(torch.sum(G * G) / m)
        G = G * torch.clamp(trust / torch.clamp(g_rms, min=1e-30), max=1.0)
    C = (1.0 - rho) * eye + rho * G
    C = 0.5 * (C + C.T)
    Lc, info = torch.linalg.cholesky_ex(C)
    Lc = torch.where(info == 0, Lc, safe_cholesky(C, policy)[0])
    X = tri_solve(Lc, ls.T)                            # Lc^{-1} ls^T
    r = torch.linalg.qr(X, mode="r")[1]                # S' = r^T r
    sign = torch.sign(torch.diagonal(r))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    ls_new = (r * sign[:, None]).T                     # lower, diag > 0
    resid = beta * a - u_mean - beta * (A2 @ u_mean)
    cinv_v = tri_solve(Lc, tri_solve(Lc, ls.T @ resid), trans=True)
    dm = rho * (ls @ cinv_v)
    if trust is not None:
        dm_norm = torch.sqrt(torch.sum(dm * dm))
        cap = trust * (1.0 + torch.sqrt(torch.sum(u_mean * u_mean)))
        dm = dm * torch.clamp(cap / torch.clamp(dm_norm, min=1e-30), max=1.0)
    return u_mean + dm, _raw_scale(ls_new)


@torch.no_grad()
def _guarded_qu(params, u_mean, raw_u_scale):
    """Store the blended q(u) in `params` in place, or keep the previous
    one where the blend produced a non-finite value (decided on the
    device)."""
    ok = torch.isfinite(torch.sum(u_mean)) & torch.isfinite(
        torch.sum(raw_u_scale))
    for k, new in (("u_mean", u_mean), ("raw_u_scale", raw_u_scale)):
        params[k].copy_(torch.where(ok, new, params[k]))


def _mesh_checked(mesh, optimizer, batch: int):
    """Refuse a mesh step whose optimizer cannot reduce its gradients or
    whose batch does not cut evenly over "data"."""
    if optimizer.mesh is None and mesh.world_size > 1:
        raise ValueError("a step on a mesh needs gp_optimizer(..., mesh=, "
                         "placement=) to reduce its gradients")
    check_divides(batch, DATA_AXIS, mesh, "batch")


def batch_block(mesh, *arrays):
    """The rank's block of each batch array (its rows over "data"); the
    arrays themselves without a mesh."""
    if mesh is None:
        return arrays
    return tuple(shard(x, DATA_SHARDED, mesh, "batch") for x in arrays)


def robbins_monro(rho: float, rho_t0: float | None, rho_kappa: float):
    """rho_at(t): the blend's step length at global step t, rho (1 + t /
    rho_t0)^-rho_kappa (rho without rho_t0). t is a host int or a 0-d
    integer tensor, the step counter of a captured step on its device;
    then rho_at(t) is a 0-d float64 tensor there, the same float64
    arithmetic, read by no host."""
    def rho_at(t):
        if rho_t0 is None:
            return rho
        if torch.is_tensor(t):
            t = t.to(torch.float64)
        return rho * (1.0 + t / rho_t0) ** (-rho_kappa)

    return rho_at


def make_svi_natgrad_step(config: Config, n_total: int, optimizer,
                          rho: float = 0.2, rho_t0: float | None = None,
                          rho_kappa: float = 0.6, blend_at: str = "updated",
                          mesh=None, streaming: bool = False,
                          policy: JitterPolicy = JitterPolicy(),
                          qu_trust: float | None = None):
    """SVI step with stochastic natural-gradient q(u): hypers, inducing
    inputs and q(X) move by `optimizer` (a `train.loop.GPOptimizer` over
    the model's parameters, updated in place; q(u)'s gradients are
    zeroed), then q(u) blends toward the optimum of the (N/B)-scaled batch
    statistics by `natgrad_blend_qu`.

    rho_t0: Robbins-Monro decay rho_t = rho (1 + t / t0)^-kappa.
    blend_at: "updated" recomputes the batch statistics at the updated
    parameters (a second K1 forward a step), "grad" reuses those of the
    gradient pass.

    mesh: a `parallel.mesh.Mesh` (the optimizer built with its `mesh` and
    the table of `parallel.recipe.place_svi`): every rank gets the same
    full batch, takes its block of rows over "data", and the bound runs
    through `parallel.sharded_elbo.svi_elbo_sharded`; the blend reads its
    whitened statistics, summed over "data", so every rank blends the
    same bits. The math of the step without a mesh.

    Returns step(t, idx, Y) -> loss (a 0-d device tensor): t is the global
    step (for rho), idx the (B,) minibatch rows of the resident Y. With
    `streaming` the host feeds the rows (`data/stream.py`) and the step is
    step(t, (idx, y_b)): idx (B,) and y_b (B, D) on the device, nothing
    gathered there; at equal rows it is the resident step, bit for bit."""
    if blend_at not in ("updated", "grad"):
        raise ValueError(f"blend_at must be 'updated'|'grad', got "
                         f"{blend_at!r}")
    if mesh is not None:
        _mesh_checked(mesh, optimizer, config.batch)
        # sharded_elbo imports this module
        from dp_gp_lvm_tpu_torch.parallel.sharded_elbo import (
            svi_elbo_sharded,
        )
    params = optimizer.params
    keys = list(params)
    leaves = [params[k] for k in keys]

    rho_at = robbins_monro(rho, rho_t0, rho_kappa)

    def loss_with_stats(y_b, idx):
        if mesh is not None:
            bound, (a, A2) = svi_elbo_sharded(
                params, y_b, idx, n_total, config, mesh, policy,
                with_aux=True)
            return -bound, a, A2, 1.0 / constrain(params, config)["noise"]
        c = constrain(params, config)
        stats, kl_x = _scaled_batch_stats(c, y_b, idx, n_total, config)
        bound, a, A2 = _bound_and_whitened(c, stats, kl_x, policy,
                                           config.kernel)
        return -bound, a, A2, 1.0 / c["noise"]

    def one(t: int, idx, y_b):
        loss, a, A2, beta = loss_with_stats(y_b, idx)
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        grads.update(optimizer.reduce({k: g for k, g in grads.items()
                                       if k not in QU_NAMES}))
        for k in QU_NAMES:
            grads[k] = torch.zeros_like(grads[k])
        optimizer.step(grads)
        with torch.no_grad():
            if blend_at == "updated":
                _, a, A2, beta = loss_with_stats(y_b, idx)
            c = constrain(params, config)
            u_mean, raw = natgrad_blend_qu(
                c["u_mean"], c["u_scale"], a.detach(), A2.detach(),
                beta.detach(), rho_at(t), policy, trust=qu_trust)
        _guarded_qu(params, u_mean, raw)
        STEPS["taken"] += 1
        return loss.detach()

    if streaming:
        def step(t: int, batch):
            return one(t, *batch_block(mesh, *batch))
    else:
        def step(t: int, idx, Y):
            (idx,) = batch_block(mesh, idx)
            return one(t, idx, Y[idx])
    return step
