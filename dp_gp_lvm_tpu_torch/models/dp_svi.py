r"""Minibatch DP-GP-LVM: the uncollapsed phi-weighted Hensman bound with an
explicit whitened q(u | t) per truncation atom (counterpart of
`dp_gp_lvm_tpu/models/dp_svi.py`, whose docstring derives it).

Each output dim d picks an atom z_d ~ Cat(phi_d); per atom t, with
L_t = chol(K_uu^t), a_t = L_t^{-1} Psi1_t^T Y, A2_t = L_t^{-1} Psi2_t L_t^{-T}
and q(v_d | z_d = t) = N(m_td, S_t):

    fit_td = -n/2 log(2 pi s2_t) - beta_t/2 [ yty_d - 2 m_td^T a_td
             + m_td^T A2_t m_td + tr(S_t A2_t) + psi0_t - tr(A2_t) ]
    KL_td  = 1/2 ||m_td||^2 + 1/2 [ tr(S_t) - logdet S_t - M ]
    ELBO   = sum_{t,d} phi_dt (fit_td - KL_td) + E[log p(z|v)] + H[q(z)]
             - KL[q(v) || p(v | alpha)] - KL[q(X)]

q(u | t) is stored in natural parameters, u_h (T, M, D) = Lambda_t m_td and
u_lam (T, M, M) = S_t^{-1}, so the natural-gradient blend toward the batch
optimum (I + beta_t A2_t, beta_t a_t) is a convex combination. At the
optimal q(u) the bound equals the collapsed `dp_gp_lvm.elbo`; at T = 1 it
is `svi_gplvm.elbo`.

Data enter only through the per-atom sufficient statistics of
`dispatch.dp_batched_suffstats` (K1 with K2 in its backward on the card),
so a minibatch estimate scales them by N/B. Every per-atom factorization
runs on the whole (T, M, M) stack at once: K_uu through
`linalg.safe_cholesky_members` (a jitter per atom, one host read a call),
Lambda through `_lam_cholesky` (on the device, no host read). The
prediction half computes its psi statistics in plain torch, as the
reference does (`use_pallas=False`). q(X) is the (N, Q) table, or with
`Config.amortized` the recognition network of `models/amortized.py`. On a
device mesh (`parallel/`) the batch rows are cut over "data" and the atoms
over "model" (`make_dp_svi_step(mesh=)`).
"""
from __future__ import annotations

import dataclasses
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
from dp_gp_lvm_tpu_torch.distributions import gaussian, stick_breaking
from dp_gp_lvm_tpu_torch.kernels import ard_rbf, linear
from dp_gp_lvm_tpu_torch.kernels.ard_rbf_vjp import psi1_weighted
from dp_gp_lvm_tpu_torch.linalg import safe_cholesky_members, tri_solve
from dp_gp_lvm_tpu_torch.models import amortized
from dp_gp_lvm_tpu_torch.models.bgplvm import _log_normal_hyperprior
from dp_gp_lvm_tpu_torch.models.svi_gplvm import (
    _mesh_checked,
    batch_block,
    robbins_monro,
)
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.parallel.collectives import all_gather, all_true
from dp_gp_lvm_tpu_torch.parallel.mesh import MODEL_AXIS
from dp_gp_lvm_tpu_torch.train.init import (
    inducing_from_latents,
    near_uniform_assignments,
    pca_latents,
)
from dp_gp_lvm_tpu_torch.train.loop import STEPS

LOG2PI = math.log(2.0 * math.pi)
# the ridge rungs of `_lam_cholesky`, in units of the Lambda >= I floor
LAM_RUNGS = (4096.0, 512.0, 64.0, 8.0, 1.0, 0.0)
# candidates of the nearest-latent init: at most ~this many strided rows
NEAREST_CANDIDATES = 2048


class Config(NamedTuple):
    num_latent: int
    num_inducing: int
    truncation: int                # T
    alpha: float = 1.0             # DP concentration
    batch: int = 256               # minibatch rows per step
    psi2_block: int | None = None  # chunk size over N of the plain Psi2
    # True | False | "auto": K1 with K2 in its backward (ops/psi.py);
    # "auto" takes them for tensors on the card where they take the shape
    use_fused: bool | str = "auto"
    kernel: str = "ard_rbf"
    fast_chol: bool = False        # no jitter search (max_tries 0)
    hyperprior_std: float = 0.0
    learn_alpha: bool = False
    ard_init: float | None = None  # ARD weight at init (None: 1.0)
    # a recognition network in place of the (N, Q) q(X) table
    # (models/amortized.py); encoder_hidden = 0 is the linear encoder
    amortized: bool = False
    encoder_hidden: int = 64
    noise_floor: float = 0.0       # lower bound on the noise variance
    # additive lower bound on the amortized q(X) variance (see
    # svi_gplvm.Config.qx_var_floor)
    qx_var_floor: float = 0.0


def _policy(config: Config, policy: JitterPolicy | None) -> JitterPolicy:
    policy = policy or JitterPolicy()
    if config.fast_chol:
        policy = dataclasses.replace(policy, max_tries=0)
    return policy


def init_params(key, Y, config: Config):
    """PCA latents, inducing points from the latents, per-atom ARD weights
    with a small symmetry-breaking draw, near-uniform phi, q(u | t) at the
    prior (h = 0, Lambda = I), drawn from `key` (a key of the reference's
    stream, `core/prng.py`) in the reference's order. On Y's device. With
    `config.amortized` the q(X) table becomes encoder leaves drawn from
    fold_in(key, 7), so that every other leaf is the resident init's to
    the bit."""
    dtype, device = Y.dtype, Y.device
    t, q, m, d = (config.truncation, config.num_latent, config.num_inducing,
                  Y.shape[1])
    r_z, r_phi, r_hyp = prng.split(key, 3)
    x0 = pca_latents(Y, q)
    z0 = inducing_from_latents(r_z, x0, m)
    ard_scale = 1.0 if config.ard_init is None else config.ard_init
    ard0 = ard_scale * (1.0 + 0.05 * prng.normal(r_hyp, (t, q), dtype)
                        ).to(device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    eye = torch.eye(m, dtype=dtype, device=device)
    params = {
        **amortized.qx_leaves_or_encoder(prng.fold_in(key, 7), Y, x0,
                                         config),
        "z": z0.expand((t,) + z0.shape).clone(),
        "raw_variance": positive_inverse(full((t,), 1.0)),
        "raw_ard": positive_inverse(torch.clamp(ard0, min=0.1 * ard_scale)),
        "raw_noise": positive_inverse(full((t,), 0.1)),
        "phi_logits": near_uniform_assignments(r_phi, d, t,
                                               dtype=dtype).to(device),
        "raw_gamma1": positive_inverse(full((t - 1,), 1.0)),
        "raw_gamma2": positive_inverse(full((t - 1,), config.alpha)),
        "u_h": full((t, m, d), 0.0),
        "u_lam": eye.expand(t, m, m).clone(),
    }
    if config.learn_alpha:
        params["raw_alpha"] = positive_inverse(full((), config.alpha))
    return {k: nn.Parameter(v.contiguous()) for k, v in params.items()}


def constrain(params, config: Config | None = None):
    """Constrained values; `config` binds its noise floor and its q(X)
    variance floor (None: the MIN_NOISE floor alone, no q(X) floor).
    Lambda comes back symmetrized; the encoder's leaves pass through
    raw."""
    floor = config.noise_floor if config is not None else 0.0
    lam = params["u_lam"]
    out = {
        "z": params["z"],
        "variance": positive(params["raw_variance"]),
        "ard": positive(params["raw_ard"]),
        "noise": (positive(params["raw_noise"], max(floor, MIN_NOISE))
                  if floor else positive_noise(params["raw_noise"])),
        "phi": torch.softmax(params["phi_logits"], dim=-1),
        # the log-softmax entropy of `dp_kl_terms` reads the logits
        "phi_logits": params["phi_logits"],
        "gamma1": positive(params["raw_gamma1"], 1e-4),
        "gamma2": positive(params["raw_gamma2"], 1e-4),
        "u_h": params["u_h"],
        "u_lam": 0.5 * (lam + lam.mT),
    }
    if "qx_mean" in params:            # the resident q(X) table
        out["qx_mean"] = params["qx_mean"]
        out["qx_var"] = positive_variational_var(params["raw_qx_var"])
    out.update(amortized.encoder_leaves(params, config))
    if "raw_alpha" in params:
        out["alpha"] = positive(params["raw_alpha"], 1e-3)
    return out


def _qx(c, y, idx):
    """q(X) moments of the rows y: the table's rows `idx` (None: every
    row), or the encoder's forward pass of y."""
    if y.device.type == "cuda":
        pin_full_f32()
    return amortized.qx_batch(c, y, idx)


def _batch_stats(c, mu, s, Y, config: Config):
    """Per-atom stacked sufficient statistics of the rows (mu, s, Y):
    (psi0 (T,), psi1T_y (T, M, D), psi2 (T, M, M), yty (D,), n)."""
    if Y.device.type == "cuda":
        pin_full_f32()
    return dispatch.dp_batched_suffstats(
        c["variance"], c["ard"], mu, s, c["z"], Y,
        block_n=config.psi2_block, use_fused=config.use_fused,
        kernel=config.kernel)


def _kuu_factors(c, config: Config, policy: JitterPolicy):
    """chol(K_uu^t) of every atom, each at its own jitter."""
    kuu = dispatch.gram(c["variance"], c["ard"], c["z"], kernel=config.kernel)
    return safe_cholesky_members(kuu, policy)[0]


def _atom_whitened(c, p1y, p2, config: Config, policy: JitterPolicy):
    """Per-atom whitened statistics: a (T, M, D), A2 (T, M, M)."""
    L = _kuu_factors(c, config, policy)
    a = tri_solve(L, p1y)
    half = tri_solve(L, p2)
    A2 = tri_solve(L, half.mT)
    return a, 0.5 * (A2 + A2.mT)


def _lam_cholesky(lam):
    r"""Cholesky of each q(u | t) precision Lambda in a (..., M, M) stack,
    with an absolute ridge sized to the Lambda >= I floor that exact
    arithmetic guarantees and f32 breaches (the reference measured eig_min
    down to -131 at c7's scale; its docstring tells the story).

    Each member's ridge is the smallest of the rungs 4096, 512, 64, 8, 1, 0
    at which its detached Lambda factors, else a Gershgorin bound
    (deficit + 1) that cannot fail. The probes run on the detached stack
    and only one differentiated factorization runs, at the chosen ridges:
    the Cholesky pullback of a failed (NaN) factor is NaN even under a zero
    cotangent, so no failed probe may enter the graph. Everything stays on
    the device: no host read."""
    eye = torch.eye(lam.shape[-1], dtype=lam.dtype, device=lam.device)
    frozen = lam.detach()
    diag = torch.diagonal(frozen, dim1=-2, dim2=-1)
    absrow = torch.sum(torch.abs(frozen), dim=-1) - torch.abs(diag)
    gersh_min = torch.amin(diag - absrow, dim=-1)
    ridge = torch.relu(-gersh_min) + 1.0
    for r in LAM_RUNGS:
        _, info = torch.linalg.cholesky_ex(frozen + r * eye)
        ridge = torch.where(info == 0, torch.full_like(ridge, r), ridge)
    L, info = torch.linalg.cholesky_ex(lam + ridge[..., None, None] * eye)
    # a failure is NaN, as JAX returns it (the optimizer's skip sees it)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, math.nan), L)


def _moments(h, lam):
    """(mean (T, M, D), S (T, M, M), chol of Lambda) of q(u | t) from its
    naturals: S = Lambda^{-1} through the ridge-guarded factor, mean = S h."""
    Llam = _lam_cholesky(lam)
    eye = torch.eye(lam.shape[-1], dtype=lam.dtype, device=lam.device)
    linv = tri_solve(Llam, eye)
    S = linv.mT @ linv
    return S @ h, S, Llam


def _bracket(yty, p0, a, A2, mean, S):
    """(T, D): yty_d - 2 m_td^T a_td + m_td^T A2_t m_td + tr(S_t A2_t)
    + psi0_t - tr(A2_t), the fit term's bracket, in the reference's order
    of additions."""
    quad = torch.sum(mean * (A2 @ mean), dim=-2)
    a_dot_m = torch.sum(mean * a, dim=-2)
    tr_s_a2 = torch.sum(S * A2, dim=(-2, -1))
    tr_a2 = torch.diagonal(A2, dim1=-2, dim2=-1).sum(-1)
    return (yty - 2.0 * a_dot_m + quad + tr_s_a2[:, None] + p0[:, None]
            - tr_a2[:, None])


def _free_energy_and_whitened(c, stats, config: Config,
                              policy: JitterPolicy):
    """(f_td (T, D), a, A2): the per-atom per-dim free energies fit_td -
    KL_td at the current q(u | t) from (possibly scaled) statistics, and
    the whitened statistics they were built from (the blend reuses them)."""
    p0, p1y, p2, yty, n = stats
    a, A2 = _atom_whitened(c, p1y, p2, config, policy)
    noise = c["noise"]
    mean, S, Llam = _moments(c["u_h"], c["u_lam"])
    m = S.shape[-1]
    logdet_s = -2.0 * torch.sum(
        torch.log(torch.diagonal(Llam, dim1=-2, dim2=-1)), dim=-1)
    fit = ((-0.5 * n * (LOG2PI + torch.log(noise)))[:, None]
           - 0.5 * (1.0 / noise)[:, None] * _bracket(yty, p0, a, A2, mean, S))
    kl = 0.5 * torch.sum(mean * mean, dim=-2) + (0.5 * (
        torch.diagonal(S, dim1=-2, dim2=-1).sum(-1) - logdet_s - m))[:, None]
    return fit - kl, a, A2


def per_dim_free_energy(c, stats, config: Config,
                        policy: JitterPolicy | None = None):
    """f (T, D) of `_free_energy_and_whitened`: at the optimal q(u | t) the
    collapsed per-dim bound F_dt."""
    return _free_energy_and_whitened(c, stats, config,
                                     _policy(config, policy))[0]


def _elbo_from_stats(c, stats, kl_x, config: Config, policy: JitterPolicy):
    f_td, a, A2 = _free_energy_and_whitened(c, stats, config, policy)
    phi = c["phi"]                                            # (D, T)
    fit = torch.sum(phi * f_td.T)
    alpha = c.get("alpha", config.alpha)
    dp = stick_breaking.dp_kl_terms(phi, c["gamma1"], c["gamma2"], alpha,
                                    logits=c["phi_logits"])
    if "alpha" in c:
        dp = dp + stick_breaking.alpha_log_prior(alpha)
    hp = _log_normal_hyperprior(config.hyperprior_std, c["variance"],
                                c["ard"], c["noise"])
    return {"elbo": fit + dp - kl_x + hp, "fit": fit, "dp_terms": dp,
            "kl_x": kl_x, "hyperprior": hp, "f_td": f_td, "_a": a,
            "_A2": A2}


def _scale_stats(stats, scale):
    return tuple(x * scale for x in stats)


def elbo_terms(params, Y, config: Config,
               policy: JitterPolicy | None = None):
    """Full-batch uncollapsed DP bound and its terms."""
    policy = _policy(config, policy)
    c = constrain(params, config)
    mu, s = _qx(c, Y, None)
    stats = _batch_stats(c, mu, s, Y, config)
    kl_x = gaussian.kl_to_standard_normal(mu, s)
    return _elbo_from_stats(c, stats, kl_x, config, policy)


def elbo(params, Y, config: Config, policy: JitterPolicy | None = None):
    return elbo_terms(params, Y, config, policy)["elbo"]


def loss(params, Y, config: Config):
    return -elbo(params, Y, config)


def _minibatch_terms(c, y_batch, idx, n_total: int, config: Config,
                     policy: JitterPolicy):
    """The bound's terms from a minibatch: every row sum (the per-atom
    statistics and the rows' KL(q(X))) scaled by N/B."""
    mu_b, s_b = _qx(c, y_batch, idx)
    scale = n_total / y_batch.shape[0]
    stats = _scale_stats(_batch_stats(c, mu_b, s_b, y_batch, config), scale)
    kl_x = scale * gaussian.kl_to_standard_normal(mu_b, s_b)
    return _elbo_from_stats(c, stats, kl_x, config, policy)


def elbo_minibatch(params, y_batch, idx, n_total: int, config: Config,
                   policy: JitterPolicy | None = None):
    """Unbiased minibatch estimate of the full-data ELBO."""
    return _minibatch_terms(constrain(params, config), y_batch, idx, n_total,
                            config, _policy(config, policy))["elbo"]


def loss_minibatch(params, y_batch, idx, n_total: int, config: Config):
    return -elbo_minibatch(params, y_batch, idx, n_total, config)


def optimal_qu(params, Y, config: Config,
               policy: JitterPolicy | None = None):
    """Closed-form optimal whitened q(u | t) at full-batch statistics, per
    atom Lambda_t* = I + beta_t A2_t, h_td* = beta_t a_td. Returns
    (u_h, u_lam)."""
    policy = policy or JitterPolicy()
    c = constrain(params, config)
    mu, s = _qx(c, Y, None)
    _, p1y, p2, _, _ = _batch_stats(c, mu, s, Y, config)
    a, A2 = _atom_whitened(c, p1y, p2, config, policy)
    beta = (1.0 / c["noise"])[:, None, None]
    eye = torch.eye(A2.shape[-1], dtype=A2.dtype, device=A2.device)
    return beta * a, eye + beta * A2


def set_optimal_qu(params, Y, config: Config):
    """params with q(u | t) at the full-batch optimum (new leaves; the
    others are shared)."""
    with torch.no_grad():
        u_h, u_lam = optimal_qu(params, Y, config)
    return {**params, "u_h": nn.Parameter(u_h), "u_lam": nn.Parameter(u_lam)}


# ---------------------------------------------------------------------------
# the training step: gradient for hypers, inducing inputs and q(X); the
# natural-gradient blend for q(u | t); CAVI for phi (optional) and gamma
# ---------------------------------------------------------------------------

# leaves updated by the blend or CAVI, whose gradients the optimizer sees
# as zeros (they count, as zeros, in its global-norm clip)
_BLEND_LEAVES = ("u_h", "u_lam", "phi_logits", "raw_gamma1", "raw_gamma2",
                 "raw_alpha")
# with phi_update="gradient", phi_logits stays an optimizer leaf
_BLEND_LEAVES_GRAD_PHI = ("u_h", "u_lam", "raw_gamma1", "raw_gamma2",
                          "raw_alpha")


@torch.no_grad()
def _guarded(params, updates: dict, mesh=None):
    """Store every blended leaf in `params` in place, or none of them where
    any holds a non-finite value (decided on the device; on a mesh of
    several ranks one decision for all of them, since a rank's atom
    leaves are its own)."""
    ok = torch.stack([torch.isfinite(torch.sum(v))
                      for v in updates.values()]).all()
    if mesh is not None and mesh.world_size > 1:
        ok = all_true(ok, mesh)
    for k, v in updates.items():
        params[k].copy_(torch.where(ok, v, params[k]))


def minibatch_indices(keys, batch: int, n_total: int, sample_idx=None):
    """The minibatch rows each key of `keys` (K, 2) draws, (K, batch) int64
    on the CPU: `sample_idx(key)` when given, else the reference's
    `randint(key, (batch,), 0, n_total)` at int32 whatever the run's float
    width (its draw is pinned to int32)."""
    if sample_idx is not None:
        return torch.stack([torch.as_tensor(sample_idx(k)) for k in keys]
                           ).long()
    return prng.randint(keys, (batch,), 0, n_total, bits=32).long()


def make_dp_svi_step(config: Config, n_total: int, optimizer,
                     rho: float = 0.2, rho_t0: float | None = None,
                     rho_kappa: float = 0.6, rho_phi: float | None = None,
                     phi_update: str = "gradient", blend_at: str = "grad",
                     sample_idx=None, mesh=None, streaming: bool = False,
                     policy: JitterPolicy | None = None):
    """One DP-SVI step over `optimizer` (a `train.loop.GPOptimizer` over the
    model's parameters, updated in place):

    - hypers, inducing inputs, q(X), and phi with phi_update="gradient":
      the optimizer, on the minibatch ELBO's gradient; the blend leaves
      are left out of autograd and handed to it as zeros;
    - q(u | t): the natural-gradient blend of (h, Lambda) toward the
      batch optimum (I + beta A2, beta a), step rho (Robbins-Monro decay
      rho (1 + t / rho_t0)^-rho_kappa when rho_t0 is given), from the
      symmetrized Lambda;
    - phi: "cavi" damps the logits toward f_td + E[log pi] (rate rho_phi,
      default rho); "frozen" leaves them as they are;
    - gamma (and alpha when learned): exact CAVI from the new phi.
    The blended leaves are stored all together or not at all (`_guarded`).

    blend_at: "grad" reuses the gradient pass's whitened statistics (one
    K1 a step); "updated" recomputes them at the updated parameters.

    mesh: a `parallel.mesh.Mesh` (the optimizer built with its `mesh` and
    the table of `parallel.recipe.place_svi("dp_svi", ...)`, the atom
    leaves the rank's T / model atoms): every rank gets the same full
    batch and takes its block of rows over "data"; the bound runs through
    `parallel.sharded_elbo.dp_svi_elbo_sharded`, q(u | t) blends on the
    local atoms from their statistics summed over "data", and the phi
    CAVI reads every atom's free energies (gathered over "model"). The
    math of the step without a mesh.

    Returns step(t, idx, Y) -> loss (a 0-d device tensor): t the global
    step (for rho), idx the (B,) minibatch rows of the resident Y. With
    `streaming` the host feeds the rows and it is step(t, (idx, y_b)).
    `step.indices(keys)` draws the rows of a (K, 2) stack of keys at
    once, on the parameters' device: `sample_idx(key)` when given, else
    the reference's int32 randint (`minibatch_indices`)."""
    if blend_at not in ("updated", "grad"):
        raise ValueError(f"blend_at must be 'updated'|'grad', got "
                         f"{blend_at!r}")
    if phi_update not in ("gradient", "cavi", "frozen"):
        raise ValueError(f"phi_update must be 'gradient'|'cavi'|'frozen', "
                         f"got {phi_update!r}")
    if mesh is not None:
        _mesh_checked(mesh, optimizer, config.batch)
        # sharded_elbo imports this module
        from dp_gp_lvm_tpu_torch.parallel.sharded_elbo import (
            dp_svi_elbo_sharded,
        )
    policy = _policy(config, policy)
    rho_phi = rho if rho_phi is None else rho_phi
    blend = (_BLEND_LEAVES_GRAD_PHI if phi_update == "gradient"
             else _BLEND_LEAVES)
    params = optimizer.params
    grad_keys = [k for k in params if k not in blend]
    leaves = [params[k] for k in grad_keys]
    zero_keys = [k for k in params if k in blend]
    device = leaves[0].device

    rho_at = robbins_monro(rho, rho_t0, rho_kappa)

    def loss_with_stats(y_b, idx):
        """(loss, a, A2, beta, f_td): the loss and, detached, what the blend
        and the CAVI update read (on a mesh a, A2 and beta of the rank's
        atoms, f_td of every atom)."""
        if mesh is not None:
            bound, (f_local, a, A2) = dp_svi_elbo_sharded(
                params, y_b, idx, n_total, config, mesh, policy,
                with_aux=True)
            beta = 1.0 / constrain(params, config)["noise"]
            f_td = (all_gather(f_local, mesh, MODEL_AXIS)
                    if phi_update == "cavi" else f_local)
            return -bound, *(x.detach() for x in (a, A2, beta, f_td))
        c = constrain(params, config)
        terms = _minibatch_terms(c, y_b, idx, n_total, config, policy)
        return -terms["elbo"], *(x.detach() for x in (
            terms["_a"], terms["_A2"], 1.0 / c["noise"], terms["f_td"]))

    def one(t: int, idx, y_b):
        loss, a, A2, beta, f_td = loss_with_stats(y_b, idx)
        grads = optimizer.reduce(
            dict(zip(grad_keys, torch.autograd.grad(loss, leaves))))
        grads.update({k: torch.zeros_like(params[k]) for k in zero_keys})
        optimizer.step(grads)
        with torch.no_grad():
            if blend_at == "updated":
                _, a, A2, beta, f_td = loss_with_stats(y_b, idx)
            c = constrain(params, config)
            rho_t = rho_at(t)
            eye = torch.eye(A2.shape[-1], dtype=A2.dtype, device=A2.device)
            b = beta[:, None, None]
            new = {"u_lam": (1.0 - rho_t) * c["u_lam"]
                   + rho_t * (eye + b * A2),
                   "u_h": (1.0 - rho_t) * c["u_h"] + rho_t * (b * a)}
            alpha = c.get("alpha", config.alpha)
            if phi_update == "cavi":
                logits_star = f_td.T + stick_breaking.expected_log_pi(
                    c["gamma1"], c["gamma2"])[None, :]
                new["phi_logits"] = ((1.0 - rho_phi) * params["phi_logits"]
                                     + rho_phi * logits_star)
                phi_new = torch.softmax(new["phi_logits"], dim=-1)
            else:
                phi_new = torch.softmax(params["phi_logits"], dim=-1)
            g1, g2 = stick_breaking.gamma_cavi_update(phi_new, alpha)
            new["raw_gamma1"] = positive_inverse(g1)
            new["raw_gamma2"] = positive_inverse(g2)
            if config.learn_alpha and "raw_alpha" in params:
                new["raw_alpha"] = positive_inverse(
                    stick_breaking.alpha_cavi_update(g1, g2))
        _guarded(params, new, mesh)
        STEPS["taken"] += 1
        return loss.detach()

    if streaming:
        def step(t: int, batch):
            return one(t, *batch_block(mesh, *batch))
    else:
        def step(t: int, idx, Y):
            (idx,) = batch_block(mesh, idx)
            return one(t, idx, Y[idx])

    def indices(keys):
        return minibatch_indices(keys, config.batch, n_total,
                                 sample_idx).to(device)

    step.indices = indices
    return step


def expected_assignments(params):
    """phi (D, T): the posterior over output-dimension group assignments."""
    return torch.softmax(params["phi_logits"], dim=-1)


def expected_residuals(params, Y, config: Config,
                       policy: JitterPolicy | None = None):
    """(D,) per-dim expected squared residual E_q[(y_d - f_d)^2] / N under
    the current q(u | t) and q(X), phi-weighted over atoms: one full-data
    pass of the statistics. The data-driven scale of `split_single_atom`'s
    noise ladder."""
    policy = policy or JitterPolicy()
    c = constrain(params, config)
    mu, s = _qx(c, Y, None)
    p0, p1y, p2, yty, n = _batch_stats(c, mu, s, Y, config)
    a, A2 = _atom_whitened(c, p1y, p2, config, policy)
    mean, S, _ = _moments(c["u_h"], c["u_lam"])
    r_td = _bracket(yty, p0, a, A2, mean, S) / n
    return torch.sum(c["phi"].T * r_td, dim=0)


def split_single_atom(params, config: Config, spread: float = 1.5,
                      min_noise: float = 2e-4, residuals=None):
    """Split a trained truncation-1 model into config.truncation atoms that
    differ only in their noise, with phi exactly uniform and gamma at its
    CAVI fixed point (the reference's docstring says why: cold multi-atom
    starts sit on a symmetric saddle). The noise ladder is a log-spread of
    +-spread around the learned noise, or, given per-dim `residuals`
    (`expected_residuals`), their quantiles at (t + 0.5) / T, floored at
    min_noise and pushed at least x1.2 apart. Returns new parameters of a
    truncation-config.truncation model."""
    t = config.truncation
    out = {}
    for k, v in params.items():
        v = v.detach()
        if k in ("z", "raw_variance", "raw_ard", "raw_noise", "u_h",
                 "u_lam"):
            v = v[0][None].expand((t,) + v.shape[1:])
        out[k] = v.clone()
    noise1 = positive_noise(params["raw_noise"].detach())[0] + 1e-6
    if residuals is not None:
        residuals = residuals.detach()
        qs = (torch.arange(t, dtype=residuals.dtype,
                           device=residuals.device) + 0.5) / t
        # floored before the log: f32 cancellation can take a well-fit
        # dim's residual slightly negative
        ladder = torch.clamp(torch.quantile(residuals, qs), min=min_noise)
        # ties (T above the number of residual levels) pushed apart by a
        # geometric gap g: log l_i' = cummax_j<=i (log l_j - g j) + g i
        steps = math.log(1.2) * torch.arange(t, dtype=ladder.dtype,
                                             device=ladder.device)
        ladder = torch.exp(torch.cummax(torch.log(ladder) - steps,
                                        dim=0).values + steps)
    else:
        ladder = noise1 * torch.exp(torch.linspace(
            -spread, spread, t, dtype=noise1.dtype, device=noise1.device))
    out["raw_noise"] = positive_inverse(
        torch.clamp(ladder, min=min_noise).to(noise1.dtype))
    logits = torch.zeros_like(out["phi_logits"][:, :1]).expand(-1, t)
    out["phi_logits"] = logits.clone()
    g1, g2 = stick_breaking.gamma_cavi_update(torch.softmax(logits, dim=-1),
                                              config.alpha)
    out["raw_gamma1"] = positive_inverse(g1)
    out["raw_gamma2"] = positive_inverse(g2)
    return {k: nn.Parameter(v.contiguous()) for k, v in out.items()}


# ---------------------------------------------------------------------------
# missing-data prediction: the phi-weighted mixture of the per-atom q(u | t)
# predictives, served from the naturals alone (no training data)
# ---------------------------------------------------------------------------


def qu_moments(params, config: Config | None = None):
    """Per-atom whitened q(u | t) moments from the stored naturals: (mean
    (T, M, D), S (T, M, M))."""
    c = constrain(params, config)
    mean, S, _ = _moments(c["u_h"], c["u_lam"])
    return mean, S


class _Predictive(NamedTuple):
    """What every q(x*) of a fixed model shares: the detached constrained
    parameters and, per atom, U = L^{-T} m (T, M, D) and W = L^{-T} (S - I)
    L^{-1} (T, M, M), L = chol(K_uu), so that a row's terms are plain
    contractions with its Psi statistics: no factorization or solve per
    request."""

    c: dict
    U: torch.Tensor
    W: torch.Tensor
    kernel: str = "ard_rbf"


@torch.no_grad()
def _predictive(params, config: Config, policy: JitterPolicy | None = None):
    c = {k: v.detach() for k, v in constrain(params, config).items()}
    mean, S, _ = _moments(c["u_h"], c["u_lam"])
    L = _kuu_factors(c, config, policy or JitterPolicy())
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    linv = tri_solve(L, eye)
    return _Predictive(c, linv.mT @ mean, linv.mT @ (S - eye) @ linv,
                       config.kernel)


def _row_stats(kernel, variance, ard, mu, s, Z):
    """Per-atom test-point statistics, plain torch: Psi1 (T, N*, M), the
    per-row Psi2 (T, N*, M, M) and E[k(x, x)] (T, N*) of the RBF, or of
    the linear kernel (exact moments: Psi2_n = var^2 Z A (mu_n mu_n^T +
    diag(s_n)) A Z^T, E[k] = var sum_q alpha_q (mu^2 + s))."""
    if dispatch._kernel(kernel) is linear:
        za = Z * ard[:, None, :]                                  # (T, M, Q)
        second = mu[:, :, None] * mu[:, None, :] + torch.diag_embed(s)
        p2 = (variance * variance)[:, None, None, None] * (
            za[:, None] @ second[None] @ za[:, None].mT)
        k_diag = variance[:, None] * torch.sum(
            ard[:, None, :] * (mu * mu + s)[None], dim=-1)
        return linear.psi1(variance, ard, mu, s, Z), p2, k_diag
    _, _, expo = ard_rbf._forward_pieces(variance, ard, mu, s, Z,
                                         ard_rbf._log_e(ard, Z))
    p2 = (variance * variance)[:, None, None, None] * torch.exp(
        torch.clamp(expo, max=0.0))
    # the RBF's expected diagonal E[k(x, x)] is its signal variance
    return psi1_weighted(variance, ard, mu, s, Z), p2, variance[:, None]


def _atom_predictive(pred: _Predictive, x_mean, x_var):
    """(f_mean (T, N*, D), var (T, N*, D)): each atom's psi-moment
    predictive at the q(x*) rows (the reference's per-atom algebra, every
    row and atom in one batch of tensor ops). With A2_n = L^{-1} Psi2_n
    L^{-T}: mean = Psi1_n U, and var = E[k_nn] - tr(A2_n) + tr(S A2_n)
    + m_d^T A2_n m_d - mean^2 + noise, where tr(S A2_n) - tr(A2_n) =
    <Psi2_n, W> and m_d^T A2_n m_d = u_d^T Psi2_n u_d."""
    c, U, W, kernel = pred
    var_f, ard, z, noise = c["variance"], c["ard"], c["z"], c["noise"]
    p1, p2, k_diag = _row_stats(kernel, var_f, ard, x_mean, x_var, z)
    f_mean = p1 @ U                                            # (T, N*, D)
    gp_var = torch.sum(p2 * W[:, None], dim=(-2, -1))
    m_quad = torch.sum(U[:, None] * (p2 @ U[:, None]), dim=-2)
    noise = noise[:, None, None]
    var = (k_diag + gp_var)[..., None] + m_quad - f_mean * f_mean + noise
    # var >= noise in exact arithmetic; the floor removes f32 cancellation
    return f_mean, torch.maximum(var, noise)


def _mixture(pred: _Predictive, x_mean, x_var):
    f_mean_t, var_t = _atom_predictive(pred, x_mean, x_var)
    w = pred.c["phi"].T[:, None, :]                            # (T, 1, D)
    mean = torch.sum(w * f_mean_t, dim=0)
    # sum_t w (var_t + (m_t - mean)^2): no cancellation can make it negative
    dev = f_mean_t - mean[None]
    return mean, torch.sum(w * (var_t + dev * dev), dim=0)


def predict_from_latent(params, x_mean, x_var, config: Config,
                        policy: JitterPolicy | None = None):
    """Mixture predictive mean and variance at q(x*) = N(x_mean,
    diag(x_var)): mean_nd = sum_t phi_dt mean_tnd, variance by the
    mixture's second moment. At one-hot phi it is the owning atom's
    predictive; at T = 1 `svi_gplvm.predict_from_latent`."""
    with torch.no_grad():
        return _mixture(_predictive(params, config, policy), x_mean, x_var)


def _objective(pred: _Predictive, y_star, mask):
    """The negative test-time ELBO of q(x*) under the phi-weighted mixture
    of the per-atom q(u | t), given the rows `y_star` observed where
    `mask` is 1."""
    c = pred.c
    phi, noise = c["phi"], c["noise"][:, None, None]
    log_norm = -0.5 * (LOG2PI + torch.log(noise))
    beta = 1.0 / noise
    w = phi.T[:, None, :]

    def objective(vp):
        s = positive_variational_var(vp["raw_s"])
        f_mean, var_t = _atom_predictive(pred, vp["m"], s)
        # E_t[(y - f)^2]; var_t holds the noise, taken back out
        sq = (y_star[None] * y_star[None] - 2.0 * y_star[None] * f_mean
              + var_t + f_mean * f_mean - noise)
        ell = torch.sum(mask[None] * w * (log_norm - 0.5 * beta * sq))
        return -(ell - gaussian.kl_to_standard_normal(vp["m"], s))

    return objective


def _infer(pred: _Predictive, y_star, mask, m_init, num_steps, lr, tol):
    from dp_gp_lvm_tpu_torch.models.prediction import (
        _fit_variational,
        _latent_var_params,
    )

    vp, trace, _ = _fit_variational(
        _objective(pred, y_star, mask),
        _latent_var_params(m_init, y_star.dtype), num_steps, lr, tol)
    return vp["m"], positive_variational_var(vp["raw_s"]), -trace


def infer_latent(params, y_star, mask, m_init, config: Config,
                 num_steps: int = 200, lr: float = 0.05,
                 tol: float | None = None,
                 policy: JitterPolicy | None = None):
    """Fit q(x*) for new rows against the masked phi-weighted expected
    log-likelihood under the per-atom q(u | t) (mask (N*, D), 1 =
    observed), with the Adam of `prediction._fit_variational`. The K_uu
    factors and q(u) moments do not depend on q(x*) and are computed once.
    Returns (m*, s*, objective trace)."""
    return _infer(_predictive(params, config, policy), y_star, mask, m_init,
                  num_steps, lr, tol)


@torch.no_grad()
def _candidates(pred: _Predictive):
    """The nearest-latent init's candidates: every (N // 2048)-th training
    latent and its mixture-predicted mean. None for an amortized model,
    which has no table: its encoder gives the init (`_nearest`)."""
    if "qx_mean" not in pred.c:
        return None
    qx = pred.c["qx_mean"]
    n = qx.shape[0]
    take = torch.arange(0, n, max(1, n // NEAREST_CANDIDATES),
                        device=qx.device)
    mean, _ = _mixture(pred, qx[take], pred.c["qx_var"][take])
    return qx[take], mean


@torch.no_grad()
def _nearest(candidates, y_star, mask, c=None):
    """Each row's candidate latent whose predicted mean best matches its
    observed dims; with no candidates (an amortized model) the encoder's
    one pass over the rows of constrained `c`, the missing dims filled at
    its centre."""
    if candidates is None:
        return amortized.encoder_fill_init(c, y_star, mask)
    cand, cand_mean = candidates
    d2 = torch.sum(((y_star[:, None, :] - cand_mean[None, :, :]) ** 2)
                   * mask[:, None, :], dim=-1)
    return cand[torch.argmin(d2, dim=1)]


def impute(params, y_star, mask, config: Config, num_steps: int = 200,
           lr: float = 0.05, tol: float | None = None):
    """Missing-data pipeline: q(x*) from the observed dims under the
    phi-weighted mixture likelihood, every dim predicted from the per-atom
    q(u | t) mixture. Returns (mean, var, m*, s*, objective trace)."""
    pred = _predictive(params, config)
    m0 = _nearest(_candidates(pred), y_star, mask, pred.c)
    m_s, s_s, trace = _infer(pred, y_star, mask, m0, num_steps, lr, tol)
    with torch.no_grad():
        mean, var = _mixture(pred, m_s, s_s)
    return mean, var, m_s, s_s, trace
