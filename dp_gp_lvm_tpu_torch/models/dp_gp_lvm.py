r"""DP-GP-LVM: a Dirichlet-process mixture over output dimensions
(counterpart of `dp_gp_lvm_tpu/models/dp_gp_lvm.py`).

    ELBO = sum_{d,t} phi_dt F_dt + E_q[log p(z|v)] + H[q(z)]
           - KL[q(v) || p(v|alpha)] - KL[q(X) || N(0, I)]

Params (unconstrained, same keys and layouts as the JAX package):
    qx_mean (N, Q), raw_qx_var (N, Q), z (T, M, Q), raw_variance (T,),
    raw_ard (T, Q), raw_noise (T,), phi_logits (D, T),
    raw_gamma1 (T-1,), raw_gamma2 (T-1,), optional raw_alpha ().
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_inverse,
    positive_noise,
    positive_variational_var,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy, pin_full_f32
from dp_gp_lvm_tpu_torch.distributions import gaussian, stick_breaking
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.models.bgplvm import _log_normal_hyperprior
from dp_gp_lvm_tpu_torch.models.bound import SuffStats, collapsed_bound
from dp_gp_lvm_tpu_torch.ops import dispatch, psi as psi_ops
from dp_gp_lvm_tpu_torch.train.init import (
    inducing_from_latents,
    near_uniform_assignments,
    pca_latents,
)
from dp_gp_lvm_tpu_torch.train.logging import named_scope


class Config(NamedTuple):
    num_latent: int
    num_inducing: int
    truncation: int          # T
    alpha: float = 1.0       # DP concentration
    psi2_block: int | None = None
    # True | False | "auto": the fused CUDA kernels K1/K2 (ops/psi.py);
    # "auto" takes them for tensors on the card where they take the shape
    use_fused: bool | str = "auto"
    kernel: str = "ard_rbf"
    fast_chol: bool = False
    hyperprior_std: float = 0.0
    learn_alpha: bool = False


def init_params(key, Y, config: Config):
    """Initial parameters on Y's device, drawn from `key` (a key of the
    reference's stream, `core/prng.py`) as the reference draws them."""
    dtype, device = Y.dtype, Y.device
    t, q = config.truncation, config.num_latent
    d = Y.shape[1]
    r_z, r_phi, r_hyp = prng.split(key, 3)
    x0 = pca_latents(Y, q)
    z0 = inducing_from_latents(r_z, x0, config.num_inducing)
    noise = prng.normal(r_hyp, (t, q), dtype).to(device)
    # small per-atom jitter on the ARD weights breaks atom symmetry
    ard0 = 1.0 + 0.05 * noise

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    params = {
        "qx_mean": x0,
        "raw_qx_var": positive_inverse(0.5 * torch.ones_like(x0)),
        "z": z0.expand((t,) + z0.shape).clone(),
        "raw_variance": positive_inverse(full((t,), 1.0)),
        "raw_ard": positive_inverse(torch.clamp(ard0, min=0.1)),
        "raw_noise": positive_inverse(full((t,), 0.1)),
        "phi_logits": near_uniform_assignments(r_phi, d, t,
                                               dtype=dtype).to(device),
        "raw_gamma1": positive_inverse(full((t - 1,), 1.0)),
        "raw_gamma2": positive_inverse(full((t - 1,), config.alpha)),
    }
    if config.learn_alpha:
        params["raw_alpha"] = positive_inverse(full((), config.alpha))
    return {k: nn.Parameter(v.contiguous()) for k, v in params.items()}


def constrain(params):
    out = {
        "qx_mean": params["qx_mean"],
        "qx_var": positive_variational_var(params["raw_qx_var"]),
        "z": params["z"],
        "variance": positive(params["raw_variance"]),
        "ard": positive(params["raw_ard"]),
        "noise": positive_noise(params["raw_noise"]),
        "phi": torch.softmax(params["phi_logits"], dim=-1),
        "gamma1": positive(params["raw_gamma1"], 1e-4),
        "gamma2": positive(params["raw_gamma2"], 1e-4),
    }
    if "raw_alpha" in params:
        out["alpha"] = positive(params["raw_alpha"], 1e-3)
    return out


def per_dim_atom_bound(hyp, Y, config: Config,
                       policy: JitterPolicy = JitterPolicy()):
    """F (T, D): per-atom, per-dimension collapsed free energies."""
    if config.fast_chol:
        policy = JitterPolicy(max_tries=0)
    mu, s, z = hyp["qx_mean"], hyp["qx_var"], hyp["z"]
    variance, ard = hyp["variance"], hyp["ard"]
    # profiler regions (`train.logging.named_scope`), each around the
    # batched call over every atom
    with named_scope("kuu_gram"):
        kuu_b = dispatch.gram(variance, ard, z, kernel=config.kernel)
    with named_scope("psi_stats"):
        if dispatch.resolve_fused(config.use_fused, config.kernel,
                                  mu.device, *z.shape[1:], Y.shape[1],
                                  inputs=(variance, ard, mu, s, z, Y)):
            # one kernel gives Psi2 AND Psi1^T Y per atom; Psi1 never stored
            p0_b = ard_rbf.psi0(variance, mu)
            p2_b, p1y_b = psi_ops.suffstats_batched_fused(
                variance, ard, mu, s, z, Y, None, config.psi2_block or 64
            )
        else:
            p0, p1y, p2 = [], [], []
            for t in range(z.shape[0]):
                p0_t, p1_t, p2_t = dispatch.psi_stats(
                    variance[t], ard[t], mu, s, z[t],
                    block_n=config.psi2_block, kernel=config.kernel,
                )
                p0.append(p0_t)
                p1y.append(p1_t.T @ Y)
                p2.append(p2_t)
            p0_b, p1y_b, p2_b = (torch.stack(x) for x in (p0, p1y, p2))
    with named_scope("collapsed_bound"):
        stats = SuffStats(
            psi0=p0_b, psi1T_y=p1y_b, psi2=p2_b,
            yty=torch.sum(Y * Y, dim=0),
            n=torch.tensor(float(Y.shape[0]), dtype=Y.dtype,
                           device=Y.device),
        )
        return collapsed_bound(kuu_b, stats, hyp["noise"], policy).per_dim


def elbo_terms(params, Y, config: Config,
               policy: JitterPolicy = JitterPolicy()):
    if Y.device.type == "cuda":
        pin_full_f32()
    hyp = constrain(params)
    f_td = per_dim_atom_bound(hyp, Y, config, policy)
    phi = hyp["phi"]
    fit = torch.sum(phi * f_td.T)
    alpha = hyp.get("alpha", torch.tensor(config.alpha, dtype=Y.dtype,
                                          device=Y.device))
    dp = stick_breaking.dp_kl_terms(
        phi, hyp["gamma1"], hyp["gamma2"], alpha,
        logits=params["phi_logits"],
    )
    if "alpha" in hyp:
        dp = dp + stick_breaking.alpha_log_prior(alpha)
    kl_x = gaussian.kl_to_standard_normal(hyp["qx_mean"], hyp["qx_var"])
    hp = _log_normal_hyperprior(
        config.hyperprior_std, hyp["variance"], hyp["ard"], hyp["noise"]
    )
    return {
        "elbo": fit + dp - kl_x + hp,
        "hyperprior": hp,
        "fit": fit,
        "dp_terms": dp,
        "kl_x": kl_x,
        "f_td": f_td,
    }


def elbo(params, Y, config: Config, policy: JitterPolicy = JitterPolicy()):
    return elbo_terms(params, Y, config, policy)["elbo"]


def loss(params, Y, config: Config):
    return -elbo(params, Y, config)


@torch.no_grad()
def cavi_step(params, Y, config: Config,
              policy: JitterPolicy = JitterPolicy()):
    """Closed-form coordinate updates of (phi, gamma) (and alpha when it is
    learned) at the other parameters held: a new params dict with
    `phi_logits`, `raw_gamma1`, `raw_gamma2` (and `raw_alpha`) replaced by
    their CAVI optima and every other leaf the same tensor, so an
    optimizer over `params` still holds its own tensors. On the card the
    per-atom bound is one K1 launch over every atom, and nothing is
    differentiated."""
    if Y.device.type == "cuda":
        pin_full_f32()
    hyp = constrain(params)
    alpha = hyp.get("alpha", torch.tensor(config.alpha, dtype=Y.dtype,
                                          device=Y.device))
    f_td = per_dim_atom_bound(hyp, Y, config, policy)
    phi = stick_breaking.phi_cavi_update(f_td.T, hyp["gamma1"],
                                         hyp["gamma2"])
    g1, g2 = stick_breaking.gamma_cavi_update(phi, alpha)
    out = dict(params)
    out["phi_logits"] = torch.log(torch.clamp(phi, min=1e-30))
    out["raw_gamma1"] = positive_inverse(g1)
    out["raw_gamma2"] = positive_inverse(g2)
    if "raw_alpha" in params:
        out["raw_alpha"] = positive_inverse(
            stick_breaking.alpha_cavi_update(g1, g2))
    return out


def expected_assignments(params):
    """phi (D, T): the posterior over output-dimension group assignments."""
    return torch.softmax(params["phi_logits"], dim=-1)
