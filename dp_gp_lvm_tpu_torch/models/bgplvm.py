r"""Bayesian GP-LVM (Titsias & Lawrence 2010), collapsed variational bound
(counterpart of `dp_gp_lvm_tpu/models/bgplvm.py`).

Latent X is unobserved with q(X) = prod N(x_n | mu_n, diag(s_n)); all D
output dims share one ARD-RBF kernel and noise:

    ELBO = sum_d F_d(Psi0, Psi1, Psi2, K_uu, sigma^2) - KL[q(X) || N(0, I)].

Params (unconstrained, same keys and layouts as the JAX package):
    qx_mean (N, Q), raw_qx_var (N, Q),
    z (M, Q), raw_variance (), raw_ard (Q,), raw_noise ().
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_inverse,
    positive_noise,
    positive_variational_var,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy, pin_full_f32
from dp_gp_lvm_tpu_torch.distributions import gaussian
from dp_gp_lvm_tpu_torch.models.bound import (
    collapsed_bound,
    suff_stats_from_psi,
)
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.train.init import inducing_from_latents, pca_latents


class Config(NamedTuple):
    num_latent: int
    num_inducing: int
    psi2_block: int | None = None  # chunk size over N of the plain Psi2
    # True | False | "auto": the fused CUDA kernels K6/K5/K2 (ops/psi.py);
    # "auto" takes them for tensors on the card where they take the shape
    use_fused: bool | str = "auto"
    kernel: str = "ard_rbf"
    fast_chol: bool = False        # skip the jitter search in the hot step
    hyperprior_std: float = 0.0    # log-normal prior on hypers (0 = off)


def init_params(key, Y, config: Config):
    """PCA-initialized parameters on Y's device; Z is drawn from `key` (a
    key of the reference's stream, `core/prng.py`) as the reference
    draws it."""
    dtype, device = Y.dtype, Y.device
    x0 = pca_latents(Y, config.num_latent)
    z0 = inducing_from_latents(key, x0, config.num_inducing)
    params = {
        "qx_mean": x0,
        "raw_qx_var": positive_inverse(0.5 * torch.ones_like(x0)),
        "z": z0,
        "raw_variance": positive_inverse(
            torch.tensor(1.0, dtype=dtype, device=device)),
        "raw_ard": positive_inverse(
            torch.ones(config.num_latent, dtype=dtype, device=device)),
        "raw_noise": positive_inverse(
            torch.tensor(0.1, dtype=dtype, device=device)),
    }
    return {k: nn.Parameter(v.contiguous()) for k, v in params.items()}


def constrain(params):
    return {
        "qx_mean": params["qx_mean"],
        "qx_var": positive_variational_var(params["raw_qx_var"]),
        "z": params["z"],
        "variance": positive(params["raw_variance"]),
        "ard": positive(params["raw_ard"]),
        "noise": positive_noise(params["raw_noise"]),
    }


def _log_normal_hyperprior(std, *values):
    """sum of log N(log v | 0, std^2) up to constants; 0 disables."""
    if not std:
        return 0.0
    tot = 0.0
    for v in values:
        lv = torch.log(v)
        tot = tot - 0.5 * torch.sum(lv * lv) / (std * std)
    return tot


def elbo_terms(params, Y, config: Config,
               policy: JitterPolicy = JitterPolicy()):
    """Per-term ELBO decomposition."""
    if Y.device.type == "cuda":
        pin_full_f32()
    if config.fast_chol:
        policy = JitterPolicy(max_tries=0)
    hyp = constrain(params)
    mu, s, z = hyp["qx_mean"], hyp["qx_var"], hyp["z"]
    p0, p1, p2 = dispatch.psi_stats(
        hyp["variance"], hyp["ard"], mu, s, z, block_n=config.psi2_block,
        use_fused=config.use_fused, kernel=config.kernel,
    )
    kuu = dispatch.gram(hyp["variance"], hyp["ard"], z, kernel=config.kernel)
    stats = suff_stats_from_psi(p0, p1, p2, Y)
    terms = collapsed_bound(kuu, stats, hyp["noise"], policy)
    fit = torch.sum(terms.per_dim)
    kl_x = gaussian.kl_to_standard_normal(mu, s)
    hp = _log_normal_hyperprior(
        config.hyperprior_std, hyp["variance"], hyp["ard"], hyp["noise"]
    )
    return {
        "elbo": fit - kl_x + hp,
        "hyperprior": hp,
        "fit": fit,
        "kl_x": kl_x,
        "logdet_b": terms.logdet_b,
        "trace_a": terms.trace_a,
        "jitter": terms.jitter,
    }


def elbo(params, Y, config: Config, policy: JitterPolicy = JitterPolicy()):
    return elbo_terms(params, Y, config, policy)["elbo"]


def loss(params, Y, config: Config):
    return -elbo(params, Y, config)
