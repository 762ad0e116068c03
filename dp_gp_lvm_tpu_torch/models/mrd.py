r"""MRD, Manifold Relevance Determination (Damianou et al. 2012)
(counterpart of `dp_gp_lvm_tpu/models/mrd.py`).

Several observation views Y^(v) share one latent space q(X); each view
has its own kernel (its own ARD weights), noise and inducing points, and
the ARD patterns across views separate shared from private latent dims:

    ELBO = sum_v sum_{d in view v} F_vd - KL[q(X) || N(0, I)].

Params (unconstrained, the reference's keys and layouts):
    qx_mean (N, Q), raw_qx_var (N, Q),
    views: a list of {z (M, Q), raw_variance (), raw_ard (Q,),
                      raw_noise ()}, one per view.
Each view's statistics go through `dispatch.suff_stats`: on the card K1
at T = 1 with K2 in the backward, and Psi1 is never stored.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

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
from dp_gp_lvm_tpu_torch.distributions import gaussian
from dp_gp_lvm_tpu_torch.models.bgplvm import _log_normal_hyperprior
from dp_gp_lvm_tpu_torch.models.bound import collapsed_bound
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.train.init import inducing_from_latents, pca_latents


class Config(NamedTuple):
    num_latent: int
    num_inducing: int
    num_views: int
    psi2_block: int | None = None
    # True | False | "auto": the fused CUDA kernels K1/K2 (ops/psi.py) per
    # view; "auto" takes them for tensors on the card where they take the
    # shape
    use_fused: bool | str = "auto"
    kernel: str = "ard_rbf"
    fast_chol: bool = False        # skip the jitter search in the hot step
    hyperprior_std: float = 0.0    # log-normal prior on hypers (0 = off)


def init_params(key, Ys: Sequence[torch.Tensor], config: Config):
    """PCA on the concatenated views, then per view its inducing points
    from its own key of `split(key, V)` (keys of the reference's stream,
    `core/prng.py`), on the views' device."""
    Yall = torch.cat(list(Ys), dim=1)
    dtype, device = Yall.dtype, Yall.device
    x0 = pca_latents(Yall, config.num_latent)
    q = config.num_latent

    def leaf(v):
        return nn.Parameter(v.contiguous())

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    views = [
        {
            "z": leaf(inducing_from_latents(k, x0, config.num_inducing)),
            "raw_variance": leaf(positive_inverse(full((), 1.0))),
            "raw_ard": leaf(positive_inverse(full((q,), 1.0))),
            "raw_noise": leaf(positive_inverse(full((), 0.1))),
        }
        for k, _ in zip(prng.split(key, len(Ys)), Ys)
    ]
    return {
        "qx_mean": leaf(x0),
        "raw_qx_var": leaf(positive_inverse(0.5 * torch.ones_like(x0))),
        "views": views,
    }


def constrain_view(vp):
    return {
        "z": vp["z"],
        "variance": positive(vp["raw_variance"]),
        "ard": positive(vp["raw_ard"]),
        "noise": positive_noise(vp["raw_noise"]),
    }


def elbo_terms(params, Ys, config: Config,
               policy: JitterPolicy = JitterPolicy()):
    """Per-term ELBO decomposition; `fit_per_view` is (V,)."""
    if Ys[0].device.type == "cuda":
        pin_full_f32()
    if config.fast_chol:
        policy = JitterPolicy(max_tries=0)
    mu = params["qx_mean"]
    s = positive_variational_var(params["raw_qx_var"])
    fit_per_view = []
    for vp, Y in zip(params["views"], Ys):
        hyp = constrain_view(vp)
        stats = dispatch.suff_stats(
            hyp["variance"], hyp["ard"], mu, s, hyp["z"], Y,
            block_n=config.psi2_block, use_fused=config.use_fused,
            kernel=config.kernel,
        )
        kuu = dispatch.gram(hyp["variance"], hyp["ard"], hyp["z"],
                            kernel=config.kernel)
        terms = collapsed_bound(kuu, stats, hyp["noise"], policy)
        fit_per_view.append(torch.sum(terms.per_dim))
    fit = sum(fit_per_view)
    kl_x = gaussian.kl_to_standard_normal(mu, s)
    hp = 0.0
    if config.hyperprior_std:
        for vp in params["views"]:
            h = constrain_view(vp)
            hp = hp + _log_normal_hyperprior(
                config.hyperprior_std, h["variance"], h["ard"], h["noise"])
    return {
        "elbo": fit - kl_x + hp,
        "hyperprior": hp,
        "fit": fit,
        "kl_x": kl_x,
        "fit_per_view": torch.stack(fit_per_view),
    }


def elbo(params, Ys, config: Config, policy: JitterPolicy = JitterPolicy()):
    return elbo_terms(params, Ys, config, policy)["elbo"]


def loss(params, Ys, config: Config):
    return -elbo(params, Ys, config)


def ard_relevance(params):
    """Per-view ARD weights (V, Q), the shared/private signature: a latent
    dim is shared when its weight is large in several views, private when
    large in exactly one."""
    return torch.stack([positive(vp["raw_ard"]) for vp in params["views"]])
