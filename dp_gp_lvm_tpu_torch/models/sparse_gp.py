r"""Sparse variational GP regression (SGPR, Titsias 2009) with the ARD-RBF
kernel (counterpart of `dp_gp_lvm_tpu/models/sparse_gp.py`): the collapsed
bound at observed inputs, where the psi statistics are Gram matrices,
Psi0 = N sigma_f^2, Psi1 = K_nm, Psi2 = K_mn K_nm.

Parameters: raw_variance (), raw_ard (Q,), raw_noise (), z (M, Q). Plain
torch, as in the reference: no Pallas kernel there, no hand kernel here.
"""
from __future__ import annotations

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_inverse,
    positive_noise,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.linalg import tri_solve
from dp_gp_lvm_tpu_torch.models.bound import (
    collapsed_bound,
    optimal_qu,
    suff_stats_from_psi,
)


def init_params(key, X, num_inducing: int):
    """Z from the inputs at the first `num_inducing` entries of
    `permutation(key, N)` (a key of the reference's stream,
    `core/prng.py`); on X's device."""
    n, q = X.shape
    idx = prng.permutation(key, n)[:num_inducing].to(X.device)
    one = torch.ones((), dtype=X.dtype, device=X.device)
    params = {"raw_variance": positive_inverse(one),
              "raw_ard": positive_inverse(torch.ones(q, dtype=X.dtype,
                                                     device=X.device)),
              "raw_noise": positive_inverse(0.1 * one),
              "z": X[idx]}
    return {k: nn.Parameter(v.contiguous()) for k, v in params.items()}


def constrain(params):
    return {"variance": positive(params["raw_variance"]),
            "ard": positive(params["raw_ard"]),
            "noise": positive_noise(params["raw_noise"]),
            "z": params["z"]}


def _stats(hyp, X, Y):
    p0, p1, p2 = ard_rbf.observed_psi(hyp["variance"], hyp["ard"], X,
                                      hyp["z"])
    return suff_stats_from_psi(p0, p1, p2, Y)


def elbo(params, X, Y, policy: JitterPolicy = JitterPolicy()):
    """Collapsed lower bound on log p(Y | X), summed over output dims."""
    hyp = constrain(params)
    kuu = ard_rbf.gram(hyp["variance"], hyp["ard"], hyp["z"])
    return torch.sum(collapsed_bound(kuu, _stats(hyp, X, Y), hyp["noise"],
                                     policy).per_dim)


def loss(params, X, Y):
    return -elbo(params, X, Y)


def predict(params, X, Y, X_star, policy: JitterPolicy = JitterPolicy()):
    """Predictive mean (N*, D) and marginal variance (N*,), noise included:
    var = k** - k_su (K_uu^{-1} - (K_uu + beta Psi2)^{-1}) k_us + sigma^2."""
    hyp = constrain(params)
    kuu = ard_rbf.gram(hyp["variance"], hyp["ard"], hyp["z"])
    w, L, LB = optimal_qu(kuu, _stats(hyp, X, Y), hyp["noise"], policy)
    ksu = ard_rbf.gram(hyp["variance"], hyp["ard"], X_star, hyp["z"])
    a = tri_solve(L, ksu.T)                            # L^{-1} k_us
    b = tri_solve(LB, a)                               # LB^{-1} L^{-1} k_us
    var = (ard_rbf.gram_diag(hyp["variance"], hyp["ard"], X_star)
           - torch.sum(a * a, dim=0) + torch.sum(b * b, dim=0)
           + hyp["noise"])
    return ksu @ w, var
