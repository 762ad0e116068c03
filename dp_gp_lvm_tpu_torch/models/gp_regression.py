r"""Exact GP regression with the ARD-RBF kernel (counterpart of
`dp_gp_lvm_tpu/models/gp_regression.py`): the base model of the family and
the oracle of the sparse bound, which is a lower bound on this log
marginal likelihood with equality at Z = X.

    log p(Y | X) = sum_d [ -1/2 y_d^T K_y^{-1} y_d - 1/2 log|K_y|
                           - N/2 log 2 pi ],   K_y = K_ff + sigma^2 I

Parameters (unconstrained): raw_variance (), raw_ard (Q,), raw_noise ().
Plain torch: no kernel of `csrc/` computes a Gram matrix.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_inverse,
    positive_noise,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy, resolve_device
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.linalg import (
    logdet_from_chol,
    safe_cholesky,
    tri_solve,
)


def init_params(q: int, dtype=torch.float64, device=None):
    """Unit signal variance and ARD weights, noise 0.1; on the card unless
    `device` names another."""
    device = resolve_device(device)
    one = torch.ones((), dtype=dtype, device=device)
    params = {"raw_variance": positive_inverse(one),
              "raw_ard": positive_inverse(torch.ones(q, dtype=dtype,
                                                     device=device)),
              "raw_noise": positive_inverse(0.1 * one)}
    return {k: nn.Parameter(v) for k, v in params.items()}


def constrain(params):
    return {"variance": positive(params["raw_variance"]),
            "ard": positive(params["raw_ard"]),
            "noise": positive_noise(params["raw_noise"])}


def _factor(hyp, X, policy):
    n = X.shape[0]
    ky = ard_rbf.gram(hyp["variance"], hyp["ard"], X) + hyp["noise"] * (
        torch.eye(n, dtype=X.dtype, device=X.device))
    return safe_cholesky(ky, policy)[0]


def log_marginal(params, X, Y, policy: JitterPolicy = JitterPolicy()):
    """Exact log marginal likelihood, summed over output dims."""
    hyp = constrain(params)
    n, d = X.shape[0], Y.shape[1]
    L = _factor(hyp, X, policy)
    alpha = tri_solve(L, Y)                            # L^{-1} Y
    return (-0.5 * torch.sum(alpha * alpha)
            - 0.5 * d * logdet_from_chol(L)
            - 0.5 * d * n * math.log(2.0 * math.pi))


def loss(params, X, Y):
    return -log_marginal(params, X, Y)


def predict(params, X, Y, X_star, policy: JitterPolicy = JitterPolicy()):
    """Predictive mean (N*, D) and marginal variance (N*,), noise
    included."""
    hyp = constrain(params)
    L = _factor(hyp, X, policy)
    ks = ard_rbf.gram(hyp["variance"], hyp["ard"], X_star, X)   # (N*, N)
    a = tri_solve(L, ks.T)                                       # (N, N*)
    mean = a.T @ tri_solve(L, Y)
    var = (ard_rbf.gram_diag(hyp["variance"], hyp["ard"], X_star)
           - torch.sum(a * a, dim=0) + hyp["noise"])
    return mean, var
