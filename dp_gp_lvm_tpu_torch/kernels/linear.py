r"""ARD-linear kernel and its psi statistics (counterpart of
`dp_gp_lvm_tpu/kernels/linear.py`).

    k(x, x') = sigma_f^2 sum_q alpha_q x_q x'_q

Under q(X) = prod N(mu, diag(s)) every psi statistic is a polynomial
moment, so all three are exact matrix products:

    psi0       = sigma_f^2 sum_{n,q} alpha_q (mu_nq^2 + s_nq)
    Psi1[n,m]  = sigma_f^2 sum_q alpha_q mu_nq z_mq
    Psi2[m,m'] = sigma_f^4 z_m^T A ( sum_n (mu_n mu_n^T + diag(s_n)) ) A z_m'
                 with A = diag(alpha).

No CUDA kernel computes them: the reference computes them outside any
Pallas kernel too. `gram` and `psi1` batch over leading (atom) dims of
variance (...,), ard (..., Q) and Z (..., M, Q), as `kernels/ard_rbf.py`
does; the rest take one kernel.
"""
from __future__ import annotations

import torch


def gram(variance, ard, X1, X2=None):
    """k(X1, X2): X1 (..., N1, Q), X2 (..., N2, Q) or None."""
    X2 = X1 if X2 is None else X2
    return variance[..., None, None] * ((X1 * ard[..., None, :]) @ X2.mT)


def gram_diag(variance, ard, X):
    return variance * torch.sum(ard[None, :] * X * X, dim=-1)


def psi0(variance, ard, mu, s, weights=None):
    per_row = torch.sum(ard[None, :] * (mu * mu + s), dim=-1)
    if weights is not None:
        per_row = per_row * weights
    return variance * torch.sum(per_row)


def psi1(variance, ard, mu, s, Z, weights=None):
    """Psi1 (..., N, M)."""
    out = variance[..., None, None] * ((mu * ard[..., None, :]) @ Z.mT)
    if weights is not None:
        out = out * weights[:, None]
    return out


def psi2(variance, ard, mu, s, Z, weights=None, block_n=None):
    """Psi2 (M, M). `block_n` is taken for the interface's sake and not
    used: the second moment contracts to a (Q, Q) matrix first, so no
    N-sized intermediate exists."""
    mu_w = mu if weights is None else mu * torch.sqrt(weights)[:, None]
    s_w = s if weights is None else s * weights[:, None]
    second = mu_w.T @ mu_w + torch.diag(torch.sum(s_w, dim=0))    # (Q, Q)
    za = Z * ard[None, :]                                          # (M, Q)
    return (variance * variance) * ((za @ second) @ za.T)


def psi_stats(variance, ard, mu, s, Z, weights=None, block_n=None):
    return (
        psi0(variance, ard, mu, s, weights),
        psi1(variance, ard, mu, s, Z, weights),
        psi2(variance, ard, mu, s, Z, weights, block_n),
    )


def observed_psi(variance, ard, X, Z):
    knm = gram(variance, ard, X, Z)
    p0 = torch.sum(gram_diag(variance, ard, X))
    return p0, knm, knm.T @ knm
