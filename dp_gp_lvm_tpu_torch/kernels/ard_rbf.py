r"""ARD-RBF kernel and its psi statistics (counterpart of
`dp_gp_lvm_tpu/kernels/ard_rbf.py`; the math is in that module's
docstring, Titsias & Lawrence 2010).

    k(x, x') = sigma_f^2 exp(-1/2 sum_q alpha_q (x_q - x'_q)^2)

Every quadratic form is expanded into matrix products, in the same order
as the reference, so that the f64 CPU path agrees with it to rounding.
Float32 products on the GPU run in full f32 (`core.types.pin_full_f32`).
"""
from __future__ import annotations

import torch


def gram(variance, ard, X1, X2=None):
    """Gram matrix k(X1, X2). X1: (..., N1, Q), X2: (..., N2, Q) or None;
    variance (...,) and ard (..., Q) batch over leading (atom) dims."""
    sq = torch.sqrt(ard)[..., None, :]
    Xs1 = X1 * sq
    Xs2 = Xs1 if X2 is None else X2 * sq
    n1 = torch.sum(Xs1 * Xs1, dim=-1)
    n2 = n1 if X2 is None else torch.sum(Xs2 * Xs2, dim=-1)
    d2 = n1[..., :, None] - 2.0 * (Xs1 @ Xs2.mT) + n2[..., None, :]
    d2 = torch.clamp(d2, min=0.0)
    return variance[..., None, None] * torch.exp(-0.5 * d2)


def gram_diag(variance, ard, X):
    """diag k(X, X) = sigma_f^2."""
    return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * variance


def psi0(variance, mu, weights=None):
    """Psi0 = sum_n w_n sigma_f^2."""
    if weights is None:
        return variance * mu.shape[0]
    return variance * torch.sum(weights)


def _psi1_pieces(variance, ard, mu, s, Z):
    u = ard[..., None, :] * s + 1.0
    a = ard[..., None, :] / u
    log_norm = -0.5 * torch.sum(torch.log(u), dim=-1)
    row = torch.sum(a * mu * mu, dim=-1)
    cross = (a * mu) @ Z.mT
    zsq = a @ (Z * Z).mT
    e = log_norm[..., None] - 0.5 * (row[..., None] - 2.0 * cross + zsq)
    return u, a, e


def psi1(variance, ard, mu, s, Z, weights=None):
    """Psi1 (..., N, M): <k(x_n, z_m)> under q(X). Batch-polymorphic over
    leading atom dims of variance (...,), ard (..., Q), Z (..., M, Q)."""
    _, _, e = _psi1_pieces(variance, ard, mu, s, Z)
    # each factor is <= 1, so the exponent is <= 0 exactly; the clamp
    # keeps f32 cancellation error from reaching exp() as a positive value
    out = variance[..., None, None] * torch.exp(torch.clamp(e, max=0.0))
    if weights is not None:
        out = out * weights[:, None]
    return out


def _log_e(ard, Z):
    """-1/4 alpha-weighted squared distance of inducing pairs, (..., M, M)
    for ard (..., Q) and Z (..., M, Q)."""
    Zs = Z * torch.sqrt(ard)[..., None, :]
    zn = torch.sum(Zs * Zs, dim=-1)
    zd2 = torch.clamp(zn[..., :, None] - 2.0 * (Zs @ Zs.mT)
                      + zn[..., None, :], min=0.0)
    return -0.25 * zd2


def _forward_pieces(variance, ard, mu, s, Z, log_e):
    """Shared forward quantities for a block of rows: u, b (..., B, Q) and
    the unclamped exponent (..., B, M, M). Batch-polymorphic over leading
    atom dims of ard (..., Q), Z (..., M, Q), log_e (..., M, M)."""
    u = 2.0 * ard[..., None, :] * s + 1.0
    b = ard[..., None, :] / u
    log_norm = -0.5 * torch.sum(torch.log(u), dim=-1)
    sterm = torch.sum(b * mu * mu, dim=-1)
    t = (b * mu) @ Z.mT
    p = b @ (Z * Z).mT
    Zb = Z[..., None, :, :] * b[..., :, None, :]
    c = torch.einsum("...bmq,...lq->...bml", Zb, Z)
    h = t - 0.25 * p
    expo = (
        log_e[..., None, :, :]
        + (log_norm - sterm)[..., None, None]
        + h[..., :, None]
        + h[..., None, :]
        - 0.5 * c
    )
    return u, b, expo


def _psi2_block(variance, ard, mu, s, Z, log_e, weights):
    """Psi2 contribution of a block of rows. mu, s: (B, Q); returns (M, M)."""
    _, _, expo = _forward_pieces(variance, ard, mu, s, Z, log_e)
    # each per-n factor is <= 1, so the exponent is <= 0 exactly; the clamp
    # keeps f32 cancellation error from overflowing exp()
    e = torch.exp(torch.clamp(expo, max=0.0))
    if weights is not None:
        e = e * weights[:, None, None]
    return (variance * variance) * torch.sum(e, dim=0)


def psi2(variance, ard, mu, s, Z, weights=None, block_n=None):
    """Psi2 (M, M) = sum_n <k(x_n, Z) k(x_n, Z)^T> under q(X).

    block_n bounds the (B, M, M) intermediate; blocks are summed in order.
    """
    n = mu.shape[0]
    log_e = _log_e(ard, Z)
    if block_n is None or block_n >= n:
        return _psi2_block(variance, ard, mu, s, Z, log_e, weights)
    out = torch.zeros(Z.shape[0], Z.shape[0], dtype=mu.dtype,
                      device=mu.device)
    for i in range(0, n, block_n):
        w = None if weights is None else weights[i:i + block_n]
        out = out + _psi2_block(variance, ard, mu[i:i + block_n],
                                s[i:i + block_n], Z, log_e, w)
    return out


def psi_stats(variance, ard, mu, s, Z, weights=None, block_n=None):
    """(Psi0, Psi1, Psi2) in one call."""
    return (psi0(variance, mu, weights),
            psi1(variance, ard, mu, s, Z, weights),
            psi2(variance, ard, mu, s, Z, weights, block_n))


def observed_psi(variance, ard, X, Z):
    """The psi statistics of observed inputs (s -> 0), the SGPR case:
    Psi0 = N sigma_f^2, Psi1 = K_nm, Psi2 = K_mn K_nm."""
    knm = gram(variance, ard, X, Z)
    return variance * X.shape[0], knm, knm.T @ knm
