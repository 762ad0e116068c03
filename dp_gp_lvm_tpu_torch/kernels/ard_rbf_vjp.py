r"""Hand-derived backward passes for the ARD-RBF psi statistics
(counterpart of `dp_gp_lvm_tpu/kernels/ard_rbf_vjp.py`, whose docstring
holds the derivation).

The Psi2 backward recomputes each block's (B, M, M) exponent tile and
contracts it at once with the cotangent G, so only (M, M)- and
(N, Q)-sized state lives across blocks. The exponent is clamped with
min(expo, 0); the pullback masks with 1[expo < 0], except the variance
pull, which goes through exp itself. This is the plain version that the
fused CUDA backward (`ops/psi.py`, K2) is held against.
"""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.kernels import ard_rbf


_forward_pieces = ard_rbf._forward_pieces
_log_e = ard_rbf._log_e


def _block_bwd(variance, ard, mu, s, Z, w, log_e, G):
    """Gradient contributions of one block of rows:
    (gvar, gard, gmu, gs, gz_partial without the E0 pull, V_partial)."""
    u, b, expo = _forward_pieces(variance, ard, mu, s, Z, log_e)
    mask = (expo < 0.0).to(mu.dtype)
    E = torch.exp(torch.clamp(expo, max=0.0)) * w[:, None, None]
    gvar_blk = 2.0 * variance * torch.sum(E * G[None, :, :])

    W = (variance * variance) * E * mask * G[None, :, :]
    A = torch.sum(W, dim=(1, 2))
    # W enters the Q-contractions only through W + W^T: one contraction
    WS = W + W.transpose(1, 2)
    Wsym_rows = torch.sum(WS, dim=2)
    WSZ = torch.einsum("bml,lq->bmq", WS, Z)
    U = 0.5 * torch.einsum("bmq,mq->bq", WSZ, Z)
    RZ = Wsym_rows @ Z
    RZ2 = Wsym_rows @ (Z * Z)
    V = torch.sum(W, dim=0)

    gb = -mu * mu * A[:, None] + mu * RZ - 0.25 * RZ2 - 0.5 * U
    gmu = b * (-2.0 * mu * A[:, None] + RZ)
    gs = gb * (-2.0 * b * b) - A[:, None] * b
    gard_blk = torch.sum(gb / (u * u), dim=0) - torch.sum(
        A[:, None] * s / u, dim=0
    )
    bz_t = torch.einsum("bm,bq->mq", Wsym_rows, b * mu)
    bz_p = torch.einsum("bm,bq->mq", Wsym_rows, b)
    bz_c = torch.einsum("bmq,bq->mq", WSZ, b)
    gz_blk = bz_t - 0.5 * Z * bz_p - 0.5 * bz_c
    return gvar_blk, gard_blk, gmu, gs, gz_blk, V


def _e0_pulls(ard, Z, V, gard, gz):
    """Add the n-independent E0 pulls (through V = sum_n W) to gard, gz.
    Batch-polymorphic over leading atom dims."""
    V1 = torch.sum(V, dim=-1)
    V2 = torch.sum(V, dim=-2)
    VZ = V @ Z
    VTZ = V.mT @ Z
    diag_ZVZ = torch.sum(Z * VZ, dim=-2)
    gard = gard - 0.25 * (
        torch.einsum("...m,...mq->...q", V1 + V2, Z * Z) - 2.0 * diag_ZVZ
    )
    gz = gz - 0.5 * ard[..., None, :] * (
        Z * (V1 + V2)[..., None] - (VZ + VTZ)
    )
    return gard, gz


def _bwd(block_n, variance, ard, mu, s, Z, weights, G):
    n, q = mu.shape
    m = Z.shape[0]
    w = torch.ones(n, dtype=mu.dtype, device=mu.device) if weights is None \
        else weights
    log_e = _log_e(ard, Z)
    blk = block_n or n
    zeros = dict(dtype=mu.dtype, device=mu.device)
    gvar = torch.zeros((), **zeros)
    gard = torch.zeros(q, **zeros)
    gz = torch.zeros(m, q, **zeros)
    V = torch.zeros(m, m, **zeros)
    gmu_b, gs_b, gw_b = [], [], []
    for i in range(0, n, blk):
        sl = slice(i, i + blk)
        gv_b, ga_b, gmu_i, gs_i, gz_i, V_i = _block_bwd(
            variance, ard, mu[sl], s[sl], Z, w[sl], log_e, G
        )
        gvar, gard, gz, V = gvar + gv_b, gard + ga_b, gz + gz_i, V + V_i
        gmu_b.append(gmu_i)
        gs_b.append(gs_i)
        if weights is not None:
            # dPsi2/dw_n = var^2 exp(expo_n) contracted with G
            _, _, expo = _forward_pieces(variance, ard, mu[sl], s[sl], Z,
                                         log_e)
            e = torch.exp(torch.clamp(expo, max=0.0))
            gw_b.append((variance * variance)
                        * torch.einsum("bml,ml->b", e, G))
    gard, gz = _e0_pulls(ard, Z, V, gard, gz)
    gw = torch.cat(gw_b) if weights is not None else None
    return gvar, gard, torch.cat(gmu_b), torch.cat(gs_b), gz, gw


class Psi2Analytic(torch.autograd.Function):
    """Psi2 (M, M) with the hand-derived recompute backward."""

    @staticmethod
    def forward(ctx, variance, ard, mu, s, Z, weights, block_n):
        ctx.save_for_backward(variance, ard, mu, s, Z, weights)
        ctx.block_n = block_n
        return ard_rbf.psi2(variance, ard, mu, s, Z, weights, block_n)

    @staticmethod
    def backward(ctx, G):
        variance, ard, mu, s, Z, weights = ctx.saved_tensors
        grads = _bwd(ctx.block_n, variance, ard, mu, s, Z, weights, G)
        return (*grads, None)


def psi2_analytic(variance, ard, mu, s, Z, weights=None, block_n=None):
    return Psi2Analytic.apply(variance, ard, mu, s, Z, weights, block_n)


# ---------------------------------------------------------------------------
# Psi1: the intermediate is only (N, M), so no blocking. Batch-polymorphic
# over leading atom dims: variance (...,), ard (..., Q), Z (..., M, Q),
# with mu, s (N, Q) shared.
# ---------------------------------------------------------------------------


_psi1_pieces = ard_rbf._psi1_pieces


def _psi1_bwd(variance, ard, mu, s, Z, G):
    """(gvar, gard, gmu, gs, gz) of <Psi1, G>; gmu, gs keep the atom dims."""
    u, a, e = _psi1_pieces(variance, ard, mu, s, Z)
    ec = torch.exp(torch.clamp(e, max=0.0))
    gvar = torch.sum(G * ec, dim=(-2, -1))
    W = variance[..., None, None] * ec * (e < 0.0).to(mu.dtype) * G
    A = torch.sum(W, dim=-1)
    WZ = W @ Z
    WZ2 = W @ (Z * Z)
    ga = -0.5 * mu * mu * A[..., None] + mu * WZ - 0.5 * WZ2
    gmu = a * (-mu * A[..., None] + WZ)
    gs = ga * (-a * a) - 0.5 * A[..., None] * a
    gard = torch.sum(ga / (u * u), dim=-2) - 0.5 * torch.sum(
        A[..., None] * s / u, dim=-2
    )
    gz = W.mT @ (a * mu) - Z * (W.mT @ a)
    return gvar, gard, gmu, gs, gz


class Psi1Analytic(torch.autograd.Function):
    """Psi1 (..., N, M) with the hand-derived backward."""

    @staticmethod
    def forward(ctx, variance, ard, mu, s, Z):
        ctx.save_for_backward(variance, ard, mu, s, Z)
        return ard_rbf.psi1(variance, ard, mu, s, Z)

    @staticmethod
    def backward(ctx, G):
        mu = ctx.saved_tensors[2]
        gvar, gard, gmu, gs, gz = _psi1_bwd(*ctx.saved_tensors, G)
        return (gvar, gard, gmu.sum_to_size(mu.shape),
                gs.sum_to_size(mu.shape), gz)


def psi1_analytic(variance, ard, mu, s, Z):
    return Psi1Analytic.apply(variance, ard, mu, s, Z)


def psi1_weighted(variance, ard, mu, s, Z, weights=None):
    """Analytic-backward Psi1; row weights applied outside the Function."""
    out = psi1_analytic(variance, ard, mu, s, Z)
    if weights is not None:
        out = out * weights[:, None]
    return out
