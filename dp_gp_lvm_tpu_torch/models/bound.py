r"""The collapsed sparse-variational free energy from sufficient statistics
(counterpart of `dp_gp_lvm_tpu/models/bound.py`, whose docstring holds
the Titsias 2009 algebra).

    F_d = -N/2 log(2 pi sigma^2) - 1/2 log|B| - 1/(2 sigma^2) y_d^T y_d
          + 1/2 c_d^T c_d - 1/(2 sigma^2) Psi0 + 1/2 tr(A)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.linalg import (
    logdet_from_chol,
    safe_cholesky_spec,
    tri_solve,
)


class SuffStats(NamedTuple):
    """Sufficient statistics of the collapsed bound (all sums over n)."""

    psi0: torch.Tensor     # scalar or (...,)
    psi1T_y: torch.Tensor  # (..., M, D)
    psi2: torch.Tensor     # (..., M, M)
    yty: torch.Tensor      # (D,)
    n: torch.Tensor        # scalar (weighted row count)


def suff_stats_from_psi(psi0, psi1, psi2, Y, weights=None):
    """Assemble SuffStats from explicit psi statistics and data Y (N, D)."""
    Yw = Y if weights is None else Y * weights[:, None]
    n = (torch.tensor(float(Y.shape[0]), dtype=Y.dtype, device=Y.device)
         if weights is None else torch.sum(weights))
    return SuffStats(psi0=psi0, psi1T_y=psi1.T @ Y, psi2=psi2,
                     yty=torch.sum(Y * Yw, dim=0), n=n)


class BoundTerms(NamedTuple):
    per_dim: torch.Tensor   # (..., D) F_d
    shared: torch.Tensor    # (...,)
    quad: torch.Tensor      # (..., D)
    logdet_b: torch.Tensor  # (...,)
    trace_a: torch.Tensor   # (...,)
    jitter: torch.Tensor    # (...,) jitter used for chol(K_uu)


def collapsed_bound(kuu, stats: SuffStats, noise_var,
                    policy: JitterPolicy = JitterPolicy()) -> BoundTerms:
    """Per-output-dimension collapsed bound F_d (..., D).

    kuu: (..., M, M); noise_var: scalar or (...,). Batch-polymorphic:
    pass the whole atom stack; the safe Cholesky repairs with one jitter
    shared over the batch."""
    dtype = kuu.dtype
    m = kuu.shape[-1]
    noise_var = torch.as_tensor(noise_var, dtype=dtype, device=kuu.device)
    beta = 1.0 / noise_var
    beta_mm = beta[..., None, None]

    L, jit_used = safe_cholesky_spec(kuu, policy)
    half = tri_solve(L, stats.psi2)
    A = beta_mm * tri_solve(L, half.mT)
    B = torch.eye(m, dtype=dtype, device=kuu.device) + 0.5 * (A + A.mT)
    LB, _ = safe_cholesky_spec(B, policy)
    logdet_b = logdet_from_chol(LB)
    trace_a = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)

    tmp = tri_solve(L, stats.psi1T_y)
    C = beta_mm * tri_solve(LB, tmp)
    quad = -0.5 * beta[..., None] * stats.yty + 0.5 * torch.sum(C * C, dim=-2)

    log2pi = math.log(2.0 * math.pi)
    shared = (
        -0.5 * stats.n * (log2pi + torch.log(noise_var))
        - 0.5 * logdet_b
        - 0.5 * beta * stats.psi0
        + 0.5 * trace_a
    )
    return BoundTerms(per_dim=shared[..., None] + quad, shared=shared,
                      quad=quad, logdet_b=logdet_b, trace_a=trace_a,
                      jitter=jit_used)


def optimal_qu(kuu, stats: SuffStats, noise_var,
               policy: JitterPolicy = JitterPolicy()):
    """Optimal collapsed q(u_d) for prediction: (w, L, LB) with
    w = K_uu^{-1} m_d = beta (K_uu + beta Psi2)^{-1} Psi1^T y_d (..., M, D),
    L = chol(K_uu) and LB = chol(I + A). Batch-polymorphic like
    `collapsed_bound`: pass the whole atom stack."""
    noise_var = torch.as_tensor(noise_var, dtype=kuu.dtype, device=kuu.device)
    beta_mm = (1.0 / noise_var)[..., None, None]
    m = kuu.shape[-1]
    L, _ = safe_cholesky_spec(kuu, policy)
    half = tri_solve(L, stats.psi2)
    A = beta_mm * tri_solve(L, half.mT)
    B = torch.eye(m, dtype=kuu.dtype, device=kuu.device) + 0.5 * (A + A.mT)
    LB, _ = safe_cholesky_spec(B, policy)
    # w = beta L^{-T} B^{-1} L^{-1} Psi1^T Y
    tmp = tri_solve(L, stats.psi1T_y)
    tmp = tri_solve(LB, tmp)
    tmp = tri_solve(LB, tmp, trans=True)
    return beta_mm * tri_solve(L, tmp, trans=True), L, LB
