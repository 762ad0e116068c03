"""Safe Cholesky with scale-aware escalating jitter, plus solve helpers
(counterpart of `dp_gp_lvm_tpu/linalg/chol.py`).

JAX's Cholesky returns NaN on a non-PSD input and the reference tests the
factor for finiteness. `torch.linalg.cholesky_ex` instead returns `info`
beside a partial factor that need not hold a NaN, so failure is read from
`info`, and a failed factor is filled with NaN so that callers (the
optimizer's non-finite skip) see what the reference shows them.
"""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.core.types import JitterPolicy


def _cholesky(A):
    """(L, info) with the lower triangle of every failed batch member set
    to NaN, as JAX returns it."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L), info


def _chol_ok(info):
    return bool(torch.all(info == 0))


def _scale(A):
    """Mean |diag| floored at 1, shaped (..., 1, 1); carries no gradient."""
    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    return torch.clamp(scale, min=1.0)[..., None, None].detach()


def _find_jitter(A_nograd, scale, policy: JitterPolicy):
    """Smallest escalated relative jitter that factors every batch member
    (one jitter shared over the whole batch), or the last one tried."""
    eye = torch.eye(A_nograd.shape[-1], dtype=A_nograd.dtype,
                    device=A_nograd.device)
    jitter = policy.initial_for(A_nograd.dtype)
    tries = 0
    while tries < policy.max_tries:
        _, info = torch.linalg.cholesky_ex(A_nograd + jitter * scale * eye)
        if _chol_ok(info):
            break
        jitter *= policy.growth
        tries += 1
    return jitter


def safe_cholesky_spec(A, policy: JitterPolicy = JitterPolicy()):
    """Speculate-then-repair safe Cholesky over a whole batch.

    Factors once at the initial jitter; only when some batch member fails
    does it search for ONE shared jitter that factors every member. The
    test of `info` is a host sync, once per call. Returns (L, jitter) with
    jitter of shape A.shape[:-2].
    """
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    scale = _scale(A)
    init = policy.initial_for(A.dtype)
    batch = A.shape[:-2]
    L0, info = _cholesky(A + init * scale * eye)
    if policy.max_tries == 0 or _chol_ok(info):
        return L0, torch.full(batch, init, dtype=A.dtype, device=A.device)
    jitter = _find_jitter(A.detach(), scale, policy)
    L, _ = _cholesky(A + jitter * scale * eye)
    return L, torch.full(batch, jitter, dtype=A.dtype, device=A.device)


def safe_cholesky(A, policy: JitterPolicy = JitterPolicy()):
    """Safe Cholesky in the reference's search-first form: (L, jitter) with
    jitter 0-d. Over a leading batch the search, as the reference's
    `lax.while_loop` over the whole batch, finds ONE relative jitter that
    factors every member (each at its own scale); a caller that wants a
    jitter per member calls it per member, as the reference's callers
    that vmap it get. Searching first and factoring at the initial jitter
    first pick the same jitter and the same factor, so this is
    `safe_cholesky_spec`: one factorization and one host sync on the good
    path."""
    L, jitter = safe_cholesky_spec(A, policy)
    return L, jitter.reshape(-1)[0] if jitter.ndim else jitter


def safe_cholesky_members(A, policy: JitterPolicy = JitterPolicy()):
    """Safe Cholesky of a (..., M, M) stack with a jitter per member: what
    a caller gets from the reference's `jax.vmap(safe_cholesky)`, where
    every member searches its own jitter.

    Factors the stack once at the initial jitter. Only if some member fails
    (one host read of `info` per call) does it factor the detached stack
    at every further rung, and give each member the first rung at which it
    factors (the last rung where none does); one differentiated
    factorization at those jitters follows. Returns (L, jitter) with
    jitter of shape A.shape[:-2]."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    scale = _scale(A)
    init = policy.initial_for(A.dtype)
    L, info = _cholesky(A + init * scale * eye)
    jitter = torch.full(A.shape[:-2], init, dtype=A.dtype, device=A.device)
    if policy.max_tries == 0 or _chol_ok(info):
        return L, jitter
    found = info == 0
    rung = init
    for _ in range(policy.max_tries):
        rung *= policy.growth
        jitter = torch.where(found, jitter, torch.full_like(jitter, rung))
        _, info = torch.linalg.cholesky_ex(A.detach() + rung * scale * eye)
        found = found | (info == 0)
    L, _ = _cholesky(A + jitter[..., None, None] * scale * eye)
    return L, jitter


def tri_solve(L, B, lower: bool = True, trans: bool = False):
    """Solve op(L) X = B for triangular L. Batched over leading dims."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def logdet_from_chol(L):
    """log|A| = 2 * sum(log diag L) for A = L L^T."""
    return 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1
    )


def cho_solve(L, B):
    """Solve (L L^T) X = B given the lower Cholesky factor L."""
    return tri_solve(L, tri_solve(L, B), trans=True)


def solve_psd(A, B, policy: JitterPolicy = JitterPolicy()):
    """PSD solve A X = B through the safe Cholesky."""
    L, _ = safe_cholesky(A, policy)
    return cho_solve(L, B)


def add_jitter(A, rel_jitter: float):
    """A + rel_jitter * scale * I, scale the mean |diag| floored at 1 (a
    gradient flows through the scale, as in the reference)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    scale = torch.clamp(torch.mean(torch.abs(torch.diagonal(
        A, dim1=-2, dim2=-1)), dim=-1), min=1.0)[..., None, None]
    return A + rel_jitter * scale * eye
