"""Safe Cholesky with scale-aware escalating jitter, plus solve helpers
(counterpart of `dp_gp_lvm_tpu/linalg/chol.py`).

JAX's Cholesky returns NaN on a non-PSD input and the reference tests the
factor for finiteness. `torch.linalg.cholesky_ex` instead returns `info`
beside a partial factor that need not hold a NaN, so failure is read from
`info`, and a failed factor is filled with NaN so that callers (the
optimizer's non-finite skip) see what the reference shows them. The
reference's repair branch (`lax.while_loop`, `lax.cond`) is a choice made
on the device here too: the ladder of jitters is factored at once and the
rung picked from `info`, so no call reads the device from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.core.types import JitterPolicy


def _cholesky(A):
    """(L, info) with the lower triangle of every failed batch member set
    to NaN, as JAX returns it, and so its gradient (a product with 1
    keeps a good member's bits and gradient)."""
    L, info = torch.linalg.cholesky_ex(A)
    m = A.shape[-1]
    lower = torch.ones(m, m, dtype=torch.bool, device=A.device).tril()
    bad = (info != 0)[..., None, None] & lower
    return L * torch.ones_like(L).masked_fill_(bad, float("nan")), info


def _scale(A):
    """Mean |diag| floored at 1, shaped (..., 1, 1); carries no gradient."""
    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    return torch.clamp(scale, min=1.0)[..., None, None].detach()


# the ladder of relative jitters of a policy, a device tensor per
# (policy, dtype, device), made once
_RUNGS: dict = {}


def jitter_rungs(policy: JitterPolicy, dtype, device) -> torch.Tensor:
    """(max_tries + 1,) relative jitters init * growth^k, each the
    previous one times growth rounded in `dtype`, as the reference's
    search escalates its jitter. Built with device fills, no copy from
    the host."""
    key = (policy, dtype, torch.device(device))
    if key not in _RUNGS:
        scalar = torch.empty((), dtype=dtype).numpy().dtype.type
        values = [scalar(policy.initial_for(dtype))]
        for _ in range(policy.max_tries):
            values.append(values[-1] * scalar(policy.growth))
        _RUNGS[key] = torch.stack([
            torch.full((), float(v), dtype=dtype, device=device)
            for v in values])
    return _RUNGS[key]


def _first_rung(ok):
    """Index of the first True along dim 0 of `ok` (rungs, ...), the last
    rung where none is: a device choice, no host read."""
    last = ok.shape[0] - 1
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    return torch.where(ok.any(dim=0), first, torch.full_like(first, last))


def _take(rungs, index):
    """rungs[index] for an integer index tensor of any shape (a 0-d tensor
    index would be read on the host)."""
    return rungs.index_select(0, index.reshape(-1)).reshape(index.shape)


def _ladder_ok(A_nograd, scale, eye, rungs):
    """(rungs, *batch) bools: whether each member factors at each rung,
    from one batched factorization of the detached stack."""
    r = rungs.reshape(-1, *([1] * A_nograd.dim()))
    _, info = torch.linalg.cholesky_ex(A_nograd.unsqueeze(0)
                                       + r * scale * eye)
    return info == 0


def _shared_jitter(A, policy: JitterPolicy):
    """(L, jitter 0-d) with ONE jitter for the whole batch, chosen on the
    device: the detached stack is factored at every rung of the policy's
    ladder (`jitter_rungs`) in one batched factorization, the jitter is
    the first rung at which every member factors (the last rung where
    none does), as the reference's search walks them, and one
    differentiated factorization follows at it."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    scale = _scale(A)
    if policy.max_tries == 0:
        init = policy.initial_for(A.dtype)
        L, _ = _cholesky(A + init * scale * eye)
        return L, torch.full((), init, dtype=A.dtype, device=A.device)
    rungs = jitter_rungs(policy, A.dtype, A.device)
    ok = _ladder_ok(A.detach(), scale, eye, rungs)
    jitter = _take(rungs, _first_rung(ok.reshape(ok.shape[0], -1).all(dim=1)))
    L, _ = _cholesky(A + jitter * scale * eye)
    return L, jitter


def safe_cholesky_spec(A, policy: JitterPolicy = JitterPolicy()):
    """Speculate-then-repair safe Cholesky over a whole batch (the
    reference's `safe_cholesky_spec`, whose `lax.cond` repairs only where
    the factor at the initial jitter fails): ONE jitter for every member,
    chosen on the device without a host read (`_shared_jitter`), so the
    step can be captured in a CUDA graph. Where the initial jitter
    factors (the good path) the factor is that of A + init * scale * I,
    bit for bit. The gradient is that of the factor returned; the
    reference's is NaN for a member whose discarded speculative factor
    failed (0 times NaN in the transpose of its `lax.cond`), which the
    port does not copy: it would skip every step of a model whose K_uu
    needs the repair (the Bayesian GP-LVM at M = 256 in f32). Returns
    (L, jitter) with jitter of shape A.shape[:-2]."""
    L, jitter = _shared_jitter(A, policy)
    return L, jitter.expand(A.shape[:-2])


def safe_cholesky(A, policy: JitterPolicy = JitterPolicy()):
    """Safe Cholesky in the reference's search-first form: (L, jitter) with
    jitter 0-d. Over a leading batch the search, as the reference's
    `lax.while_loop` over the whole batch, finds ONE relative jitter that
    factors every member (each at its own scale); a caller that wants a
    jitter per member calls `safe_cholesky_members`, as the reference's
    callers that vmap it get. It picks `safe_cholesky_spec`'s jitter and
    factor; the gradient is the factor's at that jitter."""
    return _shared_jitter(A, policy)


def safe_cholesky_members(A, policy: JitterPolicy = JitterPolicy()):
    """Safe Cholesky of a (..., M, M) stack with a jitter per member: what
    a caller gets from the reference's `jax.vmap(safe_cholesky)`, where
    every member searches its own jitter.

    The detached stack is factored at every rung of the ladder in one
    batched factorization, each member takes the first rung at which it
    factors (the last rung where none does), and one differentiated
    factorization follows at those jitters; all on the device. Returns
    (L, jitter) with jitter of shape A.shape[:-2]."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    scale = _scale(A)
    if policy.max_tries == 0:
        init = policy.initial_for(A.dtype)
        L, _ = _cholesky(A + init * scale * eye)
        return L, torch.full(A.shape[:-2], init, dtype=A.dtype,
                             device=A.device)
    rungs = jitter_rungs(policy, A.dtype, A.device)
    jitter = _take(rungs, _first_rung(_ladder_ok(A.detach(), scale, eye,
                                                  rungs)))
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
