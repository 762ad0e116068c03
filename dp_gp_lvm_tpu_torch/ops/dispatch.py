"""Kernel and psi-statistic dispatch (counterpart of
`dp_gp_lvm_tpu/ops/dispatch.py`).

Two kernels: "ard_rbf" and "linear". `use_fused` (True | False |
"auto") takes the meaning of the reference's `use_pallas`: "auto" takes
the fused CUDA kernels (`ops/psi.py`) where every input is a float32
tensor on the card and every kernel of the path takes the shape
(`psi.fused_fits`: a block of one of each kernel's forms fits an SM; past
M = 128 K1's body and K2 run their tiled forms), and the non-fused
plain path otherwise (float64 inputs included: the kernels take float32
only). An explicit True launches the kernels whatever the inputs, and
their wrappers refuse what they do not take. The reference's
M >= 96 and 5e8 cut-overs were measured against XLA on a TPU and are not
carried over. The linear kernel's psi statistics are plain matrix
products (`kernels/linear.py`): no CUDA kernel takes them, whatever
`use_fused` says.
"""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.kernels import ard_rbf, linear
from dp_gp_lvm_tpu_torch.kernels.ard_rbf_vjp import (
    psi1_weighted,
    psi2_analytic,
)
from dp_gp_lvm_tpu_torch.models.bound import SuffStats, suff_stats_from_psi
from dp_gp_lvm_tpu_torch.ops import psi as psi_ops

KERNELS = {"ard_rbf": ard_rbf, "linear": linear}


def _kernel(kernel: str):
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    return KERNELS[kernel]


def gram(variance, ard, X1, X2=None, kernel: str = "ard_rbf"):
    return _kernel(kernel).gram(variance, ard, X1, X2)


def gram_diag(variance, ard, X, kernel: str = "ard_rbf"):
    return _kernel(kernel).gram_diag(variance, ard, X)


def observed_psi(variance, ard, X, Z, kernel: str = "ard_rbf"):
    """(Psi0, Psi1, Psi2) of observed inputs: closed-form Gram matrices,
    no kernel launch."""
    return _kernel(kernel).observed_psi(variance, ard, X, Z)


def psi0(variance, ard, mu, s, weights=None, kernel: str = "ard_rbf"):
    if _kernel(kernel) is linear:
        return linear.psi0(variance, ard, mu, s, weights)
    return ard_rbf.psi0(variance, mu, weights)


def expected_gram_diag(variance, ard, mu, s, kernel: str = "ard_rbf"):
    """Per-row expected kernel diagonal E_q(x_n)[k(x_n, x_n)], (N,): the
    constant signal variance for the RBF, the latent second moment's
    weighted sum for the linear kernel."""
    if _kernel(kernel) is linear:
        return variance * torch.sum(ard[None, :] * (mu * mu + s), dim=-1)
    return variance * torch.ones(mu.shape[0], dtype=mu.dtype,
                                 device=mu.device)


def psi_stats(variance, ard, mu, s, Z, weights=None, block_n=None,
              use_fused=False, kernel: str = "ard_rbf"):
    """(Psi0, Psi1, Psi2) of one kernel. Non-fused: plain forward plus the
    hand-derived backward. Fused: K6 and K5 forward (`ops/psi.py`).
    `use_fused` defaults to False as the reference's `use_pallas` does
    here; the model configs pass their own "auto"."""
    if _kernel(kernel) is linear:
        return linear.psi_stats(variance, ard, mu, s, Z, weights, block_n)
    p0 = ard_rbf.psi0(variance, mu, weights)
    if not resolve_fused(use_fused, kernel, mu.device, *Z.shape,
                         inputs=(variance, ard, mu, s, Z, weights)):
        return (
            p0,
            psi1_weighted(variance, ard, mu, s, Z, weights),
            psi2_analytic(variance, ard, mu, s, Z, weights, block_n),
        )
    # Psi1: the fused forward is unweighted and the row weight a rescale
    # outside it, which keeps its pullback exact for the weights; Psi2's
    # weights thread through the fused forward and its pullback
    p1 = psi_ops.psi1_fused(variance, ard, mu, s, Z)
    if weights is not None:
        p1 = p1 * weights[:, None]
    return p0, p1, psi_ops.psi2_fused(variance, ard, mu, s, Z, weights,
                                      block_n or 64)


def resolve_fused(use_fused, kernel: str, device: torch.device, M: int,
                  Q: int, D: int = 0, *, inputs=()) -> bool:
    """Fused-kernel decision for the path at M inducing points, Q latent
    dims and D output dims: D > 0 is K1 + K2 (Psi2 with Psi1^T Y), D = 0
    K4/K5 and K6 + K2 (Psi2 alone). "auto" means fused on the card where
    every tensor of `inputs` (None entries skipped) is float32 on the card
    and every kernel of the path takes (M, Q, D), decided before any
    launch. The fused ops make their inputs contiguous, so the layout
    does not decide."""
    if kernel != "ard_rbf":
        return False
    if use_fused == "auto":
        return (torch.device(device).type == "cuda"
                and all(x.dtype == torch.float32 and x.device.type == "cuda"
                        for x in inputs if x is not None)
                and psi_ops.fused_fits_on(device, M, Q, D))
    return bool(use_fused)


def psi2_batched(variance, ard, mu, s, Zs, weights=None, block_n=None,
                 use_fused="auto", kernel: str = "ard_rbf"):
    """Per-atom Psi2 stack (T, M, M): K4 with the K2 pullback when fused,
    else the non-fused path atom by atom."""
    if resolve_fused(use_fused, kernel, mu.device, *Zs.shape[1:],
                     inputs=(variance, ard, mu, s, Zs, weights)):
        return psi_ops.psi2_batched_fused(variance, ard, mu, s, Zs, weights,
                                          block_n or 64)
    psi2 = linear.psi2 if _kernel(kernel) is linear else psi2_analytic
    return torch.stack([
        psi2(variance[t], ard[t], mu, s, Zs[t], weights, block_n)
        for t in range(Zs.shape[0])
    ])


def dp_batched_suffstats(variance, ard, mu, s, Zs, Y, weights=None,
                         block_n=None, use_fused="auto",
                         kernel: str = "ard_rbf"):
    """Stacked per-atom sufficient statistics of the DP family:
    (psi0 (T,), psi1T_y (T, M, D), psi2 (T, M, M), yty (D,), n)."""
    _kernel(kernel)
    Yw = Y if weights is None else Y * weights[:, None]
    p0 = ard_rbf.psi0(variance, mu, weights)
    if resolve_fused(use_fused, kernel, mu.device, *Zs.shape[1:],
                     Y.shape[1], inputs=(variance, ard, mu, s, Zs, Y,
                                         weights)):
        p2, p1y = psi_ops.suffstats_batched_fused(
            variance, ard, mu, s, Zs, Y, weights, block_n or 64
        )
    elif kernel != "ard_rbf":
        # any other kernel atom by atom through its own psi statistics
        per_atom = [psi_stats(variance[t], ard[t], mu, s, Zs[t], weights,
                              block_n, kernel=kernel)
                    for t in range(Zs.shape[0])]
        p0 = torch.stack([p0_t for p0_t, _, _ in per_atom])
        p1y = torch.stack([p1_t.T @ Y for _, p1_t, _ in per_atom])
        p2 = torch.stack([p2_t for _, _, p2_t in per_atom])
    else:
        p2 = torch.stack([
            psi2_analytic(variance[t], ard[t], mu, s, Zs[t], weights,
                          block_n)
            for t in range(Zs.shape[0])
        ])
        p1y = torch.stack([
            psi1_weighted(variance[t], ard[t], mu, s, Zs[t], None).T @ Yw
            for t in range(Zs.shape[0])
        ])
    n_eff = (torch.tensor(float(Y.shape[0]), dtype=Y.dtype, device=Y.device)
             if weights is None else torch.sum(weights))
    return p0, p1y, p2, torch.sum(Y * Yw, dim=0), n_eff


def suff_stats(variance, ard, mu, s, Z, Y, weights=None, block_n=None,
               use_fused="auto", kernel: str = "ard_rbf") -> SuffStats:
    """SuffStats of the collapsed bound for one kernel (the SVI-GPLVM's
    minibatch, a Bayesian GP-LVM, an MRD view). Fused, it is K1 at T = 1
    with K2 in its backward, and Psi1 is never stored; else the plain psi
    statistics. `"auto"` decides as `dp_batched_suffstats` does."""
    _kernel(kernel)
    if resolve_fused(use_fused, kernel, mu.device, *Z.shape, Y.shape[1],
                     inputs=(variance, ard, mu, s, Z, Y, weights)):
        p2, p1y = psi_ops.suffstats_batched_fused(
            variance[None], ard[None], mu, s, Z[None], Y, weights,
            block_n or 64)
        Yw = Y if weights is None else Y * weights[:, None]
        n_eff = (torch.tensor(float(Y.shape[0]), dtype=Y.dtype,
                              device=Y.device)
                 if weights is None else torch.sum(weights))
        return SuffStats(psi0=ard_rbf.psi0(variance, mu, weights),
                         psi1T_y=p1y[0], psi2=p2[0],
                         yty=torch.sum(Y * Yw, dim=0), n=n_eff)
    p0, p1, p2 = psi_stats(variance, ard, mu, s, Z, weights, block_n,
                           use_fused=False, kernel=kernel)
    return suff_stats_from_psi(p0, p1, p2, Y, weights)
