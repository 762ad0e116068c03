"""Synthetic datasets (counterpart of `dp_gp_lvm_tpu/data/synthetic.py`):
`toy_gplvm` (c1), `oil_flow_like` (c2) and `mocap_like` (c4/c5). Every
draw comes from an explicit `torch.Generator`, on the generator's device;
the result is moved to `device` (the card unless the caller says "cpu")."""
from __future__ import annotations

import math

import torch

from dp_gp_lvm_tpu_torch.core.types import resolve_device
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.linalg import safe_cholesky_spec


def _standardize(Y):
    return (Y - Y.mean(dim=0)) / Y.std(dim=0, correction=0)


def _gp_draws(generator, X, ard, num_out, noise, variance=1.0):
    """num_out independent GP function values over the rows of X, plus
    observation noise of variance `noise`."""
    n = X.shape[0]
    kw = dict(generator=generator, dtype=X.dtype, device=X.device)
    k = ard_rbf.gram(torch.tensor(variance, dtype=X.dtype, device=X.device),
                     ard, X)
    L, _ = safe_cholesky_spec(k)
    f = L @ torch.randn((n, num_out), **kw)
    return f + math.sqrt(noise) * torch.randn((n, num_out), **kw)


def toy_gplvm(generator: torch.Generator, n: int = 100, d: int = 10,
              q_true: int = 2, q_total: int | None = None,
              noise: float = 0.01, dtype=torch.float64, device=None):
    """Config-1 data: D outputs driven by q_true active latent dims; with
    q_total > q_true the generating ARD weights are zero on the inactive
    dims. Returns (Y, X_true)."""
    device = resolve_device(device)
    q_total = q_total or q_true
    kw = dict(dtype=dtype, device=generator.device)
    X = torch.randn((n, q_total), generator=generator, **kw)
    ard = torch.cat([torch.ones(q_true, **kw),
                     torch.zeros(q_total - q_true, **kw)])
    Y = _standardize(_gp_draws(generator, X, ard, d, noise))
    return Y.to(device), X.to(device)


def oil_flow_like(generator: torch.Generator, n: int = 1000, d: int = 12,
                  dtype=torch.float64, device=None):
    """Three-regime multiphase-flow surrogate (config-2 shape: N=1000,
    D=12): three well-separated clusters in a 2-dim latent, mapped through
    random Fourier features. Returns (Y, labels, X)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=generator.device)
    labels = torch.randint(0, 3, (n,), generator=generator,
                           device=generator.device)
    centers = torch.tensor([[-2.0, 0.0], [2.0, 0.0], [0.0, 2.5]], **kw)
    X = centers[labels] + 0.3 * torch.randn((n, 2), generator=generator, **kw)
    W = torch.randn((2, d), generator=generator, **kw)
    b = 2.0 * math.pi * torch.rand((d,), generator=generator, **kw)
    Y = _standardize(torch.sin(X @ W + b[None, :]))
    return Y.to(device), labels.to(device), X.to(device)


def mocap_like(generator: torch.Generator, n: int = 1024, d: int = 59,
               q_true: int = 4, noise: float = 0.02,
               dtype=torch.float64, device=None):
    """CMU-mocap-shaped surrogate (N~1k, D~60): smooth low-dimensional
    trajectories through a high-dimensional joint-angle space.
    Returns (Y, X) on `device` (the card unless the caller says "cpu")."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=generator.device)
    t = torch.linspace(0.0, 8.0 * math.pi, n, **kw)[:, None]
    freqs = 0.5 + torch.arange(q_true, **kw)[None, :] * 0.35
    phases = 2.0 * math.pi * torch.rand((1, q_true), generator=generator, **kw)
    X = torch.sin(t * freqs + phases)
    W = torch.randn((q_true, d), generator=generator, **kw) / math.sqrt(q_true)
    Y = X @ W + noise * torch.randn((n, d), generator=generator, **kw)
    return _standardize(Y).to(device), X.to(device)
