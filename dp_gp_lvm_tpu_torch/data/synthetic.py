"""Synthetic datasets (counterpart of `dp_gp_lvm_tpu/data/synthetic.py`).
Only the mocap-shaped surrogate of the c4/c5 configs is ported so far."""
from __future__ import annotations

import math

import torch

from dp_gp_lvm_tpu_torch.core.types import resolve_device


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
    Y = (Y - Y.mean(dim=0)) / Y.std(dim=0, correction=0)
    return Y.to(device), X.to(device)
