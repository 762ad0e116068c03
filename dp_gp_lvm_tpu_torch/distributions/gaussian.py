r"""Diagonal Gaussian q(X), its KL to N(0, I), its log density and its
draws (counterpart of `dp_gp_lvm_tpu/distributions/gaussian.py`).

KL[q(X) || N(0, I)] = 1/2 sum_{n,q} (mu^2 + s - log s - 1).
"""
from __future__ import annotations

import math

import torch

from dp_gp_lvm_tpu_torch.core import prng


def kl_to_standard_normal(mu, s, weights=None):
    """KL[q(X)||N(0,I)] for mu, s of shape (N, Q); optional row weights."""
    per_row = 0.5 * torch.sum(mu * mu + s - torch.log(s) - 1.0, dim=-1)
    if weights is not None:
        per_row = per_row * weights
    return torch.sum(per_row)


def log_prob_diag(x, mu, s):
    """Independent Gaussian log density, summed over the last axis."""
    d = x - mu
    return -0.5 * torch.sum(d * d / s + torch.log(s) + math.log(2.0 * math.pi),
                            dim=-1)


def sample(key, mu, s, num_samples: int):
    """(num_samples, N, Q) draws from q(X) with the reference's draw of
    `key` (a key of `core/prng.py`), made on the CPU and moved to mu's
    device."""
    eps = prng.normal(key, (num_samples,) + tuple(mu.shape), mu.dtype)
    return mu[None] + torch.sqrt(s)[None] * eps.to(mu.device)
