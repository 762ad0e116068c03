r"""Diagonal Gaussian q(X) and its KL to N(0, I) (counterpart of
`dp_gp_lvm_tpu/distributions/gaussian.py`).

KL[q(X) || N(0, I)] = 1/2 sum_{n,q} (mu^2 + s - log s - 1).
"""
from __future__ import annotations

import torch


def kl_to_standard_normal(mu, s, weights=None):
    """KL[q(X)||N(0,I)] for mu, s of shape (N, Q); optional row weights."""
    per_row = 0.5 * torch.sum(mu * mu + s - torch.log(s) - 1.0, dim=-1)
    if weights is not None:
        per_row = per_row * weights
    return torch.sum(per_row)
