"""Bijective transforms between unconstrained and constrained parameters
(counterpart of `dp_gp_lvm_tpu/core/transforms.py`).

Softplus is `logaddexp(raw, 0)`, exact for every raw value.
`torch.nn.functional.softplus` returns `raw` unchanged above its
threshold of 20, which differs from the reference in the last digits.
"""
from __future__ import annotations

import torch

MIN_NOISE = 1e-6
MIN_VARIATIONAL_VAR = 1e-8


def positive(raw, floor: float = 0.0):
    """softplus(raw) + floor: unconstrained -> (floor, inf)."""
    out = torch.logaddexp(raw, torch.zeros_like(raw))
    return out + floor if floor else out


def positive_noise(raw):
    return positive(raw, MIN_NOISE)


def positive_variational_var(raw):
    return positive(raw, MIN_VARIATIONAL_VAR)


def positive_inverse(value):
    """Inverse softplus: value + log(-expm1(-value)), exact for value > 0."""
    return value + torch.log(-torch.expm1(-value))


def probability_simplex(logits, dim: int = -1):
    """Unconstrained logits -> the simplex by softmax (assignment
    posteriors)."""
    e = torch.exp(logits - torch.amax(logits, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)
