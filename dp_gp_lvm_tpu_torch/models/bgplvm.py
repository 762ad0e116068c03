"""Bayesian GP-LVM (counterpart of `dp_gp_lvm_tpu/models/bgplvm.py`).
Only the hyperprior that the DP-GP-LVM ELBO uses is ported so far."""
from __future__ import annotations

import torch


def _log_normal_hyperprior(std, *values):
    """sum of log N(log v | 0, std^2) up to constants; 0 disables."""
    if not std:
        return 0.0
    tot = 0.0
    for v in values:
        lv = torch.log(v)
        tot = tot - 0.5 * torch.sum(lv * lv) / (std * std)
    return tot
