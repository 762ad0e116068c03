"""Parameters carried across from the JAX package.

`jax.random` and `torch.Generator` draw different numbers from the same
seed, and the PCA sign depends on the SVD backend, so a comparison of the
two packages hands the JAX package's parameters (as numpy arrays, same
keys and layouts) to this one instead of regenerating them. Any of the
packages' parameter dicts goes across: the DP-GP-LVM's, or the Bayesian
GP-LVM's with its 0-d `raw_variance` and `raw_noise`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core.types import resolve_device


def params_from_jax(np_params: dict[str, np.ndarray], device=None,
                    dtype=torch.float64) -> dict[str, torch.Tensor]:
    """numpy parameter dict -> dict of `nn.Parameter` on `device`."""
    device = resolve_device(device)
    return {
        k: nn.Parameter(torch.as_tensor(np.array(v), dtype=dtype,
                                        device=device))
        for k, v in np_params.items()
    }
