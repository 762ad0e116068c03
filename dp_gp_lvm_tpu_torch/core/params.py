"""Parameters carried across from the JAX package.

`jax.random` and `torch.Generator` draw different numbers from the same
seed, and the PCA sign depends on the SVD backend, so a comparison of the
two packages hands the JAX package's parameters (as numpy arrays, same
keys and layouts) to this one instead of regenerating them. Any of the
packages' parameter dicts goes across: the DP-GP-LVM's, the Bayesian
GP-LVM's with its 0-d `raw_variance` and `raw_noise`, or MRD's with its
`views` list of per-view dicts.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core.types import resolve_device


def params_from_jax(np_params: dict, device=None, dtype=torch.float64) -> dict:
    """numpy parameter dict -> dict of `nn.Parameter` on `device`; a
    `views` list becomes a list of such dicts."""
    device = resolve_device(device)

    def leaf(v):
        return nn.Parameter(torch.as_tensor(np.array(v), dtype=dtype,
                                            device=device))

    return {
        k: ([{kk: leaf(vv) for kk, vv in view.items()} for view in v]
            if k == "views" else leaf(v))
        for k, v in np_params.items()
    }
