"""Initialization: PCA latents, inducing-point selection, phi init
(counterpart of `dp_gp_lvm_tpu/train/init.py`). The random draws take a
key of the reference's stream (`core/prng.py`) and are made on the CPU."""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.core import prng


def pca_latents(Y, q: int):
    """Project Y (N, D) onto its top-q principal components, unit-scaled,
    on Y's device. The SVD runs on the host whatever the device, so a run
    on the card starts where the same run on the CPU does; the sign of
    each component depends on the SVD backend (LAPACK's here, not
    necessarily the reference's)."""
    device = Y.device
    Y = Y.cpu()
    Yc = Y - torch.mean(Y, dim=0, keepdim=True)
    u, sv, _ = torch.linalg.svd(Yc, full_matrices=False)
    k = min(q, sv.shape[0])
    scores = u[:, :k] * sv[None, :k]
    std = torch.clamp(torch.std(scores, dim=0, correction=0, keepdim=True),
                      min=1e-8)
    scores = scores / std
    if k < q:
        pad = torch.zeros(Y.shape[0], q - k, dtype=Y.dtype)
        scores = torch.cat([scores, pad], dim=1)
    return scores.to(device)


def inducing_from_latents(key, x_mean, num_inducing: int):
    """Z init: a random subset of the initial latent means."""
    idx = prng.permutation(key, x_mean.shape[0])[:num_inducing]
    return x_mean[idx.to(x_mean.device)]


def near_uniform_assignments(key, d: int, t: int, noise_scale: float = 0.01,
                             dtype=torch.float64):
    """phi logits init: near-uniform with a small symmetry-breaking jitter,
    drawn in `dtype` (the reference draws at its default float width,
    float64 only in its 64-bit mode), on the CPU."""
    return noise_scale * prng.normal(key, (d, t), dtype)
