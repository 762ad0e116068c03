"""Initialization: PCA latents, inducing-point selection, phi init
(counterpart of `dp_gp_lvm_tpu/train/init.py`). Every random draw comes
from an explicit `torch.Generator`; draws are made on the generator's
device and moved to the data's."""
from __future__ import annotations

import torch


def pca_latents(Y, q: int):
    """Project Y (N, D) onto its top-q principal components, unit-scaled.
    The sign of each component depends on the SVD backend."""
    Yc = Y - torch.mean(Y, dim=0, keepdim=True)
    u, sv, _ = torch.linalg.svd(Yc, full_matrices=False)
    k = min(q, sv.shape[0])
    scores = u[:, :k] * sv[None, :k]
    std = torch.clamp(torch.std(scores, dim=0, correction=0, keepdim=True),
                      min=1e-8)
    scores = scores / std
    if k < q:
        pad = torch.zeros(Y.shape[0], q - k, dtype=Y.dtype, device=Y.device)
        scores = torch.cat([scores, pad], dim=1)
    return scores


def inducing_from_latents(generator: torch.Generator, x_mean,
                          num_inducing: int):
    """Z init: a random subset of the initial latent means."""
    idx = torch.randperm(x_mean.shape[0], generator=generator,
                         device=generator.device)[:num_inducing]
    return x_mean[idx.to(x_mean.device)]


def near_uniform_assignments(generator: torch.Generator, d: int, t: int,
                             noise_scale: float = 0.01):
    """phi logits init: near-uniform with a small symmetry-breaking jitter
    (float64, on the generator's device)."""
    return noise_scale * torch.randn((d, t), generator=generator,
                                     dtype=torch.float64,
                                     device=generator.device)
