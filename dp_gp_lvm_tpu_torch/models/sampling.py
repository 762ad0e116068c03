r"""Pathwise posterior function sampling, Matheron's rule decoupled
(counterpart of `dp_gp_lvm_tpu/models/sampling.py`, whose docstring gives
the method; Wilson et al. 2020).

Joint draws f_s ~ p(f | data) of the trained sparse-GP families, the
generative counterpart of the moment predictions of
`models/prediction.py`:

    f_s(x) = f_prior_s(x) + k(x, Z) K_uu^{-1} (u_s - f_prior_s(Z))

with f_prior_s a draw from the GP prior in a finite feature basis (random
Fourier features for the ARD-RBF kernel, the exact Q features of the
linear kernel) and u_s ~ q(u) an exact draw: from a collapsed
`prediction.PosteriorCache` (u_s = L L^T w + L LB^{-T} eps), or from the
explicit whitened q(u) of the SVI families (u_s = L (m + Ls eps)). A
sampler is built once (every factorization and draw); evaluating S draws
at N* points is then two products, with no loop over samples.

Every random draw is the reference's, from a key of its stream
(`core/prng.py`), made on the CPU and moved to the model's device. No CUDA
kernel runs here: the products are plain matmuls and triangular solves in
the reference too, kept in full f32 on the card (no TF32).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy, pin_full_f32
from dp_gp_lvm_tpu_torch.kernels import ard_rbf, linear
from dp_gp_lvm_tpu_torch.linalg import tri_solve
from dp_gp_lvm_tpu_torch.models import svi_gplvm as svi
from dp_gp_lvm_tpu_torch.models.prediction import PosteriorCache


@dataclasses.dataclass(frozen=True)
class PathwiseSampler:
    """Precomputed pathwise posterior draws; evaluate with `sample_at`.

    Fields (S samples, M inducing, D output dims, L features, Q latents),
    each with a leading atom dim T in a DP mixture's sampler:
      freqs  (L, Q)  feature frequencies (RFF omega, or the exact linear
                     features' scaling rows)
      phases (L,)    RFF phase offsets b (zeros for linear)
      scale  ()      feature amplitude: sqrt(2 sigma^2 / L) for RFF, 1 for
                     linear (folded into freqs)
      wts    (S, L, D) prior feature weights w_s ~ N(0, I)
      v      (S, M, D) Matheron correction K_uu^{-1}(u_s - f_prior_s(Z))
      variance, ard, z: the kernel's hypers and inducing inputs
      kernel: the kernel's name
    """

    freqs: torch.Tensor
    phases: torch.Tensor
    scale: torch.Tensor
    wts: torch.Tensor
    v: torch.Tensor
    variance: torch.Tensor
    ard: torch.Tensor
    z: torch.Tensor
    kernel: str


def _prior_features(x, sampler: PathwiseSampler):
    """Feature matrix phi(x): (..., N, L), batched over x's and the
    sampler's leading dims."""
    proj = x @ sampler.freqs.mT
    if sampler.kernel == "linear":
        return proj
    return sampler.scale[..., None, None] * torch.cos(
        proj + sampler.phases[..., None, :])


def _normal(key, shape, like):
    """N(0, 1) draws of the reference's stream in `like`'s dtype, on its
    device."""
    return prng.normal(key, shape, like.dtype).to(like.device)


def qu_draws(key, cache: PosteriorCache, num_samples: int, num_dims: int):
    """Exact draws u_s ~ q(u) (S, M, D) from a collapsed cache: m = L L^T
    w, Sigma_u^{1/2} = L LB^{-T}."""
    m_u = cache.L @ (cache.L.T @ cache.w)                  # (M, D)
    # C^T = LB^{-1} L^T, i.e. LB C^T = L^T with no transpose: LB^T C^T =
    # L^T would give L (LB^T LB)^{-1} L^T, which is not Sigma_u
    c_t = tri_solve(cache.LB, cache.L.T, lower=True)
    eps = _normal(key, (num_samples, cache.L.shape[0], num_dims), cache.w)
    return m_u[None] + torch.einsum("km,skd->smd", c_t, eps)


def _feature_basis(r_w, r_b, kernel, variance, ard, num_features,
                   num_latent, dtype):
    """(freqs, phases, scale) of the prior feature map: the exact Q linear
    features, or L RFF cosines for the ARD-RBF kernel."""
    device = ard.device
    if kernel == "linear":
        freqs = torch.sqrt(variance * ard)[:, None] * torch.eye(
            num_latent, dtype=dtype, device=device)
        return (freqs, torch.zeros(num_latent, dtype=dtype, device=device),
                torch.ones((), dtype=dtype, device=device))
    if kernel == "ard_rbf":
        freqs = torch.sqrt(ard)[None, :] * _normal(
            r_w, (num_features, num_latent), ard)
        phases = prng.uniform(r_b, (num_features,), dtype, 0.0,
                              2.0 * math.pi).to(device)
        scale = torch.sqrt(2.0 * variance / num_features).to(dtype)
        return freqs, phases, scale
    raise ValueError(f"unknown kernel {kernel!r}")


def _matheron_finish(partial: PathwiseSampler, u, L) -> PathwiseSampler:
    """Complete a sampler from q(u) draws u (S, M, D): the prior draws at
    Z, the residual, and v = K_uu^{-1}(u_s - f0(Z)) as one (M, S*D)
    triangular-solve pair."""
    phi_z = _prior_features(partial.z, partial)            # (M, L)
    f0_z = torch.einsum("ml,sld->smd", phi_z, partial.wts)
    rhs = u - f0_z
    m = L.shape[0]
    num_samples, _, d = u.shape
    rhs_flat = torch.movedim(rhs, 1, 0).reshape(m, -1)     # (M, S*D)
    v_flat = tri_solve(L, tri_solve(L, rhs_flat), trans=True)
    v = torch.movedim(v_flat.reshape(m, num_samples, d), 0, 1)
    return dataclasses.replace(partial, v=v)


def _start(key, kernel, variance, ard, z, num_samples, num_features, d,
           dtype):
    """(partial sampler without v, q(u) key): the feature basis and the
    prior weights, drawn from split(key, 4) as the reference draws them."""
    r_w, r_b, r_wts, r_u = prng.split(key, 4)
    freqs, phases, scale = _feature_basis(
        r_w, r_b, kernel, variance, ard, num_features, ard.shape[-1], dtype)
    wts = _normal(r_wts, (num_samples, freqs.shape[0], d), ard)
    partial = PathwiseSampler(freqs=freqs, phases=phases, scale=scale,
                              wts=wts, v=None, variance=variance, ard=ard,
                              z=z, kernel=kernel)
    return partial, r_u


@torch.no_grad()
def make_pathwise_sampler(key, cache: PosteriorCache, num_samples: int,
                          num_latent: int, num_features: int = 2048,
                          kernel: str = "ard_rbf") -> PathwiseSampler:
    """S pathwise posterior draws from a trained collapsed cache, on its
    device. `kernel` must be the one the cache was built with, or the
    prior basis and chol(K_uu) describe different priors."""
    if cache.w.device.type == "cuda":
        pin_full_f32()
    if cache.ard.shape[-1] != num_latent:
        raise ValueError(f"num_latent {num_latent} does not match the "
                         f"cache's {cache.ard.shape[-1]} latent dims")
    partial, r_u = _start(key, kernel, cache.variance, cache.ard, cache.z,
                          num_samples, num_features, cache.w.shape[1],
                          cache.w.dtype)
    u = qu_draws(r_u, cache, num_samples, cache.w.shape[1])
    return _matheron_finish(partial, u, cache.L)


@torch.no_grad()
def make_svi_pathwise_sampler(key, params, config, num_samples: int,
                              num_features: int = 2048) -> PathwiseSampler:
    """Pathwise draws from the EXPLICIT whitened q(u) of the SVI families
    (`models/svi_gplvm.py`, or one view of `models/mrd_svi.py` through
    its `_view_params`): u_s = L (u_mean + Ls eps_s), L = chol(K_uu), and
    the Matheron correction against the same L. No training data is
    involved. On the parameters' device."""
    c = svi._detached(params, config)
    if c["u_mean"].device.type == "cuda":
        pin_full_f32()
    L = svi._kuu_factor(c, config, JitterPolicy())
    m, d = c["u_mean"].shape
    partial, r_u = _start(key, config.kernel, c["variance"], c["ard"],
                          c["z"], num_samples, num_features, d,
                          c["u_mean"].dtype)
    eps = _normal(r_u, (num_samples, m, d), c["u_mean"])
    v_s = c["u_mean"][None] + torch.einsum("mk,skd->smd", c["u_scale"], eps)
    u = torch.einsum("mk,skd->smd", L, v_s)
    return _matheron_finish(partial, u, L)


def _gram(sampler: PathwiseSampler, x):
    mod = linear if sampler.kernel == "linear" else ard_rbf
    return mod.gram(sampler.variance, sampler.ard, x, sampler.z)


@torch.no_grad()
def sample_at(sampler: PathwiseSampler, x_star):
    """The S draws at x_star (N*, Q): (S, N*, D) noise-free values, jointly
    consistent across the rows of a draw (with a leading T for a mixture's
    stacked sampler)."""
    phi_x = _prior_features(x_star, sampler)               # (..., N*, L)
    prior = torch.einsum("...nl,...sld->...snd", phi_x, sampler.wts)
    return prior + torch.einsum("...nm,...smd->...snd",
                                _gram(sampler, x_star), sampler.v)


@torch.no_grad()
def sample_at_latent_draws(sampler: PathwiseSampler, x_draws):
    """Draw s evaluated at ITS OWN latent draw x_draws[s] (S, N*, Q) ->
    (S, N*, D): latent uncertainty carried through the function draws.
    Over s the mean converges to the psi-moment predictive mean and the
    variance to the predictive variance less the noise."""
    phi_x = _prior_features(x_draws, sampler)              # (S, N*, L)
    prior = torch.einsum("snl,sld->snd", phi_x, sampler.wts)
    return prior + torch.einsum("snm,smd->snd", _gram(sampler, x_draws),
                                sampler.v)


@torch.no_grad()
def make_dp_pathwise_sampler(key, caches: PosteriorCache, phi,
                             num_samples: int, num_latent: int,
                             num_features: int = 2048,
                             kernel: str = "ard_rbf"):
    """The DP mixture's pathwise sampler: one sampler per atom (leading T
    on every field) and, for each (sample, output dim), an atom drawn once
    from Cat(phi_d), so a draw follows one atom per dim across every test
    point. caches: a batched `PosteriorCache` over atoms
    (`prediction.dp_posterior`); phi (D, T). Returns (samplers, assign
    (S, D) int64 on phi's device)."""
    t_count = caches.L.shape[0]
    r_atoms, r_pick = prng.split(key)
    atoms = [make_pathwise_sampler(
        r, PosteriorCache(*(f[t] for f in caches)), num_samples, num_latent,
        num_features, kernel) for t, r in enumerate(prng.split(r_atoms,
                                                               t_count))]
    samplers = PathwiseSampler(
        **{f.name: torch.stack([getattr(a, f.name) for a in atoms])
           for f in dataclasses.fields(PathwiseSampler) if f.name != "kernel"},
        kernel=kernel)
    logits = torch.log(torch.clamp(phi, min=1e-38))         # (D, T)
    # one key per dim, its S draws along the sample axis: (D, S)
    assign = prng.categorical(prng.split(r_pick, phi.shape[0]), logits,
                              shape=(num_samples,))
    return samplers, assign.T.to(phi.device)


@torch.no_grad()
def dp_sample_at(samplers: PathwiseSampler, assign, x_star):
    """The mixture's draws at x_star: (S, N*, D). Every atom is evaluated
    (T is small) and each (sample, dim) takes its assigned atom's
    values."""
    f_all = sample_at(samplers, x_star)                    # (T, S, N*, D)
    idx = assign[None, :, None, :].expand(1, -1, x_star.shape[0], -1)
    return torch.take_along_dim(f_all, idx, dim=0)[0]
