r"""The full-batch sharded ELBOs (counterpart of the first half of
`dp_gp_lvm_tpu/parallel/sharded_elbo.py`): the Bayesian GP-LVM, the
DP-GP-LVM and MRD over a (data, model) mesh of ranks.

Every data-dependent quantity of the collapsed bound is a sum over n
(Psi0, Psi1^T Y, Psi2, y^T y, the row count, KL[q(X)]), so each rank
runs:

    local:       partial sufficient statistics on its N-shard
    all-reduce:  one sum of (M x D + M x M + D + 3) numbers over "data"
    replicated:  the O(M^3 + M^2 D) bound algebra, the stick and
                 assignment terms, the final scalar.

This is exact: the single-device ELBO up to the order of the sums. The
DP-GP-LVM also cuts its atoms over "model": a rank computes the
statistics of its T / model atoms in one call (on the card one K1
launch over them, K2 in its backward), sums them over "data" and adds
its phi-weighted free energies to the other model ranks' with one sum
over "model". The local statistics go through `ops.dispatch`, so
`use_fused="auto"` decides from the rank's own shapes and inputs. The
sharded Bayesian GP-LVM and MRD take `dispatch.suff_stats` (K1 at T = 1
with K2 on the card) as the reference's do.

The functions take the rank's local shards, cut by `parallel.auto.place`
(`parallel.recipe.sharded_setup` does it and raises where N does not
divide over "data" or T over "model"). Each returns the replicated
value, the same on every rank, whose backward is the rank's share:
`parallel.collectives.reduce_grads` completes the gradient (see that
module). The objectives hold every term of the single-device ELBOs, the
hyperprior and the learnable alpha included.

The minibatch families (the second half of the reference module) cut
the batch, not the dataset: `svi_elbo_sharded`, `mrd_svi_elbo_sharded`
and `dp_svi_elbo_sharded` take the rank's block of the batch rows and of
their indices (the block its "data" coordinate selects; every rank draws
the same full batch), gather their q(X) moments from the whole table or
encode them, and sum the block's statistics and KL[q(X)] over "data"
before scaling them by N / B (B the whole batch). The whitened bound then
runs on every rank; the DP-SVI's per-atom free energies run on the rank's
atoms and their phi-weighted sum over "model". With `with_aux` each also
returns the whitened statistics the natural-gradient q(u) blend reads:
summed over "data", so every rank of a model coordinate holds the same
bits, and the blend needs no collective of its own.
"""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_noise,
    positive_variational_var,
)
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy, pin_full_f32
from dp_gp_lvm_tpu_torch.distributions import gaussian, stick_breaking
from dp_gp_lvm_tpu_torch.models.bgplvm import _log_normal_hyperprior
from dp_gp_lvm_tpu_torch.models import dp_svi, mrd_svi
from dp_gp_lvm_tpu_torch.models import svi_gplvm as svi
from dp_gp_lvm_tpu_torch.models.bound import SuffStats, collapsed_bound
from dp_gp_lvm_tpu_torch.models.mrd import constrain_view
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.parallel.collectives import psum, share
from dp_gp_lvm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _local_stats(variance, ard, mu, s, z, y, config) -> SuffStats:
    """The rank's partial sufficient statistics of one kernel (no sum
    over ranks yet), dispatched on the rank's own shapes and inputs."""
    return dispatch.suff_stats(
        variance, ard, mu, s, z, y, block_n=config.psi2_block,
        use_fused=config.use_fused, kernel=config.kernel,
    )


def _dp_local_stats_batched(variance, ard, mu, s, Zs, y, config) -> SuffStats:
    """The rank's stacked per-atom partial statistics of its local atoms:
    Psi0 (Tl,), Psi1^T Y (Tl, M, D), Psi2 (Tl, M, M); one K1 launch on
    the card where `use_fused` takes it."""
    p0, p1y, p2, yty, n = dispatch.dp_batched_suffstats(
        variance, ard, mu, s, Zs, y, block_n=config.psi2_block,
        use_fused=config.use_fused, kernel=config.kernel,
    )
    return SuffStats(psi0=p0, psi1T_y=p1y, psi2=p2, yty=yty, n=n)


def _psum_with_kl(stats_list, kl, mesh: Mesh):
    """Every statistic of `stats_list` and the KL partial summed over
    "data" in one all-reduce: (summed SuffStats list, summed KL)."""
    flat = [x for st in stats_list for x in st] + [kl]
    flat = psum(flat, mesh, DATA_AXIS)
    width = len(SuffStats._fields)
    return ([SuffStats(*flat[i * width:(i + 1) * width])
             for i in range(len(stats_list))], flat[-1])


def _on_card(y) -> None:
    if y.device.type == "cuda":
        pin_full_f32()


def bgplvm_elbo_sharded(params, Y, config, mesh: Mesh,
                        policy: JitterPolicy = JitterPolicy()):
    """Data-parallel Bayesian GP-LVM ELBO: Y, qx_mean and raw_qx_var are
    the rank's rows, the kernel and inducing leaves whole."""
    _on_card(Y)
    variance = positive(params["raw_variance"])
    ard = positive(params["raw_ard"])
    noise = positive_noise(params["raw_noise"])
    mu = params["qx_mean"]
    s = positive_variational_var(params["raw_qx_var"])
    stats = _local_stats(variance, ard, mu, s, params["z"], Y, config)
    (stats,), kl = _psum_with_kl(
        [stats], gaussian.kl_to_standard_normal(mu, s), mesh)
    kuu = dispatch.gram(variance, ard, params["z"], kernel=config.kernel)
    terms = collapsed_bound(kuu, stats, noise, policy)
    hp = _log_normal_hyperprior(
        getattr(config, "hyperprior_std", 0.0), variance, ard, noise)
    return share(torch.sum(terms.per_dim) - kl + hp, mesh)


def bgplvm_loss_sharded(params, Y, config, mesh: Mesh):
    return -bgplvm_elbo_sharded(params, Y, config, mesh)


def dp_elbo_sharded(params, Y, config, mesh: Mesh,
                    policy: JitterPolicy = JitterPolicy()):
    """2-D parallel DP-GP-LVM ELBO: rows over "data", atoms over "model"
    (the rank's T / model atoms of z, raw_variance, raw_ard, raw_noise);
    phi_logits and the sticks whole.

    Holds every term of `models/dp_gp_lvm.elbo`: the phi-weighted fits,
    the stick and assignment terms, KL[q(X)], the log-normal hyperprior
    (summed over "model") and the Gamma prior of a learned alpha when
    params carry raw_alpha."""
    _on_card(Y)
    learn_alpha = "raw_alpha" in params
    mu = params["qx_mean"]
    s = positive_variational_var(params["raw_qx_var"])
    z = params["z"]                                   # (Tl, M, Q)
    variance = positive(params["raw_variance"])       # (Tl,)
    ard = positive(params["raw_ard"])                 # (Tl, Q)
    noise = positive_noise(params["raw_noise"])       # (Tl,)
    phi = torch.softmax(params["phi_logits"], dim=-1)  # (D, T) whole
    t_local = z.shape[0]

    stats = _dp_local_stats_batched(variance, ard, mu, s, z, Y, config)
    (stats,), kl_x = _psum_with_kl(
        [stats], gaussian.kl_to_standard_normal(mu, s), mesh)
    # one batched bound over the local atoms
    kuu_b = dispatch.gram(variance, ard, z, kernel=config.kernel)
    f_local = collapsed_bound(kuu_b, stats, noise, policy).per_dim  # (Tl, D)
    t0 = mesh.coordinate(MODEL_AXIS) * t_local
    phi_local = phi[:, t0:t0 + t_local]                # (D, Tl)
    model_sums = [torch.sum(phi_local * f_local.T)]
    if config.hyperprior_std:
        model_sums.append(_log_normal_hyperprior(
            config.hyperprior_std, variance, ard, noise))
    model_sums = psum(model_sums, mesh, MODEL_AXIS)
    alpha = (positive(params["raw_alpha"], 1e-3) if learn_alpha
             else torch.tensor(config.alpha, dtype=Y.dtype, device=Y.device))
    dp_terms = stick_breaking.dp_kl_terms(
        phi, positive(params["raw_gamma1"], 1e-4),
        positive(params["raw_gamma2"], 1e-4), alpha,
        logits=params["phi_logits"],
    )
    if learn_alpha:
        dp_terms = dp_terms + stick_breaking.alpha_log_prior(alpha)
    return share(sum(model_sums) + dp_terms - kl_x, mesh)


def dp_loss_sharded(params, Y, config, mesh: Mesh):
    return -dp_elbo_sharded(params, Y, config, mesh)


def mrd_elbo_sharded(params, Ys, config, mesh: Mesh,
                     policy: JitterPolicy = JitterPolicy()):
    """Data-parallel MRD ELBO: the rows of every view and of q(X) over
    "data", each view's kernel and inducing leaves whole. The views have
    their own widths, so the view loop stays a Python loop; their
    statistics and KL[q(X)] are summed over "data" in one all-reduce.
    The hyperprior is included, as in `models/mrd.elbo_terms`."""
    _on_card(Ys[0])
    mu = params["qx_mean"]
    s = positive_variational_var(params["raw_qx_var"])
    hyps = [constrain_view(vp) for vp in params["views"]]
    stats = [_local_stats(h["variance"], h["ard"], mu, s, h["z"], y, config)
             for h, y in zip(hyps, Ys)]
    stats, kl = _psum_with_kl(stats, gaussian.kl_to_standard_normal(mu, s),
                              mesh)
    fit, hp = 0.0, 0.0
    for h, st in zip(hyps, stats):
        kuu = dispatch.gram(h["variance"], h["ard"], h["z"],
                            kernel=config.kernel)
        fit = fit + torch.sum(
            collapsed_bound(kuu, st, h["noise"], policy).per_dim)
        if getattr(config, "hyperprior_std", 0.0):
            hp = hp + _log_normal_hyperprior(
                config.hyperprior_std, h["variance"], h["ard"], h["noise"])
    return share(fit - kl + hp, mesh)


def mrd_loss_sharded(params, Ys, config, mesh: Mesh):
    return -mrd_elbo_sharded(params, Ys, config, mesh)


def _batch_scale(n_total: int, y_local, mesh: Mesh) -> float:
    """N / B: B the whole batch, every data rank's block of equal rows."""
    return n_total / (y_local.shape[0] * mesh.size(DATA_AXIS))


def svi_elbo_sharded(params, y_batch, idx, n_total: int, config, mesh: Mesh,
                     policy: JitterPolicy = JitterPolicy(),
                     with_aux: bool = False):
    """Data-parallel minibatch SVI-GPLVM (`models/svi_gplvm.py`), resident
    or amortized: y_batch (B_l, D) and idx (B_l,) are the rank's block of
    the batch; every parameter is whole. The block's statistics (on the
    card K1 at T = 1, K2 in the backward) and its KL[q(X)] are summed over
    "data" in one all-reduce and scaled by N / B; the whitened bound runs
    on every rank. With `with_aux` it returns (bound, (a, A2)), the summed
    whitened statistics."""
    c = svi.constrain(params, config)
    stats, kl = svi._stats(c, y_batch, idx, config)
    (stats,), kl = _psum_with_kl([stats], kl, mesh)
    stats, kl_x = svi._scale_stats(stats, kl,
                                   _batch_scale(n_total, y_batch, mesh))
    bound, a, A2 = svi._bound_and_whitened(c, stats, kl_x, policy,
                                           config.kernel)
    bound = share(bound, mesh)
    return (bound, (a, A2)) if with_aux else bound


def svi_loss_sharded(params, y_batch, idx, n_total: int, config,
                     mesh: Mesh):
    return -svi_elbo_sharded(params, y_batch, idx, n_total, config, mesh)


def mrd_svi_elbo_sharded(params, y_batches, idx, n_total: int, config,
                         mesh: Mesh, policy: JitterPolicy | None = None,
                         with_aux: bool = False):
    """Data-parallel minibatch MRD-SVI (`models/mrd_svi.py`): y_batches
    are the rank's block of the aligned batch rows of every view, idx
    their indices; the shared q(X) table or encoder (over the views'
    concatenated rows) and each view's leaves are whole. Every view's
    statistics and KL[q(X)] are summed over "data" in one all-reduce; the
    bound is the sum of the views' whitened bounds less KL[q(X)]. With
    `with_aux` it returns (bound, ((a, A2, beta) of each view))."""
    policy = mrd_svi._policy(config, policy)
    c_views = mrd_svi.constrain_views(params, config)
    y_cat = torch.cat(list(y_batches), dim=1)
    mu_b, s_b = svi._qx_batch(c_views[0], y_cat, idx)
    stats = mrd_svi._view_stats(c_views, y_batches, mu_b, s_b, config)
    stats, kl = _psum_with_kl(stats, gaussian.kl_to_standard_normal(mu_b, s_b),
                              mesh)
    scale = _batch_scale(n_total, y_cat, mesh)
    bounds, whitened = mrd_svi._bounds_from_stats(c_views, stats, config,
                                                  policy, scale)
    bound = share(sum(bounds) - scale * kl, mesh)
    return (bound, tuple(whitened)) if with_aux else bound


def mrd_svi_loss_sharded(params, y_batches, idx, n_total: int, config,
                         mesh: Mesh):
    return -mrd_svi_elbo_sharded(params, y_batches, idx, n_total, config,
                                 mesh)


def dp_svi_elbo_sharded(params, y_batch, idx, n_total: int, config,
                        mesh: Mesh, policy: JitterPolicy | None = None,
                        with_aux: bool = False):
    """2-D parallel minibatch DP-SVI (`models/dp_svi.py`): y_batch and idx
    the rank's block of the batch over "data"; z, the kernel hypers, the
    noise, u_h and u_lam the rank's T / model atoms; the q(X) table or
    encoder, phi, the sticks and a learned alpha whole.

    The local atoms' statistics of the block (on the card one K1 launch,
    K2 in the backward) and KL[q(X)] are summed over "data" in one
    all-reduce and scaled; the local atoms' free energies f_local
    (T_l, D) follow, and the phi-weighted fit with the hyperprior is
    summed over "model". The stick and assignment terms (and alpha's
    Gamma prior where alpha is learned) run on every rank. With
    `with_aux` it returns (bound, (f_local, a_l, A2_l)): the local atoms'
    free energies and whitened statistics."""
    policy = dp_svi._policy(config, policy)
    c = dp_svi.constrain(params, config)
    mu_b, s_b = dp_svi._qx(c, y_batch, idx)
    stats = dp_svi._batch_stats(c, mu_b, s_b, y_batch, config)
    flat = psum([*stats, gaussian.kl_to_standard_normal(mu_b, s_b)], mesh,
                DATA_AXIS)
    scale = _batch_scale(n_total, y_batch, mesh)
    stats, kl_x = dp_svi._scale_stats(flat[:-1], scale), scale * flat[-1]
    f_local, a_l, A2_l = dp_svi._free_energy_and_whitened(c, stats, config,
                                                          policy)
    t_local = f_local.shape[0]
    t0 = mesh.coordinate(MODEL_AXIS) * t_local
    phi = c["phi"]                                        # (D, T) whole
    hp = _log_normal_hyperprior(config.hyperprior_std, c["variance"],
                                c["ard"], c["noise"])     # 0.0 without one
    fit, *hp = psum([torch.sum(phi[:, t0:t0 + t_local] * f_local.T),
                     *([hp] if torch.is_tensor(hp) else [])], mesh,
                    MODEL_AXIS)
    alpha = c.get("alpha", config.alpha)
    dp_terms = stick_breaking.dp_kl_terms(phi, c["gamma1"], c["gamma2"],
                                          alpha, logits=c["phi_logits"])
    if "alpha" in c:
        dp_terms = dp_terms + stick_breaking.alpha_log_prior(alpha)
    bound = fit + dp_terms - kl_x
    if hp:
        bound = bound + hp[0]
    bound = share(bound, mesh)
    return (bound, (f_local, a_l, A2_l)) if with_aux else bound


def dp_svi_loss_sharded(params, y_batch, idx, n_total: int, config,
                        mesh: Mesh):
    return -dp_svi_elbo_sharded(params, y_batch, idx, n_total, config, mesh)
