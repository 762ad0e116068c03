r"""Minibatch (SVI) MRD: the multi-view MRD on the uncollapsed whitened
Hensman bound (counterpart of `dp_gp_lvm_tpu/models/mrd_svi.py`, whose
docstring gives the algebra).

Every view shares one q(X), a resident (N, Q) table or the recognition
network of `models/amortized.py` over the CONCATENATED views, while view v
has its own ARD-RBF kernel, noise, inducing inputs and explicit whitened
q(u^v). Every data term is a sum over rows, so a minibatch of B aligned
rows (the same indices in every view) is an unbiased estimate at O(B M^2 V)
a step, whatever N:

    ELBO = sum_v [ sum_{d in v} fit_vd - KL_u^v ] - KL(q(X) || N(0, I))

with each view's fit and KL_u the single-view bound of
`models/svi_gplvm.py` (its `_bound_and_whitened`, KL(q(X)) left out and
taken once). On the card each view's statistics are K1 at T = 1 with K2 in
its backward (`dispatch.suff_stats`). Views couple only through q(X): at
every view's closed-form optimal q(u^v) the bound is the collapsed
`mrd.elbo`, and with one view it is `svi_gplvm.elbo`.

q(u^v) trains by a natural-gradient blend per view, from the whitened
statistics of the gradient pass (one K1 forward and one K2 backward a view
and step); the rest by `train.loop.gp_optimizer`. Cross-view serving reads
the explicit q(u^v) alone, with no training data: infer the shared q(x*)
from the observed views, predict the target view. Its psi statistics are
plain torch, as the reference computes them off its kernels. On a device
mesh (`parallel/`) the aligned batch rows are cut over "data"
(`make_svi_natgrad_step(mesh=)`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import (
    positive,
    positive_inverse,
    positive_variational_var,
)
from dp_gp_lvm_tpu_torch.core.types import (
    JitterPolicy,
    pin_full_f32,
    resolve_device,
)
from dp_gp_lvm_tpu_torch.distributions import gaussian
from dp_gp_lvm_tpu_torch.models import amortized
from dp_gp_lvm_tpu_torch.models import svi_gplvm as svi
from dp_gp_lvm_tpu_torch.models.dp_svi import minibatch_indices
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.train.init import inducing_from_latents, pca_latents
from dp_gp_lvm_tpu_torch.train.loop import STEPS, leaf_name

LOG2PI = math.log(2.0 * math.pi)
# nearest-latent init: at most ~CANDIDATES strided training latents
CANDIDATES = 4096


class Config(NamedTuple):
    num_latent: int
    num_inducing: int
    num_views: int
    batch: int = 256               # aligned minibatch rows a step
    psi2_block: int | None = None
    # True | False | "auto": K1 with K2 in its backward per view
    use_fused: bool | str = "auto"
    kernel: str = "ard_rbf"
    fast_chol: bool = False        # skip the jitter search
    # a recognition network over the concatenated views in place of the
    # (N, Q) q(X) table; serving fills a missing view at its centre
    amortized: bool = False
    encoder_hidden: int = 64
    # lower bound on each view's noise variance (svi_gplvm.Config's)
    noise_floor: float = 0.0
    # additive lower bound on the amortized q(X) variance
    qx_var_floor: float = 0.0
    # per-view column counts: the streamed step splits its host-fed
    # (B, sum D_v) rows back into views with them
    view_dims: tuple = ()


def config_from_experiment(cfg, batch: int | None = None) -> Config:
    """The model config of a named `ExperimentConfig` (`core/config.py`),
    for training and serving alike."""
    return Config(
        num_latent=cfg.q, num_inducing=cfg.m, num_views=len(cfg.views),
        batch=batch or 1024, psi2_block=cfg.psi2_block,
        amortized=cfg.amortized, noise_floor=cfg.noise_floor,
        qx_var_floor=cfg.qx_var_floor, view_dims=tuple(cfg.views))


def _svi_config(config: Config) -> svi.Config:
    """The single-view config every per-view computation runs under."""
    return svi.Config(
        num_latent=config.num_latent, num_inducing=config.num_inducing,
        batch=config.batch, psi2_block=config.psi2_block,
        use_fused=config.use_fused, kernel=config.kernel,
        amortized=config.amortized, encoder_hidden=config.encoder_hidden,
        noise_floor=config.noise_floor, qx_var_floor=config.qx_var_floor)


def _policy(config: Config, policy: JitterPolicy | None) -> JitterPolicy:
    policy = policy or JitterPolicy()
    if config.fast_chol:
        policy = dataclasses.replace(policy, max_tries=0)
    return policy


def init_params(key, Ys: Sequence[torch.Tensor], config: Config):
    """PCA on the concatenated views (the shared q(X) table, or encoder
    leaves from fold_in(key, 7) whose encode(Y) is that table); per view
    inducing points from fold_in(key, v) and whitened q(u^v) at the prior
    (m = 0, S = I). `key` is of the reference's stream (`core/prng.py`);
    the leaves are `nn.Parameter`s on the views' device, nested as
    {q(X) leaves, "views": [one dict per view]}."""
    Yall = torch.cat(list(Ys), dim=1)
    dtype, device = Yall.dtype, Yall.device
    q, m = config.num_latent, config.num_inducing
    x0 = pca_latents(Yall, q)

    def const(value, shape=()):
        return torch.full(shape, value, dtype=dtype, device=device)

    def leaf(v):
        return nn.Parameter(v.contiguous())

    eye = torch.eye(m, dtype=dtype, device=device)
    views = [{
        "z": leaf(inducing_from_latents(prng.fold_in(key, v), x0, m)),
        "raw_variance": leaf(positive_inverse(const(1.0))),
        "raw_ard": leaf(positive_inverse(const(1.0, (q,)))),
        "raw_noise": leaf(positive_inverse(const(0.1))),
        "u_mean": leaf(const(0.0, (m, Y.shape[1]))),
        "raw_u_scale": leaf(const(0.0, (m, m))
                            + eye * positive_inverse(const(1.0))),
    } for v, Y in enumerate(Ys)]
    qx = amortized.qx_leaves_or_encoder(prng.fold_in(key, 7), Yall, x0,
                                        config)
    return {**{k: leaf(v) for k, v in qx.items()}, "views": views}


def on_device(params, device):
    """The nested parameters, detached, on `device`."""
    return {k: ([{kk: vv.detach().to(device) for kk, vv in view.items()}
                 for view in v] if k == "views" else v.detach().to(device))
            for k, v in params.items()}


def _view_params(params, v: int):
    """View v's leaves with the shared q(X) (or encoder) leaves: a
    `svi_gplvm` parameter dict, so every single-view function runs on it
    unchanged."""
    return {**{k: params[k] for k in params if k != "views"},
            **params["views"][v]}


def constrain_views(params, config: Config | None = None):
    """Each view's constrained dict (`svi_gplvm.constrain`), the shared
    q(X) leaves in each; `config` binds the noise and q(X) floors."""
    return [svi.constrain(_view_params(params, v), config)
            for v in range(len(params["views"]))]


def _view_stats(c_views, y_views, mu, s, config: Config):
    """Each view's SuffStats of the rows y_views at the q(X) moments
    (mu, s): on the card K1 at T = 1 a view, K2 in its backward."""
    if mu.device.type == "cuda":
        pin_full_f32()
    return [dispatch.suff_stats(
        c["variance"], c["ard"], mu, s, c["z"], y,
        block_n=config.psi2_block, use_fused=config.use_fused,
        kernel=config.kernel) for c, y in zip(c_views, y_views)]


def _bounds_per_view(c_views, y_views, mu, s, config: Config, policy,
                     scale=None):
    """Each view's whitened bound (KL(q(X)) left out) and its whitened
    statistics (a, A2, beta), from the q(X) moments (mu, s) of the rows;
    `scale` multiplies the statistics (N/B of a minibatch; None: every
    row)."""
    return _bounds_from_stats(
        c_views, _view_stats(c_views, y_views, mu, s, config), config,
        policy, scale)


def _bounds_from_stats(c_views, view_stats, config: Config, policy,
                       scale=None):
    """`_bounds_per_view` from each view's (unscaled) SuffStats."""
    bounds, whitened = [], []
    for c, stats in zip(c_views, view_stats):
        if scale is not None:
            stats = stats._replace(
                psi0=stats.psi0 * scale, psi1T_y=stats.psi1T_y * scale,
                psi2=stats.psi2 * scale, yty=stats.yty * scale,
                n=stats.n * scale)
        bound, a, A2 = svi._bound_and_whitened(c, stats, 0.0, policy,
                                               config.kernel)
        bounds.append(bound)
        whitened.append((a, A2, 1.0 / c["noise"]))
    return bounds, whitened


def elbo_terms(params, Ys, config: Config,
               policy: JitterPolicy | None = None):
    """The full-batch bound with its per-view fits (small N, and the
    runner's gated ELBO: on the card K1 over every row of each view)."""
    policy = _policy(config, policy)
    c_views = constrain_views(params, config)
    mu, s = amortized.qx_batch(c_views[0], torch.cat(list(Ys), dim=1), None)
    bounds, _ = _bounds_per_view(c_views, Ys, mu, s, config, policy)
    kl_x = gaussian.kl_to_standard_normal(mu, s)
    return {"elbo": sum(bounds) - kl_x, "kl_x": kl_x,
            "fit_per_view": torch.stack(bounds)}


def elbo(params, Ys, config: Config, policy: JitterPolicy | None = None):
    return elbo_terms(params, Ys, config, policy)["elbo"]


def loss(params, Ys, config: Config):
    return -elbo(params, Ys, config)


def _minibatch_bound(params, y_batches, idx, n_total: int, config: Config,
                     policy):
    """(estimate, whitened statistics of each view) of B aligned rows."""
    c_views = constrain_views(params, config)
    y_cat = torch.cat(list(y_batches), dim=1)
    mu_b, s_b = amortized.qx_batch(c_views[0], y_cat, idx)
    scale = n_total / y_cat.shape[0]
    bounds, whitened = _bounds_per_view(c_views, y_batches, mu_b, s_b,
                                        config, policy, scale)
    kl_x = scale * gaussian.kl_to_standard_normal(mu_b, s_b)
    return sum(bounds) - kl_x, whitened


def elbo_minibatch(params, y_batches: Sequence[torch.Tensor], idx,
                   n_total: int, config: Config,
                   policy: JitterPolicy | None = None):
    """Unbiased minibatch estimate: y_batches are the SAME B rows (table
    rows `idx`) of every view; the statistics and the rows' KL(q(X))
    scale by N/B."""
    return _minibatch_bound(params, y_batches, idx, n_total, config,
                            _policy(config, policy))[0]


def loss_minibatch(params, y_batches, idx, n_total: int, config: Config):
    return -elbo_minibatch(params, y_batches, idx, n_total, config)


def set_optimal_qu(params, Ys, config: Config,
                   policy: JitterPolicy | None = None):
    """params (new tensors) with every view's q(u^v) at its closed-form
    full-batch optimum; the views couple only through q(X), so these are
    jointly optimal and the bound is the collapsed `mrd.elbo`."""
    policy = _policy(config, policy)
    c_views = constrain_views(params, config)
    mu, s = amortized.qx_batch(c_views[0], torch.cat(list(Ys), dim=1), None)
    _, whitened = _bounds_per_view(c_views, Ys, mu, s, config, policy)
    views = []
    for vp, (a, A2, beta) in zip(params["views"], whitened):
        m_star, ls_star = svi.optimal_qu_from_whitened(a, A2, beta)
        views.append({**vp, "u_mean": m_star,
                      "raw_u_scale": svi._raw_scale(ls_star)})
    return {**params, "views": views}


def ard_relevance(params):
    """Per-view ARD weights (V, Q): the shared/private signature."""
    return torch.stack([positive(vp["raw_ard"]) for vp in params["views"]])


def nested(flat):
    """The nested parameter dict over the tensors of a flat one
    (`train.loop.flat_leaves`'s `views.{i}.{key}` names)."""
    out, views = {}, {}
    for k, v in flat.items():
        if k.startswith("views."):
            _, i, leaf = k.split(".", 2)
            views.setdefault(int(i), {})[leaf] = v
        else:
            out[k] = v
    out["views"] = [views[i] for i in sorted(views)]
    return out


def make_svi_natgrad_step(config: Config, n_total: int, optimizer,
                          rho: float = 0.2, rho_t0: float | None = None,
                          rho_kappa: float = 0.6, sample_idx=None,
                          mesh=None, streaming: bool = False,
                          policy: JitterPolicy | None = None,
                          qu_trust: float | None = None):
    """One SVI step over `optimizer` (a `train.loop.GPOptimizer` over the
    model's parameters, updated in place): hypers, inducing inputs and
    q(X) (or the encoder) by the optimizer on the minibatch ELBO's
    gradient (q(u^v)'s gradients handed to it as zeros), then each view's
    q(u^v) by `svi_gplvm.natgrad_blend_qu` toward the optimum its own
    (N/B)-scaled batch statistics imply. The blend reads the statistics of
    the gradient pass, at the parameters before the update: one K1 forward
    and one K2 backward a view and step. Each view's blend is stored or
    dropped on its own (`svi_gplvm._guarded_qu`).

    mesh: a `parallel.mesh.Mesh` (the optimizer built with its `mesh` and
    the table of `parallel.recipe.place_svi("mrd_svi", ...)`): every rank
    gets the same full batch and takes its block of rows over "data"; the
    bound runs through `parallel.sharded_elbo.mrd_svi_elbo_sharded` and
    each view blends from its statistics summed over "data", the same
    bits on every rank. The math of the step without a mesh.

    rho_t0: Robbins-Monro decay rho (1 + t / t0)^-kappa. qu_trust: the
    blend's trust region (None: the exact natural gradient).

    Returns step(t, idx, Ys) -> loss (a 0-d device tensor): t the global
    step (for rho), idx the (B,) rows of the resident views Ys. With
    `streaming` it is step(t, (idx, y_cat)): the host feeds the rows with
    the views concatenated column-wise, and `config.view_dims` splits
    them; at equal rows it is the resident step. `step.indices(keys)` draws
    the rows of a (K, 2) stack of keys on the parameters' device:
    `sample_idx(key)` when given, else the reference's int32 randint."""
    if mesh is not None:
        svi._mesh_checked(mesh, optimizer, config.batch)
        # sharded_elbo imports this module
        from dp_gp_lvm_tpu_torch.parallel.sharded_elbo import (
            mrd_svi_elbo_sharded,
        )
    if streaming and len(config.view_dims) != config.num_views:
        raise ValueError(
            "streaming mrd_svi needs Config.view_dims (the per-view column "
            f"split of the streamed matrix); got {config.view_dims!r}")
    policy = _policy(config, policy)
    flat = optimizer.params
    params = nested(flat)
    grad_keys = [k for k in flat if leaf_name(k) not in svi.QU_NAMES]
    zero_keys = [k for k in flat if leaf_name(k) in svi.QU_NAMES]
    leaves = [flat[k] for k in grad_keys]
    device = leaves[0].device

    rho_at = svi.robbins_monro(rho, rho_t0, rho_kappa)

    def one(t: int, idx, y_b):
        if mesh is not None:
            bound, whitened = mrd_svi_elbo_sharded(
                params, y_b, idx, n_total, config, mesh, policy,
                with_aux=True)
        else:
            bound, whitened = _minibatch_bound(params, y_b, idx, n_total,
                                               config, policy)
        loss = -bound
        grads = optimizer.reduce(
            dict(zip(grad_keys, torch.autograd.grad(loss, leaves))))
        grads.update({k: torch.zeros_like(flat[k]) for k in zero_keys})
        optimizer.step(grads)
        for vp, (a, A2, beta) in zip(params["views"], whitened):
            with torch.no_grad():
                cv = svi.constrain(vp, config)
                u_mean, raw = svi.natgrad_blend_qu(
                    cv["u_mean"], cv["u_scale"], a.detach(), A2.detach(),
                    beta.detach(), rho_at(t), policy, trust=qu_trust)
            svi._guarded_qu(vp, u_mean, raw)
        STEPS["taken"] += 1
        return loss.detach()

    if streaming:
        def step(t: int, batch):
            idx, *y_views = svi.batch_block(mesh, batch[0], *torch.split(
                batch[1], list(config.view_dims), dim=1))
            return one(t, idx, [y.contiguous() for y in y_views])
    else:
        def step(t: int, idx, Ys):
            (idx,) = svi.batch_block(mesh, idx)
            return one(t, idx, [Y[idx] for Y in Ys])

    def indices(keys):
        return minibatch_indices(keys, config.batch, n_total,
                                 sample_idx).to(device)

    step.indices = indices
    return step


# ---------------------------------------------------------------------------
# serving from q(u^v) alone
# ---------------------------------------------------------------------------


def _view_cache(params, v: int, config: Config, policy: JitterPolicy):
    """(detached constrained view v, chol(K_uu) of it): what a request
    reads of a view. The factorization reads its status once."""
    c = svi._detached(_view_params(params, v), config)
    return c, svi._kuu_factor(c, config, policy)


def predict_view(params, x_mean, x_var, view: int, config: Config,
                 policy: JitterPolicy | None = None):
    """Predictive mean and variance of one view at q(x*) rows, from that
    view's explicit q(u^v)."""
    return svi.predict_from_latent(_view_params(params, view), x_mean, x_var,
                                   _svi_config(config),
                                   policy or JitterPolicy())


def _infer(caches, m_init, config: Config, num_steps: int, lr: float,
           tol: float | None):
    """Fit q(x*) against the summed expected log-likelihoods of the
    observed views: `caches` is a list of (view cache, rows (N*, D_v))."""
    from dp_gp_lvm_tpu_torch.models.prediction import _fit_variational

    scfg = _svi_config(config)
    dtype = caches[0][1].dtype
    var_params = {
        "m": m_init.to(dtype),
        "raw_s": positive_inverse(0.1 * torch.ones_like(m_init)).to(dtype),
    }

    def objective(vp):
        s = positive_variational_var(vp["raw_s"])
        ell = 0.0
        for (c, L), y in caches:
            phi, gp_var, m_quad = svi._latent_row_pieces(c, L, vp["m"], s,
                                                         scfg)
            f_mean = phi @ c["u_mean"]
            sq = y * y - 2.0 * y * f_mean + m_quad + gp_var[:, None]
            ell = ell + torch.sum(-0.5 * (LOG2PI + torch.log(c["noise"]))
                                  - 0.5 * (1.0 / c["noise"]) * sq)
        return -(ell - gaussian.kl_to_standard_normal(vp["m"], s))

    vp, trace, _ = _fit_variational(objective, var_params, num_steps, lr,
                                    tol)
    return vp["m"], positive_variational_var(vp["raw_s"]), -trace


def infer_latent(params, observed: dict, m_init, config: Config,
                 num_steps: int = 200, lr: float = 0.05,
                 tol: float | None = None,
                 policy: JitterPolicy | None = None):
    """Fit the shared q(x*) = N(m*, diag s*) of new rows against the sum
    of the observed views' expected log-likelihoods under their q(u^v)
    (`observed`: view index -> (N*, D_v) rows), with the Adam of
    `prediction._fit_variational`. Returns (m*, s*, objective trace)."""
    policy = _policy(config, policy)
    caches = [(_view_cache(params, v, config, policy), y)
              for v, y in sorted(observed.items())]
    return _infer(caches, m_init, config, num_steps, lr, tol)


def candidate_table(params, view: int, config: Config):
    """The resident nearest-latent init's table for `view`: (cand (C, Q),
    their predicted means (C, D_view)), every (N // 4096)-th training
    latent. Parameters only: a serving factory builds it once."""
    c0 = svi._detached(_view_params(params, view), config)
    n = c0["qx_mean"].shape[0]
    take = torch.arange(0, n, max(1, n // CANDIDATES),
                        device=c0["qx_mean"].device)
    cand, cand_var = c0["qx_mean"][take], c0["qx_var"][take]
    mean, _ = predict_view(params, cand, cand_var, view, config)
    return cand, mean


def _latent_init(params, observed: dict, config: Config, init_table=None):
    """q(x*) means to start from. Amortized: one encoder pass, the
    unobserved views filled at the encoder's centre (zero after centring).
    Resident: the candidate whose predicted mean of the first observed
    view is nearest (argmin of the squared distance)."""
    items = sorted(observed.items())
    if "qx_mean" not in params:
        c0 = svi._detached(_view_params(params, items[0][0]), config)
        dims = [vp["u_mean"].shape[1] for vp in params["views"]]
        offs = [0]
        for d_v in dims:
            offs.append(offs[-1] + d_v)
        y0 = items[0][1]
        y_cat = c0["enc_mean"][None, :].expand(y0.shape[0], offs[-1]).clone()
        mask = torch.zeros(y0.shape[0], offs[-1], dtype=y0.dtype,
                           device=y0.device)
        for v, y in items:
            y_cat[:, offs[v]:offs[v + 1]] = y
            mask[:, offs[v]:offs[v + 1]] = 1.0
        with torch.no_grad():
            return amortized.encoder_fill_init(c0, y_cat, mask)
    v0, y0 = items[0]
    if init_table is None:
        init_table = candidate_table(params, v0, config)
    cand, cand_mean = init_table
    d2 = torch.sum((y0[:, None, :] - cand_mean[None, :, :]) ** 2, dim=-1)
    return cand[torch.argmin(d2, dim=1)]


def cross_view_predict(params, observed: dict, target_view: int,
                       config: Config, num_steps: int = 200,
                       lr: float = 0.05, tol: float | None = None,
                       init_table=None):
    """Cross-view serving from q(u) alone: observe some views of new rows,
    infer the shared q(x*), predict the target view. Returns (mean, var,
    m*, s*, objective trace). init_table: a `candidate_table` of the first
    observed view, built once by a serving factory."""
    m0 = _latent_init(params, observed, config, init_table)
    m_s, s_s, trace = infer_latent(params, observed, m0, config, num_steps,
                                   lr, tol)
    with torch.no_grad():
        mean, var = predict_view(params, m_s, s_s, target_view, config)
    return mean, var, m_s, s_s, trace


def cross_view_sample(key, params, observed: dict, target_view: int,
                      config: Config, num_samples: int,
                      num_steps: int = 200, lr: float = 0.05,
                      tol: float | None = None, num_features: int = 2048,
                      init_table=None, device=None):
    """Generative cross-view serving: (S, N*, D_target) joint function
    draws of the target view at new rows, the latent uncertainty carried
    through: infer q(x*) from the observed views, draw x_s ~ q(x*) per
    sample, and evaluate S pathwise draws of the target view's q(u^v)
    (`models/sampling.py`) each at its own x_s. `key` (of the reference's
    stream) splits into the sampler's key and the latents'. Runs on
    `device` (the card unless the caller says "cpu"), where the parameters
    and rows are moved. Marginally the draws converge to
    `cross_view_predict`'s mean and variance less the noise."""
    from dp_gp_lvm_tpu_torch.models import sampling

    device = resolve_device(device)
    if device.type == "cuda":
        pin_full_f32()
    params = on_device(params, device)
    observed = {v: y.to(device) for v, y in observed.items()}
    m0 = _latent_init(params, observed, config, init_table)
    m_s, s_s, _ = infer_latent(params, observed, m0, config, num_steps, lr,
                               tol)
    r_f, r_x = prng.split(key)
    smp = sampling.make_svi_pathwise_sampler(
        r_f, _view_params(params, target_view), _svi_config(config),
        num_samples, num_features=num_features)
    eps = prng.normal(r_x, (num_samples,) + tuple(m_s.shape), m_s.dtype)
    x_draws = m_s[None] + torch.sqrt(s_s)[None] * eps.to(device)
    with torch.no_grad():
        return sampling.sample_at_latent_draws(smp, x_draws)
