"""The port's pathwise sampling (`models/sampling.py`) and its Gumbel-max
draws (`core/prng.py`) against the JAX package's, in float64 on the CPU:
every sampler built from the same key on the same posterior (the
collapsed Bayesian GP-LVM cache with RFF and linear features, the
explicit whitened q(u) of an SVI-GPLVM, the DP mixture with its atom
assignments bit for bit) and evaluated at the same points; `categorical`
and `gumbel` against `jax.random` on several keys. The posteriors are
the JAX package's, off their init, built in one jitted program. Then the
reference's `tests/test_sampling.py` moment cases, on models the port
trains itself (no JAX). The port draws its random numbers on the host
through `core/prng.py`, at ~250 bytes of memory a draw, so the RBF cases
take 500 draws of 512 features (the reference: 8000 of 4096) and the
mixture 16 features an atom: its mean check does not depend on the
feature count, since the prior draws have mean zero."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.models import prediction as jpred
from dp_gp_lvm_tpu.models import sampling as jsmp
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.kernels import ard_rbf, linear
from dp_gp_lvm_tpu_torch.models import (
    bgplvm,
    dp_gp_lvm,
    mrd_svi,
    prediction,
    sampling,
    svi_gplvm,
)
from dp_gp_lvm_tpu_torch.train.loop import fit

N, D, Q, M = 24, 4, 2, 6
S, L, T = 5, 16, 3
FIELDS = ("freqs", "phases", "scale", "wts", "v", "variance", "ard", "z")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(tree):
    return jax.tree.map(lambda v: v + 0.01 * jnp.sin(jnp.arange(
        v.size, dtype=v.dtype)).reshape(v.shape), tree)


def _fields(smp):
    return {f: getattr(smp, f) for f in FIELDS}


@functools.lru_cache(maxsize=1)
def _reference():
    def program(key):
        Y, _ = jsyn.toy_gplvm(key, n=N, d=D, q_true=2, dtype=jnp.float64)
        bcfg = jbg.Config(num_latent=Q, num_inducing=M)
        cache = jpred.bgplvm_posterior(_perturbed(jbg.init_params(
            jax.random.PRNGKey(4), Y, bcfg)), Y, bcfg)
        x_star = jnp.sin(jnp.arange(7 * Q, dtype=jnp.float64)).reshape(7, Q)
        x_draws = jnp.cos(jnp.arange(S * 7 * Q, dtype=jnp.float64)
                          ).reshape(S, 7, Q)
        rff = jsmp.make_pathwise_sampler(jax.random.PRNGKey(0), cache, S, Q,
                                         num_features=L)
        lin = jsmp.make_pathwise_sampler(jax.random.PRNGKey(1), cache, S, Q,
                                         kernel="linear")
        scfg = jsvi.Config(num_latent=Q, num_inducing=M)
        sp = _perturbed(jsvi.init_params(jax.random.PRNGKey(5), Y, scfg))
        svi = jsmp.make_svi_pathwise_sampler(jax.random.PRNGKey(33), sp,
                                             scfg, S, num_features=L)
        dcfg = jdp.Config(num_latent=Q, num_inducing=M, truncation=T)
        dp = _perturbed(jdp.init_params(jax.random.PRNGKey(14), Y, dcfg))
        caches, phi = jpred.dp_posterior(dp, Y, dcfg)
        dsmp, assign = jsmp.make_dp_pathwise_sampler(
            jax.random.PRNGKey(15), caches, phi, 40, Q, num_features=L)
        return {
            "cache": cache, "x_star": x_star, "x_draws": x_draws,
            "qu": jsmp.qu_draws(jax.random.PRNGKey(7), cache, S, D),
            "rff": _fields(rff), "rff_at": jsmp.sample_at(rff, x_star),
            "rff_feat": jsmp._prior_features(x_star, rff),
            "lin": _fields(lin), "lin_at": jsmp.sample_at(lin, x_star),
            "svi_params": sp, "svi": _fields(svi),
            "svi_at": jsmp.sample_at_latent_draws(svi, x_draws),
            "dp_caches": caches, "phi": phi, "dp": _fields(dsmp),
            "assign": assign,
            "dp_at": jsmp.dp_sample_at(dsmp, assign, x_star),
        }

    return jax.tree.map(np.asarray, jax.jit(program)(jax.random.PRNGKey(3)))


def _cache(arrays):
    return prediction.PosteriorCache(*(torch.tensor(a) for a in arrays))


def _held(smp, want, rtol=1e-10):
    for f in FIELDS:
        got = getattr(smp, f).numpy()
        np.testing.assert_allclose(got, want[f], rtol=rtol,
                                   atol=rtol * max(np.abs(want[f]).max(),
                                                   1e-300), err_msg=f)


def test_collapsed_samplers_match_reference():
    """RFF and exact linear features, the q(u) draws and the Matheron
    solve (every field), and the draws at the same points."""
    ref = _reference()
    cache = _cache(ref["cache"])
    x_star = torch.tensor(ref["x_star"])
    u = sampling.qu_draws(prng.PRNGKey(7), cache, S, D)
    np.testing.assert_allclose(u.numpy(), ref["qu"], rtol=1e-10,
                               atol=1e-12)
    rff = sampling.make_pathwise_sampler(prng.PRNGKey(0), cache, S, Q,
                                         num_features=L)
    _held(rff, ref["rff"])
    np.testing.assert_allclose(
        sampling._prior_features(x_star, rff).numpy(), ref["rff_feat"],
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sampling.sample_at(rff, x_star).numpy(),
                               ref["rff_at"], rtol=1e-9, atol=1e-10)
    lin = sampling.make_pathwise_sampler(prng.PRNGKey(1), cache, S, Q,
                                         kernel="linear")
    _held(lin, ref["lin"])
    np.testing.assert_allclose(sampling.sample_at(lin, x_star).numpy(),
                               ref["lin_at"], rtol=1e-9, atol=1e-10)


def test_svi_sampler_and_latent_draws_match_reference():
    ref = _reference()
    params = params_from_jax(ref["svi_params"], "cpu")
    cfg = svi_gplvm.Config(num_latent=Q, num_inducing=M)
    smp = sampling.make_svi_pathwise_sampler(prng.PRNGKey(33), params, cfg,
                                             S, num_features=L)
    _held(smp, ref["svi"])
    got = sampling.sample_at_latent_draws(smp, torch.tensor(ref["x_draws"]))
    np.testing.assert_allclose(got.numpy(), ref["svi_at"], rtol=1e-9,
                               atol=1e-10)


def test_dp_sampler_and_assignments_match_reference():
    """Every atom's sampler, the (S, D) atom assignments bit for bit, and
    the mixture's draws."""
    ref = _reference()
    caches = _cache(ref["dp_caches"])
    phi = torch.tensor(ref["phi"])
    smp, assign = sampling.make_dp_pathwise_sampler(
        prng.PRNGKey(15), caches, phi, 40, Q, num_features=L)
    _held(smp, ref["dp"])
    assert assign.shape == (40, D)
    assert np.array_equal(assign.numpy(), ref["assign"])
    assert len(np.unique(ref["assign"])) > 1        # not a vacuous check
    got = sampling.dp_sample_at(smp, assign, torch.tensor(ref["x_star"]))
    np.testing.assert_allclose(got.numpy(), ref["dp_at"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 11])
def test_categorical_and_gumbel_match_jax(seed):
    """`jax.random.categorical` with replacement, one key and its logits
    batch, and vmapped over a batch of keys; the Gumbel values in f64 to
    the bit but the host's logarithms, in f32 to a few ulps."""
    key = jax.random.PRNGKey(seed)
    logits = np.log(np.random.default_rng(seed).dirichlet(
        np.full(5, 0.7), size=3))
    want = jax.random.categorical(key, jnp.asarray(logits), shape=(60, 3))
    got = prng.categorical(prng.PRNGKey(seed), torch.tensor(logits),
                           shape=(60, 3))
    assert np.array_equal(got.numpy(), np.asarray(want))
    keys = jax.random.split(key, 3)
    want = jax.vmap(lambda r, lg: jax.random.categorical(
        r, lg, shape=(50,)))(keys, jnp.asarray(logits))
    got = prng.categorical(prng.split(prng.PRNGKey(seed), 3),
                           torch.tensor(logits), shape=(50,))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for jdt, tdt, rtol in ((jnp.float64, torch.float64, 1e-15),
                           (jnp.float32, torch.float32, 1e-6)):
        g = np.asarray(jax.random.gumbel(key, (40, 6), jdt))
        np.testing.assert_allclose(
            prng.gumbel(prng.PRNGKey(seed), (40, 6), tdt).numpy(), g,
            rtol=rtol, atol=rtol)
    with pytest.raises(ValueError, match="batch shape"):
        prng.categorical(prng.PRNGKey(seed), torch.tensor(logits),
                         shape=(4,))


# ---------------------------------------------------------------------------
# the reference's moment cases, on models the port trains
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_cache():
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(3), n=48, d=6, q_true=2,
                               noise=0.01, device="cpu")
    cfg = bgplvm.Config(num_latent=2, num_inducing=10)
    params = bgplvm.init_params(prng.PRNGKey(4), Y, cfg)
    fit(lambda p, y: bgplvm.loss(p, y, cfg), params, (Y,), 250, lr=2e-2)
    cache = prediction.bgplvm_posterior(params, Y, cfg)
    with torch.no_grad():
        x_star = bgplvm.constrain(params)["qx_mean"][:9].detach()
    return cache, x_star


def _function_moments(cache, x_star, kernel="ard_rbf"):
    """Noise-free predictive mean and variance at deterministic x*."""
    with torch.no_grad():
        mean, var = prediction.predict_from_latent(
            cache, x_star, torch.zeros_like(x_star), kernel)
    return mean.numpy(), (var - cache.noise).numpy()


def test_rff_prior_covariance_matches_kernel(trained_cache):
    cache, x_star = trained_cache
    smp = sampling.make_pathwise_sampler(prng.PRNGKey(0), cache, 1, 2,
                                         num_features=8192)
    phi = sampling._prior_features(x_star, smp)
    k_true = ard_rbf.gram(cache.variance, cache.ard, x_star)
    assert float((phi @ phi.T - k_true).abs().max()) < 0.05 * float(
        cache.variance)


def test_linear_features_exact(trained_cache):
    cache, x_star = trained_cache
    smp = sampling.make_pathwise_sampler(prng.PRNGKey(0), cache, 1, 2,
                                         kernel="linear")
    phi = sampling._prior_features(x_star, smp)
    np.testing.assert_allclose(
        (phi @ phi.T).numpy(),
        linear.gram(cache.variance, cache.ard, x_star).numpy(), rtol=1e-10,
        atol=1e-12)


def test_qu_draw_moments(trained_cache):
    """Sample mean and covariance of q(u) against m = K_uu w and the
    EXPLICIT L B^{-1} L^T (not the factor route the code takes)."""
    cache, _ = trained_cache
    s = 40000
    u = sampling.qu_draws(prng.PRNGKey(7), cache, s, cache.w.shape[1])
    m_true = (cache.L @ (cache.L.T @ cache.w)).numpy()
    L, LB = cache.L.numpy(), cache.LB.numpy()
    cov_true = L @ np.linalg.inv(LB @ LB.T) @ L.T
    u = u.numpy()
    sd = np.sqrt(np.diag(cov_true)).max()
    assert np.max(np.abs(u.mean(0) - m_true)) < 5 * sd / np.sqrt(s)
    emp = np.cov(u[:, :, 0].T)
    assert np.max(np.abs(emp - cov_true)) < 0.05 * max(cov_true.max(), 1e-3)


def test_pathwise_moments_linear_exact_features():
    """Exact features on a linear-kernel model: only Monte Carlo error
    is left between the draws' moments and the predictive."""
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(21), n=40, d=5, q_true=2,
                               noise=0.01, device="cpu")
    cfg = bgplvm.Config(num_latent=2, num_inducing=8, kernel="linear")
    params = bgplvm.init_params(prng.PRNGKey(22), Y, cfg)
    fit(lambda p, y: bgplvm.loss(p, y, cfg), params, (Y,), 200, lr=2e-2)
    cache = prediction.bgplvm_posterior(params, Y, cfg)
    with torch.no_grad():
        x_star = bgplvm.constrain(params)["qx_mean"][:7].detach()
    s = 20000
    smp = sampling.make_pathwise_sampler(prng.PRNGKey(5), cache, s, 2,
                                         kernel="linear")
    f = sampling.sample_at(smp, x_star).numpy()
    mean_true, var_true = _function_moments(cache, x_star, "linear")
    var_true = np.maximum(var_true, 0.0)
    se = np.sqrt(var_true / s)
    assert np.all(np.abs(f.mean(0) - mean_true) < 6 * se + 1e-4)
    assert np.all(np.abs(f.var(0) - var_true) < 0.1 * var_true + 1e-4)


def test_pathwise_moments_rbf(trained_cache):
    cache, x_star = trained_cache
    s = 500
    smp = sampling.make_pathwise_sampler(prng.PRNGKey(6), cache, s, 2,
                                         num_features=512)
    f = sampling.sample_at(smp, x_star).numpy()
    mean_true, var_true = _function_moments(cache, x_star)
    scale = np.sqrt(float(cache.variance))
    assert np.max(np.abs(f.mean(0) - mean_true)) < 0.1 * scale
    assert np.max(np.abs(np.sqrt(f.var(0)) - np.sqrt(
        np.maximum(var_true, 0.0)))) < 0.1 * scale


def test_joint_consistency_within_sample(trained_cache):
    """Two nearby points of one draw give nearly the same value."""
    cache, x_star = trained_cache
    x_pair = torch.cat([x_star[:1], x_star[:1] + 1e-3])
    smp = sampling.make_pathwise_sampler(prng.PRNGKey(8), cache, 64, 2,
                                         num_features=2048)
    f = sampling.sample_at(smp, x_pair).numpy()
    gap = np.abs(f[:, 0] - f[:, 1]).max()
    assert gap < 0.05 * max(f[:, 0].std(0).max(), 1e-6)


def test_dp_mixture_sample_moments():
    """The mixture draws' mean against the phi-weighted predictive mean,
    and the atoms' frequencies against phi."""
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(13), n=40,
                                     dims_per_group=(4, 4), q=2, noise=0.01,
                                     device="cpu")
    cfg = dp_gp_lvm.Config(num_latent=2, num_inducing=10, truncation=3)
    params = dp_gp_lvm.init_params(prng.PRNGKey(14), Y, cfg)
    fit(lambda p, y: dp_gp_lvm.loss(p, y, cfg), params, (Y,), 250, lr=2e-2)
    caches, phi = prediction.dp_posterior(params, Y, cfg)
    with torch.no_grad():
        x_star = dp_gp_lvm.constrain(params)["qx_mean"][:6].detach()
        phi = phi.detach()
        mean_true, _ = prediction.dp_predict_from_latent(
            caches, phi, x_star, torch.zeros_like(x_star))
    s = 4000
    samplers, assign = sampling.make_dp_pathwise_sampler(
        prng.PRNGKey(15), caches, phi, s, 2, num_features=16)
    f = sampling.dp_sample_at(samplers, assign, x_star).numpy()
    scale = float(torch.sqrt(caches.variance.max()))
    assert np.max(np.abs(f.mean(0) - mean_true.numpy())) < 0.15 * scale
    freqs = np.stack([(assign.numpy() == t).mean(0)
                      for t in range(phi.shape[1])], axis=1)
    assert np.max(np.abs(freqs - phi.numpy())) < 0.05


def test_svi_pathwise_moments():
    """Draws from the explicit whitened q(u) against the SVI predictive,
    with no collapsed cache and no training data in the sampler."""
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(31), n=48, d=6, q_true=2,
                               noise=0.01, device="cpu")
    cfg = svi_gplvm.Config(num_latent=2, num_inducing=10)
    params = svi_gplvm.init_params(prng.PRNGKey(32), Y, cfg)
    fit(lambda p, y: svi_gplvm.loss(p, y, cfg), params, (Y,), 250, lr=2e-2)
    with torch.no_grad():
        params = svi_gplvm.set_optimal_qu(params, Y, cfg)
        c = svi_gplvm.constrain(params, cfg)
        x_star = c["qx_mean"][:9]
    s = 500
    smp = sampling.make_svi_pathwise_sampler(prng.PRNGKey(33), params, cfg,
                                             s, num_features=512)
    f = sampling.sample_at(smp, x_star).numpy()
    with torch.no_grad():
        mean_true, var_full = svi_gplvm.predict_from_latent(
            params, x_star, torch.zeros_like(x_star), cfg)
    var_true = np.maximum(var_full.numpy() - float(c["noise"]), 0.0)
    scale = np.sqrt(float(smp.variance))
    assert np.max(np.abs(f.mean(0) - mean_true.numpy())) < 0.1 * scale
    assert np.max(np.abs(np.sqrt(f.var(0)) - np.sqrt(var_true))) < \
        0.1 * scale


def test_mrd_svi_view_sampler_smoke():
    """A view of the multi-view model samples through the same path."""
    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(0), n=40, d1=4, d2=5,
                                   device="cpu")
    cfg = mrd_svi.Config(num_latent=3, num_inducing=8, num_views=2)
    with torch.no_grad():
        params = mrd_svi.set_optimal_qu(
            mrd_svi.init_params(prng.PRNGKey(1), (Y1, Y2), cfg), (Y1, Y2),
            cfg)
    smp = sampling.make_svi_pathwise_sampler(
        prng.PRNGKey(2), mrd_svi._view_params(params, 1),
        svi_gplvm.Config(num_latent=3, num_inducing=8), 32,
        num_features=1024)
    f = sampling.sample_at(smp, params["qx_mean"][:5].detach())
    assert f.shape == (32, 5, 5) and bool(torch.isfinite(f).all())
