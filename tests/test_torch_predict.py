"""The port's test-time inference and imputation
(dp_gp_lvm_tpu_torch/models/prediction.py) against the JAX package, f64 on
the CPU, for the Bayesian GP-LVM and the DP-GP-LVM: posterior caches on
both of the port's branches, predictive moments at a fixed q(x*), and the
whole imputation pipeline (nearest-point init, Adam latent inference for a
fixed unroll and with early stopping, prediction). Parameters come from
numpy and go to both packages. Each JAX pipeline is jitted once per
module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.models import prediction as jpred
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, prediction

N, D, Q, M, T, NS = 30, 5, 2, 6, 3, 4
STEPS = 12
# early-stopping tolerances under which each model's inference rests for
# five steps in a row, and so stops, at step 9 of the 12
TOL, TOL_DP = 0.02, 0.048
RTOL = 1e-8
# 12 Adam steps divide by sqrt(nu): rounding grows with the steps
RTOL_FIT = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(r):
    x = r.normal(size=(N, Q))
    Y = np.sin(x @ r.normal(size=(Q, D))) + 0.1 * r.normal(size=(N, D))
    y_star = Y[:NS] + 0.05 * r.normal(size=(NS, D))
    mask = np.ones((NS, D))
    mask[:, D // 2:] = 0.0
    return x, Y, y_star, mask


def _bgplvm_case():
    r = np.random.default_rng(11)
    x, Y, y_star, mask = _data(r)
    params = dict(
        qx_mean=x + 0.1 * r.normal(size=(N, Q)),
        raw_qx_var=r.normal(size=(N, Q)) - 2.0, z=r.normal(size=(M, Q)),
        raw_variance=np.float64(0.4), raw_ard=r.normal(size=Q) * 0.3,
        raw_noise=np.float64(-2.0))
    return params, Y, y_star, mask


def _dp_case():
    r = np.random.default_rng(12)
    x, Y, y_star, mask = _data(r)
    params = dict(
        qx_mean=x + 0.1 * r.normal(size=(N, Q)),
        raw_qx_var=r.normal(size=(N, Q)) - 2.0, z=r.normal(size=(T, M, Q)),
        raw_variance=r.normal(size=T) * 0.3 + 0.4,
        raw_ard=r.normal(size=(T, Q)) * 0.3,
        raw_noise=r.normal(size=T) * 0.2 - 2.0,
        phi_logits=r.normal(size=(D, T)),
        raw_gamma1=r.normal(size=T - 1), raw_gamma2=r.normal(size=T - 1))
    return params, Y, y_star, mask


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _t(params):
    return params_from_jax(params, "cpu", torch.float64)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


JCFG_BG = jbg.Config(num_latent=Q, num_inducing=M)
JCFG_DP = jdp.Config(num_latent=Q, num_inducing=M, truncation=T,
                     use_pallas=False)


@pytest.fixture(scope="module")
def jax_bgplvm():
    """JAX posterior and the two jitted imputation pipelines."""
    params, Y, y_star, mask = _bgplvm_case()
    jp, jY = _j(params), jnp.asarray(Y)
    run = {
        tol: jax.jit(lambda ys, mk, tol=tol: jpred.impute_bgplvm(
            jp, jY, JCFG_BG, ys, mk, num_steps=STEPS, tol=tol))(
                jnp.asarray(y_star), jnp.asarray(mask))
        for tol in (None, TOL)
    }
    return jpred.bgplvm_posterior(jp, jY, JCFG_BG), run


@pytest.fixture(scope="module")
def jax_dp():
    params, Y, y_star, mask = _dp_case()
    jp, jY = _j(params), jnp.asarray(Y)
    run = {
        tol: jax.jit(lambda ys, mk, tol=tol: jpred.impute_dp(
            jp, jY, JCFG_DP, ys, mk, num_steps=STEPS, tol=tol))(
                jnp.asarray(y_star), jnp.asarray(mask))
        for tol in (None, TOL_DP)
    }
    return jpred.dp_posterior(jp, jY, JCFG_DP), run


def _assert_cache(got, want):
    for name in prediction.PosteriorCache._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert not g.requires_grad
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w)


@pytest.mark.parametrize("use_fused", [True, False])
def test_bgplvm_posterior_matches_jax(jax_bgplvm, use_fused):
    params, Y, _, _ = _bgplvm_case()
    cfg = bgplvm.Config(num_latent=Q, num_inducing=M, use_fused=use_fused)
    cache = prediction.bgplvm_posterior(_t(params), torch.tensor(Y), cfg)
    _assert_cache(cache, jax_bgplvm[0])


@pytest.mark.parametrize("use_fused", [True, False])
def test_dp_posterior_matches_jax(jax_dp, use_fused):
    params, Y, _, _ = _dp_case()
    cfg = dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T,
                           use_fused=use_fused)
    caches, phi = prediction.dp_posterior(_t(params), torch.tensor(Y), cfg)
    _assert_cache(caches, jax_dp[0][0])
    assert not phi.requires_grad
    _close(phi, jax_dp[0][1])


def _fixed_latent():
    r = np.random.default_rng(13)
    return r.normal(size=(NS, Q)), r.uniform(0.05, 0.5, (NS, Q))


def test_predict_from_latent_matches_jax(jax_bgplvm):
    params, Y, _, _ = _bgplvm_case()
    m, s = _fixed_latent()
    want = jpred.predict_from_latent(jax_bgplvm[0], jnp.asarray(m),
                                     jnp.asarray(s))
    cache = prediction.bgplvm_posterior(
        _t(params), torch.tensor(Y), bgplvm.Config(Q, M, use_fused=False))
    got = prediction.predict_from_latent(cache, torch.tensor(m),
                                         torch.tensor(s))
    for g, w in zip(got, want):
        assert g.shape == (NS, D)
        _close(g, w)
    assert float(got[1].min()) > 0.0


def test_dp_predict_from_latent_matches_jax(jax_dp):
    params, Y, _, _ = _dp_case()
    m, s = _fixed_latent()
    jcaches, jphi = jax_dp[0]
    want = jpred.dp_predict_from_latent(jcaches, jphi, jnp.asarray(m),
                                        jnp.asarray(s))
    caches, phi = prediction.dp_posterior(
        _t(params), torch.tensor(Y),
        dp_gp_lvm.Config(Q, M, T, use_fused=False))
    got = prediction.dp_predict_from_latent(caches, phi, torch.tensor(m),
                                            torch.tensor(s))
    for g, w in zip(got, want):
        assert g.shape == (NS, D)
        _close(g, w)
    # the per-atom stack is one broadcast call: (T, N*, D) each
    means, vars_ = prediction.predict_from_latent(caches, torch.tensor(m),
                                                  torch.tensor(s))
    assert means.shape == vars_.shape == (T, NS, D)


def _assert_pipeline(got, want, tol):
    names = ("mean", "var", "m", "s", "trace")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, RTOL_FIT)
    trace = got[4]
    assert trace.shape == (STEPS,)
    assert float(trace[-1]) > float(trace[0])      # the objective rose
    frozen = int((trace == trace[-1]).sum())
    if tol is None:
        assert frozen == 1
    else:
        # early stopping ended before the cap: the tail repeats, in the
        # port as in the reference, from the same step on
        assert frozen == STEPS - 9 + 1
        assert frozen == int((np.asarray(want[4])
                              == np.asarray(want[4])[-1]).sum())


@pytest.mark.parametrize("tol", [None, TOL], ids=["unroll", "tol"])
def test_impute_bgplvm_matches_jax(jax_bgplvm, tol):
    params, Y, y_star, mask = _bgplvm_case()
    cfg = bgplvm.Config(num_latent=Q, num_inducing=M)
    got = prediction.impute_bgplvm(
        _t(params), torch.tensor(Y), cfg, torch.tensor(y_star),
        torch.tensor(mask), num_steps=STEPS, tol=tol)
    _assert_pipeline(got, jax_bgplvm[1][tol], tol)


@pytest.mark.parametrize("tol", [None, TOL_DP], ids=["unroll", "tol"])
def test_impute_dp_matches_jax(jax_dp, tol):
    params, Y, y_star, mask = _dp_case()
    cfg = dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T)
    got = prediction.impute_dp(
        _t(params), torch.tensor(Y), cfg, torch.tensor(y_star),
        torch.tensor(mask), num_steps=STEPS, tol=tol)
    _assert_pipeline(got, jax_dp[1][tol], tol)


def test_fit_variational_steps_trace_and_anneal():
    """Early stopping returns the reference's shape of result: a trace of
    num_steps entries whose tail repeats, and the count of active steps;
    `anneal` follows optax's cosine schedule (rate 0 after num_steps)."""
    target = torch.tensor([1.0, -2.0], dtype=torch.float64)
    start = {"x": torch.zeros(2, dtype=torch.float64)}

    def objective(vp):
        return torch.sum((vp["x"] - target) ** 2)

    vp, trace, k = prediction._fit_variational(objective, start, 400, 0.05,
                                               tol=1e-4)
    assert trace.shape == (400,) and 5 <= k < 400
    assert bool((trace[k - 1:] == trace[k - 1]).all())
    assert float(trace[k - 2]) != float(trace[k - 1])
    assert float(start["x"].abs().max()) == 0.0        # input untouched
    _, trace_full, k_full = prediction._fit_variational(objective, start,
                                                        50, 0.05)
    assert k_full == 50
    np.testing.assert_array_equal(trace_full.numpy(), trace[:50].numpy())

    import optax

    opt = optax.adam(optax.cosine_decay_schedule(0.05, 20))
    x = jnp.zeros(2)
    state = opt.init(x)
    for _ in range(20):
        g = jax.grad(lambda v: jnp.sum((v - jnp.asarray(target.numpy())) ** 2)
                     )(x)
        upd, state = opt.update(g, state)
        x = optax.apply_updates(x, upd)
    vp, _, _ = prediction._fit_variational(objective, start, 20, 0.05,
                                           anneal=True)
    np.testing.assert_allclose(vp["x"].numpy(), np.asarray(x), rtol=1e-9)


def test_init_latent_and_predictive_loglik_match_jax():
    params, Y, y_star, mask = _bgplvm_case()
    want = jpred.init_latent_from_nearest(
        jnp.asarray(params["qx_mean"]), jnp.asarray(Y), jnp.asarray(y_star),
        jnp.asarray(mask))
    got = prediction.init_latent_from_nearest(
        torch.tensor(params["qx_mean"]), torch.tensor(Y),
        torch.tensor(y_star), torch.tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r = np.random.default_rng(14)
    mean, var = r.normal(size=(NS, D)), r.uniform(-0.1, 1.0, (NS, D))
    want = jpred.gaussian_predictive_loglik(
        jnp.asarray(y_star), jnp.asarray(mean), jnp.asarray(var),
        jnp.asarray(1.0 - mask))
    got = prediction.gaussian_predictive_loglik(
        torch.tensor(y_star), torch.tensor(mean), torch.tensor(var),
        torch.tensor(1.0 - mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    assert np.isfinite(float(got))     # the variance floor held
