"""The port's imputation servers (dp_gp_lvm_tpu_torch/models/serving.py)
against the JAX package end to end, f64 on the CPU: each factory builds its
posterior once and answers three distinct requests as the reference's
jitted closure does. The Bayesian GP-LVM server runs under tol="auto" at a
batch above TOL_MAX_BATCH (the fixed unroll), the DP server under an
explicit early-stopping tolerance, so both modes are served with one JAX
compile each."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.models import serving as jserving
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, serving

N, D, Q, M, T = 30, 5, 2, 6, 3
STEPS = 10
TOL_DP = 0.05
RTOL = 1e-6    # ten Adam steps divide by sqrt(nu): rounding grows with them


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(seed, dp):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N, Q))
    Y = np.sin(x @ r.normal(size=(Q, D))) + 0.1 * r.normal(size=(N, D))
    atoms = (T,) if dp else ()
    params = dict(
        qx_mean=x + 0.1 * r.normal(size=(N, Q)),
        raw_qx_var=r.normal(size=(N, Q)) - 2.0,
        z=r.normal(size=atoms + (M, Q)),
        raw_variance=r.normal(size=atoms) * 0.3 + 0.4,
        raw_ard=r.normal(size=atoms + (Q,)) * 0.3,
        raw_noise=r.normal(size=atoms) * 0.2 - 2.0)
    if dp:
        params.update(phi_logits=r.normal(size=(D, T)),
                      raw_gamma1=r.normal(size=T - 1),
                      raw_gamma2=r.normal(size=T - 1))
    return params, Y


def _requests(seed, batch):
    """Three distinct requests of one batch size, second half masked."""
    r = np.random.default_rng(seed)
    mask = np.ones((batch, D))
    mask[:, D // 2:] = 0.0
    return [(r.normal(size=(batch, D)), mask) for _ in range(3)]


def _serve_both(jimpute, impute, requests):
    for y, mask in requests:
        want = jimpute(jnp.asarray(y), jnp.asarray(mask))
        got = impute(torch.tensor(y), torch.tensor(mask))
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape == y.shape
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max())
        assert float(got[1].min()) > 0.0


def test_bgplvm_imputer_matches_jax_on_three_requests():
    params, Y = _case(21, dp=False)
    jimpute = jserving.make_bgplvm_imputer(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(Y),
        jbg.Config(num_latent=Q, num_inducing=M), num_steps=STEPS)
    impute = serving.make_bgplvm_imputer(
        params_from_jax(params, "cpu"), torch.tensor(Y),
        bgplvm.Config(num_latent=Q, num_inducing=M), num_steps=STEPS,
        device="cpu")
    _serve_both(jimpute, impute, _requests(22, serving.TOL_MAX_BATCH + 1))


def test_dp_imputer_matches_jax_on_three_requests():
    params, Y = _case(23, dp=True)
    jimpute = jserving.make_dp_imputer(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(Y),
        jdp.Config(num_latent=Q, num_inducing=M, truncation=T,
                   use_pallas=False), num_steps=STEPS, tol=TOL_DP)
    impute = serving.make_dp_imputer(
        params_from_jax(params, "cpu"), torch.tensor(Y),
        dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T),
        num_steps=STEPS, tol=TOL_DP, device="cpu")
    _serve_both(jimpute, impute, _requests(24, 3))


@pytest.mark.parametrize("tol,num_steps,batch", [
    ("auto", 150, 1), ("auto", 150, 4), ("auto", 150, 5), ("auto", 400, 2),
    (None, 150, 1), (1e-3, 150, 128),
])
def test_resolve_matches_jax(tol, num_steps, batch):
    assert serving._resolve(tol, num_steps, batch) == jserving._resolve(
        tol, num_steps, batch)
    assert (serving.TOL_MAX_BATCH, serving.AUTO_TOL, serving.AUTO_TOL_CAP) \
        == (jserving.TOL_MAX_BATCH, jserving.AUTO_TOL, jserving.AUTO_TOL_CAP)


def test_imputer_builds_its_posterior_once(monkeypatch):
    """The factory does the train-data work once; a request runs none of
    it again."""
    from dp_gp_lvm_tpu_torch.models import prediction

    params, Y = _case(25, dp=True)
    calls = []
    real = prediction.dp_posterior
    monkeypatch.setattr(prediction, "dp_posterior",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    impute = serving.make_dp_imputer(
        params_from_jax(params, "cpu"), torch.tensor(Y),
        dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T),
        num_steps=3, tol=None, device="cpu")
    for y, mask in _requests(26, 2):
        mean, var = impute(torch.tensor(y), torch.tensor(mask))
        assert bool(torch.isfinite(mean).all()) and float(var.min()) > 0.0
    assert calls == [1]
