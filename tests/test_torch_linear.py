"""The port's linear kernel (`kernels/linear.py`) and its dispatch against
the JAX package, f64 on the CPU: every function of the kernel with row
weights, the Bayesian GP-LVM's and the DP-GP-LVM's ELBO and gradient with
`kernel="linear"`, the test-point psi statistics of a single and of a
per-atom cache, and the small helpers of this slice
(`gaussian.log_prob_diag` and `sample`, `transforms.probability_simplex`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.core import transforms as jtransforms
from dp_gp_lvm_tpu.distributions import gaussian as jgaussian
from dp_gp_lvm_tpu.kernels import linear as jlinear
from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.models import prediction as jpred
from dp_gp_lvm_tpu_torch.core import prng, transforms
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.distributions import gaussian
from dp_gp_lvm_tpu_torch.kernels import linear
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, prediction
from dp_gp_lvm_tpu_torch.ops import dispatch

# M < Q: with M >= Q inducing points span the linear kernel's whole
# feature space, K_uu is singular (rank Q) and the bound no longer depends
# on Z, so its gradient is jitter-driven rounding
N, D, Q, M, T, NSTAR = 25, 4, 4, 3, 3, 6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays():
    r = np.random.default_rng(8)
    return dict(
        v=1.3, ard=r.uniform(0.2, 2.0, Q), mu=r.normal(size=(N, Q)),
        s=r.uniform(0.05, 0.6, (N, Q)), Z=r.normal(size=(M, Q)),
        X2=r.normal(size=(7, Q)), w=r.uniform(0.0, 1.5, N),
        Y=r.normal(size=(N, D)), m_star=r.normal(size=(NSTAR, Q)),
        s_star=r.uniform(0.05, 0.5, (NSTAR, Q)),
        logits=r.normal(0.0, 40.0, (D, T)))


def _bgplvm_params(r):
    return dict(qx_mean=r.normal(size=(N, Q)),
                raw_qx_var=r.normal(size=(N, Q)) - 1.0,
                z=r.normal(size=(M, Q)), raw_variance=np.array(0.4),
                raw_ard=0.3 * r.normal(size=Q), raw_noise=np.array(-1.5))


def _dp_params(r):
    return dict(qx_mean=r.normal(size=(N, Q)),
                raw_qx_var=r.normal(size=(N, Q)) - 1.0,
                z=r.normal(size=(T, M, Q)),
                raw_variance=0.3 * r.normal(size=T),
                raw_ard=0.3 * r.normal(size=(T, Q)),
                raw_noise=0.2 * r.normal(size=T) - 1.5,
                phi_logits=r.normal(size=(D, T)),
                raw_gamma1=r.normal(size=T - 1),
                raw_gamma2=r.normal(size=T - 1))


@functools.lru_cache(maxsize=1)
def _reference():
    """One jitted program over every reference function held here."""
    a = _arrays()
    r = np.random.default_rng(9)
    bp, dp = _bgplvm_params(r), _dp_params(r)
    bcfg = jbg.Config(num_latent=Q, num_inducing=M, kernel="linear")
    dcfg = jdp.Config(num_latent=Q, num_inducing=M, truncation=T,
                      kernel="linear")

    def program(a, bp, dp, key):
        v, ard, mu, s, Z, w = (a[k] for k in ("v", "ard", "mu", "s", "Z",
                                               "w"))
        cache = jpred.bgplvm_posterior(bp, a["Y"], bcfg)
        caches, _ = jpred.dp_posterior(dp, a["Y"], dcfg)
        test_psi_dp = jax.vmap(lambda c: jpred._test_psi(
            c, a["m_star"], a["s_star"], "linear"))(caches)
        return {
            "gram": jlinear.gram(v, ard, mu, a["X2"]),
            "gram_sym": jlinear.gram(v, ard, Z),
            "gram_diag": jlinear.gram_diag(v, ard, mu),
            "psi0": [jlinear.psi0(v, ard, mu, s, w),
                     jlinear.psi0(v, ard, mu, s)],
            "psi1": [jlinear.psi1(v, ard, mu, s, Z, w),
                     jlinear.psi1(v, ard, mu, s, Z)],
            "psi2": [jlinear.psi2(v, ard, mu, s, Z, w),
                     jlinear.psi2(v, ard, mu, s, Z, block_n=4)],
            "psi_stats": jlinear.psi_stats(v, ard, mu, s, Z, w),
            "observed_psi": jlinear.observed_psi(v, ard, mu, Z),
            "bg_terms": jbg.elbo_terms(bp, a["Y"], bcfg),
            "bg_grad": jax.grad(lambda p: jbg.loss(p, a["Y"], bcfg))(bp),
            "dp_elbo": jdp.elbo(dp, a["Y"], dcfg),
            "dp_grad": jax.grad(lambda p: jdp.loss(p, a["Y"], dcfg))(dp),
            "test_psi": jpred._test_psi(cache, a["m_star"], a["s_star"],
                                        "linear"),
            "predict": jpred.predict_from_latent(cache, a["m_star"],
                                                 a["s_star"], "linear"),
            "test_psi_dp": test_psi_dp,
            "log_prob": jgaussian.log_prob_diag(a["m_star"], mu[:NSTAR],
                                                s[:NSTAR]),
            "sample64": jgaussian.sample(key, mu, s, 3),
            "sample32": jgaussian.sample(key, mu.astype(jnp.float32),
                                         s.astype(jnp.float32), 3),
            "simplex": jtransforms.probability_simplex(a["logits"]),
            "simplex0": jtransforms.probability_simplex(a["logits"], 0),
        }

    out = jax.jit(program)(a, bp, dp, jax.random.PRNGKey(12))
    return a, bp, dp, jax.tree.map(np.asarray, out)


def _t(a):
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in a.items()}


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def test_every_linear_function_matches_reference_with_weights():
    a, _, _, want = _reference()
    t = _t(a)
    v, ard, mu, s, Z, w = (t[k] for k in ("v", "ard", "mu", "s", "Z", "w"))
    _close(linear.gram(v, ard, mu, t["X2"]), want["gram"], 1e-12)
    _close(linear.gram(v, ard, Z), want["gram_sym"], 1e-12)
    _close(linear.gram_diag(v, ard, mu), want["gram_diag"], 1e-12)
    _close(linear.psi0(v, ard, mu, s, w), want["psi0"][0], 1e-12)
    _close(linear.psi0(v, ard, mu, s), want["psi0"][1], 1e-12)
    _close(linear.psi1(v, ard, mu, s, Z, w), want["psi1"][0], 1e-12)
    _close(linear.psi1(v, ard, mu, s, Z), want["psi1"][1], 1e-12)
    _close(linear.psi2(v, ard, mu, s, Z, w), want["psi2"][0], 1e-12)
    _close(linear.psi2(v, ard, mu, s, Z, block_n=4), want["psi2"][1], 1e-12)
    for g, x in zip(linear.psi_stats(v, ard, mu, s, Z, w), want["psi_stats"]):
        _close(g, x, 1e-12)
    for g, x in zip(linear.observed_psi(v, ard, mu, Z),
                    want["observed_psi"]):
        _close(g, x, 1e-12)


def test_linear_gram_and_psi1_batch_over_atoms():
    """The DP path calls them once over every atom's (variance, ard, Z)."""
    a, _, _, _ = _reference()
    t = _t(a)
    r = np.random.default_rng(10)
    vs = torch.tensor(r.uniform(0.5, 1.5, T))
    ards = torch.tensor(r.uniform(0.2, 2.0, (T, Q)))
    Zs = torch.tensor(r.normal(size=(T, M, Q)))
    batched = (linear.gram(vs, ards, Zs),
               linear.psi1(vs, ards, t["mu"], t["s"], Zs, t["w"]))
    for k in range(T):
        _close(batched[0][k], np.asarray(jlinear.gram(
            float(vs[k]), ards[k].numpy(), Zs[k].numpy())), 1e-12)
        _close(batched[1][k], np.asarray(jlinear.psi1(
            float(vs[k]), ards[k].numpy(), a["mu"], a["s"], Zs[k].numpy(),
            a["w"])), 1e-12)


def test_dispatch_takes_the_linear_kernel_and_no_cuda_kernel():
    a, _, _, want = _reference()
    t = _t(a)
    args = (t["v"], t["ard"], t["mu"], t["s"], t["Z"])
    assert dispatch.KERNELS["linear"] is linear
    for use_fused in (False, True, "auto"):
        assert not dispatch.resolve_fused(use_fused, "linear",
                                          torch.device("cuda"), M, Q, D)
        for g, x in zip(dispatch.psi_stats(*args, t["w"], use_fused=use_fused,
                                           kernel="linear"),
                        want["psi_stats"]):
            _close(g, x, 1e-12)
    _close(dispatch.psi0(*args[:4], t["w"], kernel="linear"),
           want["psi0"][0], 1e-12)
    _close(dispatch.gram_diag(t["v"], t["ard"], t["mu"], kernel="linear"),
           want["gram_diag"], 1e-12)
    _close(dispatch.expected_gram_diag(t["v"], t["ard"], t["mu"], t["s"],
                                       kernel="linear"),
           float(a["v"]) * np.sum(a["ard"] * (a["mu"] ** 2 + a["s"]), -1),
           1e-12)
    stats = dispatch.suff_stats(*args, t["Y"], t["w"], kernel="linear")
    want_p0, want_p1, want_p2 = want["psi_stats"]
    _close(stats.psi0, want_p0, 1e-12)
    _close(stats.psi1T_y, want_p1.T @ a["Y"], 1e-12)
    _close(stats.psi2, want_p2, 1e-12)
    p0, p1y, p2, _, _ = dispatch.dp_batched_suffstats(
        t["v"][None], t["ard"][None], t["mu"], t["s"], t["Z"][None], t["Y"],
        t["w"], kernel="linear")
    _close(p0[0], want_p0, 1e-12)
    _close(p1y[0], want_p1.T @ a["Y"], 1e-12)
    _close(p2[0], want_p2, 1e-12)
    _close(dispatch.psi2_batched(t["v"][None], t["ard"][None], t["mu"],
                                 t["s"], t["Z"][None], t["w"],
                                 kernel="linear")[0], want_p2, 1e-12)
    with pytest.raises(ValueError, match="unknown kernel"):
        dispatch.psi_stats(*args, kernel="matern")


@pytest.mark.parametrize("family", ["bgplvm", "dp"])
def test_model_elbo_and_gradient_with_the_linear_kernel(family):
    a, bp, dp, want = _reference()
    Y = torch.tensor(a["Y"])
    if family == "bgplvm":
        model, p, key = bgplvm, bp, "bg"
        cfg = bgplvm.Config(num_latent=Q, num_inducing=M, kernel="linear")
        _close(bgplvm.elbo_terms(params_from_jax(p, "cpu"), Y, cfg)["elbo"],
               want["bg_terms"]["elbo"], 1e-9)
    else:
        model, p, key = dp_gp_lvm, dp, "dp"
        cfg = dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T,
                               kernel="linear")
        _close(dp_gp_lvm.elbo(params_from_jax(p, "cpu"), Y, cfg),
               want["dp_elbo"], 1e-9)
    tp = params_from_jax(p, "cpu")
    grads = torch.autograd.grad(model.loss(tp, Y, cfg), list(tp.values()))
    for k, g in zip(tp, grads):
        _close(g, want[f"{key}_grad"][k], 1e-9, k)


def test_test_point_psi_of_the_linear_kernel():
    """Single cache and per-atom caches, and the predictive built on
    them."""
    a, bp, dp, want = _reference()
    Y = torch.tensor(a["Y"])
    m, s = torch.tensor(a["m_star"]), torch.tensor(a["s_star"])
    cache = prediction.bgplvm_posterior(
        params_from_jax(bp, "cpu"), Y,
        bgplvm.Config(num_latent=Q, num_inducing=M, kernel="linear"))
    for g, x in zip(prediction._test_psi(cache, m, s, "linear"),
                    want["test_psi"]):
        assert g.shape == x.shape
        _close(g, x, 1e-9)
    for g, x in zip(prediction.predict_from_latent(cache, m, s, "linear"),
                    want["predict"]):
        _close(g, x, 1e-9)
    caches, _ = prediction.dp_posterior(
        params_from_jax(dp, "cpu"), Y,
        dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T,
                         kernel="linear"))
    for g, x in zip(prediction._test_psi(caches, m, s, "linear"),
                    want["test_psi_dp"]):
        assert g.shape == x.shape
        _close(g, x, 1e-9)


def test_log_prob_diag_and_probability_simplex_match_reference():
    a, _, _, want = _reference()
    t = _t(a)
    _close(gaussian.log_prob_diag(t["m_star"], t["mu"][:NSTAR],
                                  t["s"][:NSTAR]), want["log_prob"], 1e-12)
    # logits 40 apart: the max shift keeps exp finite
    _close(transforms.probability_simplex(t["logits"]), want["simplex"],
           1e-12)
    _close(transforms.probability_simplex(t["logits"], 0), want["simplex0"],
           1e-12)
    np.testing.assert_allclose(
        transforms.probability_simplex(t["logits"]).sum(-1).numpy(), 1.0,
        rtol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_sample_draws_the_references_normals(dtype):
    """The same key gives jax.random's normals to within 4 ulps; the draw
    is mu + sqrt(s) eps."""
    a, _, _, want = _reference()
    mu = torch.tensor(a["mu"], dtype=dtype)
    s = torch.tensor(a["s"], dtype=dtype)
    got = gaussian.sample(prng.PRNGKey(12), mu, s, 3)
    ref = want["sample64" if dtype == torch.float64 else "sample32"]
    assert got.shape == ref.shape == (3, N, Q) and got.dtype == dtype
    eps_got = ((got - mu) / torch.sqrt(s)).numpy()
    eps_ref = (ref - a["mu"].astype(ref.dtype)) / np.sqrt(
        a["s"].astype(ref.dtype))
    ulp = np.spacing(np.abs(eps_ref).astype(ref.dtype))
    # the draws themselves within 4 ulps, plus the rounding of undoing
    # mu + sqrt(s) eps on both sides
    slack = 4 * np.spacing(np.abs(a["mu"]).astype(ref.dtype)) / np.sqrt(
        a["s"].astype(ref.dtype))
    assert (np.abs(eps_got - eps_ref) <= 4 * ulp + 2 * slack).all()
