"""The port's minibatch DP-GP-LVM (`models/dp_svi.py`, `linalg.chol.
safe_cholesky_members`, `synthetic.grouped_dims` and `grouped_dims_big`)
against the JAX package's, in float64 on the CPU: the generators' draws,
`init_params`, the bound's terms at rtol 1e-9, the per-member Cholesky
against `jax.vmap(safe_cholesky)`, `_lam_cholesky`'s rungs and factors on
indefinite precisions, five steps in each `phi_update` mode on the same
`fold_in` minibatches at rtol 1e-8, and `expected_residuals`,
`split_single_atom`, `qu_moments`, `predict_from_latent` and `impute`,
and with the linear kernel `predict_from_latent` and
`make_dp_svi_imputer` at rtol 1e-10. The JAX values come from one
module-scoped oracle at N=40, B=16, M=8, Q=2, T=3, D=8. The reference's own `tests/test_dp_svi.py` cases run
on the port in `tests/test_torch_dp_svi_cases.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.linalg import safe_cholesky as jsafe_cholesky
from dp_gp_lvm_tpu.models import dp_svi as jdp
from dp_gp_lvm_tpu.models import serving as jserving
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.linalg import safe_cholesky_members
from dp_gp_lvm_tpu_torch.models import dp_svi, serving
from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

N, B, M, Q, T = 40, 16, 8, 2, 3
DIMS = (4, 4)
STEPS = 5
IMPUTE_STEPS = 15
# (phi_update, blend_at) of the step runs held against the reference
MODES = (("gradient", "grad"), ("cavi", "grad"), ("frozen", "grad"))
BIG = dict(n=96, dims_per_group=(3, 3, 2, 4), q=3)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chol_stack():
    """Four 6 x 6 symmetric matrices: positive definite, and with smallest
    eigenvalues -3e-6, -3e-4 and -3e2 times the mean diagonal (the last
    beyond every rung)."""
    gen = np.random.default_rng(4)
    out = []
    for lo in (0.5, -3e-6, -3e-4, -3e2):
        rot, _ = np.linalg.qr(gen.standard_normal((6, 6)))
        w = np.linspace(1.0, 2.0, 6)
        w[0] = lo * w.mean()
        out.append((rot * w) @ rot.T)
    return np.stack(out)


def _lam_stack():
    """Three 16 x 16 precisions: healthy, and with the Lambda >= I floor
    breached to -4 and to -200 (the reference's test shapes)."""
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, 16)))
    base = a @ a.T * 1e4
    w, v = np.linalg.eigh(base)
    out = [np.eye(16) + a @ a.T]
    for deficit in (-4.0, -200.0):
        w2 = w.copy()
        w2[0] = deficit
        out.append((v * w2) @ v.T)
    return np.stack(out)


def _perturbed(p):
    """Off the init manifold, so that no check is vacuous."""
    return jax.tree.map(lambda v: v + 0.01 * jnp.sin(jnp.arange(
        v.size, dtype=v.dtype)).reshape(v.shape), p)


def _lam_grad_fn(mat):
    L = jax.vmap(jdp._lam_cholesky)(mat)
    return jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1))) + jnp.sum(L)


def _scan_steps(step, state, Y):
    """STEPS steps, step t on the key fold_in(PRNGKey(100), t)."""
    keys = jax.vmap(lambda t: jax.random.fold_in(jax.random.PRNGKey(100),
                                                 t))(jnp.arange(STEPS))
    return jax.lax.scan(lambda st, r: step(st, r, Y), state, keys)


def _oracle(chol_stack, lam_stack):
    """Every JAX value this file compares with, in one jitted program."""
    Y, _, _ = jsyn.grouped_dims(jax.random.PRNGKey(3), n=N,
                                dims_per_group=DIMS, q=Q, noise=0.01)
    big = jsyn.grouped_dims_big(jax.random.PRNGKey(5), **BIG)
    cfg = jdp.Config(num_latent=Q, num_inducing=M, truncation=T, batch=B)
    p_init = jdp.init_params(jax.random.PRNGKey(1), Y, cfg)
    p0 = _perturbed(p_init)
    out = {"Y": Y, "big": big, "init": p_init, "params": p0,
           "terms": {k: v for k, v in jdp.elbo_terms(p0, Y, cfg).items()
                     if not k.startswith("_")},
           "chol": jax.vmap(jsafe_cholesky)(chol_stack),
           "lam": jax.vmap(jdp._lam_cholesky)(lam_stack),
           "lam_grad": jax.grad(_lam_grad_fn)(lam_stack),
           "residuals": jdp.expected_residuals(p0, Y, cfg)}
    for phi_update, blend_at in MODES:
        opt = jloop.gp_optimizer(p0, lr=3e-3, ngd_lr=1.0,
                                 decay_steps=STEPS)
        step = jdp.make_dp_svi_step(cfg, N, opt, rho=0.3, rho_phi=0.2,
                                    phi_update=phi_update,
                                    blend_at=blend_at)
        state, m = _scan_steps(step, jloop.init_state(p0, opt), Y)
        out[f"steps_{phi_update}_{blend_at}"] = (state.params, m["loss"])
    trained = out["steps_gradient_grad"][0]
    # the split of a truncation-1 model, by residual quantiles and by the
    # log-spread around its noise
    cfg1 = cfg._replace(truncation=1)
    p1 = _perturbed(jdp.init_params(jax.random.PRNGKey(2), Y, cfg1))
    resid1 = jdp.expected_residuals(p1, Y, cfg1)
    out.update(p1=p1, split_q=jdp.split_single_atom(p1, cfg, residuals=resid1),
               split_s=jdp.split_single_atom(p1, cfg))
    xm = trained["qx_mean"][:5] + 0.1
    xv = jdp.constrain(trained)["qx_var"][:5]
    out["predict"] = jdp.predict_from_latent(trained, xm, xv, cfg)
    out["qu"] = jdp.qu_moments(trained)
    mask = jnp.zeros((6, Y.shape[1])).at[:, ::2].set(1.0)
    out["mask"] = mask
    out["impute"] = jdp.impute(trained, Y[::7][:6], mask, cfg,
                               num_steps=IMPUTE_STEPS)
    # the linear kernel's predictive at M = Q (a rank-Q K_uu is singular
    # past it), q(u | t) at its full-batch optimum
    cfg_lin = _linear_cfg(jdp.Config)
    p_lin = jdp.set_optimal_qu(_perturbed(jdp.init_params(
        jax.random.PRNGKey(6), Y, cfg_lin)), Y, cfg_lin)
    out["linear"] = dict(
        params=p_lin,
        predict=jdp.predict_from_latent(p_lin, xm[:, :Q], xv[:, :Q],
                                        cfg_lin),
        imputer=jserving.make_dp_svi_imputer(
            p_lin, cfg_lin, num_steps=IMPUTE_STEPS)(Y[::7][:6], mask))
    return out


def _linear_cfg(config_cls):
    return config_cls(num_latent=Q, num_inducing=Q, truncation=T, batch=B,
                      kernel="linear")


@pytest.fixture(scope="module")
def ref():
    return jax.tree.map(np.asarray, jax.jit(_oracle)(
        jnp.asarray(_chol_stack()), jnp.asarray(_lam_stack())))


def _cfg(**kw):
    return dp_svi.Config(num_latent=Q, num_inducing=M, truncation=T,
                         batch=B, **kw)


def _p(tree):
    return params_from_jax(tree, "cpu")


def _close(got, want, rtol, atol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def test_generators_draw_the_references_data(ref):
    """grouped_dims through the GP draw's Cholesky (two LAPACKs: 1e-9);
    grouped_dims_big's latents bit for bit but normal's few ulps, its rows
    through a product and a standardization."""
    Y, labels, X = synthetic.grouped_dims(prng.PRNGKey(3), n=N,
                                          dims_per_group=DIMS, q=Q,
                                          noise=0.01, device="cpu")
    _close(Y, ref["Y"], 1e-9, 1e-9)
    Yb, lb, Xb = synthetic.grouped_dims_big(prng.PRNGKey(5), device="cpu",
                                            **BIG)
    _close(Xb, ref["big"][2], 4e-15, 4e-15)
    _close(Yb, ref["big"][0], 1e-12, 1e-12)
    assert lb.tolist() == ref["big"][1].tolist()
    assert labels.tolist() == [0] * 4 + [1] * 4


def test_init_params_match_reference(ref):
    """The same draws; PCA's column signs are the host LAPACK's, an exact
    symmetry of the model, so the latents are compared up to them."""
    p = dp_svi.init_params(prng.PRNGKey(1), torch.tensor(ref["Y"]), _cfg())
    want = ref["init"]
    assert set(p) == set(want)
    sign = np.sign(np.sum(p["qx_mean"].detach().numpy() * want["qx_mean"],
                          axis=0))
    for k, v in want.items():
        got = p[k].detach().numpy()
        if k in ("qx_mean", "z"):
            got = got * sign
        np.testing.assert_allclose(got, v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_elbo_terms_match_reference(ref):
    with torch.no_grad():
        terms = dp_svi.elbo_terms(_p(ref["params"]), torch.tensor(ref["Y"]),
                                  _cfg())
    for k, want in ref["terms"].items():
        _close(terms[k], want, 1e-9, 1e-9 * np.abs(want).max(), k)


def test_per_member_cholesky_is_the_vmapped_search(ref):
    """Each member gets the jitter its own search finds (1e-6, 1e-5, 1e-3
    and the last rung here), and the same factor where it factors."""
    L, jitter = safe_cholesky_members(torch.tensor(_chol_stack()))
    L_ref, jit_ref = ref["chol"]
    _close(jitter, jit_ref, 1e-12)
    assert jitter.tolist() == pytest.approx([1e-6, 1e-5, 1e-3, 1.0])
    _close(L[:3], L_ref[:3], 1e-10, 1e-12)
    assert not torch.isfinite(L[3].diagonal()).all()
    assert not np.isfinite(np.diagonal(L_ref[3])).all()


def test_lam_cholesky_rungs_factors_and_gradient(ref):
    """Rung 0 on the healthy precision (the plain factor, bit for bit), a
    fixed rung at -4, the Gershgorin ridge at -200; the factors and the
    gradient of a function of them equal the reference's, and stay
    finite though probes fail."""
    lam = torch.tensor(_lam_stack(), requires_grad=True)
    L = dp_svi._lam_cholesky(lam)
    _close(L, ref["lam"], 1e-10, 1e-10)
    assert torch.equal(L[0].detach(), torch.linalg.cholesky(lam[0].detach()))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(lam[2].detach())
    f = (torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
         + torch.sum(L))
    (g,) = torch.autograd.grad(f, lam)
    assert torch.isfinite(g).all()
    _close(g, ref["lam_grad"], 1e-8, 1e-10)


@pytest.mark.parametrize("phi_update,blend_at", MODES)
def test_five_steps_match_reference(ref, phi_update, blend_at):
    p = _p(ref["params"])
    Y = torch.tensor(ref["Y"])
    opt = gp_optimizer(p, lr=3e-3, ngd_lr=1.0, decay_steps=STEPS)
    step = dp_svi.make_dp_svi_step(_cfg(), N, opt, rho=0.3, rho_phi=0.2,
                                   phi_update=phi_update, blend_at=blend_at)
    idx = step.indices(prng.fold_in(prng.PRNGKey(100),
                                    torch.arange(STEPS)))
    losses = [float(step(t, idx[t], Y)) for t in range(STEPS)]
    want_params, want_losses = ref[f"steps_{phi_update}_{blend_at}"]
    _close(np.array(losses), want_losses, 1e-8)
    for k, v in want_params.items():
        _close(p[k], v, 1e-8, 1e-10, k)


def test_expected_residuals_and_split_match_reference(ref):
    Y = torch.tensor(ref["Y"])
    cfg1 = _cfg()._replace(truncation=1)
    with torch.no_grad():
        _close(dp_svi.expected_residuals(_p(ref["params"]), Y, _cfg()),
               ref["residuals"], 1e-9)
        p1 = _p(ref["p1"])
        resid = dp_svi.expected_residuals(p1, Y, cfg1)
    for name, got in (("split_q", dp_svi.split_single_atom(
            p1, _cfg(), residuals=resid)),
            ("split_s", dp_svi.split_single_atom(p1, _cfg()))):
        assert set(got) == set(ref[name])
        for k, v in ref[name].items():
            _close(got[k], v, 1e-10, 1e-12, f"{name} {k}")


def test_predict_and_impute_match_reference(ref):
    trained = _p(ref["steps_gradient_grad"][0])
    with torch.no_grad():
        for g, w in zip(dp_svi.qu_moments(trained), ref["qu"]):
            _close(g, w, 1e-9, 1e-12)
        xm = trained["qx_mean"][:5] + 0.1
        xv = dp_svi.constrain(trained)["qx_var"][:5]
    for g, w in zip(dp_svi.predict_from_latent(trained, xm, xv, _cfg()),
                    ref["predict"]):
        _close(g, w, 1e-9, 1e-12)
    Y = torch.tensor(ref["Y"])
    got = dp_svi.impute(trained, Y[::7][:6], torch.tensor(ref["mask"]),
                        _cfg(), num_steps=IMPUTE_STEPS)
    for g, w in zip(got, ref["impute"]):
        _close(g, w, 1e-7, 1e-10)


def test_linear_kernel_predict_and_imputer_match_reference(ref):
    """The DP-SVI predictive with the linear kernel (K_uu and the test
    points' Psi statistics through the linear branches): the mixture
    predictive and the serving imputer against the reference's, f64."""
    lin = ref["linear"]
    p = _p(lin["params"])
    cfg = _linear_cfg(dp_svi.Config)
    with torch.no_grad():
        trained = _p(ref["steps_gradient_grad"][0])
        xm = (trained["qx_mean"][:5] + 0.1)[:, :Q]
        xv = dp_svi.constrain(trained)["qx_var"][:5, :Q]
    for g, w in zip(dp_svi.predict_from_latent(p, xm, xv, cfg),
                    lin["predict"]):
        _close(g, w, 1e-10, 1e-12)
    Y = torch.tensor(ref["Y"])
    impute = serving.make_dp_svi_imputer(p, cfg, num_steps=IMPUTE_STEPS,
                                         device="cpu")
    for g, w in zip(impute(Y[::7][:6], torch.tensor(ref["mask"])),
                    lin["imputer"]):
        _close(g, w, 1e-10, 1e-12)
