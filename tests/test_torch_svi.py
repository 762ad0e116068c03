"""The port's minibatch SVI-GPLVM (`models/svi_gplvm.py`, `eval_f64.py`,
`dispatch.suff_stats`) against the JAX package's, in float64 on the CPU:
the bound, its minibatch estimate and the optimal q(u) at rtol 1e-9, the
natural-gradient blend, five natural-gradient steps on the same `fold_in`
minibatches at 1e-8, the imputation at 1e-7 and the float64 host ELBO at
1e-10. The JAX oracles run once, in one jitted program, at N=64, B=16,
M=8, Q=3, D=5. The reference's own `tests/test_svi.py` cases run on the
port in `tests/test_torch_svi_cases.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import eval_f64 as jeval
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.core.transforms import positive
from dp_gp_lvm_tpu_torch.models import eval_f64, svi_gplvm
from dp_gp_lvm_tpu_torch.ops import dispatch
from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

N, B, M, Q, D = 64, 16, 8, 3, 5
STEPS = 5
IMPUTE_STEPS = 20


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _blend_inputs():
    """A q(u) state and whitened batch statistics whose precision target
    I + beta A2 has condition number 1e4 (float64, numpy)."""
    m, d, kappa = 12, 4, 1e4
    gen = np.random.default_rng(0)
    lam_eigs = np.logspace(0, np.log10(kappa), m)
    rot, _ = np.linalg.qr(gen.standard_normal((m, m)))
    A2 = (rot * ((lam_eigs - 1.0) / 10.0)) @ rot.T
    s_cur = (rot / (1.0 + 0.7 * (lam_eigs - 1.0))) @ rot.T
    ls = np.linalg.cholesky(0.5 * (s_cur + s_cur.T))
    return (gen.standard_normal((m, d)), ls, 50.0 * gen.standard_normal(
        (m, d)), 0.5 * (A2 + A2.T))


def _oracle(blend_inputs):
    """Every JAX value this file compares with, in one jitted program."""
    Y, _ = jsyn.toy_gplvm(jax.random.PRNGKey(5), n=N, d=D, q_true=2,
                          q_total=Q, dtype=jnp.float64)
    cfg = jsvi.Config(num_latent=Q, num_inducing=M, batch=B)
    p0 = jsvi.init_params(jax.random.PRNGKey(6), Y, cfg)
    # off the init manifold, so that no check is vacuous
    p0 = jax.tree.map(lambda v: v + 0.01 * jnp.sin(jnp.arange(
        v.size, dtype=v.dtype)).reshape(v.shape), p0)
    idx = jnp.arange(3, 3 + 3 * B, 3)
    out = {"Y": Y, "params": p0, "idx": idx, "elbo": jsvi.elbo(p0, Y, cfg),
           "elbo_mb": jsvi.elbo_minibatch(p0, Y[idx], idx, N, cfg),
           "qu": jsvi.optimal_qu(p0, Y, cfg),
           "blend": jsvi.natgrad_blend_qu(*blend_inputs, jnp.float64(10.0),
                                          jnp.float64(0.2))}
    # five natural-gradient steps of the runner's loop: step t draws
    # randint(fold_in(r1, t), (B,), 0, N)
    opt = jloop.gp_optimizer(p0, lr=3e-3, ngd_lr=1.0, decay_steps=STEPS)
    step = jsvi.make_svi_natgrad_step(cfg, N, opt, rho=0.2)
    state = jloop.init_state(p0, opt)
    _, r1 = jax.random.split(jax.random.PRNGKey(100))
    losses = []
    for t in range(STEPS):
        state, metrics = step(state, jax.random.fold_in(r1, t), Y)
        losses.append(metrics["loss"])
    out["trained"], out["losses"] = state.params, jnp.stack(losses)
    out["mask"] = jnp.ones((8, D)).at[:, D // 2:].set(0.0)
    out["impute"] = jsvi.impute(state.params, Y[::8], out["mask"], cfg,
                                num_steps=IMPUTE_STEPS)[:4]
    return out


@pytest.fixture(scope="module")
def ref():
    out = jax.tree.map(np.asarray, jax.jit(_oracle)(
        tuple(jnp.asarray(x) for x in _blend_inputs())))
    cfg = jsvi.Config(num_latent=Q, num_inducing=M, batch=B)
    out["elbo_f64"] = jeval.elbo_f64(out["params"], out["Y"], cfg, chunk=17)
    return out


def _port(ref):
    cfg = svi_gplvm.Config(num_latent=Q, num_inducing=M, batch=B)
    return (torch.tensor(ref["Y"]), cfg,
            params_from_jax(ref["params"], "cpu"))


def test_bound_minibatch_and_optimal_qu_match_reference(ref):
    Y, cfg, p = _port(ref)
    idx = torch.tensor(ref["idx"])
    with torch.no_grad():
        got = float(svi_gplvm.elbo(p, Y, cfg))
        got_mb = float(svi_gplvm.elbo_minibatch(p, Y[idx], idx, N, cfg))
        qu = svi_gplvm.optimal_qu(p, Y, cfg)
    np.testing.assert_allclose(got, ref["elbo"], rtol=1e-9)
    np.testing.assert_allclose(got_mb, ref["elbo_mb"], rtol=1e-9)
    for g, w in zip(qu, ref["qu"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-12)


def test_suff_stats_plain_path_equals_psi_statistics(ref):
    """On the CPU `dispatch.suff_stats` is the plain psi statistics; on the
    card it is K1 (tests/test_torch_cuda.py holds the two together)."""
    Y, cfg, p = _port(ref)
    with torch.no_grad():
        c = svi_gplvm.constrain(p, cfg)
        st = dispatch.suff_stats(c["variance"], c["ard"], c["qx_mean"],
                                 c["qx_var"], c["z"], Y)
        p0, p1, p2 = dispatch.psi_stats(c["variance"], c["ard"],
                                        c["qx_mean"], c["qx_var"], c["z"])
    np.testing.assert_allclose(st.psi1T_y.numpy(), (p1.T @ Y).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(st.psi2.numpy(), p2.numpy(), rtol=1e-12)
    assert float(st.psi0) == float(p0) and float(st.n) == N


def test_five_natgrad_steps_on_the_same_minibatches_match_reference(ref):
    Y, cfg, p = _port(ref)
    opt = gp_optimizer(p, lr=3e-3, ngd_lr=1.0, decay_steps=STEPS)
    step = svi_gplvm.make_svi_natgrad_step(cfg, N, opt, rho=0.2)
    _, r1 = prng.split(prng.PRNGKey(100))
    idx = prng.randint(prng.fold_in(r1, torch.arange(STEPS)), (B,), 0, N)
    losses = [float(step(t, idx[t].long(), Y)) for t in range(STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-8)
    for k, v in ref["trained"].items():
        np.testing.assert_allclose(p[k].detach().numpy(), v, rtol=1e-8,
                                   atol=1e-10, err_msg=k)


def test_impute_matches_reference(ref):
    Y, cfg, _ = _port(ref)
    trained = params_from_jax(ref["trained"], "cpu")
    mask = torch.tensor(ref["mask"])
    got = svi_gplvm.impute(trained, Y[::8], mask, cfg,
                           num_steps=IMPUTE_STEPS)
    for g, w in zip(got[:4], ref["impute"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=1e-12)


def test_elbo_f64_matches_reference_and_the_model(ref):
    Y, cfg, p = _port(ref)
    got = eval_f64.elbo_f64(p, Y, cfg, chunk=17)
    np.testing.assert_allclose(got, ref["elbo_f64"], rtol=1e-10)
    np.testing.assert_allclose(got, ref["elbo"], rtol=5e-5)


def _naive_natural_blend(u_mean, ls, a, A2, beta, rho):
    """The textbook blend through explicit natural parameters."""
    eye = torch.eye(ls.shape[0], dtype=ls.dtype)
    h, lam = svi_gplvm._natural_from_params({"u_mean": u_mean,
                                              "u_scale": ls})
    return svi_gplvm._params_from_natural(
        (1.0 - rho) * h + rho * beta * a,
        (1.0 - rho) * lam + rho * (eye + beta * A2))


def _s_of(raw):
    ls = torch.tril(raw, -1) + torch.diag(positive(torch.diagonal(raw)))
    return (ls @ ls.T).numpy()


def test_natgrad_blend_matches_naive_naturals_and_reference(ref):
    """At a condition number of 1e4, where the naive path is accurate in
    f64: the blend equals the explicit-naturals blend and the JAX
    package's blend on the same inputs."""
    args = tuple(torch.tensor(x) for x in _blend_inputs()) + (10.0, 0.2)
    m_new, raw_new = svi_gplvm.natgrad_blend_qu(*args)
    m_naive, raw_naive = _naive_natural_blend(*args)
    np.testing.assert_allclose(m_new.numpy(), m_naive.numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(_s_of(raw_new), _s_of(raw_naive), rtol=1e-8,
                               atol=1e-12)
    for g, w in zip((m_new, raw_new), ref["blend"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)
