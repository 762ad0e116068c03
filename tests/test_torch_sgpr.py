"""The port's supervised models (`models/gp_regression.py`,
`models/sparse_gp.py`) and the linear algebra they bring
(`linalg.cho_solve`, `solve_psd`, `add_jitter`, `safe_cholesky` over a
leading batch, `dispatch.observed_psi`, `gram_diag`, `psi0`) against the
JAX package's, on the CPU in float64: values, both predictives and the
loss gradients at rtol 1e-10; the sparse bound at most the exact marginal
and equal to it at Z = X (the reference's `tests/test_bound.py` cases).
The JAX oracle runs once, at N=30, Q=2, M=7, D=3, N*=5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.linalg import chol as jchol
from dp_gp_lvm_tpu.models import gp_regression as jgpr
from dp_gp_lvm_tpu.models import sparse_gp as jsgpr
from dp_gp_lvm_tpu.ops import dispatch as jdispatch
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.linalg import (
    add_jitter,
    cho_solve,
    safe_cholesky,
    solve_psd,
)
from dp_gp_lvm_tpu_torch.models import gp_regression, sparse_gp
from dp_gp_lvm_tpu_torch.ops import dispatch

N, Q, M, D, NS = 30, 2, 7, 3, 5
RTOL = 1e-10
# the reference's bound tests factor at a 1e-12 jitter
POLICY = JitterPolicy(initial=1e-12)


def _data():
    r = np.random.default_rng(0)
    return (r.normal(size=(N, Q)), r.normal(size=(N, D)),
            r.normal(size=(NS, Q)))


def _raw(z):
    """Parameters off their init: variance 1.3, ARD 0.8 and 1.1, noise
    0.2 (raw values, numpy)."""
    inv = lambda v: np.log(np.expm1(v))          # softplus^-1
    out = {"raw_variance": inv(np.float64(1.3)),
           "raw_ard": inv(np.array([0.8, 1.1])),
           "raw_noise": inv(np.float64(0.2))}
    if z is not None:
        out["z"] = z
    return out


def _oracle(X, Y, Xs, pg, ps):
    """Every JAX value this file compares with, in one jitted program."""
    ard = jnp.asarray([0.8, 1.1])
    return dict(lm=jgpr.log_marginal(pg, X, Y),
                gpr_pred=jgpr.predict(pg, X, Y, Xs),
                gpr_grad=jax.grad(jgpr.loss)(pg, X, Y),
                elbo=jsgpr.elbo(ps, X, Y),
                sgpr_pred=jsgpr.predict(ps, X, Y, Xs),
                sgpr_grad=jax.grad(jsgpr.loss)(ps, X, Y),
                obs=jdispatch.observed_psi(1.3, ard, X, X[:M]),
                diag=jdispatch.gram_diag(1.3, ard, Xs))


@pytest.fixture(scope="module")
def ref():
    X, Y, Xs = _data()
    init = jsgpr.init_params(jax.random.PRNGKey(3), jnp.asarray(X), M)
    pg, ps = _raw(None), _raw(np.asarray(init["z"]))
    out = jax.jit(_oracle)(*jax.tree.map(jnp.asarray, (X, Y, Xs, pg, ps)))
    return dict(jax.tree.map(np.asarray, out), X=X, Y=Y, Xs=Xs, pg=pg,
                ps=ps, z0=np.asarray(init["z"]))


def _t(tree):
    return {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=1e-14)


def test_gp_regression_matches_reference(ref):
    X, Y, Xs = (torch.tensor(ref[k]) for k in ("X", "Y", "Xs"))
    p = _t(ref["pg"])
    lm = gp_regression.log_marginal(p, X, Y)
    _close(lm, ref["lm"])
    for got, want in zip(gp_regression.predict(p, X, Y, Xs),
                         ref["gpr_pred"]):
        _close(got, want)
    grads = torch.autograd.grad(gp_regression.loss(p, X, Y), list(p.values()))
    for (k, g) in zip(p, grads):
        _close(g, ref["gpr_grad"][k])


def test_sgpr_matches_reference(ref):
    X, Y, Xs = (torch.tensor(ref[k]) for k in ("X", "Y", "Xs"))
    init = sparse_gp.init_params(prng.PRNGKey(3), X, M)
    np.testing.assert_array_equal(init["z"].detach().numpy(), ref["z0"])
    p = _t(ref["ps"])
    _close(sparse_gp.elbo(p, X, Y), ref["elbo"])
    for got, want in zip(sparse_gp.predict(p, X, Y, Xs), ref["sgpr_pred"]):
        _close(got, want)
    grads = torch.autograd.grad(sparse_gp.loss(p, X, Y), list(p.values()))
    for (k, g) in zip(p, grads):
        _close(g, ref["sgpr_grad"][k])


def test_observed_psi_and_gram_diag_match_reference(ref):
    X, Xs = torch.tensor(ref["X"]), torch.tensor(ref["Xs"])
    v = torch.tensor(1.3, dtype=torch.float64)
    a = torch.tensor([0.8, 1.1], dtype=torch.float64)
    for got, want in zip(dispatch.observed_psi(v, a, X, X[:M]), ref["obs"]):
        _close(got, want)
    _close(dispatch.gram_diag(v, a, Xs), ref["diag"])
    mu, s = X[:4], 0.1 * torch.ones(4, Q, dtype=torch.float64)
    assert float(dispatch.psi0(v, a, mu, s)) == 1.3 * 4
    p0, p1, p2 = ard_rbf.psi_stats(v, a, mu, s, X[:M])
    assert p1.shape == (4, M) and p2.shape == (M, M) and float(p0) == 1.3 * 4


@torch.no_grad()
def test_sparse_bound_is_below_the_exact_marginal_and_equal_at_z_eq_x(ref):
    X, Y, Xs = (torch.tensor(ref[k]) for k in ("X", "Y", "Xs"))
    pg = _t(ref["pg"])
    exact = float(gp_regression.log_marginal(pg, X, Y, POLICY))
    below = _t({**ref["pg"], "z": ref["X"][:M]})
    assert float(sparse_gp.elbo(below, X, Y, POLICY)) <= exact + 1e-8
    at_x = _t({**ref["pg"], "z": ref["X"]})
    np.testing.assert_allclose(float(sparse_gp.elbo(at_x, X, Y, POLICY)),
                               exact, rtol=1e-6)
    (m_s, v_s), (m_e, v_e) = (model.predict(p, X, Y, Xs, POLICY) for model, p
                              in ((sparse_gp, at_x), (gp_regression, pg)))
    np.testing.assert_allclose(m_s.detach().numpy(), m_e.detach().numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v_s.detach().numpy(), v_e.detach().numpy(),
                               rtol=1e-4, atol=1e-6)


def _psd(r, m, shift):
    a = r.normal(size=(m, m))
    w, v = np.linalg.eigh(a @ a.T)
    w[0] = shift                                 # the smallest eigenvalue
    return (v * w) @ v.T


def test_cho_solve_solve_psd_and_add_jitter_match_reference():
    r = np.random.default_rng(1)
    A, B = _psd(r, 6, 0.5), r.normal(size=(6, 2))
    L = np.linalg.cholesky(A)
    _close(cho_solve(torch.tensor(L), torch.tensor(B)),
           np.asarray(jchol.cho_solve(jnp.asarray(L), jnp.asarray(B))))
    _close(solve_psd(torch.tensor(A), torch.tensor(B)),
           np.asarray(jchol.solve_psd(jnp.asarray(A), jnp.asarray(B))))
    At = torch.tensor(A, requires_grad=True)
    got = add_jitter(At, 1e-3)
    _close(got, np.asarray(jchol.add_jitter(jnp.asarray(A), 1e-3)))
    # the scale carries a gradient, as in the reference
    g = torch.autograd.grad(got.sum(), At)[0]
    want = jax.grad(lambda a: jchol.add_jitter(a, 1e-3).sum())(jnp.asarray(A))
    _close(g, np.asarray(want))


@pytest.mark.parametrize("bad", [False, True], ids=["good", "one_repaired"])
def test_batched_safe_cholesky_matches_reference(bad):
    """One jitter for the whole batch, as the reference's search over a
    batch finds; with one member whose smallest eigenvalue is -1e-5 it is
    the jitter that repairs that member."""
    r = np.random.default_rng(2)
    A = np.stack([_psd(r, 5, 0.3), _psd(r, 5, -1e-5 if bad else 0.2),
                  _psd(r, 5, 0.1)])
    L, jitter = safe_cholesky(torch.tensor(A))
    L_ref, jitter_ref = jchol.safe_cholesky(jnp.asarray(A))
    assert jitter.ndim == 0 and float(jitter) == float(jitter_ref)
    assert (float(jitter) > 1e-6) == bad
    _close(L, np.asarray(L_ref))
    assert torch.isfinite(L).all()
