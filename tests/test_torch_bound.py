"""Port's ARD-RBF kernels, safe Cholesky and collapsed bound against the
JAX package, f64 on the CPU, at tiny sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.kernels import ard_rbf as jard
from dp_gp_lvm_tpu.linalg import safe_cholesky_spec as j_spec
from dp_gp_lvm_tpu.models import bound as jbound
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.kernels import ard_rbf, ard_rbf_vjp
from dp_gp_lvm_tpu_torch.linalg import safe_cholesky_spec
from dp_gp_lvm_tpu_torch.models import bound

N, M, Q, D, T = 37, 6, 3, 4, 3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(seed=0):
    r = np.random.default_rng(seed)
    return dict(v=np.float64(r.uniform(0.5, 1.5)), a=r.uniform(0.3, 2.0, Q),
                mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
                Z=r.normal(size=(M, Q)), w=r.uniform(0.2, 1.0, N))


@pytest.mark.parametrize("weighted", [False, True])
def test_psi_stats_and_analytic_gradients_match_jax(weighted):
    c = _case(1)
    G1 = np.random.default_rng(2).normal(size=(N, M))
    G2 = np.random.default_rng(3).normal(size=(M, M))
    names = ("v", "a", "mu", "s", "Z", "w")

    def f_jax(v, a, mu, s, Z, w):
        w = w if weighted else None
        p1 = jard.psi1(v, a, mu, s, Z, w)
        p2 = jard.psi2(v, a, mu, s, Z, w, block_n=8)
        return jnp.sum(p1 * G1) + jnp.sum(p2 * G2), (p1, p2)

    jargs = [jnp.asarray(c[k]) for k in names]
    (val_j, (p1_j, p2_j)), g_j = jax.value_and_grad(
        f_jax, argnums=tuple(range(6)), has_aux=True)(*jargs)

    targs = [torch.tensor(c[k], requires_grad=True) for k in names]
    v, a, mu, s, Z, w = targs
    w = w if weighted else None
    p1 = ard_rbf_vjp.psi1_weighted(v, a, mu, s, Z, w)
    p2 = ard_rbf_vjp.psi2_analytic(v, a, mu, s, Z, w, 8)
    val = torch.sum(p1 * torch.as_tensor(G1)) + torch.sum(
        p2 * torch.as_tensor(G2))
    g_t = torch.autograd.grad(val, targs, allow_unused=True)
    np.testing.assert_allclose(p1.detach().numpy(), p1_j, rtol=1e-12)
    np.testing.assert_allclose(p2.detach().numpy(), p2_j, rtol=1e-11)
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-11)
    for k, gt, gj in zip(names, g_t, g_j):
        if k == "w" and not weighted:
            continue
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-9,
                                   atol=1e-12 * float(np.abs(gj).max()))


def test_gram_matches_jax_batched():
    c = _case(4)
    r = np.random.default_rng(5)
    vs, ards, Zs = r.uniform(0.5, 1.5, T), r.uniform(0.3, 2, (T, Q)), \
        r.normal(size=(T, M, Q))
    want = np.stack([np.asarray(jard.gram(vs[t], ards[t], Zs[t]))
                     for t in range(T)])
    got = ard_rbf.gram(torch.as_tensor(vs), torch.as_tensor(ards),
                       torch.as_tensor(Zs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-15)
    cross = ard_rbf.gram(torch.as_tensor(c["v"]), torch.as_tensor(c["a"]),
                         torch.as_tensor(c["mu"]), torch.as_tensor(c["Z"]))
    np.testing.assert_allclose(
        cross.numpy(), jard.gram(c["v"], c["a"], c["mu"], c["Z"]),
        rtol=1e-13, atol=1e-15)


def test_safe_cholesky_spec_good_path_matches_jax():
    A0 = np.random.default_rng(6).normal(size=(5, 16, 16))
    A = A0 @ A0.transpose(0, 2, 1) / 16.0 + 2.0 * np.eye(16)
    L_j, jit_j = j_spec(jnp.asarray(A))
    L_t, jit_t = safe_cholesky_spec(torch.as_tensor(A))
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(jit_t.numpy(), np.asarray(jit_j))
    assert jit_t.shape == (5,)


def test_safe_cholesky_spec_repairs_bad_batch_like_jax():
    """One non-PSD member: ONE shared jitter repairs the whole batch."""
    bad = np.eye(8)
    bad[0, 0] = -0.5
    A = np.stack([2.0 * np.eye(8), bad])
    L_j, jit_j = j_spec(jnp.asarray(A))
    L_t, jit_t = safe_cholesky_spec(torch.as_tensor(A))
    assert bool(torch.isfinite(L_t).all())
    np.testing.assert_array_equal(jit_t.numpy(), np.asarray(jit_j))
    assert float(jit_t[0]) > JitterPolicy().initial_for(torch.float64)
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=1e-12, atol=1e-14)


def test_failed_factor_is_nan_like_jax():
    """cholesky_ex's partial factor need not hold a NaN; the port fills a
    failed member with NaN, as JAX's Cholesky does."""
    bad = np.eye(4)
    bad[2, 2] = -1.0
    A = np.stack([np.eye(4), bad])
    L_j, _ = j_spec(jnp.asarray(A), jbound.JitterPolicy(max_tries=0))
    L_t, _ = safe_cholesky_spec(torch.as_tensor(A), JitterPolicy(max_tries=0))
    np.testing.assert_array_equal(np.isnan(L_t.numpy()),
                                  np.isnan(np.asarray(L_j)))
    assert bool(torch.isnan(L_t[1]).any()) and bool(
        torch.isfinite(L_t[0]).all())


def test_collapsed_bound_batched_matches_jax():
    r = np.random.default_rng(7)
    Zs = r.normal(size=(T, M, Q))
    kuu = np.stack([np.asarray(jard.gram(1.2, np.ones(Q), Zs[t]))
                    for t in range(T)])
    B = r.normal(size=(T, M, 3 * M))
    psi2 = B @ B.transpose(0, 2, 1)
    p1y = r.normal(size=(T, M, D))
    psi0 = r.uniform(40, 60, T)
    yty = r.uniform(30, 40, D)
    noise = r.uniform(0.05, 0.3, T)

    want = jbound.collapsed_bound(
        jnp.asarray(kuu),
        jbound.SuffStats(psi0=jnp.asarray(psi0), psi1T_y=jnp.asarray(p1y),
                         psi2=jnp.asarray(psi2), yty=jnp.asarray(yty),
                         n=jnp.asarray(float(N))),
        jnp.asarray(noise))
    t = torch.as_tensor
    got = bound.collapsed_bound(
        t(kuu),
        bound.SuffStats(psi0=t(psi0), psi1T_y=t(p1y), psi2=t(psi2),
                        yty=t(yty), n=t(float(N))),
        t(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)
