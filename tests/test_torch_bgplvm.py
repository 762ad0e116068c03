"""The port's Bayesian GP-LVM against the JAX package, f64 on the CPU: the
BGPLVM goldens of tests/test_golden.py through both of the port's branches
(init ELBO, and the ELBO after 5 plain-Adam steps), the gradients against
`jax.grad`, `optimal_qu` single and batched, and the ported data
generators. Parameters and data are the JAX package's, carried across
with `params_from_jax`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsynthetic
from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import bound as jbound
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.config import CONFIGS
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import bgplvm, bound, prediction

BGPLVM_INIT_ELBO = -3857.134114362175          # tests/test_golden.py GOLDEN
BGPLVM_ELBO_AFTER_5_ADAM = -3563.149531226589  # ... GOLDEN_TRAJ


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def _jax_case():
    """tests/test_golden.py::_bgplvm_case."""
    Y, _ = jsynthetic.toy_gplvm(
        jax.random.PRNGKey(1234), n=100, d=10, q_true=2, q_total=2,
        dtype=jnp.float64,
    )
    cfg = jbg.Config(num_latent=2, num_inducing=20)
    params = jbg.init_params(jax.random.PRNGKey(1234), Y, cfg)
    return params, Y, cfg


@functools.lru_cache(maxsize=1)
def _jax_grad():
    params, Y, cfg = _jax_case()
    return jax.jit(jax.grad(lambda p: jbg.loss(p, Y, cfg)))(params)


def _port_case(use_fused):
    params, Y, _ = _jax_case()
    tp = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                         "cpu", torch.float64)
    cfg = bgplvm.Config(num_latent=2, num_inducing=20, use_fused=use_fused)
    return tp, torch.tensor(np.asarray(Y)), cfg


@pytest.mark.parametrize("use_fused", [True, False])
def test_bgplvm_golden_init_elbo_and_gradients(use_fused):
    params, Y, cfg = _jax_case()
    tp, Yt, tcfg = _port_case(use_fused)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        "qx_mean": (100, 2), "raw_qx_var": (100, 2), "z": (20, 2),
        "raw_variance": (), "raw_ard": (2,), "raw_noise": ()}
    loss = bgplvm.loss(tp, Yt, tcfg)
    np.testing.assert_allclose(-float(loss.detach()), BGPLVM_INIT_ELBO,
                               rtol=1e-9)
    keys = list(tp)
    got = torch.autograd.grad(loss, [tp[k] for k in keys])
    want = _jax_grad()
    for k, g in zip(keys, got):
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7,
                                   atol=1e-9 * np.abs(w).max())


@pytest.mark.parametrize("use_fused", [True, False])
def test_bgplvm_golden_after_5_adam_steps(use_fused):
    """5 plain-Adam (lr 1e-2) steps: the optax.adam trajectory golden,
    taken with the port's Adam (`prediction._fit_variational`)."""
    tp, Yt, tcfg = _port_case(use_fused)
    fitted, trace, k = prediction._fit_variational(
        lambda p: bgplvm.loss(p, Yt, tcfg), tp, 5, 1e-2)
    assert k == 5 and trace.shape == (5,)
    np.testing.assert_allclose(-float(trace[0]), BGPLVM_INIT_ELBO, rtol=1e-9)
    np.testing.assert_allclose(float(bgplvm.elbo(fitted, Yt, tcfg)),
                               BGPLVM_ELBO_AFTER_5_ADAM, rtol=1e-8)


def test_elbo_terms_fast_chol_and_hyperprior_match_jax():
    params, Y, _ = _jax_case()
    tp, Yt, _ = _port_case(False)
    jcfg = jbg.Config(num_latent=2, num_inducing=20, fast_chol=True,
                      hyperprior_std=1.5, psi2_block=32)
    tcfg = bgplvm.Config(num_latent=2, num_inducing=20, fast_chol=True,
                         hyperprior_std=1.5, psi2_block=32, use_fused=False)
    want = jbg.elbo_terms(params, Y, jcfg)
    with torch.no_grad():
        got = bgplvm.elbo_terms(tp, Yt, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-9)


def _stats(r, batch):
    m, d = 6, 4
    a = r.normal(size=batch + (m, m))
    kuu = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(m)
    b = r.normal(size=batch + (m, m))
    return dict(kuu=kuu, psi2=b @ np.swapaxes(b, -1, -2),
                psi1T_y=r.normal(size=batch + (m, d)),
                psi0=r.uniform(10.0, 20.0, batch), yty=r.uniform(5, 9, d),
                n=np.float64(37.0), noise=r.uniform(0.05, 0.5, batch))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
def test_optimal_qu_matches_jax(batch):
    c = _stats(np.random.default_rng(5), batch)
    keys = ("psi0", "psi1T_y", "psi2", "yty", "n")
    want = jbound.optimal_qu(
        jnp.asarray(c["kuu"]),
        jbound.SuffStats(**{k: jnp.asarray(c[k]) for k in keys}),
        jnp.asarray(c["noise"]))
    got = bound.optimal_qu(
        torch.tensor(c["kuu"]),
        bound.SuffStats(**{k: torch.tensor(c[k]) for k in keys}),
        torch.tensor(c["noise"]))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)
    if batch:      # one batched call equals the loop over its members
        for i in range(batch[0]):
            one = bound.optimal_qu(
                torch.tensor(c["kuu"][i]),
                bound.SuffStats(psi0=torch.tensor(c["psi0"][i]),
                                psi1T_y=torch.tensor(c["psi1T_y"][i]),
                                psi2=torch.tensor(c["psi2"][i]),
                                yty=torch.tensor(c["yty"]),
                                n=torch.tensor(c["n"])),
                torch.tensor(c["noise"][i]))
            for g, o in zip(got, one):
                np.testing.assert_allclose(g[i].numpy(), o.numpy(),
                                           rtol=1e-12, atol=1e-14)


def test_init_params_layout_and_generators_on_cpu():
    gen = prng.PRNGKey(3)
    Y, labels, X = synthetic.oil_flow_like(gen, n=60, d=5, device="cpu")
    assert Y.shape == (60, 5) and X.shape == (60, 2)
    assert labels.shape == (60,) and set(labels.tolist()) <= {0, 1, 2}
    np.testing.assert_allclose(Y.mean(0).numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(Y.std(0, correction=0).numpy(), 1.0,
                               rtol=1e-12)
    Yt, Xt = synthetic.toy_gplvm(gen, n=30, d=4, q_true=2, q_total=3,
                                 device="cpu")
    assert Yt.shape == (30, 4) and Xt.shape == (30, 3)
    np.testing.assert_allclose(Yt.std(0, correction=0).numpy(), 1.0,
                               rtol=1e-12)
    cfg = bgplvm.Config(num_latent=3, num_inducing=7)
    p = bgplvm.init_params(gen, Y, cfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "qx_mean": (60, 3), "raw_qx_var": (60, 3), "z": (7, 3),
        "raw_variance": (), "raw_ard": (3,), "raw_noise": ()}
    assert all(v.dtype == torch.float64 and v.requires_grad
               for v in p.values())
    with torch.no_grad():
        hyp = bgplvm.constrain(p)
    np.testing.assert_allclose(float(hyp["variance"]), 1.0, rtol=1e-12)
    np.testing.assert_allclose(float(hyp["noise"]), 0.1 + 1e-6, rtol=1e-9)
    np.testing.assert_allclose(hyp["qx_var"].numpy(), 0.5 + 1e-8,
                               rtol=1e-9)
    assert bool(torch.isfinite(bgplvm.elbo(p, Y, cfg)))


@pytest.mark.parametrize("name", ["c1_bgplvm_toy", "c2_sparse_oil",
                                  "c4_dp_mocap", "c5_dp_missing"])
def test_copied_configs_equal_the_jax_package(name):
    from dp_gp_lvm_tpu.core.config import CONFIGS as JCONFIGS

    assert CONFIGS[name].to_json() == JCONFIGS[name].to_json()
