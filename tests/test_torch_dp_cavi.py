"""The port's full-batch DP CAVI step (`models/dp_gp_lvm.py::cavi_step`,
`expected_assignments`) and the three closed-form stick-breaking updates
against the JAX package, f64 on the CPU: the updates on random inputs, the
step on the same parameters with the concentration fixed and learned, and
the ELBO it must not lower."""
import functools

import jax
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.distributions import stick_breaking as jsb
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.distributions import stick_breaking as sb
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm

N, D, Q, M, T = 30, 7, 2, 5, 4
LEARN = {"fixed": False, "learned": True}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _updates_inputs():
    r = np.random.default_rng(5)
    return dict(gamma1=r.uniform(0.5, 5.0, T - 1),
                gamma2=r.uniform(0.5, 5.0, T - 1),
                phi=r.dirichlet(np.ones(T), size=D),
                f=r.normal(0.0, 30.0, (D, T)), alpha=1.7)


def _case(learn_alpha):
    """Numpy data and the port's init (carried to both packages)."""
    r = np.random.default_rng(6)
    x = r.normal(size=(N, Q))
    Y = np.concatenate([np.sin(x @ r.normal(size=(Q, 4))),
                        np.cos(2.0 * x[:, :1] @ r.normal(size=(1, 3)))], 1)
    Y = Y + 0.05 * r.normal(size=Y.shape)
    cfg = dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T,
                           alpha=1.3, learn_alpha=learn_alpha)
    p = dp_gp_lvm.init_params(prng.PRNGKey(7), torch.tensor(Y), cfg)
    return {k: v.detach().numpy() for k, v in p.items()}, Y, cfg


@functools.lru_cache(maxsize=1)
def _reference():
    """One jitted program: the three updates, and per case the CAVI step
    with the ELBO before and after it."""
    u = _updates_inputs()
    cases = {name: _case(learn) for name, learn in LEARN.items()}

    def program(u, cases):
        out = {
            "alpha": jsb.alpha_cavi_update(u["gamma1"], u["gamma2"]),
            "alpha_prior": jsb.alpha_cavi_update(u["gamma1"], u["gamma2"],
                                                 2.0, 0.5),
            "gamma": jsb.gamma_cavi_update(u["phi"], u["alpha"]),
            "phi": jsb.phi_cavi_update(u["f"], u["gamma1"], u["gamma2"]),
        }
        for name, (params, Y) in cases.items():
            cfg = jdp.Config(num_latent=Q, num_inducing=M, truncation=T,
                             alpha=1.3, learn_alpha=LEARN[name])
            new = jdp.cavi_step(params, Y, cfg)
            out[name] = {"params": new,
                         "phi": jdp.expected_assignments(new),
                         "elbo_before": jdp.elbo(params, Y, cfg),
                         "elbo_after": jdp.elbo(new, Y, cfg)}
        return out

    jcases = {name: (p, Y) for name, (p, Y, _) in cases.items()}
    return cases, jax.tree.map(np.asarray, jax.jit(program)(u, jcases))


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def test_stick_breaking_updates_match_reference():
    _, want = _reference()
    u = {k: torch.as_tensor(v, dtype=torch.float64)
         for k, v in _updates_inputs().items()}
    _close(sb.alpha_cavi_update(u["gamma1"], u["gamma2"]), want["alpha"],
           1e-12)
    _close(sb.alpha_cavi_update(u["gamma1"], u["gamma2"], 2.0, 0.5),
           want["alpha_prior"], 1e-12)
    g1, g2 = sb.gamma_cavi_update(u["phi"], u["alpha"])
    assert g1.shape == g2.shape == (T - 1,)
    _close(g1, want["gamma"][0], 1e-12)
    _close(g2, want["gamma"][1], 1e-12)
    phi = sb.phi_cavi_update(u["f"], u["gamma1"], u["gamma2"])
    _close(phi, want["phi"], 1e-12)
    np.testing.assert_allclose(phi.sum(-1).numpy(), 1.0, rtol=1e-14)


@pytest.mark.parametrize("name", sorted(LEARN))
def test_cavi_step_matches_reference(name):
    cases, want = _reference()
    params, Y, cfg = cases[name]
    tp = params_from_jax(params, "cpu", torch.float64)
    new = dp_gp_lvm.cavi_step(tp, torch.tensor(Y), cfg)
    ref = want[name]["params"]
    assert sorted(new) == sorted(ref) == sorted(tp)
    replaced = {"phi_logits", "raw_gamma1", "raw_gamma2"} | (
        {"raw_alpha"} if cfg.learn_alpha else set())
    for k, v in new.items():
        _close(v, ref[k], 1e-9, k)
        # the rest are the caller's own tensors, untouched
        assert (v is tp[k]) == (k not in replaced), k
        assert not v.requires_grad or k not in replaced
    _close(dp_gp_lvm.expected_assignments(new), want[name]["phi"], 1e-9)


@pytest.mark.parametrize("name", sorted(LEARN))
def test_cavi_step_does_not_lower_the_elbo(name):
    """The reference's claim (tests/test_dp.py): a coordinate-ascent step
    at the other parameters held cannot lower the ELBO."""
    cases, want = _reference()
    params, Y, cfg = cases[name]
    tp = params_from_jax(params, "cpu", torch.float64)
    Y = torch.tensor(Y)
    with torch.no_grad():
        before = float(dp_gp_lvm.elbo(tp, Y, cfg))
        new = dp_gp_lvm.cavi_step(tp, Y, cfg)
        after = float(dp_gp_lvm.elbo(new, Y, cfg))
    _close(before, want[name]["elbo_before"], 1e-10)
    _close(after, want[name]["elbo_after"], 1e-9)
    assert after >= before - 1e-8 * abs(before)
    phi = dp_gp_lvm.expected_assignments(new)
    assert phi.shape == (D, T)
    np.testing.assert_allclose(phi.sum(-1).numpy(), 1.0, rtol=1e-14)
