"""The port's DP-GP-LVM training step against the JAX package, f64 on
the CPU: the DP golden ELBO of tests/test_golden.py through both of the
port's branches, its gradients against jax.grad, and 5 optimizer steps
against the optax trajectory. Parameters and data are the JAX package's,
carried across with `params_from_jax`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm as pdp
from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

DP_INIT_ELBO = -15879.401667596852   # tests/test_golden.py GOLDEN


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def _jax_case():
    """tests/test_golden.py::_dp_case, plus its jitted value-and-grad."""
    Y, _, _ = synthetic.grouped_dims(
        jax.random.PRNGKey(1234), n=200, dims_per_group=(6, 6), q=4,
        dtype=jnp.float64,
    )
    cfg = jdp.Config(num_latent=4, num_inducing=16, truncation=5)
    params = jdp.init_params(jax.random.PRNGKey(1234), Y, cfg)
    vg = jax.jit(jax.value_and_grad(lambda p: jdp.loss(p, Y, cfg)))
    return params, Y, cfg, vg


def _port_case(use_fused="auto"):
    params, Y, _, _ = _jax_case()
    tp = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                         "cpu", torch.float64)
    cfg = pdp.Config(num_latent=4, num_inducing=16, truncation=5,
                     use_fused=use_fused)
    return tp, torch.tensor(np.asarray(Y)), cfg


@pytest.mark.parametrize("use_fused", [True, False])
def test_dp_golden_elbo_and_gradients(use_fused):
    params, _, _, vg = _jax_case()
    tp, Y, cfg = _port_case(use_fused)
    loss = pdp.loss(tp, Y, cfg)
    np.testing.assert_allclose(-float(loss.detach()), DP_INIT_ELBO,
                               rtol=1e-9)
    grads = torch.autograd.grad(loss, list(tp.values()))
    _, jgrads = vg(params)
    for k, g in zip(tp, grads):
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-7,
                                   atol=1e-7 * float(np.abs(want).max()))


@pytest.mark.parametrize("ngd_lr", [None, 1.0])
def test_five_optimizer_steps_match_optax(ngd_lr):
    params, _, _, vg = _jax_case()
    opt = jloop.gp_optimizer(params, lr=1e-2, ngd_lr=ngd_lr)
    state = opt.init(params)
    update = jax.jit(opt.update)
    jp = params
    for _ in range(5):
        _, g = vg(jp)
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    tp, Y, cfg = _port_case()
    topt = gp_optimizer(tp, lr=1e-2, ngd_lr=ngd_lr)
    keys = list(tp)
    for _ in range(5):
        loss = pdp.loss(tp, Y, cfg)
        grads = torch.autograd.grad(loss, [tp[k] for k in keys])
        assert bool(topt.step(dict(zip(keys, grads))))
    for k in keys:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=1e-8,
                                   atol=1e-8 * float(np.abs(want).max()))
    with torch.no_grad():
        np.testing.assert_allclose(-float(pdp.loss(tp, Y, cfg)),
                                   -float(vg(jp)[0]), rtol=1e-8)


def test_nonfinite_gradient_skips_the_whole_update():
    """apply_if_finite: a step with a NaN gradient moves no parameter and
    leaves the Adam moments as they were."""
    tp, Y, cfg = _port_case()
    opt = gp_optimizer(tp, lr=1e-2)
    before = {k: v.detach().clone() for k, v in tp.items()}
    grads = {k: torch.ones_like(v) for k, v in tp.items()}
    grads["z"] = grads["z"].clone()
    grads["z"][0, 0, 0] = float("nan")
    assert not bool(opt.step(grads))
    for k in tp:
        assert torch.equal(tp[k].detach(), before[k])
        if k in opt.mu:
            assert not bool(opt.mu[k].any())
    assert all(int(c) == 0 for c in opt.count.values())
