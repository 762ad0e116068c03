"""The port's `fit_lbfgs` (optax's L-BFGS with its zoom line search,
`train/loop.py`) against the reference's, f64 on the CPU, on the
reference test's GP-regression problem (`tests/test_train.py::
test_lbfgs_fits_gp_regression`: 40 points in 2 dims, 3 outputs, 40
steps): every step's loss at rtol 1e-10, the same count of loss
evaluations (the reference's counted by a debug callback in its loss),
and the parameters after 20 steps at rtol 1e-8; and on three small
functions that take the line search through its other branches (the
zoom's interpolations on Rosenbrock's valley, a step out of a log
barrier's domain, and the failed searches that end on the safeguarded
step at a kink), the losses at rtol 1e-10, the evaluations and the
parameters at rtol 1e-8.

After ~25 steps the loss is flat along raw_ard (an ARD weight near 5e-5;
its line searches take 10 and 14 evaluations): the last bits by which
XLA's and PyTorch's arithmetic differ then move raw_ard by ~2e-8
relative while the losses still agree to ~2e-12, so the 40-step
parameters are held at rtol 1e-6 (raw_noise and raw_variance at 1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import gp_regression as jgp
from dp_gp_lvm_tpu.train.loop import fit_lbfgs as jfit_lbfgs
from dp_gp_lvm_tpu_torch.models import gp_regression
from dp_gp_lvm_tpu_torch.train.loop import fit_lbfgs

STEPS = 40
EARLY = 20


def _rosenbrock(x, xp):
    return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _barrier(x, xp):
    return xp.sum(5.0 * x - xp.log(1.0 - x * x))


def _kink(x, xp):
    return xp.sum(xp.abs(x - 0.3)) + 0.01 * xp.sum(x ** 2)


# (function, start, steps)
SMALL = dict(rosenbrock=(_rosenbrock, [-1.2, 1.0, 0.5, -0.3], 20),
             barrier=(_barrier, [-0.2], 8),
             kink=(_kink, [0.0, 1.1], 8))


def _counted(fn, evaluations):
    def loss(*args):
        jax.debug.callback(lambda: evaluations.__setitem__(
            0, evaluations[0] + 1))
        return fn(*args)
    return loss


def _problem():
    X = jax.random.normal(jax.random.PRNGKey(7), (40, 2))
    Y, _ = jsyn.toy_gplvm(jax.random.PRNGKey(8), n=40, d=3, q_true=2)
    return X, Y, jgp.init_params(2, dtype=X.dtype)


@pytest.fixture(scope="module")
def ref():
    X, Y, p0 = _problem()
    evaluations = [0]
    params, losses = jfit_lbfgs(_counted(jgp.loss, evaluations), p0, (X, Y),
                                STEPS)
    jax.block_until_ready(losses)
    early, _ = jfit_lbfgs(jgp.loss, p0, (X, Y), EARLY)
    out = jax.tree.map(np.asarray, dict(X=X, Y=Y, p0=p0, params=params,
                                        losses=losses, early=early))
    out["evaluations"] = evaluations[0]
    for name, (fn, x0, steps) in SMALL.items():
        count = [0]
        p, losses = jfit_lbfgs(
            _counted(lambda q: fn(q["x"], jnp), count),
            {"x": jnp.asarray(x0, dtype=jnp.float64)}, (), steps)
        jax.block_until_ready(losses)
        out[name] = dict(x=np.asarray(p["x"]), losses=np.asarray(losses),
                         evaluations=count[0])
    return out


def _fit(ref, steps, info=None):
    X, Y = torch.tensor(ref["X"]), torch.tensor(ref["Y"])
    p0 = {k: torch.tensor(v) for k, v in ref["p0"].items()}
    return fit_lbfgs(lambda p, x, y: gp_regression.loss(p, x, y), p0, (X, Y),
                     steps, info=info)


def test_losses_and_evaluations_match_reference(ref):
    info = {}
    params, losses = _fit(ref, STEPS, info)
    np.testing.assert_allclose(losses.numpy(), ref["losses"], rtol=1e-10)
    assert info["evaluations"] == ref["evaluations"]
    assert info["evaluations"] == 1 + sum(info["linesearch_steps"])
    # the reference test's claim, on the port
    assert losses[-1] < losses[0] - 1.0
    for k, v in ref["params"].items():
        np.testing.assert_allclose(params[k].numpy(), v,
                                   rtol=1e-6 if k == "raw_ard" else 1e-8,
                                   err_msg=k)


def test_params_after_the_descent_match_reference(ref):
    params, _ = _fit(ref, EARLY)
    for k, v in ref["early"].items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=1e-8,
                                   err_msg=k)


def test_inputs_are_left_as_they_were(ref):
    p0 = {k: torch.tensor(v) for k, v in ref["p0"].items()}
    before = {k: v.clone() for k, v in p0.items()}
    X, Y = torch.tensor(ref["X"]), torch.tensor(ref["Y"])
    fit_lbfgs(gp_regression.loss, p0, (X, Y), 3)
    for k in p0:
        assert torch.equal(p0[k], before[k])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_line_search_branches_match_reference(ref, name):
    fn, x0, steps = SMALL[name]
    info = {}
    p, losses = fit_lbfgs(lambda q: fn(q["x"], torch),
                          {"x": torch.tensor(x0, dtype=torch.float64)}, (),
                          steps, info=info)
    want = ref[name]
    np.testing.assert_allclose(losses.numpy(), want["losses"], rtol=1e-10)
    np.testing.assert_allclose(p["x"].numpy(), want["x"], rtol=1e-8)
    assert info["evaluations"] == want["evaluations"]
