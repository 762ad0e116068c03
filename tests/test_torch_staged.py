"""The port's staged trainer and plain-Adam trainer (`train/staged.py`,
`train/loop.py::fit`) against the JAX package's, on the CPU in float64:
a tiny Bayesian GP-LVM (N=12, D=3, Q=2, M=4) through a variational-only
stage then everything, and through `fit`, with parameters at rtol 1e-8
after each stage; frozen leaves unchanged to the bit; and
`masked_optimizer` where the frozen leaves' gradients dominate the clip
norm (optax clips before it masks), also over MRD's `views` sub-dicts."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu.train import staged as jstaged
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import bgplvm
from dp_gp_lvm_tpu_torch.train import staged
from dp_gp_lvm_tpu_torch.train.loop import fit

N, D, Q, M = 12, 3, 2, 4
STAGE_STEPS = 3
FIT_STEPS, LOG_EVERY = 5, 2
HYPERS = ("raw_variance", "raw_ard", "raw_noise")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def ref():
    Y = np.random.default_rng(0).standard_normal((N, D))
    cfg = jbg.Config(num_latent=Q, num_inducing=M)
    p0 = jbg.init_params(jax.random.PRNGKey(1), jnp.asarray(Y), cfg)
    loss_fn = lambda p, y: jbg.loss(p, y, cfg)
    p1, e1 = jstaged.staged_fit(loss_fn, p0, (jnp.asarray(Y),), stages=[
        (STAGE_STEPS, jstaged.variational_only)], lr=1e-2)
    p2, e2 = jstaged.staged_fit(loss_fn, p1, (jnp.asarray(Y),), stages=[
        (STAGE_STEPS, jstaged.everything)], lr=1e-2)
    pf, hist = jloop.fit(loss_fn, p0, (jnp.asarray(Y),), FIT_STEPS,
                         lr=1e-2, log_every=LOG_EVERY)
    return dict(Y=Y, p0=_np(p0), stages=[_np(p1), _np(p2)],
                elbos=e1 + e2, fit=_np(pf), fit_elbo=hist["elbo"])


def _port(ref):
    cfg = bgplvm.Config(num_latent=Q, num_inducing=M)
    return (torch.tensor(ref["Y"]), params_from_jax(ref["p0"], "cpu"),
            lambda p, y: bgplvm.loss(p, y, cfg))


def _close(params, want):
    assert sorted(params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].detach().numpy(), v,
                                   rtol=1e-8, atol=1e-12, err_msg=k)


def test_staged_fit_matches_reference_after_each_stage(ref):
    Y, p, loss_fn = _port(ref)
    elbos = []
    for (steps, pred), want in zip(
            [(STAGE_STEPS, staged.variational_only),
             (STAGE_STEPS, staged.everything)], ref["stages"]):
        out, e = staged.staged_fit(loss_fn, p, (Y,), stages=[(steps, pred)],
                                   lr=1e-2)
        assert out is p
        _close(p, want)
        elbos += e
    np.testing.assert_allclose(elbos, ref["elbos"], rtol=1e-8)


def test_first_stage_holds_the_hypers_to_the_bit(ref):
    Y, p, loss_fn = _port(ref)
    before = {k: p[k].detach().clone() for k in p}
    seen = []
    staged.staged_fit(loss_fn, p, (Y,), lr=1e-2,
                      stages=[(STAGE_STEPS, staged.variational_only)],
                      callback=lambda i, m: seen.append(i))
    assert seen == list(range(STAGE_STEPS))
    for k in p:
        assert torch.equal(p[k].detach(), before[k]) == (k in HYPERS), k


def test_fit_matches_reference(ref):
    Y, p, loss_fn = _port(ref)
    calls = []
    out, hist = fit(loss_fn, p, (Y,), FIT_STEPS, lr=1e-2,
                    log_every=LOG_EVERY,
                    callback=lambda i, e, m: calls.append(i))
    assert calls == [0, 2, 4]
    np.testing.assert_allclose(hist["elbo"], ref["fit_elbo"], rtol=1e-8)
    _close(out, ref["fit"])


def _dominated():
    """Parameters whose frozen leaves carry gradients ~1e8 times the
    trainable ones, top-level and inside MRD-style `views`: the clip
    shrinks the trainable gradients to ~1e-7, near Adam's eps of 1e-8,
    so clipping after the mask instead would move them ~5% further."""
    r = np.random.default_rng(3)
    return {"qx_mean": r.normal(size=(3, 2)),
            "raw_noise": r.normal(size=()),
            "views": [{"z": r.normal(size=(2, 2)),
                       "raw_ard": r.normal(size=(2,))} for _ in range(2)]}


def _dominated_loss(p, sq):
    views = sum(sq(v["z"] - 0.5) + 1e8 * sq(v["raw_ard"]) for v in p["views"])
    return sq(p["qx_mean"] - 1.0) + 1e8 * sq(p["raw_noise"]) + views


def test_clip_counts_the_frozen_gradients(ref):
    p0 = _dominated()
    opt = jstaged.masked_optimizer(0.1, p0, jstaged.variational_only, clip=10.0)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    loss = lambda p: _dominated_loss(p, lambda x: jnp.sum(x * x))

    @jax.jit
    def three_steps(jp, state):
        for _ in range(3):
            updates, state = opt.update(jax.grad(loss)(jp), state, jp)
            jp = optax.apply_updates(jp, updates)
        return jp

    jp = three_steps(jp, state)

    tp = {"qx_mean": torch.tensor(p0["qx_mean"], requires_grad=True),
          "raw_noise": torch.tensor(p0["raw_noise"], requires_grad=True),
          "views": [{k: torch.tensor(v, requires_grad=True)
                     for k, v in view.items()} for view in p0["views"]]}
    port = staged.masked_optimizer(0.1, tp, staged.variational_only, clip=10.0)
    leaves = list(port.params.values())
    for _ in range(3):
        grads = torch.autograd.grad(
            _dominated_loss(tp, lambda x: torch.sum(x * x)), leaves)
        port.step(dict(zip(port.params, grads)))
    got = {k: v.detach().numpy() for k, v in port.params.items()}
    want = {"qx_mean": jp["qx_mean"], "raw_noise": jp["raw_noise"],
            **{f"views.{i}.{k}": v for i, view in enumerate(jp["views"])
               for k, v in view.items()}}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-12,
                                   err_msg=k)
    # frozen leaves held, the trainable ones moved
    assert got["raw_noise"] == p0["raw_noise"]
    for i in range(2):
        np.testing.assert_array_equal(got[f"views.{i}.raw_ard"],
                                      p0["views"][i]["raw_ard"])
    assert not np.allclose(got["qx_mean"], p0["qx_mean"])
