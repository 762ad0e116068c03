"""The port's minibatch MRD (`models/mrd_svi.py`) against the JAX
package's, in float64 on the CPU at N=64, views (5, 4), Q=3, M=6 and 16
aligned rows a step: `init_params` from the same key (up to the PCA
columns' signs), the bound's terms, the minibatch estimate and its
gradient for every leaf, `set_optimal_qu` at rtol 1e-9; five
natural-gradient steps on the same minibatches at 1e-8; `predict_view`,
`candidate_table`, `infer_latent` and `cross_view_predict` on the stepped
parameters; and the amortized branch's init and a step with its q(u)
trust region. The JAX oracles run once, in one jitted program; K1 and K2
are not reached there (the JAX package takes its plain psi statistics on
the CPU). The reference's own `tests/test_mrd_svi.py` cases run on the
port in `tests/test_torch_mrd_svi_cases.py`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import mrd_svi as jms
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import mrd_svi
from dp_gp_lvm_tpu_torch.train import loop

N, D1, D2, Q, M, B = 64, 5, 4, 3, 6, 16
STEPS = 5
INFER_STEPS = 20
GRAD_SCALE = 0.7           # the cotangent of the estimate's gradient


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(amortized=False):
    kw = dict(num_latent=Q, num_inducing=M, num_views=2, batch=B)
    if amortized:
        kw.update(amortized=True, encoder_hidden=8, noise_floor=1e-3,
                  qx_var_floor=1e-2)
    return kw


def _perturbed(tree):
    """Off the init manifold, so that no check is vacuous."""
    return jax.tree.map(lambda v: v + 0.01 * jnp.sin(jnp.arange(
        v.size, dtype=v.dtype)).reshape(v.shape), tree)


def _steps(cfg, p0, Ys, qu_trust=None, count=STEPS):
    opt = jloop.gp_optimizer(p0, lr=3e-3, decay_steps=count)
    step = jms.make_svi_natgrad_step(cfg, N, opt, rho=0.2, qu_trust=qu_trust)
    state = jloop.init_state(p0, opt)
    _, r1 = jax.random.split(jax.random.PRNGKey(100))
    losses = []
    for t in range(count):
        state, metrics = step(state, jax.random.fold_in(r1, t), tuple(Ys))
        losses.append(metrics["loss"])
    return state.params, jnp.stack(losses)


@functools.lru_cache(maxsize=1)
def _reference():
    cfg, cfg_a = jms.Config(**_cfg()), jms.Config(**_cfg(amortized=True))

    def program(key):
        Y1, Y2, _ = jsyn.two_view(key, n=N, d1=D1, d2=D2, q_shared=2,
                                  private_weight=0.5, dtype=jnp.float64)
        Ys = [Y1, Y2]
        init = jms.init_params(jax.random.PRNGKey(9), Ys, cfg)
        p0 = _perturbed(init)
        idx = jnp.arange(3, 3 + 3 * B, 3)
        yb = [Y[idx] for Y in Ys]
        trained, losses = _steps(cfg, p0, Ys)
        obs = {0: Y1[::8]}
        x = jnp.sin(jnp.arange(8 * Q, dtype=jnp.float64)).reshape(8, Q)
        s = 0.05 + 0.01 * jnp.cos(jnp.arange(8 * Q, dtype=jnp.float64)
                                  ).reshape(8, Q)
        init_a = jms.init_params(jax.random.PRNGKey(9), Ys, cfg_a)
        p0_a = _perturbed(init_a)
        stepped_a, losses_a = _steps(cfg_a, p0_a, Ys, qu_trust=100.0,
                                     count=1)
        return {
            "data": (Y1, Y2), "init": init, "p0": p0, "idx": idx,
            "terms": jms.elbo_terms(p0, Ys, cfg),
            "elbo_mb": jms.elbo_minibatch(p0, yb, idx, N, cfg),
            "grad_mb": jax.grad(lambda p: GRAD_SCALE * jms.elbo_minibatch(
                p, yb, idx, N, cfg))(p0),
            "optimal": jms.set_optimal_qu(p0, Ys, cfg),
            "trained": trained, "losses": losses,
            "x": x, "s": s,
            "predict": jms.predict_view(trained, x, s, 1, cfg),
            "table": jms.candidate_table(trained, 0, cfg),
            "infer": jms.infer_latent(trained, obs, x, cfg,
                                      num_steps=INFER_STEPS),
            "cross": jms.cross_view_predict(trained, obs, 1, cfg,
                                            num_steps=INFER_STEPS),
            "init_a": init_a, "p0_a": p0_a,
            "terms_a": jms.elbo_terms(p0_a, Ys, cfg_a),
            "stepped_a": stepped_a, "losses_a": losses_a,
            "cross_a": jms.cross_view_predict(stepped_a, obs, 1, cfg_a,
                                              num_steps=INFER_STEPS),
        }

    return jax.tree.map(np.asarray, jax.jit(program)(jax.random.PRNGKey(4)))


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-300), err_msg=name)


def _flat(tree):
    return {**{k: v for k, v in tree.items() if k != "views"},
            **{f"views.{i}.{k}": v for i, view in enumerate(tree["views"])
               for k, v in view.items()}}


def _port(name="p0"):
    ref = _reference()
    return (ref, [torch.tensor(y) for y in ref["data"]],
            params_from_jax(ref[name], "cpu"))


@pytest.mark.parametrize("amortized", [False, True],
                         ids=["resident", "amortized"])
def test_init_params_match_reference_up_to_column_sign(amortized):
    """PCA on the concatenated views: the latents, each view's Z and the
    encoder's readout compared up to the sign of each latent column (the
    SVD's signs are LAPACK's choice); every other leaf exactly."""
    ref, Ys, _ = _port()
    want = ref["init_a" if amortized else "init"]
    got = mrd_svi.init_params(prng.PRNGKey(9), Ys,
                              mrd_svi.Config(**_cfg(amortized)))
    assert sorted(got) == sorted(want) and len(got["views"]) == 2
    flat = loop.flat_leaves(got)
    head = "enc_wlin" if amortized else "qx_mean"
    sign = np.sign(np.sum(flat[head].detach().numpy() * want[head], axis=0))
    assert (sign != 0).all()
    for k, w in _flat(want).items():
        assert isinstance(flat[k], torch.nn.Parameter), k
        g = flat[k].detach().numpy()
        if k in ("qx_mean", "enc_wlin") or k.endswith(".z"):
            g = g * sign
        if k == "enc_mean":     # the column means of standardized views: 0
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        else:
            _close(g, w, 1e-9, k)


def test_bound_terms_minibatch_and_its_gradient_match_reference():
    ref, Ys, p = _port()
    cfg = mrd_svi.Config(**_cfg())
    with torch.no_grad():
        terms = mrd_svi.elbo_terms(p, Ys, cfg)
    for k in ("elbo", "kl_x", "fit_per_view"):
        _close(terms[k], ref["terms"][k], 1e-9, k)
    idx = torch.tensor(ref["idx"]).long()
    est = mrd_svi.elbo_minibatch(p, [Y[idx] for Y in Ys], idx, N, cfg)
    _close(est, ref["elbo_mb"], 1e-9)
    leaves = loop.flat_leaves(p)
    grads = torch.autograd.grad(GRAD_SCALE * est, list(leaves.values()))
    want = _flat(ref["grad_mb"])
    assert sorted(want) == sorted(leaves)
    for k, g in zip(leaves, grads):
        _close(g, want[k], 1e-9, k)


def test_set_optimal_qu_matches_reference():
    ref, Ys, p = _port()
    with torch.no_grad():
        got = mrd_svi.set_optimal_qu(p, Ys, mrd_svi.Config(**_cfg()))
    for k, w in _flat(ref["optimal"]).items():
        _close(loop.flat_leaves(got)[k], w, 1e-9, k)


def _port_steps(p, Ys, cfg, qu_trust=None, count=STEPS):
    opt = loop.gp_optimizer(p, lr=3e-3, decay_steps=count)
    step = mrd_svi.make_svi_natgrad_step(cfg, N, opt, rho=0.2,
                                         qu_trust=qu_trust)
    _, r1 = prng.split(prng.PRNGKey(100))
    idx = step.indices(prng.fold_in(r1, torch.arange(count)))
    return [float(step(t, idx[t], Ys)) for t in range(count)]


def test_five_natgrad_steps_on_the_same_minibatches_match_reference():
    """The same int32 minibatches, the optimizer's update and each view's
    blend from the gradient pass's statistics."""
    ref, Ys, p = _port()
    losses = _port_steps(p, Ys, mrd_svi.Config(**_cfg()))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-8)
    for k, w in _flat(ref["trained"]).items():
        _close(loop.flat_leaves(p)[k], w, 1e-8, k)


def test_serving_matches_reference():
    """predict_view at a fixed q(x*), the candidate table, the latent
    inference from a fixed start, and the whole cross-view pipeline."""
    ref, Ys, p = _port("trained")
    cfg = mrd_svi.Config(**_cfg())
    x, s = torch.tensor(ref["x"]), torch.tensor(ref["s"])
    obs = {0: Ys[0][::8]}
    with torch.no_grad():
        pred = mrd_svi.predict_view(p, x, s, 1, cfg)
        table = mrd_svi.candidate_table(p, 0, cfg)
    for g, w in zip(pred + table, tuple(ref["predict"]) + tuple(
            ref["table"])):
        _close(g, w, 1e-9)
    infer = mrd_svi.infer_latent(p, obs, x, cfg, num_steps=INFER_STEPS)
    for g, w in zip(infer, ref["infer"]):
        _close(g, w, 1e-8)
    cross = mrd_svi.cross_view_predict(p, obs, 1, cfg,
                                       num_steps=INFER_STEPS)
    for g, w in zip(cross, ref["cross"]):
        _close(g, w, 1e-8)


def test_amortized_bound_step_and_serving_match_reference():
    """The encoder over the concatenated views: the bound, one step with
    the q(u) trust region, and the cross-view pipeline from the encoder's
    one-pass init (the target view filled at its centre)."""
    ref, Ys, p = _port("p0_a")
    cfg = mrd_svi.Config(**_cfg(amortized=True))
    with torch.no_grad():
        terms = mrd_svi.elbo_terms(p, Ys, cfg)
    for k in ("elbo", "kl_x", "fit_per_view"):
        _close(terms[k], ref["terms_a"][k], 1e-9, k)
    losses = _port_steps(p, Ys, cfg, qu_trust=100.0, count=1)
    np.testing.assert_allclose(losses, ref["losses_a"], rtol=1e-8)
    for k, w in _flat(ref["stepped_a"]).items():
        _close(loop.flat_leaves(p)[k], w, 1e-8, k)
    cross = mrd_svi.cross_view_predict(p, {0: Ys[0][::8]}, 1, cfg,
                                       num_steps=INFER_STEPS)
    for g, w in zip(cross, ref["cross_a"]):
        _close(g, w, 1e-8)
