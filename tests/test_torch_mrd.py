"""The port's MRD (`models/mrd.py`) against the JAX package, f64 on the
CPU: the two-view generator on the same key, `init_params` up to the PCA
column signs, the ELBO terms and the gradient of every leaf (the views'
included) on the JAX package's parameters carried across, five decayed
NGD + Adam steps of `gp_optimizer` with c3's settings against optax, and
the optimizer group of every leaf."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import mrd as jmrd
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.config import CONFIGS
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import mrd
from dp_gp_lvm_tpu_torch.train import loop

N, D1, D2, Q, M = 40, 5, 4, 3, 6
C3 = CONFIGS["c3_mrd_twoview"]
STEPS = 5
HYPERPRIOR = 0.7


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def _reference():
    """One jitted program: the draw, the init, the ELBO terms (with and
    without the hyperprior), the gradient, and five of c3's optimizer
    steps from the init."""
    cfg = jmrd.Config(num_latent=Q, num_inducing=M, num_views=2)
    cfg_hp = cfg._replace(hyperprior_std=HYPERPRIOR)

    def program(key):
        Y1, Y2, X = jsyn.two_view(key, n=N, d1=D1, d2=D2, q_shared=2,
                                  private_weight=0.5, dtype=jnp.float64)
        Ys = [Y1, Y2]
        params = jmrd.init_params(jax.random.PRNGKey(9), Ys, cfg)
        loss = lambda p, *ys: jmrd.loss(p, list(ys), cfg)
        opt = jloop.gp_optimizer(params, lr=C3.lr, decay_steps=STEPS,
                                 ngd_lr=C3.ngd_lr)
        multi = jloop.make_multi_step_fn(loss, opt, num_inner=STEPS)
        state, losses = multi(jloop.init_state(params, opt), Y1, Y2)
        return {
            "data": (Y1, Y2, X), "init": params,
            "terms": jmrd.elbo_terms(params, Ys, cfg),
            "terms_hp": jmrd.elbo_terms(params, Ys, cfg_hp),
            "grad": jax.grad(lambda p: jmrd.loss(p, Ys, cfg))(params),
            "grad_hp": jax.grad(lambda p: jmrd.loss(p, Ys, cfg_hp))(params),
            "stepped": state.params, "losses": losses,
        }

    return _np(jax.jit(program)(jax.random.PRNGKey(4)))


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-300), err_msg=name)


def _carried():
    ref = _reference()
    tp = params_from_jax(ref["init"], "cpu", torch.float64)
    Ys = [torch.tensor(y) for y in ref["data"][:2]]
    return ref, tp, Ys


def _flat(tree):
    """The reference's parameter tree under the port's flat names."""
    return {**{k: v for k, v in tree.items() if k != "views"},
            **{f"views.{i}.{k}": v for i, view in enumerate(tree["views"])
               for k, v in view.items()}}


def test_two_view_matches_reference_on_the_same_key():
    want = _reference()["data"]
    got = synthetic.two_view(prng.PRNGKey(4), n=N, d1=D1, d2=D2, q_shared=2,
                             private_weight=0.5, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-10)
    # each view standardized over the whole series (ddof 0)
    for y in got[:2]:
        np.testing.assert_allclose(y.mean(0).numpy(), 0.0, atol=1e-12)
        np.testing.assert_allclose(y.std(0, correction=0).numpy(), 1.0,
                                   rtol=1e-12)


def test_init_params_match_reference_up_to_column_sign():
    """The PCA latents and each view's Z are compared up to the sign of
    each latent column: the SVD's signs are LAPACK's choice."""
    ref, _, Ys = _carried()
    want = ref["init"]
    got = mrd.init_params(prng.PRNGKey(9), Ys,
                          mrd.Config(num_latent=Q, num_inducing=M,
                                     num_views=2))
    assert sorted(got) == sorted(want) and len(got["views"]) == 2
    sign = np.sign(np.sum(got["qx_mean"].detach().numpy() * want["qx_mean"],
                          axis=0))
    assert (sign != 0).all()
    for k, w in _flat(want).items():
        g = loop.flat_leaves(got)[k]
        assert isinstance(g, torch.nn.Parameter), k
        g = g.detach().numpy()
        if k == "qx_mean" or k.endswith(".z"):
            g = g * sign
        _close(g, w, 1e-10, k)


@pytest.mark.parametrize("hyperprior", [0.0, HYPERPRIOR],
                         ids=["plain", "hyperprior"])
def test_elbo_terms_and_every_gradient_match_reference(hyperprior):
    ref, tp, Ys = _carried()
    tag = "_hp" if hyperprior else ""
    cfg = mrd.Config(num_latent=Q, num_inducing=M, num_views=2,
                     hyperprior_std=hyperprior)
    terms = mrd.elbo_terms(tp, Ys, cfg)
    for k in ("elbo", "fit", "kl_x", "fit_per_view", "hyperprior"):
        _close(torch.as_tensor(terms[k]), ref["terms" + tag][k], 1e-9, k)
    assert terms["fit_per_view"].shape == (2,)
    leaves = loop.flat_leaves(tp)
    grads = torch.autograd.grad(mrd.loss(tp, Ys, cfg), list(leaves.values()))
    want = _flat(ref["grad" + tag])
    assert sorted(leaves) == sorted(want)
    for k, g in zip(leaves, grads):
        _close(g, want[k], 1e-8, k)


def test_five_c3_optimizer_steps_match_optax():
    """NGD on q(X) at ngd_lr, Adam on the views' Z at lr and on their
    hypers at lr/10, all decayed over the 5 steps, through the port's
    multi-step driver with the loss closed over the nested params."""
    ref, tp, Ys = _carried()
    cfg = mrd.Config(num_latent=Q, num_inducing=M, num_views=2)
    opt = loop.gp_optimizer(tp, lr=C3.lr, decay_steps=STEPS,
                            ngd_lr=C3.ngd_lr)
    multi = loop.make_multi_step_fn(lambda _, *ys: mrd.loss(tp, list(ys), cfg),
                                    opt, STEPS)
    losses = multi(*Ys)
    _close(losses, ref["losses"], 1e-8)
    want = _flat(ref["stepped"])
    got = loop.flat_leaves(tp)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _close(got[k], w, 1e-8, k)
        # the optimizer moved the model's own tensors
        assert got[k] is opt.params[k]


def test_every_leaf_gets_the_references_label():
    """raw_variance, raw_ard and raw_noise of each view train at the hyper
    rate, Z at the variational rate, q(X) by NGD; with ard_lr and freeze
    the views' leaves follow their own key too."""
    _, tp, _ = _carried()
    opt = loop.gp_optimizer(tp, lr=C3.lr, ngd_lr=C3.ngd_lr)
    want = {"qx_mean": "ngd", "raw_qx_var": "ngd"}
    for i in range(2):
        want.update({f"views.{i}.z": "var",
                     f"views.{i}.raw_variance": "hyper",
                     f"views.{i}.raw_ard": "hyper",
                     f"views.{i}.raw_noise": "hyper"})
    assert opt.labels == want
    opt = loop.gp_optimizer(tp, lr=C3.lr, ard_lr=0.05,
                            freeze=frozenset({"z"}))
    assert {k: opt.labels[k] for k in ("qx_mean", "views.1.z",
                                       "views.0.raw_ard",
                                       "views.1.raw_noise")} == {
        "qx_mean": "var", "views.1.z": "frozen", "views.0.raw_ard": "ard",
        "views.1.raw_noise": "hyper"}


def test_ard_relevance_stacks_each_views_weights():
    _, tp, _ = _carried()
    rel = mrd.ard_relevance(tp)
    assert rel.shape == (2, Q)
    for i, view in enumerate(tp["views"]):
        _close(rel[i], torch.nn.functional.softplus(view["raw_ard"]).detach()
               .numpy(), 1e-12)
