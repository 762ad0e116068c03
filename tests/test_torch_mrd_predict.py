"""The port's MRD cross-view prediction (`models/prediction.py`, MRD part,
and `models/serving.py::make_mrd_cross_view_predictor`) against the JAX
package, f64 on the CPU, on a small trained MRD handed to both packages:
the per-view posterior caches, latent inference from one view, per-point
restarts, `predict_view_from_views` (with and without restarts,
annealed), and the server in both inference modes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.models import mrd as jmrd
from dp_gp_lvm_tpu.models import prediction as jpred
from dp_gp_lvm_tpu.models import serving as jserving
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import mrd, prediction, serving
from dp_gp_lvm_tpu_torch.train.loop import fit, flat_leaves

N_TRAIN, STEPS, LR = 40, 30, 0.05
RTOL = 1e-6   # many Adam steps divide by sqrt(nu): rounding grows with them
UNROLL = 8    # a batch above serving.TOL_MAX_BATCH: the fixed unroll
TOL = 3       # a batch at most TOL_MAX_BATCH: early stopping


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data():
    """Two views of 48 rows (40 to train on, 8 held out) sharing two of
    four latent dims, each with one private dim: numpy, seeded."""
    r = np.random.default_rng(31)
    X = r.normal(size=(N_TRAIN + UNROLL, 4))
    Y1 = np.sin(X[:, [0, 1, 2]] @ r.normal(size=(3, 5)))
    Y2 = np.cos(X[:, [0, 1, 3]] @ r.normal(size=(3, 4)))
    Ys = [y + 0.05 * r.normal(size=y.shape) for y in (Y1, Y2)]
    return [y[:N_TRAIN] for y in Ys], Ys[0][N_TRAIN:]


@functools.lru_cache(maxsize=1)
def _reference():
    """A tiny MRD (100 plain-Adam steps, trained by the port: the
    parameters are what both packages are then handed), then one jitted
    program of the reference with every prediction path on the held-out
    rows, its server included."""
    train, y_obs = _data()
    cfg = jmrd.Config(num_latent=3, num_inducing=8, num_views=2)
    tcfg = mrd.Config(num_latent=3, num_inducing=8, num_views=2)
    Ys = [torch.tensor(y) for y in train]
    tp = mrd.init_params(prng.PRNGKey(32), Ys, tcfg)
    fit(lambda _, *ys: mrd.loss(tp, list(ys), tcfg), flat_leaves(tp), Ys,
        100, lr=2e-2)
    params = jax.tree.map(lambda v: jnp.asarray(v.detach().numpy()), tp)

    def program(params):
        caches = jpred.mrd_posterior(params, list(train), cfg)
        ones = jnp.ones_like(y_obs)
        m0 = jpred.init_latent_from_nearest(params["qx_mean"], train[0],
                                            y_obs, ones)
        knn = jpred.init_latent_knn(params["qx_mean"], train[0], y_obs,
                                    ones, 2)
        m_inits = jnp.concatenate([knn, jnp.zeros_like(knn[:1])], axis=0)
        predictor = jserving.make_mrd_cross_view_predictor(
            params, list(train), cfg, observed_view=0, target_view=1,
            num_steps=STEPS)
        return {
            "caches": [c._asdict() for c in caches],
            "m0": m0, "knn": knn,
            "ell_per_point": jpred._expected_loglik_per_point(
                caches[1], train[1][:UNROLL],
                jnp.ones_like(train[1][:UNROLL]), m0,
                0.1 * jnp.ones_like(m0)),
            "infer": jpred.mrd_infer_latent(caches, {0: y_obs}, m0, STEPS,
                                            LR),
            "restarts": jpred.mrd_infer_latent_restarts(
                caches, {0: y_obs}, m_inits, STEPS, LR),
            "predict": jpred.predict_view_from_views(
                params, list(train), cfg, {0: y_obs}, 1, STEPS, LR),
            "predict_restarts": jpred.predict_view_from_views(
                params, list(train), cfg, {0: y_obs}, 1, STEPS, LR,
                restarts=2, anneal=True),
            "served_unroll": predictor(y_obs),
            "served_tol": predictor(y_obs[:TOL]),
        }

    return _np(params), train, y_obs, _np(jax.jit(program)(params))


def _carried():
    params, train, y_obs, want = _reference()
    tp = params_from_jax(params, "cpu", torch.float64)
    return (tp, [torch.tensor(y) for y in train], torch.tensor(y_obs), want,
            mrd.Config(num_latent=3, num_inducing=8, num_views=2))


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def test_mrd_posterior_caches_match_reference():
    tp, train, _, want, cfg = _carried()
    caches = prediction.mrd_posterior(tp, train, cfg)
    assert len(caches) == 2
    for cache, ref in zip(caches, want["caches"]):
        for k, v in cache._asdict().items():
            _close(v, ref[k], 1e-8, k)


def test_per_point_objective_sums_to_the_joint():
    """q(x*) factorizes per test point: the per-point expected
    log-likelihood rows sum to the joint value the optimizer uses, and
    equal the reference's."""
    tp, train, y_obs, want, cfg = _carried()
    caches = prediction.mrd_posterior(tp, train, cfg)
    m0 = prediction.init_latent_from_nearest(
        tp["qx_mean"].detach(), train[0], y_obs, torch.ones_like(y_obs))
    _close(m0, want["m0"], 1e-12)
    s0 = 0.1 * torch.ones_like(m0)
    y, mask = train[1][:UNROLL], torch.ones_like(train[1][:UNROLL])
    per_point = prediction._expected_loglik_per_point(caches[1], y, mask,
                                                      m0, s0)
    assert per_point.shape == (UNROLL,)
    _close(per_point, want["ell_per_point"], 1e-10)
    joint = prediction._expected_loglik(caches[1], y, mask, m0, s0)
    _close(torch.sum(per_point), float(joint), 1e-12)
    objective = prediction._per_point_objective(caches, [(1, y)], m0, s0,
                                                "ard_rbf")
    kl = 0.5 * torch.sum(m0 * m0 + s0 - torch.log(s0) - 1.0, dim=-1)
    _close(objective, (per_point - kl).numpy(), 1e-12)


def test_mrd_infer_latent_matches_reference():
    tp, train, y_obs, want, cfg = _carried()
    caches = prediction.mrd_posterior(tp, train, cfg)
    m0 = torch.tensor(want["m0"])
    got = prediction.mrd_infer_latent(caches, {0: y_obs}, m0, STEPS, LR)
    for g, w, name in zip(got, want["infer"], ("m", "s", "trace")):
        _close(g, w, RTOL, name)


def test_restarts_choose_the_references_restart_per_point():
    """Each point keeps the restart with the best test-time ELBO; the one
    the reference kept is the one the port keeps."""
    tp, train, y_obs, want, cfg = _carried()
    caches = prediction.mrd_posterior(tp, train, cfg)
    ones = torch.ones_like(y_obs)
    knn = prediction.init_latent_knn(tp["qx_mean"].detach(), train[0], y_obs,
                                     ones, 2)
    _close(knn, want["knn"], 1e-12)
    m_inits = torch.cat([knn, torch.zeros_like(knn[:1])], dim=0)
    got = prediction.mrd_infer_latent_restarts(caches, {0: y_obs}, m_inits,
                                               STEPS, LR)
    for g, w, name in zip(got, want["restarts"], ("m", "s", "objective")):
        _close(g, w, RTOL, name)
    # the chosen restart per point, recomputed restart by restart
    fits = [prediction.mrd_infer_latent(caches, {0: y_obs}, m_inits[k],
                                        STEPS, LR) for k in range(3)]
    objs = torch.stack([prediction._per_point_objective(
        caches, [(0, y_obs)], m, s, "ard_rbf") for m, s, _ in fits])
    chosen = torch.argmax(objs, dim=0).numpy()
    ref_m = want["restarts"][0]
    nearest = np.argmin([np.abs(m.numpy() - ref_m).max(axis=1)
                         for m, _, _ in fits], axis=0)
    np.testing.assert_array_equal(chosen, nearest)
    assert len(set(chosen.tolist())) > 1     # the choice is per point


@pytest.mark.parametrize("restarts", [0, 2])
def test_predict_view_from_views_matches_reference(restarts):
    tp, train, y_obs, want, cfg = _carried()
    got = prediction.predict_view_from_views(
        tp, train, cfg, {0: y_obs}, 1, STEPS, LR, restarts=restarts,
        anneal=bool(restarts))
    ref = want["predict_restarts" if restarts else "predict"]
    assert got[0].shape == (UNROLL, 4)
    for g, w, name in zip(got, ref, ("mean", "var", "m", "s", "trace")):
        _close(g, w, RTOL, name)


@pytest.mark.parametrize("batch", [TOL, UNROLL], ids=["tol", "unroll"])
def test_cross_view_predictor_matches_reference(batch):
    """tol="auto": early stopping at a batch of at most TOL_MAX_BATCH, the
    fixed unroll above it."""
    assert (batch <= serving.TOL_MAX_BATCH) == (batch == TOL)
    tp, train, y_obs, want, cfg = _carried()
    predict = serving.make_mrd_cross_view_predictor(
        tp, train, cfg, observed_view=0, target_view=1, num_steps=STEPS,
        device="cpu")
    mean, var = predict(y_obs[:batch])
    ref = want["served_tol" if batch == TOL else "served_unroll"]
    _close(mean, ref[0], RTOL, "mean")
    _close(var, ref[1], RTOL, "var")
    assert bool((var > 0).all())


def test_cross_view_predictor_defaults_to_the_card():
    tp, train, _, _, cfg = _carried()
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.make_mrd_cross_view_predictor(tp, train, cfg, 0, 1)
