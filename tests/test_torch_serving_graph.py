"""The servers' device-state latent inference on the CPU in float64.

`prediction.VariationalFit` (through `_fit_variational`) against the
reference's jitted scan on one objective: early stopping that converges
inside a chunk of `prediction.TOL_CHUNK` steps, early stopping that never
converges within its cap, the fixed unroll and the annealed rate. Then
each of the six serving factories, at batch 1 (early stopping, except
the encoder imputer's fixed refinement) and batch 8 (the fixed unroll),
answers under the host-read guard of `tests/torch_sync_guard.py`: no read
in the fixed unroll, one read of the converged flag a chunk in early
stopping; and each answer is the one the eager one-shot functions give
(`infer_latent` and the predictive), to the bit."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.models import prediction as jpred
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import (
    amortized,
    bgplvm,
    dp_gp_lvm,
    dp_svi,
    mrd,
    mrd_svi,
    prediction,
    serving,
    svi_gplvm,
)
from torch_sync_guard import guarded

TOL = 1e-10
LR = 0.05
# (tol, num_steps, anneal) of each fit; the "converges" case stops inside
# a chunk, the "capped" one runs into its cap
FITS = {"converges": (1e-6, 300, False), "capped": (1e-14, 47, False),
        "unroll": (None, 60, False), "anneal": (None, 60, True)}
A = np.array([[0.7, -1.2], [0.3, 2.0], [-0.4, 0.9]])
START_M = np.array([[0.1, 0.2], [-0.3, 0.0], [0.5, -0.5]])


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _objective(xp):
    """One smooth objective of (m, raw_s) in either package: a quartic
    well around A plus the KL-like term of the variances."""
    def objective(vp):
        m, a = vp["m"], xp.asarray(A)
        s = xp.logaddexp(vp["raw_s"], 0.0 * vp["raw_s"])
        return xp.sum(0.5 * (m - a) ** 2 + 0.05 * m ** 4) + xp.sum(
            0.5 * (s - xp.log(s)))
    return objective


class _T:
    """The torch names `_objective` uses."""
    asarray, logaddexp = torch.as_tensor, torch.logaddexp
    sum, log = torch.sum, torch.log


def _start(xp):
    return {"m": xp.asarray(START_M), "raw_s": xp.full((3, 2), -1.5)}


@pytest.fixture(scope="module")
def jax_fits():
    """Every case of the reference's `_fit_variational`, jitted once."""
    @jax.jit
    def fits(start):
        return {name: jpred._fit_variational(_objective(jnp), start, steps,
                                             LR, tol, anneal=anneal)
                for name, (tol, steps, anneal) in FITS.items()}

    return jax.tree_util.tree_map(np.asarray, fits(_start(jnp)))


@pytest.mark.parametrize("name", list(FITS))
def test_device_state_fit_matches_the_reference(jax_fits, name):
    tol, steps, anneal = FITS[name]
    start = {k: torch.as_tensor(np.asarray(v, dtype=np.float64))
             for k, v in _start(np).items()}
    vp, trace, k = prediction._fit_variational(_objective(_T), start, steps,
                                               LR, tol, anneal=anneal)
    want_vp, want_trace, want_k = jax_fits[name]
    assert int(k) == int(want_k)
    for key in ("m", "raw_s"):
        np.testing.assert_allclose(vp[key].numpy(), want_vp[key], rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(trace.numpy(), want_trace, rtol=TOL, atol=TOL)
    if name == "converges":
        assert int(k) % prediction.TOL_CHUNK != 0 and int(k) < steps
    if name == "capped":
        assert int(k) == steps and steps % prediction.TOL_CHUNK != 0


def test_a_fit_reloaded_repeats_its_first_run():
    """A second load of the same start runs the same fit to the bit: the
    carry is reset, not continued."""
    fit = prediction.VariationalFit(_objective(_T), 300, LR, tol=1e-6)
    runs = []
    for _ in range(2):
        fit.load({k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                  for k, v in _start(np).items()})
        fit.run()
        runs.append((fit.vp["m"].detach().clone(), fit.trace.clone(),
                     int(fit.k)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2]


# ---------------------------------------------------------------------------
# the six factories under the guard
# ---------------------------------------------------------------------------

N, D, Q, M, T = 40, 6, 2, 5, 3
STEPS = 12
BATCHES = (1, 8)


def _case(seed, dp):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N, Q))
    Y = np.sin(x @ r.normal(size=(Q, D))) + 0.1 * r.normal(size=(N, D))
    atoms = (T,) if dp else ()
    params = dict(
        qx_mean=x + 0.1 * r.normal(size=(N, Q)),
        raw_qx_var=r.normal(size=(N, Q)) - 2.0,
        z=r.normal(size=atoms + (M, Q)),
        raw_variance=r.normal(size=atoms) * 0.3 + 0.4,
        raw_ard=r.normal(size=atoms + (Q,)) * 0.3,
        raw_noise=r.normal(size=atoms) * 0.2 - 2.0)
    if dp:
        params.update(phi_logits=r.normal(size=(D, T)),
                      raw_gamma1=r.normal(size=T - 1),
                      raw_gamma2=r.normal(size=T - 1))
    return params_from_jax(params, "cpu"), torch.tensor(Y)


def _bgplvm():
    params, Y = _case(31, dp=False)
    cfg = bgplvm.Config(num_latent=Q, num_inducing=M)
    cache = prediction.bgplvm_posterior(params, Y, cfg)

    def reference(y, mask, steps, tol):
        m0 = prediction.init_latent_from_nearest(params["qx_mean"], Y, y,
                                                 mask)
        m, s, _ = prediction.infer_latent(cache, y, mask, m0, steps, LR,
                                          tol=tol)
        return prediction.predict_from_latent(cache, m, s)

    return serving.make_bgplvm_imputer(params, Y, cfg, STEPS,
                                       device="cpu"), reference


def _dp():
    params, Y = _case(32, dp=True)
    cfg = dp_gp_lvm.Config(num_latent=Q, num_inducing=M, truncation=T)
    caches, phi = prediction.dp_posterior(params, Y, cfg)

    def reference(y, mask, steps, tol):
        m0 = prediction.init_latent_from_nearest(params["qx_mean"], Y, y,
                                                 mask)
        m, s, _ = prediction.dp_infer_latent(caches, phi, y, mask, m0, steps,
                                             LR, tol=tol)
        return prediction.dp_predict_from_latent(caches, phi, m, s)

    return serving.make_dp_imputer(params, Y, cfg, STEPS,
                                   device="cpu"), reference


def _mocap():
    return synthetic.mocap_like(prng.PRNGKey(0), n=N, d=D, device="cpu")[0]


def _dp_svi():
    Y = _mocap()
    cfg = dp_svi.Config(num_latent=Q, num_inducing=M, truncation=T, batch=16)
    params = dp_svi.init_params(prng.PRNGKey(1), Y, cfg)
    pred = dp_svi._predictive(params, cfg)
    cands = dp_svi._candidates(pred)

    def reference(y, mask, steps, tol):
        m0 = dp_svi._nearest(cands, y, mask, pred.c)
        m, s, _ = dp_svi._infer(pred, y, mask, m0, steps, LR, tol)
        return dp_svi._mixture(pred, m, s)

    return serving.make_dp_svi_imputer(params, cfg, STEPS,
                                       device="cpu"), reference


def _encoder(refine):
    Y = _mocap()
    cfg = svi_gplvm.Config(num_latent=Q, num_inducing=M, batch=16,
                           amortized=True, encoder_hidden=4,
                           qx_var_floor=1e-3)
    params = svi_gplvm.init_params(prng.PRNGKey(1), Y, cfg)
    enc = amortized.encoder_leaves(params)
    c = svi_gplvm._detached(params, cfg)
    L = svi_gplvm._kuu_factor(c, cfg, JitterPolicy())

    def reference(y, mask, steps, tol):
        y_fill = torch.where(mask > 0, y, enc["enc_mean"][None, :])
        m, s = amortized.encode(enc, y_fill)
        if refine:
            m, s, _ = svi_gplvm._infer(c, L, y, mask, m, cfg, refine, LR,
                                       None)
        return svi_gplvm._predict(c, L, m, s, cfg)

    return serving.make_encoder_imputer(
        params, cfg, refine_steps=refine, device="cpu"), reference


def _two_view():
    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(0), n=N, d1=4, d2=D,
                                   device="cpu")
    return Y1, Y2


def _mrd():
    Ys = _two_view()
    cfg = mrd.Config(num_latent=Q, num_inducing=M, num_views=2)
    params = mrd.init_params(prng.PRNGKey(9), Ys, cfg)
    caches = prediction.mrd_posterior(params, Ys, cfg)
    qx = params["qx_mean"].detach()

    def reference(y, mask, steps, tol):
        m0 = prediction.init_latent_from_nearest(qx, Ys[0], y,
                                                 torch.ones_like(y))
        m, s, _ = prediction.mrd_infer_latent(caches, {0: y}, m0, steps, LR,
                                              tol=tol)
        return prediction.predict_from_latent(caches[1], m, s)

    return serving.make_mrd_cross_view_predictor(
        params, list(Ys), cfg, 0, 1, STEPS, device="cpu"), reference


def _mrd_svi():
    Ys = _two_view()
    cfg = mrd_svi.Config(num_latent=Q, num_inducing=M, num_views=2, batch=16)
    params = mrd_svi.init_params(prng.PRNGKey(1), Ys, cfg)
    policy = mrd_svi._policy(cfg, None)
    obs = mrd_svi._view_cache(params, 0, cfg, policy)
    c_t, L_t = mrd_svi._view_cache(params, 1, cfg, policy)

    def reference(y, mask, steps, tol):
        m0 = mrd_svi._latent_init(params, {0: y}, cfg)
        m, s, _ = mrd_svi._infer([(obs, y)], m0, cfg, steps, LR, tol)
        return svi_gplvm._predict(c_t, L_t, m, s, mrd_svi._svi_config(cfg))

    return serving.make_mrd_svi_predictor(params, cfg, 0, 1, STEPS,
                                          device="cpu"), reference


FACTORIES = {"bgplvm": _bgplvm, "dp": _dp, "dp_svi": _dp_svi,
             "encoder_refined": lambda: _encoder(4),
             "encoder": lambda: _encoder(0), "mrd": _mrd,
             "mrd_svi": _mrd_svi}
CROSS_VIEW = {"mrd", "mrd_svi"}


def _request(name, batch, seed):
    r = np.random.default_rng(seed)
    if name in CROSS_VIEW:
        y = torch.tensor(r.normal(size=(batch, 4)))
        return (y,), torch.ones_like(y)
    y = torch.tensor(r.normal(size=(batch, D)))
    mask = torch.ones_like(y)
    mask[:, D // 2:] = 0.0
    return (y, mask), mask


@pytest.mark.parametrize("name", list(FACTORIES))
def test_a_request_reads_the_host_once_a_chunk_at_most(name):
    serve, reference = FACTORIES[name]()
    # batch 1, then two of batch 8 (the second at a shape built before)
    for seed, batch in enumerate((1, 8, 8)):
        args, mask = _request(name, batch, seed)
        reads = []
        with torch.no_grad(), guarded(reads):
            mean, var = serve(*args)
        shape = serve.shapes[batch]
        tol, steps = (None, None) if name.startswith("encoder") else \
            serving._resolve("auto", STEPS, batch)
        if tol is None:
            assert reads == []
        else:
            k = int(shape.fit.k)
            chunks = math.ceil(k / prediction.TOL_CHUNK)
            assert reads == ["host read: __bool__",
                             "syncing op: aten._local_scalar_dense."
                             "default"] * chunks, (k, reads)
        want = reference(args[0], mask, steps, tol)
        assert torch.equal(mean, want[0]) and torch.equal(var, want[1])
    assert sorted(serve.shapes) == list(BATCHES)


def test_answers_are_not_overwritten_by_the_next_request():
    serve, _ = _bgplvm()
    args, _ = _request("bgplvm", 8, 0)
    first = serve(*args)
    kept = [t.clone() for t in first]
    serve(*_request("bgplvm", 8, 1)[0])
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


def test_a_request_of_another_width_is_refused():
    serve, _ = _bgplvm()
    serve(*_request("bgplvm", 8, 0)[0])
    with pytest.raises(ValueError):
        serve(torch.zeros(8, D - 1), torch.ones(8, D - 1))


def test_a_request_in_another_dtype_than_the_model_is_served():
    """An f64 model answers an f32 request (its rows mix into the f64
    objective) as the eager one-shot functions do."""
    serve, reference = _bgplvm()
    args, mask = _request("bgplvm", 8, 0)
    args = tuple(a.float() for a in args)
    mean, var = serve(*args)
    want = reference(args[0], args[1], STEPS, None)
    np.testing.assert_allclose(mean.numpy(), want[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert bool(torch.isfinite(var).all())
