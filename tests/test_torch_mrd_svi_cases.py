"""The reference's `tests/test_mrd_svi.py` cases on the port's minibatch
MRD (`models/mrd_svi.py`), in float64 on the CPU, without JAX: one view
reduces to `svi_gplvm.elbo`; at the optimal q(u^v) the bound is the
collapsed `mrd.elbo`; a disjoint partition's minibatch estimates average
to the full bound; a rho = 1 full-batch step lands on the optimum;
training raises the bound; cross-view prediction beats the mean; the
streamed step is the resident step; the predictor answers as the
pipeline; the amortized init is the resident one and trains; sampled
cross-view moments match the predictive; on a one-rank mesh the streamed
step is the unsharded one. The reference's three mesh cases run on four
ranks in `tests/test_torch_parallel_svi.py`."""
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import (
    mrd,
    mrd_svi,
    sampling,
    serving,
    svi_gplvm,
)
from dp_gp_lvm_tpu_torch.train.loop import flat_leaves, gp_optimizer

FROZEN = frozenset({"qx_mean", "raw_qx_var", "z", "raw_variance", "raw_ard",
                    "raw_noise"})


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(n=48, d1=5, d2=7, q=3, m=8, batch=16, **kw):
    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(0), n=n, d1=d1, d2=d2,
                                   q_shared=1, q_private=1, device="cpu")
    cfg = mrd_svi.Config(num_latent=q, num_inducing=m, num_views=2,
                         batch=batch, **kw)
    return (Y1, Y2), cfg, mrd_svi.init_params(prng.PRNGKey(1), (Y1, Y2), cfg)


def _elbo(params, Ys, cfg):
    with torch.no_grad():
        return float(mrd_svi.elbo(params, Ys, cfg))


def _collapsed_elbo(params, Ys, cfg):
    mcfg = mrd.Config(num_latent=cfg.num_latent,
                      num_inducing=cfg.num_inducing, num_views=cfg.num_views)
    mparams = {"qx_mean": params["qx_mean"],
               "raw_qx_var": params["raw_qx_var"],
               "views": [{k: vp[k] for k in ("z", "raw_variance", "raw_ard",
                                             "raw_noise")}
                         for vp in params["views"]]}
    with torch.no_grad():
        return float(mrd.elbo(mparams, Ys, mcfg))


def _train(step, Ys, steps, seed):
    """`steps` steps, step i on the rows its key draws: the reference's
    split chain rng, sub = split(rng)."""
    key = prng.PRNGKey(seed)
    for t in range(steps):
        key, sub = prng.split(key)
        step(t, step.indices(sub[None])[0], Ys)


def test_single_view_reduces_to_svi_gplvm():
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(0), n=40, d=6, q_true=2,
                               q_total=3, device="cpu")
    cfg = mrd_svi.Config(num_latent=3, num_inducing=8, num_views=1)
    params = mrd_svi.init_params(prng.PRNGKey(1), (Y,), cfg)
    with torch.no_grad():
        b = float(svi_gplvm.elbo(mrd_svi._view_params(params, 0), Y,
                                 svi_gplvm.Config(num_latent=3,
                                                  num_inducing=8)))
    np.testing.assert_allclose(_elbo(params, (Y,), cfg), b, rtol=1e-12)


def test_optimal_qu_recovers_collapsed_mrd():
    Ys, cfg, p0 = _setup()
    with torch.no_grad():
        params = mrd_svi.set_optimal_qu(p0, Ys, cfg)
    collapsed = _collapsed_elbo(params, Ys, cfg)
    np.testing.assert_allclose(_elbo(params, Ys, cfg), collapsed, rtol=1e-6)
    # q(u) at the prior: a valid bound, strictly below
    assert _elbo(p0, Ys, cfg) < collapsed - 1.0


def test_minibatch_partition_averages_to_full_bound():
    Ys, cfg, params = _setup(n=48, batch=16)
    with torch.no_grad():
        params = mrd_svi.set_optimal_qu(params, Ys, cfg)
        n, b = Ys[0].shape[0], cfg.batch
        ests = [float(mrd_svi.elbo_minibatch(
            params, [Y[s:s + b] for Y in Ys], torch.arange(s, s + b), n,
            cfg)) for s in range(0, n, b)]
    np.testing.assert_allclose(np.mean(ests), _elbo(params, Ys, cfg),
                               rtol=1e-10)


def test_natgrad_full_batch_rho1_lands_on_optimum():
    """One rho = 1 step on every row with every other leaf frozen: the
    step's own blend must land each view on its collapsed optimum."""
    Ys, cfg, params = _setup(n=48, batch=48)
    n = Ys[0].shape[0]
    opt = gp_optimizer(params, lr=0.0, freeze=FROZEN)
    step = mrd_svi.make_svi_natgrad_step(
        cfg, n, opt, rho=1.0, sample_idx=lambda key: torch.arange(n))
    step(0, step.indices(prng.PRNGKey(0)[None])[0], Ys)
    np.testing.assert_allclose(_elbo(params, Ys, cfg),
                               _collapsed_elbo(params, Ys, cfg), rtol=1e-6)


def test_svi_training_improves_full_elbo():
    Ys, cfg, params = _setup()
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    step = mrd_svi.make_svi_natgrad_step(cfg, Ys[0].shape[0], opt, rho=0.2)
    e0 = _elbo(params, Ys, cfg)
    _train(step, Ys, 150, 3)
    e1 = _elbo(params, Ys, cfg)
    assert np.isfinite(e1) and e1 > e0 + 1.0, (e0, e1)
    assert mrd_svi.ard_relevance(params).shape == (2, cfg.num_latent)


def test_cross_view_prediction_beats_mean_baseline():
    """Full-batch training at rho = 1 (each blend lands on the batch
    optimum), then view 1 of held-out rows predicts view 2 better than
    the training mean does."""
    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(31), n=60, d1=6, d2=6,
                                   q_shared=2, q_private=1, noise=0.01,
                                   device="cpu")
    n_tr = 48
    Ys_tr = [Y1[:n_tr], Y2[:n_tr]]
    cfg = mrd_svi.Config(num_latent=4, num_inducing=12, num_views=2,
                         batch=n_tr)
    params = mrd_svi.init_params(prng.PRNGKey(32), Ys_tr, cfg)
    opt = gp_optimizer(params, lr=2e-2)
    step = mrd_svi.make_svi_natgrad_step(cfg, n_tr, opt, rho=1.0)
    _train(step, Ys_tr, 600, 5)
    mean, var, *_ = mrd_svi.cross_view_predict(params, {0: Y1[n_tr:]}, 1,
                                               cfg, num_steps=150)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    mse = float(torch.mean((mean - Y2[n_tr:]) ** 2))
    base = float(torch.mean((Y2[n_tr:] - Y2[:n_tr].mean(dim=0)) ** 2))
    assert mse < base, (mse, base)


def test_streaming_step_matches_resident():
    """The host-fed (idx, concatenated rows) step equals the resident step
    at the same rows, to the bit."""
    Ys, cfg, p1 = _setup()
    _, _, p2 = _setup()
    cfg_s = cfg._replace(view_dims=tuple(Y.shape[1] for Y in Ys))
    n = Ys[0].shape[0]
    idx = torch.arange(4, 20)
    res = mrd_svi.make_svi_natgrad_step(cfg, n, gp_optimizer(p1, lr=2e-2),
                                        rho=0.3)
    st = mrd_svi.make_svi_natgrad_step(cfg_s, n, gp_optimizer(p2, lr=2e-2),
                                       rho=0.3, streaming=True)
    a = res(0, idx, Ys)
    b = st(0, (idx, torch.cat([Y[idx] for Y in Ys], dim=1)))
    assert torch.equal(a, b)
    for (k, x), y in zip(flat_leaves(p1).items(), flat_leaves(p2).values()):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match="view_dims"):
        mrd_svi.make_svi_natgrad_step(cfg, n, gp_optimizer(p1, lr=2e-2),
                                      streaming=True)
    # on a one-rank mesh (a gloo group of one, as the card's NCCL group of
    # one) the streamed step is the unsharded one, to the bit
    from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
    from dp_gp_lvm_tpu_torch.parallel.recipe import place_svi

    mesh = mesh_lib.make_mesh(1, 1, "cpu")
    try:
        p3, _, table = place_svi("mrd_svi", _setup()[2], Ys, mesh)
        on_mesh = mrd_svi.make_svi_natgrad_step(
            cfg_s, n, gp_optimizer(p3, lr=2e-2, mesh=mesh, placement=table),
            rho=0.3, streaming=True, mesh=mesh)
        c = on_mesh(0, (idx, torch.cat([Y[idx] for Y in Ys], dim=1)))
    finally:
        mesh_lib.close_distributed()
    assert torch.equal(a, c)
    for (k, x), y in zip(flat_leaves(p1).items(), flat_leaves(p3).values()):
        assert torch.equal(x, y), k


def test_serving_predictor_matches_pipeline():
    """The build-once predictor answers as the one-shot pipeline, with no
    training data in its closure."""
    Ys, cfg, params = _setup()
    with torch.no_grad():
        params = mrd_svi.set_optimal_qu(params, Ys, cfg)
    y_obs = Ys[0][:8]
    mean_ref, var_ref, *_ = mrd_svi.cross_view_predict(
        params, {0: y_obs}, 1, cfg, num_steps=50)
    predictor = serving.make_mrd_svi_predictor(
        params, cfg, observed_view=0, target_view=1, num_steps=50, tol=None,
        device="cpu")
    mean, var = predictor(y_obs)
    np.testing.assert_allclose(mean.numpy(), mean_ref.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(var.numpy(), var_ref.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_amortized_init_equality_and_training():
    """The encoder over the concatenated views starts at the resident
    init (equal bounds), trains finitely, and serves in one pass."""
    Ys, _, _ = _setup()
    cfg_r = mrd_svi.Config(num_latent=3, num_inducing=8, num_views=2,
                           batch=16)
    cfg_a = cfg_r._replace(amortized=True, encoder_hidden=8)
    p_r = mrd_svi.init_params(prng.PRNGKey(1), Ys, cfg_r)
    p_a = mrd_svi.init_params(prng.PRNGKey(1), Ys, cfg_a)
    e_a = _elbo(p_a, Ys, cfg_a)
    np.testing.assert_allclose(e_a, _elbo(p_r, Ys, cfg_r), rtol=1e-10)
    step = mrd_svi.make_svi_natgrad_step(cfg_a, Ys[0].shape[0],
                                         gp_optimizer(p_a, lr=2e-2), rho=0.2)
    _train(step, Ys, 100, 7)
    e1 = _elbo(p_a, Ys, cfg_a)
    assert np.isfinite(e1) and e1 > e_a, (e_a, e1)
    mean, var, *_ = mrd_svi.cross_view_predict(p_a, {0: Ys[0][:8]}, 1,
                                               cfg_a, num_steps=50)
    assert mean.shape == (8, Ys[1].shape[1])
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


def test_cross_view_sample_moments_match_predictive():
    """Generative cross-view draws with the latent uncertainty carried
    through: their mean and variance approach `cross_view_predict`'s mean
    and variance less the noise; with the same latent in every sample,
    the latent-draw evaluation is `sample_at`. 500 draws of 512 features
    (the reference: 4000 of 4096): the port draws on the host at ~250
    bytes a draw."""
    Ys, cfg, params = _setup()
    with torch.no_grad():
        params = mrd_svi.set_optimal_qu(params, Ys, cfg)
    y_obs = Ys[0][:6]
    s = 500
    f = mrd_svi.cross_view_sample(prng.PRNGKey(9), params, {0: y_obs}, 1,
                                  cfg, num_samples=s, num_steps=80,
                                  num_features=512, device="cpu").numpy()
    assert f.shape == (s, 6, Ys[1].shape[1])
    mean, var, m_s, _, _ = mrd_svi.cross_view_predict(
        params, {0: y_obs}, 1, cfg, num_steps=80)
    with torch.no_grad():
        c1 = svi_gplvm.constrain(mrd_svi._view_params(params, 1))
    fvar = np.maximum(var.numpy() - float(c1["noise"]), 0.0)
    scale = float(torch.sqrt(c1["variance"]))
    assert np.max(np.abs(f.mean(0) - mean.numpy())) < 0.15 * scale
    assert np.max(np.abs(np.sqrt(f.var(0)) - np.sqrt(fvar))) < 0.15 * scale

    smp = sampling.make_svi_pathwise_sampler(
        prng.PRNGKey(1), mrd_svi._view_params(params, 1),
        mrd_svi._svi_config(cfg), 16, num_features=512)
    x0 = m_s[:4]
    np.testing.assert_allclose(
        sampling.sample_at(smp, x0).numpy(),
        sampling.sample_at_latent_draws(
            smp, x0[None].expand(16, *x0.shape)).numpy(),
        rtol=1e-12, atol=1e-12)
