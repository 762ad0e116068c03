"""The reference's `tests/test_dp_svi.py` cases that need no device mesh
and no amortized q(X), and the DP-SVI cases of its `tests/test_stream.py`,
run on the port's minibatch DP-GP-LVM (`models/dp_svi.py`) in float64 on
the CPU, as cases of one parametrised test: the collapsed-bound identity at
the optimal q(u | t) (against the port's `dp_gp_lvm.elbo`), the bound below
it elsewhere, T = 1 against `svi_gplvm`, the minibatch partition, the
rho = 1 step (its rows drawn by `sample_idx`), the per-dim free
energies, training that recovers the planted groups, the learned
alpha, `_lam_cholesky`'s repairs, the residual ladder, prediction at T = 1
and at one-hot phi, imputation, the serving imputer, and the streamed step
against the resident one. The port's random stream is the reference's
(`core/prng.py`), so each case runs on the reference's own data, init and
minibatches. The reference's mesh cases run on four ranks in
`tests/test_torch_parallel_svi.py`. No JAX is imported here."""
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import positive_noise
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm, dp_svi, serving, svi_gplvm
from dp_gp_lvm_tpu_torch.train.loop import (
    TrainState,
    gp_optimizer,
    make_streaming_scan_fn,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _collapsed_elbo(params, Y, dcfg):
    keep = {k: v for k, v in params.items() if k not in ("u_h", "u_lam")}
    with torch.no_grad():
        return float(dp_gp_lvm.elbo(keep, Y, dcfg))


def _elbo(params, Y, cfg):
    with torch.no_grad():
        return float(dp_svi.elbo(params, Y, cfg))


def _setup(n=40, dims=(4, 4), q=2, m=8, t=3, **kw):
    Y, labels, _ = synthetic.grouped_dims(prng.PRNGKey(3), n=n,
                                          dims_per_group=dims, q=q,
                                          noise=0.01, device="cpu")
    cfg = dp_svi.Config(num_latent=q, num_inducing=m, truncation=t,
                        batch=16, **kw)
    params = dp_svi.init_params(prng.PRNGKey(1), Y, cfg)
    dcfg = dp_gp_lvm.Config(num_latent=q, num_inducing=m, truncation=t,
                            **kw)
    return Y, labels, cfg, dcfg, params


def _train(step, Y, key, steps):
    """`steps` steps, each on the next key of the chain key, sub =
    split(key), as the reference's tests loop."""
    for t in range(steps):
        key, sub = prng.split(key)
        step(t, step.indices(sub[None])[0], Y)


def case_optimal_qu_recovers_collapsed_dp_bound():
    Y, _, cfg, dcfg, params = _setup()
    params = dp_svi.set_optimal_qu(params, Y, cfg)
    np.testing.assert_allclose(_elbo(params, Y, cfg),
                               _collapsed_elbo(params, Y, dcfg), rtol=1e-6)


def case_optimal_qu_oracle_with_hyperprior_and_alpha():
    Y, _, cfg, dcfg, params = _setup(hyperprior_std=1.0, learn_alpha=True)
    assert "raw_alpha" in params
    params = dp_svi.set_optimal_qu(params, Y, cfg)
    np.testing.assert_allclose(_elbo(params, Y, cfg),
                               _collapsed_elbo(params, Y, dcfg), rtol=1e-6)


def case_free_energies_at_optimal_qu_are_the_collapsed_ones():
    """The per-atom per-dim free energies at the optimal q(u | t) are the
    collapsed model's per-dim bounds F_dt (the module's identity, term by
    term), to the 1e-6 relative jitter the collapsed bound puts on
    I + beta A2 and the optimal Lambda does not."""
    Y, _, cfg, dcfg, params = _setup()
    params = dp_svi.set_optimal_qu(params, Y, cfg)
    with torch.no_grad():
        c = dp_svi.constrain(params, cfg)
        stats = dp_svi._batch_stats(c, c["qx_mean"], c["qx_var"], Y, cfg)
        f_td = dp_svi.per_dim_free_energy(c, stats, cfg)
        collapsed = dp_gp_lvm.per_dim_atom_bound(
            dp_gp_lvm.constrain(params), Y, dcfg)
    np.testing.assert_allclose(f_td.numpy(), collapsed.numpy(), rtol=5e-6)


def case_suboptimal_qu_is_below_collapsed_bound():
    Y, _, cfg, dcfg, params = _setup()
    collapsed = _collapsed_elbo(params, Y, dcfg)
    below = _elbo(params, Y, cfg)            # the prior q(u | t)
    assert below < collapsed - 1.0, (below, collapsed)
    p2 = dp_svi.set_optimal_qu(params, Y, cfg)
    p2 = {**p2, "u_h": p2["u_h"] + 0.1}
    below2 = _elbo(p2, Y, cfg)
    assert below2 < collapsed, (below2, collapsed)


def _t1_pair():
    """A T = 1 DP-SVI model with the SVI-GPLVM's parameters."""
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(0), n=30, d=5, q_true=2,
                               device="cpu")
    scfg = svi_gplvm.Config(num_latent=2, num_inducing=8, batch=10)
    sparams = svi_gplvm.init_params(prng.PRNGKey(1), Y, scfg)
    dcfg = dp_svi.Config(num_latent=2, num_inducing=8, truncation=1,
                         batch=10)
    dparams = dp_svi.init_params(prng.PRNGKey(1), Y, dcfg)
    for k in ("qx_mean", "raw_qx_var"):
        dparams[k] = sparams[k]
    for k in ("z", "raw_variance", "raw_ard", "raw_noise"):
        dparams[k] = torch.nn.Parameter(sparams[k].detach()[None])
    return Y, scfg, sparams, dcfg, dparams


def case_t1_reduces_to_svi_gplvm():
    Y, scfg, sparams, dcfg, dparams = _t1_pair()
    with torch.no_grad():
        s_elbo = float(svi_gplvm.elbo(sparams, Y, scfg))
        s_opt = float(svi_gplvm.elbo(svi_gplvm.set_optimal_qu(sparams, Y,
                                                              scfg), Y, scfg))
    np.testing.assert_allclose(_elbo(dparams, Y, dcfg), s_elbo, rtol=1e-8)
    np.testing.assert_allclose(
        _elbo(dp_svi.set_optimal_qu(dparams, Y, dcfg), Y, dcfg), s_opt,
        rtol=1e-7)


def case_minibatch_partition_averages_to_full_bound():
    Y, _, cfg, _, params = _setup(n=48)
    params = dp_svi.set_optimal_qu(params, Y, cfg)
    full = _elbo(params, Y, cfg)
    ests = []
    with torch.no_grad():
        for start in range(0, Y.shape[0], cfg.batch):
            idx = torch.arange(start, start + cfg.batch)
            ests.append(float(dp_svi.elbo_minibatch(params, Y[idx], idx,
                                                    Y.shape[0], cfg)))
    np.testing.assert_allclose(np.mean(ests), full, rtol=1e-9)


def _rho1_lands_on_collapsed(blend_at):
    """rho = 1 on the exact full batch: the post-step q(u | t) is optimal
    for the parameters it was blended at (zero rates for "grad", so that
    those are the post-step parameters too)."""
    Y, _, cfg, dcfg, params = _setup(n=32)
    cfg = cfg._replace(batch=32)
    lr = 1e-3 if blend_at == "updated" else 0.0
    opt = gp_optimizer(params, lr=lr, hyper_lr=lr / 10 if lr else 0.0)
    step = dp_svi.make_dp_svi_step(cfg, 32, opt, rho=1.0, rho_phi=0.3,
                                   blend_at=blend_at,
                                   sample_idx=lambda key: torch.arange(32))
    step(0, step.indices(prng.PRNGKey(0)[None])[0], Y)
    np.testing.assert_allclose(_elbo(params, Y, cfg),
                               _collapsed_elbo(params, Y, dcfg), rtol=1e-5)


def case_step_rho1_full_batch_lands_on_collapsed_updated():
    _rho1_lands_on_collapsed("updated")


def case_step_rho1_full_batch_lands_on_collapsed_grad():
    _rho1_lands_on_collapsed("grad")


def case_training_improves_and_recovers_groups():
    Y, labels, cfg, _, params = _setup(n=48, dims=(5, 5), t=4, m=10)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    step = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt, rho=0.3,
                                   rho_phi=0.1)
    e0 = _elbo(params, Y, cfg)
    _train(step, Y, prng.PRNGKey(7), 300)
    e1 = _elbo(params, Y, cfg)
    assert np.isfinite(e1) and e1 > e0 + 10.0, (e0, e1)
    phi = dp_svi.expected_assignments(params).detach().numpy()
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, rtol=1e-5)
    hard = phi.argmax(axis=1)
    labels = labels.numpy()
    for g in (0, 1):
        purity = max((hard[labels == g] == a).mean() for a in np.unique(hard))
        assert purity > 0.7, (g, hard)


def case_learnable_alpha_step_stays_finite():
    Y, _, cfg, _, params = _setup(learn_alpha=True)
    opt = gp_optimizer(params, lr=1e-2)
    step = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt, rho=0.3)
    _train(step, Y, prng.PRNGKey(5), 30)
    a = float(dp_svi.constrain(params)["alpha"].detach())
    assert np.isfinite(a) and a > 0
    assert np.isfinite(_elbo(params, Y, cfg))


def case_lam_cholesky_exact_when_well_conditioned():
    a = prng.normal(prng.PRNGKey(0), (8, 8), torch.float64)
    lam = torch.eye(8, dtype=torch.float64) + a @ a.T
    assert torch.equal(dp_svi._lam_cholesky(lam), torch.linalg.cholesky(lam))


def _breached(key, deficit):
    a = prng.normal(prng.PRNGKey(key), (16, 16), torch.float64)
    w, v = torch.linalg.eigh(a @ a.T * 1e4)
    w[0] = deficit
    return (v * w[None, :]) @ v.T


def case_lam_cholesky_repairs_indefinite_with_finite_grads():
    lam = _breached(1, -4.0)
    assert torch.linalg.cholesky_ex(lam)[1] != 0
    L = dp_svi._lam_cholesky(lam)
    assert torch.isfinite(L).all()
    np.testing.assert_allclose(torch.diagonal(L @ L.T).numpy(),
                               torch.diagonal(lam).numpy(), rtol=0.05,
                               atol=70.0)
    lam.requires_grad_()
    Lg = dp_svi._lam_cholesky(lam)
    (g,) = torch.autograd.grad(torch.sum(torch.log(torch.diagonal(Lg)))
                               + torch.sum(Lg), lam)
    assert torch.isfinite(g).all()


def case_lam_cholesky_gershgorin_rung_cannot_fail():
    for deficit in (-200.0, -1e6):
        lam = _breached(2, deficit).requires_grad_()
        L = dp_svi._lam_cholesky(lam)
        assert torch.isfinite(L).all(), deficit
        (g,) = torch.autograd.grad(torch.sum(torch.log(torch.diagonal(L))),
                                   lam)
        assert torch.isfinite(g).all(), deficit


def case_expected_residuals_tracks_planted_noise():
    Y, labels, _ = synthetic.grouped_dims_big(
        prng.PRNGKey(5), n=64, dims_per_group=(5, 5), q=2,
        noise=(0.01, 0.4), device="cpu")
    cfg1 = dp_svi.Config(num_latent=2, num_inducing=12, truncation=1,
                         batch=32)
    params = dp_svi.init_params(prng.PRNGKey(1), Y, cfg1)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    step = dp_svi.make_dp_svi_step(cfg1, Y.shape[0], opt, rho=0.3)
    _train(step, Y, prng.PRNGKey(9), 300)
    params = dp_svi.set_optimal_qu(params, Y, cfg1)
    with torch.no_grad():
        r = dp_svi.expected_residuals(params, Y, cfg1)
    assert r.shape == (Y.shape[1],) and torch.isfinite(r).all()
    labels = labels.numpy()
    rn = r.numpy()
    assert rn[labels == 1].min() > rn[labels == 0].max(), rn
    out = dp_svi.split_single_atom(params, cfg1._replace(truncation=4),
                                   residuals=r)
    noises = positive_noise(out["raw_noise"]).detach().numpy()
    assert np.all(np.diff(noises) > 0), noises
    assert noises[0] <= np.median(rn[labels == 0]) * 1.5
    assert noises[-1] >= np.median(rn[labels == 1]) * 0.5


def case_predict_t1_matches_svi_gplvm():
    Y, scfg, sparams, dcfg, dparams = _t1_pair()
    d_opt = dp_svi.set_optimal_qu(dparams, Y, dcfg)
    s_opt = svi_gplvm.set_optimal_qu(sparams, Y, scfg)
    xm = torch.tensor([[0.3, -0.2], [1.0, 0.5], [-0.7, 0.1]],
                      dtype=torch.float64)
    xv = torch.full_like(xm, 0.05)
    for d, s in zip(dp_svi.predict_from_latent(d_opt, xm, xv, dcfg),
                    svi_gplvm.predict_from_latent(s_opt, xm, xv, scfg)):
        np.testing.assert_allclose(d.numpy(), s.detach().numpy(), rtol=1e-5,
                                   atol=1e-7)


def case_predict_one_hot_phi_selects_owning_atom():
    Y, _, cfg, _, params = _setup(n=40, dims=(4, 4), t=3, m=8)
    params = dp_svi.set_optimal_qu(params, Y, cfg)
    hard = torch.tensor([0] * 4 + [2] * 4)
    params["phi_logits"] = torch.nn.Parameter(
        60.0 * torch.nn.functional.one_hot(hard, 3).double())
    with torch.no_grad():
        c = dp_svi.constrain(params)
        xm, xv = c["qx_mean"][:3], c["qx_var"][:3]
    mean, var = dp_svi.predict_from_latent(params, xm, xv, cfg)
    with torch.no_grad():
        f_t, v_t = dp_svi._atom_predictive(dp_svi._predictive(params, cfg),
                                           xm, xv)
    for dd, t in enumerate(hard.tolist()):
        np.testing.assert_allclose(mean[:, dd].numpy(), f_t[t, :, dd].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(var[:, dd].numpy(), v_t[t, :, dd].numpy(),
                                   rtol=1e-4)


def case_dp_svi_impute_beats_mean_baseline():
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(11), n=72,
                                     dims_per_group=(5, 5), q=2, noise=0.01,
                                     device="cpu")
    Y_train, Y_test = Y[:56], Y[56:]
    cfg = dp_svi.Config(num_latent=2, num_inducing=10, truncation=3,
                        batch=16)
    params = dp_svi.init_params(prng.PRNGKey(1), Y_train, cfg)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    step = dp_svi.make_dp_svi_step(cfg, Y_train.shape[0], opt, rho=0.3,
                                   rho_phi=0.1)
    _train(step, Y_train, prng.PRNGKey(7), 300)
    mask = torch.zeros_like(Y_test)
    mask[:, ::2] = 1.0
    mean, var, *_ = dp_svi.impute(params, Y_test, mask, cfg, num_steps=150)
    missing = 1.0 - mask
    mse = float(torch.sum(missing * (mean - Y_test) ** 2) / missing.sum())
    base = float(torch.sum(missing * Y_test ** 2) / missing.sum())
    assert np.isfinite(mse) and mse < 0.5 * base, (mse, base)
    assert bool((var > 0).all())


def case_dp_svi_serving_imputer_matches_pipeline():
    """The serving factory moves only the candidates' work to build time:
    its requests equal `dp_svi.impute` at the same step budget."""
    Y, _, cfg, _, params = _setup(n=48, dims=(4, 4))
    params = dp_svi.set_optimal_qu(params, Y, cfg)
    y_star = Y[:6]
    mask = torch.zeros_like(y_star)
    mask[:, ::2] = 1.0
    mean_p, var_p, *_ = dp_svi.impute(params, y_star, mask, cfg,
                                      num_steps=60, tol=None)
    imputer = serving.make_dp_svi_imputer(params, cfg, num_steps=60,
                                          tol=None, device="cpu")
    mean_s, var_s = imputer(y_star, mask)
    np.testing.assert_allclose(mean_s.numpy(), mean_p.numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(var_s.numpy(), var_p.numpy(), rtol=1e-5,
                               atol=1e-8)
    assert torch.isfinite(mean_s).all()


def _stream_setup():
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(3), n=96,
                                     dims_per_group=(3, 2), q=2, noise=0.01,
                                     device="cpu")
    cfg = dp_svi.Config(num_latent=2, num_inducing=8, truncation=3, batch=8)
    return Y, cfg


def _twin_steps(Y, cfg, streaming):
    params = dp_svi.init_params(prng.PRNGKey(1), Y, cfg)
    opt = gp_optimizer(params, lr=1e-2)
    return params, opt, dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt,
                                                rho=0.3, streaming=streaming)


def case_streaming_step_equals_resident():
    Y, cfg = _stream_setup()
    idx = torch.tensor([3, 3, 0, 95, 17, 4, 60, 8])
    p_res, _, res = _twin_steps(Y, cfg, False)
    p_str, _, st = _twin_steps(Y, cfg, True)
    assert torch.equal(res(0, idx, Y), st(0, (idx, Y[idx])))
    for k in p_res:
        assert torch.equal(p_res[k], p_str[k]), k


def case_streaming_scan_chunk_equals_resident_loop():
    Y, cfg = _stream_setup()
    chunk = 4
    gen = np.random.Generator(np.random.Philox(5))
    idx = torch.from_numpy(gen.integers(0, Y.shape[0], size=(chunk,
                                                             cfg.batch),
                                        dtype=np.int32))
    p_res, _, res = _twin_steps(Y, cfg, False)
    losses_ref = torch.stack([res(k, idx[k].long(), Y)
                              for k in range(chunk)])
    p_str, opt, st = _twin_steps(Y, cfg, True)
    _, losses = make_streaming_scan_fn(st)(TrainState(opt), idx, Y[idx.long()])
    assert torch.equal(losses, losses_ref)
    for k in p_res:
        assert torch.equal(p_res[k], p_str[k]), k


REFERENCE_CASES = {name[len("case_"):]: fn for name, fn in globals().items()
                   if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_dp_svi_case(case):
    REFERENCE_CASES[case]()


def test_one_rank_mesh_cavi_step_is_the_unsharded_step():
    """The mesh and the amortized q(X): on a one-rank mesh (a gloo group
    of one, as the card's NCCL group of one) a "cavi" step, its phi
    reading the gathered free energies, is the unsharded step to the bit
    (tests/test_torch_parallel_svi.py holds the mesh of four ranks); the
    amortized init holds encoder leaves in place of the table
    (tests/test_torch_amortized.py)."""
    from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
    from dp_gp_lvm_tpu_torch.parallel.recipe import place_svi

    Y, _, cfg, _, params = _setup()
    idx = torch.arange(cfg.batch)
    opt = gp_optimizer(params, lr=1e-2)
    want = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt,
                                   phi_update="cavi")(0, idx, Y)
    mesh = mesh_lib.make_mesh(1, 1, "cpu")
    try:
        local, _, table = place_svi("dp_svi", _setup()[4], (Y,), mesh)
        opt = gp_optimizer(local, lr=1e-2, mesh=mesh, placement=table)
        got = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt, mesh=mesh,
                                      phi_update="cavi")(0, idx, Y)
    finally:
        mesh_lib.close_distributed()
    assert torch.equal(got, want)
    for k, v in params.items():
        assert torch.equal(local[k], v), k
    p = dp_svi.init_params(prng.PRNGKey(1), Y, cfg._replace(amortized=True))
    assert "qx_mean" not in p and "enc_wlin" in p
