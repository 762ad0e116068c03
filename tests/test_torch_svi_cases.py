"""The reference's `tests/test_svi.py` cases that need no device mesh and
no amortized q(X), run on the port's SVI-GPLVM (`models/svi_gplvm.py`) in
float64 on the CPU, as cases of one parametrised test: the collapsed-bound
identity at the optimal q(u), the minibatch partition, training by plain
and natural-gradient SVI, imputation, the full-batch rho = 1 blends, the
non-finite guard, the noise floor, and the f32 blend from a pathological
state. The port's random stream is the reference's (`core/prng.py`), so
each case runs on the reference's own data, init and minibatches. The
reference's mesh case runs on four ranks in
`tests/test_torch_parallel_svi.py`. No JAX is imported here."""
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import bgplvm, svi_gplvm
from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _naive_natural_blend(u_mean, ls, a, A2, beta, rho):
    """The textbook blend through explicit natural parameters."""
    eye = torch.eye(ls.shape[0], dtype=ls.dtype)
    h, lam = svi_gplvm._natural_from_params({"u_mean": u_mean,
                                              "u_scale": ls})
    return svi_gplvm._params_from_natural(
        (1.0 - rho) * h + rho * beta * a,
        (1.0 - rho) * lam + rho * (eye + beta * A2))


# ---------------------------------------------------------------------------


def _setup(n=48, d=5, q=2, m=8):
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(0), n=n, d=d, q_true=2,
                               q_total=q, device="cpu")
    cfg = svi_gplvm.Config(num_latent=q, num_inducing=m, batch=16)
    return Y, cfg, svi_gplvm.init_params(prng.PRNGKey(1), Y, cfg)


def _collapsed_elbo(params, Y, cfg):
    bcfg = bgplvm.Config(num_latent=cfg.num_latent,
                         num_inducing=cfg.num_inducing)
    keep = ("qx_mean", "raw_qx_var", "z", "raw_variance", "raw_ard",
            "raw_noise")
    with torch.no_grad():
        return float(bgplvm.elbo({k: params[k] for k in keep}, Y, bcfg))


def _elbo(params, Y, cfg):
    with torch.no_grad():
        return float(svi_gplvm.elbo(params, Y, cfg))


def _train(step, Y, n, steps, seed, batch):
    key = prng.PRNGKey(seed)
    for t in range(steps):
        key, sub = prng.split(key)
        step(t, prng.randint(sub, (batch,), 0, n).long(), Y)


def _optimal_qu_recovers_collapsed_bound():
    Y, cfg, params = _setup()
    params = svi_gplvm.set_optimal_qu(params, Y, cfg)
    np.testing.assert_allclose(_elbo(params, Y, cfg),
                               _collapsed_elbo(params, Y, cfg), rtol=1e-6)


def _suboptimal_qu_is_below_collapsed_bound():
    Y, cfg, params = _setup()
    collapsed = _collapsed_elbo(params, Y, cfg)
    assert _elbo(params, Y, cfg) < collapsed - 1.0
    p2 = svi_gplvm.set_optimal_qu(params, Y, cfg)
    p2 = {**p2, "u_mean": p2["u_mean"] + 0.1}
    assert _elbo(p2, Y, cfg) < collapsed


def _minibatch_partition_averages_to_full_bound():
    Y, cfg, params = _setup(n=48)
    params = svi_gplvm.set_optimal_qu(params, Y, cfg)
    n, b = Y.shape[0], cfg.batch
    with torch.no_grad():
        ests = [float(svi_gplvm.elbo_minibatch(
            params, Y[start:start + b], torch.arange(start, start + b), n,
            cfg)) for start in range(0, n, b)]
    np.testing.assert_allclose(np.mean(ests), _elbo(params, Y, cfg),
                               rtol=1e-10)


def _svi_training_improves_full_elbo():
    Y, cfg, params = _setup()
    e0 = _elbo(params, Y, cfg)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    _train(svi_gplvm.make_svi_step(cfg, Y.shape[0], opt), Y, Y.shape[0],
           200, 3, cfg.batch)
    e1 = _elbo(params, Y, cfg)
    assert np.isfinite(e1) and e1 > e0 + 1.0, (e0, e1)


def _predict_from_latent_sane():
    Y, cfg, params = _setup()
    params = svi_gplvm.set_optimal_qu(params, Y, cfg)
    c = svi_gplvm._detached(params, cfg)
    mean, var = svi_gplvm.predict_from_latent(params, c["qx_mean"],
                                              c["qx_var"], cfg)
    assert mean.shape == Y.shape and var.shape == Y.shape
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    base = float(torch.mean((Y - Y.mean(0)) ** 2))
    assert float(torch.mean((mean - Y) ** 2)) < 0.7 * base


def _svi_impute_beats_mean_baseline():
    Y, cfg, params = _setup(n=48, d=6)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    _train(svi_gplvm.make_svi_step(cfg, Y.shape[0], opt), Y, Y.shape[0],
           300, 5, cfg.batch)
    params = svi_gplvm.set_optimal_qu(params, Y, cfg)
    y_star, d = Y[::7], Y.shape[1]
    mask = torch.ones_like(y_star)
    mask[:, d // 2:] = 0.0
    mean, var, *_ = svi_gplvm.impute(params, y_star, mask, cfg,
                                     num_steps=150)
    miss = 1.0 - mask
    mse = float(torch.sum(((mean - y_star) ** 2) * miss) / torch.sum(miss))
    base = float(torch.sum(((Y.mean(0) - y_star) ** 2) * miss)
                 / torch.sum(miss))
    assert np.isfinite(mse) and mse < 0.5 * base, (mse, base)
    assert bool((var > 0).all())


def _full_batch_rho1(blend_at, lr, hyper_lr=None):
    Y, cfg, params = _setup(n=32)
    cfg = cfg._replace(batch=32)
    opt = gp_optimizer(params, lr=lr, hyper_lr=hyper_lr)
    step = svi_gplvm.make_svi_natgrad_step(cfg, 32, opt, rho=1.0,
                                           blend_at=blend_at)
    step(0, torch.arange(32), Y)
    np.testing.assert_allclose(_elbo(params, Y, cfg),
                               _collapsed_elbo(params, Y, cfg), rtol=1e-5)


def _natgrad_full_batch_rho1_lands_on_optimum():
    _full_batch_rho1("updated", 1e-3)


def _natgrad_blend_at_grad_full_batch_rho1():
    _full_batch_rho1("grad", 0.0, 0.0)


def _natgrad_trains(rho, rho_t0, rho_kappa, seed):
    Y, cfg, params = _setup(n=48)
    e0 = _elbo(params, Y, cfg)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    step = svi_gplvm.make_svi_natgrad_step(cfg, 48, opt, rho=rho,
                                           rho_t0=rho_t0,
                                           rho_kappa=rho_kappa)
    _train(step, Y, 48, 120, seed, cfg.batch)
    e1 = _elbo(params, Y, cfg)
    assert np.isfinite(e1) and e1 > e0 + 10.0, (e0, e1)


def _natgrad_robbins_monro_schedule_trains():
    _natgrad_trains(0.5, 20.0, 0.7, 11)


def _natgrad_trains_stably():
    _natgrad_trains(0.2, None, 0.6, 7)


def _natgrad_nonfinite_blend_keeps_previous_qu():
    prev = {"u_mean": torch.ones(3, 2), "raw_u_scale": torch.eye(3)}
    bad = torch.tensor([[float("nan"), 1.0], [0.0, 1.0], [0.0, 1.0]])
    svi_gplvm._guarded_qu(prev, bad, torch.eye(3) * 2.0)
    assert torch.equal(prev["u_mean"], torch.ones(3, 2))
    assert torch.equal(prev["raw_u_scale"], torch.eye(3))
    svi_gplvm._guarded_qu(prev, torch.zeros_like(bad), torch.eye(3) * 2.0)
    assert torch.equal(prev["raw_u_scale"], torch.eye(3) * 2.0)


def _noise_floor_binds_and_elbo_stays_bounded():
    Y, cfg, params = _setup(n=32, d=4)
    cfg = cfg._replace(noise_floor=1e-3)
    params["raw_noise"] = torch.tensor(-40.0, dtype=Y.dtype)
    with torch.no_grad():
        assert float(svi_gplvm.constrain(params, cfg)["noise"]) >= 1e-3
        assert float(svi_gplvm.constrain(params)["noise"]) < 1e-3
    e = _elbo(params, Y, cfg)
    cap = Y.numel() * 0.5 * (-np.log(2 * np.pi * 1e-3))
    assert np.isfinite(e) and e <= cap + 1.0, (e, cap)


def _natgrad_blend_recovers_from_pathological_state_f32():
    """S directions ~1e-12: the explicit-naturals blend's f32 Cholesky of
    Lambda is non-finite, the sandwiched blend stays finite and matches
    its f64 value."""
    m, d = 24, 3
    f64 = torch.float64
    k1, k2, k3 = prng.split(prng.PRNGKey(2), 3)
    diag = torch.logspace(0, -6, m, dtype=f64)
    ls = torch.diag(diag) + 0.1 * torch.tril(
        prng.normal(k1, (m, m), f64), -1) * diag[None, :]
    x = prng.normal(k2, (4 * m, m), f64)
    A2 = (x.T @ x) * (1e3 / (4 * m))
    A2 = 0.5 * (A2 + A2.T)
    u = prng.normal(k3, (m, d), f64)
    a = 50.0 * prng.normal(prng.fold_in(k3, 1), (m, d), f64)

    def blend(fn, dtype):
        return fn(*(v.to(dtype) for v in (u, ls, a, A2)), 10.0, 0.2)

    m64, _ = blend(svi_gplvm.natgrad_blend_qu, torch.float64)
    m32, raw32 = blend(svi_gplvm.natgrad_blend_qu, torch.float32)
    assert bool(torch.isfinite(m32).all() and torch.isfinite(raw32).all())
    np.testing.assert_allclose(m32.numpy(), m64.numpy().astype(np.float32),
                               rtol=1e-3, atol=1e-3)
    m_naive, raw_naive = blend(_naive_natural_blend, torch.float32)
    assert not bool(torch.isfinite(m_naive).all()
                    and torch.isfinite(raw_naive).all())


REFERENCE_CASES = {f.__name__[1:]: f for f in (
    _optimal_qu_recovers_collapsed_bound,
    _suboptimal_qu_is_below_collapsed_bound,
    _minibatch_partition_averages_to_full_bound,
    _svi_training_improves_full_elbo,
    _predict_from_latent_sane,
    _svi_impute_beats_mean_baseline,
    _natgrad_full_batch_rho1_lands_on_optimum,
    _natgrad_blend_at_grad_full_batch_rho1,
    _natgrad_robbins_monro_schedule_trains,
    _natgrad_nonfinite_blend_keeps_previous_qu,
    _natgrad_trains_stably,
    _noise_floor_binds_and_elbo_stays_bounded,
    _natgrad_blend_recovers_from_pathological_state_f32,
)}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_svi_case(case):
    REFERENCE_CASES[case]()


def test_one_rank_mesh_step_is_the_unsharded_step():
    """The mesh, the streamed feed and the amortized q(X): on a one-rank
    mesh (a gloo group of one, as the card's NCCL group of one) the step
    is the unsharded step to the bit (tests/test_torch_parallel_svi.py
    holds the mesh of four ranks); the streamed step takes the host-fed pair (idx,
    y_b) instead of the resident Y (tests/test_torch_stream.py); the
    amortized init holds encoder leaves in place of the table
    (tests/test_torch_amortized.py)."""
    Y, cfg, params = _setup(n=32)
    opt = gp_optimizer(params)
    idx = torch.arange(cfg.batch)
    local, got = _one_rank_mesh_step(Y, cfg, idx)
    want = svi_gplvm.make_svi_natgrad_step(cfg, 32, opt)(0, idx, Y)
    assert torch.equal(got, want)
    for k, v in params.items():
        assert torch.equal(local[k], v), k
    step = svi_gplvm.make_svi_natgrad_step(cfg, 32, opt, streaming=True)
    assert bool(torch.isfinite(step(0, (idx, Y[idx]))))
    p = svi_gplvm.init_params(prng.PRNGKey(0), Y,
                              cfg._replace(amortized=True))
    assert "qx_mean" not in p and "enc_wlin" in p


def _one_rank_mesh_step(Y, cfg, idx):
    """One step of the `_setup` parameters on a 1 x 1 mesh: (the rank's
    parameters after it, the loss)."""
    from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
    from dp_gp_lvm_tpu_torch.parallel.recipe import place_svi

    mesh = mesh_lib.make_mesh(1, 1, "cpu")
    try:
        params, _, table = place_svi("svi_gplvm", _setup(n=Y.shape[0])[2],
                                     (Y,), mesh)
        opt = gp_optimizer(params, mesh=mesh, placement=table)
        loss = svi_gplvm.make_svi_natgrad_step(cfg, Y.shape[0], opt,
                                               mesh=mesh)(0, idx, Y)
        return params, loss
    finally:
        mesh_lib.close_distributed()
