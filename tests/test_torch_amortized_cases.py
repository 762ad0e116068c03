"""The reference's `tests/test_amortized.py` cases that need no device mesh,
run on the port's amortized q(X) (`models/amortized.py` through
`svi_gplvm.py` and `dp_svi.py`) in float64 on the CPU, as cases of one
parametrised test: encode(Y) at init is the resident init and the two
bounds agree (SVI-GPLVM and DP-SVI), the minibatch partition, training
that moves the encoder, the split that keeps it, the DP-SVI's training
without the mesh, its streamed step against the resident one, and
imputation from the encoder's init and by the one-pass encoder imputer.
The reference's sharded cases run on four ranks in
`tests/test_torch_parallel_svi.py`. The port's random stream is the
reference's (`core/prng.py`), so each case runs on the reference's own
data, init and minibatches. Beside them, what
the port adds: the variance floor carried through every walk of a
constrained dict, `params_from_jax` and the export round trip of encoder
leaves, and the staged recipe's frozen manifold over them. No JAX is
imported here."""
import numpy as np
import pytest
import torch
from torch import nn

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import (
    amortized,
    dp_svi,
    eval_f64,
    serving,
    svi_gplvm,
)
from dp_gp_lvm_tpu_torch.train import dp_recipe
from dp_gp_lvm_tpu_torch.train.checkpoint import export_npz, load_npz
from dp_gp_lvm_tpu_torch.train.init import pca_latents
from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(n=48, d=5, q=2, m=8, hidden=16, batch=16, **kw):
    Y, _ = synthetic.toy_gplvm(prng.PRNGKey(0), n=n, d=d, q_true=2,
                               q_total=q, device="cpu")
    cfg = svi_gplvm.Config(num_latent=q, num_inducing=m, batch=batch,
                           amortized=True, encoder_hidden=hidden, **kw)
    return Y, cfg, svi_gplvm.init_params(prng.PRNGKey(1), Y, cfg)


def _dp_setup(n=40, dims=(4, 4), q=2, m=8, t=3, hidden=8):
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(3), n=n,
                                     dims_per_group=dims, q=q, noise=0.01,
                                     device="cpu")
    cfg = dp_svi.Config(num_latent=q, num_inducing=m, truncation=t,
                        batch=16, amortized=True, encoder_hidden=hidden)
    return Y, cfg, dp_svi.init_params(prng.PRNGKey(1), Y, cfg)


def _value(fn, *args):
    with torch.no_grad():
        return float(fn(*args))


def _train(step, Y, n, steps, seed, batch):
    """Step t on randint(sub, (batch,), 0, n), key, sub = split(key): the
    reference's loop over its default sampler."""
    key = prng.PRNGKey(seed)
    for t in range(steps):
        key, sub = prng.split(key)
        step(t, prng.randint(sub, (batch,), 0, n).long(), Y)


def _leaves(params):
    return {k: nn.Parameter(v.detach().clone()) for k, v in params.items()}


@torch.no_grad()
def _encoder_moved(before, after):
    return sum(float(torch.sum(torch.abs(after[k] - before[k])))
               for k in before if amortized.is_encoder_leaf(k))


def _masked_mse(mean, y_star, miss):
    return float(torch.sum(((mean - y_star) ** 2) * miss) / torch.sum(miss))


# ---------------------------------------------------------------------------
# the reference's cases


def _init_encode_matches_resident_init():
    for hidden in (0, 16):
        Y, cfg, params = _setup(hidden=hidden)
        with torch.no_grad():
            mu, s = amortized.encode(params, Y)
        np.testing.assert_allclose(mu.numpy(),
                                   pca_latents(Y, cfg.num_latent).numpy(),
                                   atol=1e-9)
        # both modes share the +1e-8 positive_variational_var floor
        np.testing.assert_allclose(s.numpy(), 0.5, rtol=1e-7)
        rcfg = cfg._replace(amortized=False)
        rparams = svi_gplvm.init_params(prng.PRNGKey(1), Y, rcfg)
        np.testing.assert_allclose(_value(svi_gplvm.elbo, params, Y, cfg),
                                   _value(svi_gplvm.elbo, rparams, Y, rcfg),
                                   rtol=1e-9)


def _minibatch_partition_averages_to_full_bound():
    Y, cfg, params = _setup(n=48)
    params = svi_gplvm.set_optimal_qu(params, Y, cfg)
    n, b = Y.shape[0], cfg.batch
    ests = [_value(svi_gplvm.elbo_minibatch, params, Y[s:s + b],
                   torch.arange(s, s + b), n, cfg) for s in range(0, n, b)]
    np.testing.assert_allclose(np.mean(ests),
                               _value(svi_gplvm.elbo, params, Y, cfg),
                               rtol=1e-10)


def _amortized_training_improves_full_elbo():
    """ngd_lr set on purpose: with no table leaves the NGD group is
    dropped."""
    Y, cfg, params = _setup()
    start = {k: v.detach().clone() for k, v in params.items()}
    before = _value(svi_gplvm.elbo, params, Y, cfg)
    opt = gp_optimizer(params, lr=2e-2, ngd_lr=0.5)
    assert "ngd" not in opt.rates
    _train(svi_gplvm.make_svi_natgrad_step(cfg, Y.shape[0], opt, rho=0.5),
           Y, Y.shape[0], 120, 2, cfg.batch)
    after = _value(svi_gplvm.elbo, params, Y, cfg)
    assert np.isfinite(after) and after > before + 10.0, (before, after)
    assert _encoder_moved(start, params) > 1e-3


def _dp_svi_amortized_init_matches_resident():
    Y, cfg, params = _dp_setup()
    rcfg = cfg._replace(amortized=False)
    rparams = dp_svi.init_params(prng.PRNGKey(1), Y, rcfg)
    np.testing.assert_allclose(_value(dp_svi.elbo, params, Y, cfg),
                               _value(dp_svi.elbo, rparams, Y, rcfg),
                               rtol=1e-9)


def _dp_svi_amortized_split_keeps_encoder():
    Y, cfg, _ = _dp_setup()
    cfg1 = cfg._replace(truncation=1)
    p1 = dp_svi.init_params(prng.PRNGKey(1), Y, cfg1)
    out = dp_svi.split_single_atom(p1, cfg)
    enc = [k for k in p1 if amortized.is_encoder_leaf(k)]
    assert enc, "the amortized init must give encoder leaves"
    for k in enc:
        assert torch.equal(out[k], p1[k]), k
    assert out["raw_noise"].shape == (cfg.truncation,)


def _dp_svi_amortized_step_trains():
    """The single-device half of the reference's case (the sharded half
    needs `parallel/`): sixty steps raise the full bound."""
    Y, cfg, params = _dp_setup(t=2)
    start = {k: v.detach().clone() for k, v in params.items()}
    before = _value(dp_svi.elbo, params, Y, cfg)
    opt = gp_optimizer(params, lr=1e-2)
    step = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt, rho=0.5)
    _train(step, Y, Y.shape[0], 60, 5, cfg.batch)
    after = _value(dp_svi.elbo, params, Y, cfg)
    assert np.isfinite(after) and after > before + 5.0, (before, after)
    assert _encoder_moved(start, params) > 1e-3


def _amortized_streaming_step_equals_resident():
    Y, cfg, params = _dp_setup(t=2)
    idx = torch.tensor([3, 3, 0, 31, 17, 4, 22, 8])
    p_res, p_str = _leaves(params), _leaves(params)
    res = dp_svi.make_dp_svi_step(cfg, Y.shape[0], gp_optimizer(
        p_res, lr=1e-2), rho=0.3)
    st = dp_svi.make_dp_svi_step(cfg, Y.shape[0], gp_optimizer(
        p_str, lr=1e-2), rho=0.3, streaming=True)
    assert torch.equal(res(0, idx, Y), st(0, (idx, Y[idx])))
    for k in p_res:
        assert torch.equal(p_res[k], p_str[k]), k


def _amortized_impute_from_encoder_init():
    Y, cfg, params = _setup(n=64)
    params = _leaves(svi_gplvm.set_optimal_qu(params, Y, cfg))
    opt = gp_optimizer(params, lr=2e-2)
    _train(svi_gplvm.make_svi_natgrad_step(cfg, Y.shape[0], opt, rho=0.5),
           Y, Y.shape[0], 150, 3, cfg.batch)
    params = svi_gplvm.set_optimal_qu(params, Y, cfg)

    y_star = Y[:8]
    mask = torch.ones_like(y_star)
    mask[:, ::2] = 0.0
    miss = 1.0 - mask
    mean, var, *_ = svi_gplvm.impute(params, y_star * mask, mask, cfg,
                                     num_steps=150, lr=0.05)
    mse = _masked_mse(mean, y_star, miss)
    mse_base = _masked_mse(Y.mean(0)[None, :], y_star, miss)
    assert np.isfinite(mse) and mse < 0.6 * mse_base, (mse, mse_base)
    assert bool((var > 0).all())
    # one forward pass, no inference loop: still beats the mean
    mean0, var0 = serving.make_encoder_imputer(params, cfg, device="cpu")(
        y_star * mask, mask)
    mse0 = _masked_mse(mean0, y_star, miss)
    assert np.isfinite(mse0) and bool((var0 > 0).all())
    assert mse0 < mse_base, (mse0, mse_base)
    # refined from the encoded init: the full pipeline's ballpark
    mean_r, _ = serving.make_encoder_imputer(
        params, cfg, refine_steps=150, device="cpu")(y_star * mask, mask)
    mse_r = _masked_mse(mean_r, y_star, miss)
    assert mse_r < 0.75 * mse_base, (mse_r, mse_base)


REFERENCE_CASES = {f.__name__[1:]: f for f in (
    _init_encode_matches_resident_init,
    _minibatch_partition_averages_to_full_bound,
    _amortized_training_improves_full_elbo,
    _dp_svi_amortized_init_matches_resident,
    _dp_svi_amortized_split_keeps_encoder,
    _dp_svi_amortized_step_trains,
    _amortized_streaming_step_equals_resident,
    _amortized_impute_from_encoder_init,
)}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_amortized_case(case):
    REFERENCE_CASES[case]()


# ---------------------------------------------------------------------------
# the port's own


def test_variance_floor_survives_every_walk_of_a_constrained_dict():
    """The floor is a host tensor in the constrained dict: detaching the
    dict, moving it and the serving paths keep it, and `encode` adds it;
    without a config there is none; eval_f64 adds it as `constrain`."""
    Y, cfg, params = _setup(qx_var_floor=1e-2)
    c = svi_gplvm._detached(params, cfg)
    assert amortized.VAR_FLOOR in c
    moved = {k: v.to("cpu") for k, v in c.items()}
    with torch.no_grad():
        s_floor = amortized.encode(moved, Y)[1]
        s_bare = amortized.encode(svi_gplvm.constrain(params), Y)[1]
    np.testing.assert_allclose((s_floor - s_bare).numpy(), 1e-2, rtol=1e-12)
    assert amortized.VAR_FLOOR not in svi_gplvm.constrain(params)
    assert amortized.VAR_FLOOR in dp_svi.constrain(
        _dp_setup()[2], _dp_setup()[1]._replace(qx_var_floor=1e-2))
    np.testing.assert_allclose(eval_f64.elbo_f64(params, Y, cfg),
                               _value(svi_gplvm.elbo, params, Y, cfg),
                               rtol=1e-10)
    assert eval_f64.elbo_f64(params, Y, cfg) != eval_f64.elbo_f64(
        params, Y, cfg._replace(qx_var_floor=0.0))


def test_encoder_leaves_cross_params_from_jax_and_the_export(tmp_path):
    """The raw export (`params.npz`) of an amortized model read back by
    `params_from_jax`: every encoder leaf, the same bits, the same bound."""
    Y, cfg, params = _setup()
    export_npz(str(tmp_path / "params.npz"), params)
    back = params_from_jax(load_npz(str(tmp_path / "params.npz")), "cpu")
    assert set(back) == set(params)
    for k, v in params.items():
        assert isinstance(back[k], nn.Parameter)
        assert torch.equal(back[k], v), k
    assert _value(svi_gplvm.elbo, back, Y, cfg) == _value(
        svi_gplvm.elbo, params, Y, cfg)


def test_staged_recipe_freezes_the_encoder_with_the_manifold():
    """Stage 2b holds the manifold: for an amortized model the encoder's
    leaves are in it, and the optimizer leaves them where they are."""
    Y, cfg, params = _dp_setup()
    frozen = dp_recipe._frozen_manifold_for(params)
    enc = {k for k in params if amortized.is_encoder_leaf(k)}
    assert enc and enc <= frozen and "qx_mean" not in params
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = gp_optimizer(params, lr=1e-2, freeze=frozen)
    step = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt, rho=0.3)
    _train(step, Y, Y.shape[0], 3, 1, cfg.batch)
    for k in enc | {"z", "raw_ard"}:
        assert torch.equal(params[k], start[k]), k
    assert not torch.equal(params["raw_noise"], start["raw_noise"])
