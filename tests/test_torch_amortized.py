"""The port's amortized q(X) (`models/amortized.py` and the amortized
branches of `svi_gplvm.py`, `dp_svi.py`, `eval_f64.py` and `serving.py`)
against the JAX package's, in float64 on the CPU: the init's leaves, the
encoder's forward pass with and without its variance floor, the bound, its
minibatch estimate and every encoder gradient at rtol 1e-9, five
natural-gradient steps with slow inducing points and the q(u) trust region
(c8's runner) on the same `fold_in` minibatches at 1e-8, the float64 host
ELBO at 1e-10, the amortized DP-SVI's bound and three steps, and the
encoder imputer, the amortized DP-SVI imputer and `impute` from the
encoder's init at 1e-9. The JAX values come from one module-scoped oracle
(each reference program jitted once) at N=48, B=16, M=8, Q=2, D=5 (the
DP-SVI at N=40, D=8, T=3). The reference's own `tests/test_amortized.py`
cases run on the port in `tests/test_torch_amortized_cases.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import amortized as jamortized
from dp_gp_lvm_tpu.models import dp_svi as jdp
from dp_gp_lvm_tpu.models import eval_f64 as jeval
from dp_gp_lvm_tpu.models import serving as jserving
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import (
    amortized,
    dp_svi,
    eval_f64,
    serving,
    svi_gplvm,
)
from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

N, B, M, Q, D, HIDDEN = 48, 16, 8, 2, 5, 6
STEPS = 5
DP_N, DP_DIMS, DP_T, DP_HIDDEN, DP_STEPS = 40, (4, 4), 3, 8, 3
REFINE = 20
SERVE_STEPS = 10
# c8's floors and its runner's stabilisers
FLOORS = dict(noise_floor=1e-3, qx_var_floor=1e-2)
SLOW, TRUST = frozenset({"z"}), 100.0


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(p):
    """Off the init manifold (the MLP's heads nonzero), so that no check is
    vacuous."""
    return jax.tree.map(lambda v: v + 0.01 * jnp.sin(jnp.arange(
        v.size, dtype=v.dtype)).reshape(v.shape), p)


def _jcfg():
    return jsvi.Config(num_latent=Q, num_inducing=M, batch=B, amortized=True,
                       encoder_hidden=HIDDEN, **FLOORS)


def _jdcfg():
    return jdp.Config(num_latent=Q, num_inducing=M, truncation=DP_T, batch=B,
                      amortized=True, encoder_hidden=DP_HIDDEN, **FLOORS)


def _mask(rows, d):
    return jnp.ones((rows, d)).at[:, ::2].set(0.0)


def _base():
    """The data, the inits and the values at the perturbed parameters."""
    Y, _ = jsyn.toy_gplvm(jax.random.PRNGKey(0), n=N, d=D, q_true=2,
                          q_total=Q, dtype=jnp.float64)
    cfg = _jcfg()
    init = jsvi.init_params(jax.random.PRNGKey(1), Y, cfg)
    p0 = _perturbed(init)
    idx = jnp.arange(2, 2 + 2 * B, 2)
    Yd, _, _ = jsyn.grouped_dims(jax.random.PRNGKey(3), n=DP_N,
                                 dims_per_group=DP_DIMS, q=Q, noise=0.01)
    dinit = jdp.init_params(jax.random.PRNGKey(1), Yd, _jdcfg())
    dp0 = _perturbed(dinit)
    return {"Y": Y, "init": init, "params": p0, "idx": idx,
            "encode_raw": jamortized.encode(p0, Y),
            "encode_floored": jamortized.encode(jsvi.constrain(p0, cfg), Y),
            "elbo": jsvi.elbo(p0, Y, cfg),
            "elbo_mb": jsvi.elbo_minibatch(p0, Y[idx], idx, N, cfg),
            "grad": jax.grad(jsvi.loss_minibatch)(p0, Y[idx], idx, N, cfg),
            "Yd": Yd, "dinit": dinit, "dparams": dp0,
            "delbo": jdp.elbo(dp0, Yd, _jdcfg())}


def _steps(step, state, keys, Y):
    """The reference's jitted step (one compile) on each key."""
    losses = []
    for k in keys:
        state, metrics = step(state, k, Y)
        losses.append(metrics["loss"])
    return state.params, jnp.stack(losses)


def _oracle():
    """Every JAX value this file compares with: each reference program
    jitted once (a step, a request shape)."""
    out = jax.jit(_base)()
    Y, p0, cfg = out["Y"], out["params"], _jcfg()
    # c8's runner: Z at the hyper rate, q(u) blended in a trust region,
    # step t on randint(fold_in(r1, t), (B,), 0, N)
    opt = jloop.gp_optimizer(p0, lr=3e-3, decay_steps=STEPS, slow=SLOW)
    step = jsvi.make_svi_natgrad_step(cfg, N, opt, rho=0.2, qu_trust=TRUST)
    _, r1 = jax.random.split(jax.random.PRNGKey(100))
    trained, out["losses"] = _steps(
        step, jloop.init_state(p0, opt),
        [jax.random.fold_in(r1, t) for t in range(STEPS)], Y)
    out["trained"] = trained
    y_star, mask = Y[::6] * _mask(8, D), _mask(8, D)
    out["mask"] = mask
    out["encoder_imputer"] = {
        r: jserving.make_encoder_imputer(trained, cfg, refine_steps=r)(
            y_star, mask) for r in (0, REFINE)}
    out["impute"] = jax.jit(lambda p, y, m: jsvi.impute(
        p, y, m, cfg, num_steps=REFINE)[:4])(trained, y_star, mask)

    # the amortized DP-SVI
    Yd, dp0, dcfg = out["Yd"], out["dparams"], _jdcfg()
    dopt = jloop.gp_optimizer(dp0, lr=1e-2, decay_steps=DP_STEPS)
    dstep = jdp.make_dp_svi_step(dcfg, DP_N, dopt, rho=0.3, rho_phi=0.1)
    dtrained, out["dlosses"] = _steps(
        dstep, jloop.init_state(dp0, dopt),
        [jax.random.fold_in(jax.random.PRNGKey(100), t)
         for t in range(DP_STEPS)], Yd)
    d_star, dmask = Yd[::5][:6], _mask(6, Yd.shape[1])
    out.update(
        dtrained=dtrained, dmask=dmask,
        dp_imputer=jserving.make_dp_svi_imputer(
            dtrained, dcfg, num_steps=SERVE_STEPS, tol=None)(d_star, dmask),
        dp_encoder_imputer=jserving.make_encoder_imputer(
            dtrained, dcfg, model="dp_svi", refine_steps=REFINE)(
                d_star, dmask))
    return out


@pytest.fixture(scope="module")
def ref():
    out = jax.tree.map(np.asarray, _oracle())
    out["elbo_f64"] = jeval.elbo_f64(out["params"], out["Y"], _jcfg(),
                                     chunk=17)
    return out


def _cfg(**kw):
    return svi_gplvm.Config(num_latent=Q, num_inducing=M, batch=B,
                            amortized=True, encoder_hidden=HIDDEN,
                            **{**FLOORS, **kw})


def _dcfg():
    return dp_svi.Config(num_latent=Q, num_inducing=M, truncation=DP_T,
                         batch=B, amortized=True, encoder_hidden=DP_HIDDEN,
                         **FLOORS)


def _p(tree):
    return params_from_jax(tree, "cpu")


def _close(got, want, rtol, atol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("model", ["svi_gplvm", "dp_svi"])
def test_init_leaves_match_reference(ref, model):
    """The same draws: enc_w1 within 4 ulps (`normal`), the readout up to
    PCA's column signs (the host LAPACK's, an exact symmetry of the model,
    which flip Z's columns with it), every other leaf to 1e-12; and every
    leaf but q(X)'s is the resident init's to the bit."""
    if model == "svi_gplvm":
        Y, want, mod, cfg = torch.tensor(ref["Y"]), ref["init"], svi_gplvm, \
            _cfg()
    else:
        Y, want, mod, cfg = torch.tensor(ref["Yd"]), ref["dinit"], dp_svi, \
            _dcfg()
    p = mod.init_params(prng.PRNGKey(1), Y, cfg)
    assert set(p) == set(want)
    z, z_ref = p["z"].detach().numpy(), want["z"]
    sign = np.sign(np.sum((z * z_ref).reshape(-1, Q), axis=0))
    assert (sign != 0).all()
    for k, v in want.items():
        got = p[k].detach().numpy()
        if k == "enc_w1":
            np.testing.assert_array_max_ulp(got, v, maxulp=4)
            continue
        if k in ("enc_wlin", "z"):
            got = got * sign
        np.testing.assert_allclose(got, v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    resident = mod.init_params(prng.PRNGKey(1), Y,
                               cfg._replace(amortized=False))
    for k, v in resident.items():
        if k not in ("qx_mean", "raw_qx_var"):
            assert torch.equal(p[k], v), k


def test_encode_matches_reference_with_and_without_the_floor(ref):
    """The floor enters through `constrain` given a config that sets it,
    and only there; the raw leaves and a constrain without a config
    encode without it."""
    Y, p = torch.tensor(ref["Y"]), _p(ref["params"])
    with torch.no_grad():
        raw = amortized.encode(p, Y)
        floored = amortized.encode(svi_gplvm.constrain(p, _cfg()), Y)
        bare = amortized.encode(svi_gplvm.constrain(p), Y)
    for got, want in ((raw, ref["encode_raw"]),
                      (floored, ref["encode_floored"]),
                      (bare, ref["encode_raw"])):
        for g, w in zip(got, want):
            _close(g, w, 1e-12, 1e-14)
    assert float(torch.min(floored[1] - raw[1])) > 0.99e-2


def test_bound_and_every_gradient_match_reference(ref):
    Y, p = torch.tensor(ref["Y"]), _p(ref["params"])
    idx = torch.tensor(ref["idx"]).long()
    cfg = _cfg()
    with torch.no_grad():
        got = float(svi_gplvm.elbo(p, Y, cfg))
    _close(got, ref["elbo"], 1e-9)
    loss = svi_gplvm.loss_minibatch(p, Y[idx], idx, N, cfg)
    _close(-loss, ref["elbo_mb"], 1e-9)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert any(amortized.is_encoder_leaf(k) for k in p)
    for (k, g) in zip(p, grads):
        want = ref["grad"][k]
        _close(g, want, 1e-9, 1e-9 * np.abs(want).max(), k)


def test_five_natgrad_steps_with_slow_z_and_trust_match_reference(ref):
    Y, p = torch.tensor(ref["Y"]), _p(ref["params"])
    opt = gp_optimizer(p, lr=3e-3, decay_steps=STEPS, slow=SLOW)
    assert opt.labels["z"] == "hyper" and opt.labels["enc_w1"] == "var"
    step = svi_gplvm.make_svi_natgrad_step(_cfg(), N, opt, rho=0.2,
                                           qu_trust=TRUST)
    _, r1 = prng.split(prng.PRNGKey(100))
    idx = prng.randint(prng.fold_in(r1, torch.arange(STEPS)), (B,), 0, N)
    losses = [float(step(t, idx[t].long(), Y)) for t in range(STEPS)]
    _close(np.array(losses), ref["losses"], 1e-8)
    for k, v in ref["trained"].items():
        _close(p[k], v, 1e-8, 1e-10, k)


def test_elbo_f64_matches_reference_and_the_model(ref):
    Y, p = torch.tensor(ref["Y"]), _p(ref["params"])
    got = eval_f64.elbo_f64(p, Y, _cfg(), chunk=17)
    np.testing.assert_allclose(got, ref["elbo_f64"], rtol=1e-10)
    np.testing.assert_allclose(got, ref["elbo"], rtol=5e-5)


def test_dp_svi_bound_and_three_steps_match_reference(ref):
    Y, p = torch.tensor(ref["Yd"]), _p(ref["dparams"])
    cfg = _dcfg()
    with torch.no_grad():
        _close(float(dp_svi.elbo(p, Y, cfg)), ref["delbo"], 1e-9)
    opt = gp_optimizer(p, lr=1e-2, decay_steps=DP_STEPS)
    step = dp_svi.make_dp_svi_step(cfg, DP_N, opt, rho=0.3, rho_phi=0.1)
    idx = step.indices(prng.fold_in(prng.PRNGKey(100),
                                    torch.arange(DP_STEPS)))
    losses = [float(step(t, idx[t], Y)) for t in range(DP_STEPS)]
    _close(np.array(losses), ref["dlosses"], 1e-8)
    for k, v in ref["dtrained"].items():
        _close(p[k], v, 1e-8, 1e-10, k)


@pytest.mark.parametrize("refine", [0, REFINE])
def test_encoder_imputer_matches_reference(ref, refine):
    """One encoder pass (refine 0), or 20 inference steps from it; the
    served variance carries no q(X) floor while the predictive binds the
    noise floor, as the reference's."""
    Y, trained = torch.tensor(ref["Y"]), _p(ref["trained"])
    mask = torch.tensor(ref["mask"])
    impute = serving.make_encoder_imputer(trained, _cfg(),
                                          refine_steps=refine, device="cpu")
    got = impute(Y[::6] * mask, mask)
    for g, w in zip(got, ref["encoder_imputer"][refine]):
        _close(g, w, 1e-9, 1e-12)
    if refine == 0:
        # with the floor served, the variance would differ
        with torch.no_grad():
            floored = amortized.encode(
                svi_gplvm.constrain(trained, _cfg()), Y[::6])[1]
            bare = amortized.encode(svi_gplvm.constrain(trained), Y[::6])[1]
        assert float(torch.min(floored - bare)) > 0.99e-2


def test_impute_from_the_encoder_init_matches_reference(ref):
    Y, trained = torch.tensor(ref["Y"]), _p(ref["trained"])
    mask = torch.tensor(ref["mask"])
    got = svi_gplvm.impute(trained, Y[::6] * mask, mask, _cfg(),
                           num_steps=REFINE)
    for g, w in zip(got[:4], ref["impute"]):
        _close(g, w, 1e-9, 1e-12)


def test_dp_svi_imputers_match_reference(ref):
    """`make_dp_svi_imputer` from the encoder's init (no candidate table)
    and the one-pass encoder imputer with refinement, on the amortized
    DP-SVI."""
    Y, trained = torch.tensor(ref["Yd"]), _p(ref["dtrained"])
    mask = torch.tensor(ref["dmask"])
    y = Y[::5][:6]
    got = serving.make_dp_svi_imputer(trained, _dcfg(),
                                      num_steps=SERVE_STEPS, tol=None,
                                      device="cpu")(y, mask)
    for g, w in zip(got, ref["dp_imputer"]):
        _close(g, w, 1e-9, 1e-12)
    got = serving.make_encoder_imputer(trained, _dcfg(), model="dp_svi",
                                       refine_steps=REFINE,
                                       device="cpu")(y, mask)
    for g, w in zip(got, ref["dp_encoder_imputer"]):
        _close(g, w, 1e-9, 1e-12)


@pytest.mark.parametrize("model", ["svi_gplvm", "dp_svi"])
def test_streamed_step_is_the_resident_step_bit_for_bit(ref, model):
    """The host-fed (idx, rows) step against the step that gathers the rows
    from the resident Y: the encoder reads only the rows, so the two are
    one computation."""
    if model == "svi_gplvm":
        Y, params, cfg = torch.tensor(ref["Y"]), ref["params"], _cfg()

        def make(opt, streaming):
            return svi_gplvm.make_svi_natgrad_step(
                cfg, N, opt, rho=0.2, qu_trust=TRUST, streaming=streaming)
    else:
        Y, params, cfg = torch.tensor(ref["Yd"]), ref["dparams"], _dcfg()

        def make(opt, streaming):
            return dp_svi.make_dp_svi_step(cfg, DP_N, opt, rho=0.3,
                                           streaming=streaming)
    idx = torch.tensor([3, 3, 0, 31, 17, 4, 22, 8] * 2)
    p_res, p_str = _p(params), _p(params)
    res = make(gp_optimizer(p_res, lr=1e-2, slow=SLOW), False)
    st = make(gp_optimizer(p_str, lr=1e-2, slow=SLOW), True)
    for t in range(2):
        assert torch.equal(res(t, idx, Y), st(t, (idx, Y[idx].clone())))
    for k in p_res:
        assert torch.equal(p_res[k], p_str[k]), k
