"""The port at M = 256 inducing points, where the JAX package runs its
Pallas kernels and the port's K1 body and K2 run their tiled forms on the
card, against the JAX package, f64 on the CPU.

The port's plain versions of K1 (`suffstats_batched`), K4
(`psi2_batched`) and K2 (`psi2_bwd_batched`, finished) are held against
the Pallas kernels in interpret mode and against the reference's plain
functions; the DP-GP-LVM and Bayesian GP-LVM losses and gradients at
M = 256, from the reference's own init carried over with
`params_from_jax`, against its `loss` with `use_pallas=True` (interpret
mode, as its own tests run it) and `use_pallas=False`. N = 320 >= M / 2
keeps K_uu conditioned. Each JAX program is jitted once. The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic
from dp_gp_lvm_tpu.kernels import ard_rbf as jard
from dp_gp_lvm_tpu.kernels import ard_rbf_vjp as jvjp
from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.ops import dispatch as jdispatch
from dp_gp_lvm_tpu.ops.pallas import psi as jpsi
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import bgplvm as pbg
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm as pdp
from dp_gp_lvm_tpu_torch.ops import psi

T, N, M, Q, D = 2, 320, 256, 4, 6
BLOCK = 32           # the reference's Pallas row block at M = 256
RTOL = 1e-10         # plain against plain, f64
RTOL_PALLAS = 2e-6   # against the Pallas kernels (K4's pins its dots to f32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, weighted):
    r = np.random.default_rng(seed)
    arrs = dict(
        vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
        mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
        Zs=r.normal(size=(T, M, Q)), Y=r.normal(size=(N, D)),
        G=r.normal(size=(T, M, M)),
    )
    # mask-style weights (zeros included): the missing-data regime
    arrs["w"] = ((r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
                 if weighted else None)
    return arrs


def _j(a):
    return {k: None if v is None else jnp.asarray(v) for k, v in a.items()}


def _t(a):
    return {k: None if v is None else torch.as_tensor(v)
            for k, v in a.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_program(name, weighted):
    """One jitted reference program per kernel and weighting."""
    if name == "suffstats_pallas":
        return jax.jit(lambda vs, ards, mu, s, Zs, Y, w:
                       jpsi.suffstats_batched_pallas(
                           vs, ards, mu, s, Zs, Y, weights=w,
                           block_n=BLOCK, interpret=True))
    if name == "psi2_batched_pallas":
        return jax.jit(lambda vs, ards, mu, s, Zs, w:
                       jpsi.psi2_batched_pallas(
                           vs, ards, mu, s, Zs, weights=w, block_n=BLOCK,
                           interpret=True))
    if name == "psi2_bwd_pallas":
        return jax.jit(lambda vs, ards, mu, s, Zs, G, w:
                       jpsi.psi2_bwd_batched_pallas(
                           vs, ards, mu, s, Zs, G, weights=w,
                           block_n=BLOCK, interpret=True))
    if name == "psi2_bwd_plain":
        # the reference's plain Psi2 with its hand-derived VJP, atom by atom
        def stack(vs, ards, mu, s, Zs, w):
            return jax.vmap(lambda v, a, z: jvjp.psi2_analytic(
                v, a, mu, s, z, w, BLOCK))(vs, ards, Zs)

        if weighted:
            def pull(vs, ards, mu, s, Zs, G, w):
                return jax.vjp(stack, vs, ards, mu, s, Zs, w)[1](G)
        else:
            def pull(vs, ards, mu, s, Zs, G, w):
                return jax.vjp(lambda *x: stack(*x, None), vs, ards, mu, s,
                               Zs)[1](G)
        return jax.jit(pull)
    raise KeyError(name)


@pytest.mark.parametrize("weighted", [False, True])
def test_suffstats_at_m256_matches_the_reference(weighted):
    a = _inputs(1, weighted)
    j, t = _j(a), _t(a)
    keys = ("vs", "ards", "mu", "s", "Zs", "Y")
    p2, p1y = psi.suffstats_batched(*(t[k] for k in keys), t["w"])
    want = _jax_program("suffstats_pallas", weighted)(
        *(j[k] for k in keys), j["w"])
    _close(p2, want[0], RTOL_PALLAS)
    _close(p1y, want[1], RTOL_PALLAS)
    _, p1y_j, p2_j, _, _ = jdispatch.dp_batched_suffstats(
        *(j[k] for k in keys), j["w"], use_pallas=False)
    _close(p2, p2_j)
    _close(p1y, p1y_j)


@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_batched_at_m256_matches_the_reference(weighted):
    a = _inputs(2, weighted)
    j, t = _j(a), _t(a)
    keys = ("vs", "ards", "mu", "s", "Zs")
    got = psi.psi2_batched(*(t[k] for k in keys), t["w"])
    _close(got, _jax_program("psi2_batched_pallas", weighted)(
        *(j[k] for k in keys), j["w"]), RTOL_PALLAS)
    for i in range(T):
        _close(got[i], jard.psi2(j["vs"][i], j["ards"][i], j["mu"], j["s"],
                                 j["Zs"][i], j["w"], BLOCK))


@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_bwd_at_m256_matches_the_reference(weighted):
    a = _inputs(3, weighted)
    j, t = _j(a), _t(a)
    keys = ("vs", "ards", "mu", "s", "Zs", "G")
    raw = psi.psi2_bwd_batched(*(t[k] for k in keys), t["w"])
    gvar, gard, gmu, gs, gz, gw = psi.finish_psi2_bwd(t["vs"], t["ards"],
                                                      t["Zs"], raw)
    want = _jax_program("psi2_bwd_pallas", weighted)(
        *(j[k] for k in keys), j["w"])
    for g, w_ in zip((gvar, gard, gmu, gs, gz, gw), want):
        _close(g, w_, RTOL_PALLAS)
    plain = _jax_program("psi2_bwd_plain", weighted)(
        *(j[k] for k in keys), j["w"])
    for g, w_ in zip((gvar, gard, gmu, gs, gz) + ((gw,) if weighted else ()),
                     plain):
        _close(g, w_)


@functools.lru_cache(maxsize=None)
def _model_case(family, use_pallas):
    """The reference's data, init and jitted value-and-grad at M = 256."""
    key = jax.random.PRNGKey(256)
    Y, _ = synthetic.mocap_like(key, n=N, d=D, dtype=jnp.float64)
    if family == "dp":
        cfg = jdp.Config(num_latent=Q, num_inducing=M, truncation=T,
                         use_pallas=use_pallas)
        params = jdp.init_params(key, Y, cfg)
        loss = jdp.loss
    else:
        cfg = jbg.Config(num_latent=Q, num_inducing=M,
                         use_pallas=use_pallas)
        params = jbg.init_params(key, Y, cfg)
        loss = jbg.loss
    vg = jax.jit(jax.value_and_grad(lambda p: loss(p, Y, cfg)))
    return params, Y, vg(params)


RTOL_MODEL, RTOL_MODEL_GRAD = 1e-9, 1e-7


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "pallas"])
@pytest.mark.parametrize("family", ["dp", "bgplvm"])
def test_model_loss_and_gradients_at_m256_match_the_reference(family,
                                                              use_pallas):
    """The port's fused path (K1 and K2, or K6, K5 and K2; their plain
    versions here) against the reference's loss and jax.grad at
    RTOL_MODEL / RTOL_MODEL_GRAD: against its plain path, and against its
    Pallas path for the DP-GP-LVM (whose K1 and K2 Pallas kernels lie
    3.6e-12 off its plain loss here, z's gradient 4.7e-09 scaled). The
    Bayesian GP-LVM's Pallas case is a smoke check only: K5's and K6's
    Pallas kernels pin f32 dots, which K_uu's solves amplify at M = 256
    (its loss 1.0e-3 and its z gradient 0.81 scaled off the reference's
    plain f64 path here; every leaf at least 3.8e-3), so there the port
    may differ by twice that gap; the plain case holds the port."""
    params, Y, (jloss, jgrads) = _model_case(family, use_pallas)
    _, _, (ploss, pgrads) = _model_case(family, False)
    smoke = family == "bgplvm" and use_pallas
    tp = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                         "cpu", torch.float64)
    Yt = torch.as_tensor(np.array(Y))
    if family == "dp":
        model, cfg = pdp, pdp.Config(num_latent=Q, num_inducing=M,
                                     truncation=T, use_fused=True)
    else:
        model, cfg = pbg, pbg.Config(num_latent=Q, num_inducing=M,
                                     use_fused=True)
    loss = model.loss(tp, Yt, cfg)
    want = float(jloss)
    tol = RTOL_MODEL * abs(want)
    if smoke:
        tol = max(tol, 2.0 * abs(float(ploss) - want))
    assert abs(float(loss.detach()) - want) <= tol
    grads = torch.autograd.grad(loss, list(tp.values()))
    for k, g in zip(tp, grads):
        want = np.asarray(jgrads[k])
        tol = RTOL_MODEL_GRAD * float(np.abs(want).max())
        if smoke:
            tol = max(tol, 2.0 * float(np.abs(np.asarray(pgrads[k])
                                              - want).max()))
        assert float(np.abs(g.numpy() - want).max()) <= tol, k
