"""Port's fused psi-statistics op (dp_gp_lvm_tpu_torch/ops/psi.py) against
the JAX package, f64 on the CPU.

The plain versions of K1 (suffstats) and K2 (Psi2 pullback) are held
against the Pallas kernels run in interpret mode, and the autograd
gradients of `SuffstatsBatchedFused` against `jax.grad` through
`suffstats_batched_fused`. Sizes are tiny and N=37 leaves a ragged last
block. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.ops import dispatch as jdispatch
from dp_gp_lvm_tpu.ops.pallas import psi as jpsi
from dp_gp_lvm_tpu_torch.ops import dispatch, psi

T, N, M, Q, D = 3, 37, 6, 3, 4
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0, weighted=False):
    r = np.random.default_rng(seed)
    arrs = dict(
        vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
        mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
        Zs=r.normal(size=(T, M, Q)), Y=r.normal(size=(N, D)),
    )
    if weighted:
        # mask-style weights (zeros included): the missing-data regime
        arrs["w"] = (r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
    return arrs


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _t(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("weighted", [False, True])
def test_suffstats_reference_matches_pallas_interpret(weighted):
    a = _inputs(1, weighted)
    j, t = _j(a), _t(a)
    jw, tw = j.get("w"), t.get("w")
    p2_j, p1y_j = jpsi.suffstats_batched_pallas(
        j["vs"], j["ards"], j["mu"], j["s"], j["Zs"], j["Y"], weights=jw,
        block_n=8, interpret=True)
    p2_t, p1y_t = psi.suffstats_batched(
        t["vs"], t["ards"], t["mu"], t["s"], t["Zs"], t["Y"], tw, block_n=8)
    _close(p2_t, p2_j)
    _close(p1y_t, p1y_j)


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_dp_batched_suffstats_matches_jax(use_fused, weighted):
    a = _inputs(2, weighted)
    j, t = _j(a), _t(a)
    want = jdispatch.dp_batched_suffstats(
        j["vs"], j["ards"], j["mu"], j["s"], j["Zs"], j["Y"], j.get("w"),
        use_pallas=False)
    got = dispatch.dp_batched_suffstats(
        t["vs"], t["ards"], t["mu"], t["s"], t["Zs"], t["Y"], t.get("w"),
        use_fused=use_fused)
    for g, w in zip(got, want):
        _close(g, w)


def test_psi2_bwd_reference_matches_pallas_interpret():
    a = _inputs(3, weighted=True)
    G = np.random.default_rng(4).normal(size=(T, M, M))
    j, t = _j(a), _t(a)
    want = jpsi.psi2_bwd_batched_pallas(
        j["vs"], j["ards"], j["mu"], j["s"], j["Zs"], jnp.asarray(G),
        weights=j["w"], block_n=8, interpret=True)
    raw = psi.psi2_bwd_batched(t["vs"], t["ards"], t["mu"], t["s"], t["Zs"],
                               torch.as_tensor(G), t["w"], block_n=8)
    got = psi.finish_psi2_bwd(t["vs"], t["ards"], t["Zs"], raw)
    for g, w in zip(got, want):
        _close(g, w)


def test_suffstats_fused_weighted_gradients_match_jax():
    a = _inputs(5, weighted=True)
    j = _j(a)
    order = ("vs", "ards", "mu", "s", "Zs", "w", "Y")

    def f_jax(v, ar, m_, s_, z_, w_, y_):
        p2, p1y = jpsi.suffstats_batched_fused(v, ar, m_, s_, z_, y_, w_, 8,
                                               True)
        return jnp.sum(p2 ** 2) + jnp.sum(jnp.sin(p1y))

    args = [j[k] for k in order]
    val_j = f_jax(*args)
    grads_j = jax.grad(f_jax, argnums=tuple(range(7)))(*args)

    targs = [torch.tensor(a[k], requires_grad=True) for k in order]
    v, ar, m_, s_, z_, w_, y_ = targs
    p2, p1y = psi.suffstats_batched_fused(v, ar, m_, s_, z_, y_, w_, 8)
    val_t = torch.sum(p2 ** 2) + torch.sum(torch.sin(p1y))
    grads_t = torch.autograd.grad(val_t, targs)
    _close(val_t, val_j)
    for g, w in zip(grads_t, grads_j):
        _close(g, w)


def test_wrapper_rejects_a_tensor_off_cpu_and_cuda():
    """A wrapper takes the plain version only for CPU tensors; anything
    else goes to the kernel, which checks and raises."""
    a = _t(_inputs(6))
    meta = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises((ValueError, RuntimeError)):
        psi.suffstats_batched(meta["vs"], meta["ards"], meta["mu"],
                              meta["s"], meta["Zs"], meta["Y"])
