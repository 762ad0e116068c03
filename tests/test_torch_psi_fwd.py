"""The port's single-output psi ops (dp_gp_lvm_tpu_torch/ops/psi.py: K4
`psi2_batched`, K5 `psi2_single`, K6 `psi1`) against the JAX package, f64
on the CPU.

Each plain version is held against the reference's plain f64 function at
rtol 1e-10 and against its Pallas kernel run in interpret mode. These
three Pallas kernels pin `preferred_element_type=jnp.float32` on their
dots whatever the input type (ops/pallas/psi.py:80-96, 189-190, 265-278),
so in interpret mode they carry f32 rounding (~1e-7 relative) even on f64
inputs; against them the tolerance is RTOL_PALLAS. Gradients use a fixed
cotangent, so that the reference's f64 backward is not fed that rounding,
and are held at rtol 1e-8. Sizes are tiny and N=37 leaves a ragged last
block. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.kernels import ard_rbf as jard
from dp_gp_lvm_tpu.ops import dispatch as jdispatch
from dp_gp_lvm_tpu.ops.pallas import psi as jpsi
from dp_gp_lvm_tpu_torch.kernels import ard_rbf_vjp
from dp_gp_lvm_tpu_torch.ops import dispatch, psi

T, N, M, Q = 3, 37, 6, 3
RTOL = 1e-10
RTOL_GRAD = 1e-8
RTOL_PALLAS = 2e-6   # f32 dots inside the K4/K5/K6 Pallas kernels


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
        Zs=r.normal(size=(T, M, Q)),
    )
    # mask-style weights (zeros included): the missing-data regime
    arrs["w"] = ((r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
                 if weighted else None)
    return arrs


def _single(a):
    """The first atom's kernel: variance (), ard (Q,), Z (M, Q)."""
    return dict(v=a["vs"][0], ard=a["ards"][0], mu=a["mu"], s=a["s"],
                Z=a["Zs"][0], w=a["w"])


def _j(a):
    return {k: None if v is None else jnp.asarray(v) for k, v in a.items()}


def _t(a, grad=False):
    return {k: None if v is None else torch.tensor(v, requires_grad=grad)
            for k, v in a.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0.0)


@pytest.mark.parametrize("weighted", [False, True])
def test_psi1_reference_matches_pallas_interpret(weighted):
    a = _single(_inputs(1, weighted))
    j, t = _j(a), _t(a)
    want = jpsi.psi1_pallas(j["v"], j["ard"], j["mu"], j["s"], j["Z"],
                            weights=j["w"], block_n=8, interpret=True)
    got = psi.psi1(t["v"], t["ard"], t["mu"], t["s"], t["Z"], t["w"],
                   block_n=8)
    assert got.shape == (N, M)
    _close(got, want, RTOL_PALLAS)
    _close(got, jard.psi1(j["v"], j["ard"], j["mu"], j["s"], j["Z"], j["w"]))


@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_single_reference_matches_pallas_interpret(weighted):
    a = _single(_inputs(2, weighted))
    j, t = _j(a), _t(a)
    want = jpsi.psi2_pallas(j["v"], j["ard"], j["mu"], j["s"], j["Z"],
                            weights=j["w"], block_n=8, interpret=True)
    got = psi.psi2_single(t["v"], t["ard"], t["mu"], t["s"], t["Z"], t["w"],
                          block_n=8)
    _close(got, want, RTOL_PALLAS)
    _close(got, jard.psi2(j["v"], j["ard"], j["mu"], j["s"], j["Z"], j["w"],
                          8))


@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_batched_reference_matches_pallas_interpret(weighted):
    a = _inputs(3, weighted)
    j, t = _j(a), _t(a)
    want = jpsi.psi2_batched_pallas(j["vs"], j["ards"], j["mu"], j["s"],
                                    j["Zs"], weights=j["w"], block_n=8,
                                    interpret=True)
    got = psi.psi2_batched(t["vs"], t["ards"], t["mu"], t["s"], t["Zs"],
                           t["w"], block_n=8)
    _close(got, want, RTOL_PALLAS)
    for i in range(T):
        _close(got[i], jard.psi2(j["vs"][i], j["ards"][i], j["mu"], j["s"],
                                 j["Zs"][i], j["w"], 8))


def test_psi1_fused_gradients_match_jax():
    a = _single(_inputs(4, False))
    names = ("v", "ard", "mu", "s", "Z")
    j = _j(a)
    ct = np.random.default_rng(40).normal(size=(N, M))

    def f_jax(*args):
        return jnp.sum(jpsi.psi1_fused(*args, 8, True) * ct)

    want = jax.grad(f_jax, argnums=tuple(range(5)))(*(j[k] for k in names))
    t = _t({k: a[k] for k in names}, grad=True)
    out = psi.psi1_fused(*(t[k] for k in names))
    got = torch.autograd.grad(torch.sum(out * torch.tensor(ct)),
                              [t[k] for k in names])
    for g, w in zip(got, want):
        _close(g, w, RTOL_GRAD)


@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_fused_gradients_match_jax(weighted):
    a = _single(_inputs(5, weighted))
    names = ("v", "ard", "mu", "s", "Z") + (("w",) if weighted else ())
    j = _j(a)
    ct = np.random.default_rng(50).normal(size=(M, M))

    def f_jax(*args):
        return jnp.sum(jpsi.psi2_fused(
            *args[:5], args[5] if weighted else None, 8, True) * ct)

    want = jax.grad(f_jax, argnums=tuple(range(len(names))))(
        *(j[k] for k in names))
    t = _t({k: a[k] for k in names}, grad=True)
    out = psi.psi2_fused(*(t[k] for k in names[:5]), t.get("w"), 8)
    got = torch.autograd.grad(torch.sum(out * torch.tensor(ct)),
                              [t[k] for k in names])
    for g, w in zip(got, want):
        _close(g, w, RTOL_GRAD)


def test_psi2_batched_fused_weighted_gradients_match_jax():
    a = _inputs(6, True)
    names = ("vs", "ards", "mu", "s", "Zs", "w")
    j = _j(a)
    ct = np.random.default_rng(60).normal(size=(T, M, M))

    def f_jax(*args):
        return jnp.sum(jpsi.psi2_batched_fused(*args, 8, True) * ct)

    want = jax.grad(f_jax, argnums=tuple(range(6)))(*(j[k] for k in names))
    t = _t(a, grad=True)
    out = psi.psi2_batched_fused(*(t[k] for k in names), 8)
    got = torch.autograd.grad(torch.sum(out * torch.tensor(ct)),
                              [t[k] for k in names])
    for g, w in zip(got, want):
        _close(g, w, RTOL_GRAD)


@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_fused_backward_equals_the_analytic_backward(weighted):
    """On the CPU `Psi2Fused` pulls back through K2's plain version with
    the atom dim set to one; that must be `ard_rbf_vjp._bwd`, which the
    reference's `psi2_fused` uses."""
    a = _t(_single(_inputs(7, weighted)))
    G = torch.tensor(np.random.default_rng(8).normal(size=(M, M)))
    args = (a["v"], a["ard"], a["mu"], a["s"], a["Z"])
    raw = psi.psi2_bwd_batched(a["v"].reshape(1), a["ard"][None], a["mu"],
                               a["s"], a["Z"][None], G[None], a["w"], 8)
    gvar, gard, gmu, gs, gz, gw = psi.finish_psi2_bwd(
        a["v"].reshape(1), a["ard"][None], a["Z"][None], raw)
    want = ard_rbf_vjp._bwd(8, *args, a["w"], G)
    for g, w in zip((gvar[0], gard[0], gmu, gs, gz[0]), want[:5]):
        _close(g, w.numpy())
    if weighted:
        _close(gw, want[5].numpy())
    else:
        assert want[5] is None


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_psi_stats_matches_jax_on_both_branches(use_fused, weighted):
    a = _single(_inputs(9, weighted))
    j, t = _j(a), _t(a)
    want = jdispatch.psi_stats(j["v"], j["ard"], j["mu"], j["s"], j["Z"],
                               weights=j["w"], block_n=8,
                               use_pallas=use_fused)
    got = dispatch.psi_stats(t["v"], t["ard"], t["mu"], t["s"], t["Z"],
                             weights=t["w"], block_n=8, use_fused=use_fused)
    for g, w in zip(got, want):
        _close(g, w, RTOL_PALLAS if use_fused else RTOL)
    # in f64 either branch of the port is the reference's plain path
    plain = jdispatch.psi_stats(j["v"], j["ard"], j["mu"], j["s"], j["Z"],
                                weights=j["w"], block_n=8)
    for g, w in zip(got, plain):
        _close(g, w)


@pytest.mark.parametrize("use_fused", [True, False])
def test_dispatch_psi2_batched_matches_jax(use_fused):
    a = _inputs(10, True)
    j, t = _j(a), _t(a)
    want = jpsi.psi2_batched_pallas(j["vs"], j["ards"], j["mu"], j["s"],
                                    j["Zs"], weights=j["w"], block_n=8,
                                    interpret=True)
    got = dispatch.psi2_batched(t["vs"], t["ards"], t["mu"], t["s"], t["Zs"],
                                t["w"], 8, use_fused=use_fused)
    _close(got, want, RTOL_PALLAS)


def test_psi_stats_refuses_the_linear_kernel():
    """No fused kernel takes the linear kernel: asked for the fused path,
    psi_stats gives the linear kernel's plain statistics, the reference's
    dispatch; a kernel neither package has is refused."""
    a = _single(_inputs(11, True))
    j, t = _j(a), _t(a)
    want = jdispatch.psi_stats(j["v"], j["ard"], j["mu"], j["s"], j["Z"],
                               j["w"], kernel="linear")
    got = dispatch.psi_stats(t["v"], t["ard"], t["mu"], t["s"], t["Z"],
                             t["w"], use_fused=True, kernel="linear")
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError, match="unknown kernel"):
        dispatch.psi_stats(t["v"], t["ard"], t["mu"], t["s"], t["Z"],
                           kernel="matern")


def test_new_wrappers_reject_a_tensor_off_cpu_and_cuda():
    """A wrapper takes the plain version only for CPU tensors; anything
    else goes to the kernel, which checks and raises."""
    a = _inputs(12, False)
    meta = {k: torch.tensor(v).to("meta") for k, v in a.items()
            if v is not None}
    one = (meta["vs"][0], meta["ards"][0], meta["mu"], meta["s"],
           meta["Zs"][0])
    for call in (lambda: psi.psi1(*one), lambda: psi.psi2_single(*one),
                 lambda: psi.psi2_batched(meta["vs"], meta["ards"],
                                          meta["mu"], meta["s"], meta["Zs"])):
        with pytest.raises((ValueError, RuntimeError)):
            call()
