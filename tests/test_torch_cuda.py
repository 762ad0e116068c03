"""The port's CUDA kernels K1 and K2 on the card, against their plain
versions in f64. Marked `cuda`; they skip on a host without a CUDA device.

This file imports neither JAX nor the JAX package, so on the GPU machine
(which has no JAX) it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.ops import psi

T, N, M, Q, D = 3, 37, 6, 3, 4
TOL_K1, TOL_K2 = 1e-4, 5e-4   # scaled by max|ref|, as in chip_smoke.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(card, weighted):
    r = np.random.default_rng(7)
    arrs = dict(
        vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
        mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
        Zs=r.normal(size=(T, M, Q)), Y=r.normal(size=(N, D)),
        w=(r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N),
        G=r.normal(size=(T, M, M)),
    )
    f64 = {k: torch.as_tensor(v, device=card) for k, v in arrs.items()}
    if not weighted:
        f64["w"] = None
    f32 = {k: None if v is None else v.float().contiguous()
           for k, v in f64.items()}
    return f64, f32


def _scaled_errors(got, want):
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_kernels_match_plain_on_card(card, weighted):
    a, f = _inputs(card, weighted)
    psi.reset_launch_counts()
    got = psi.suffstats_batched(f["vs"], f["ards"], f["mu"], f["s"], f["Zs"],
                                f["Y"], f["w"])
    want = psi.suffstats_batched_reference(a["vs"], a["ards"], a["mu"],
                                           a["s"], a["Zs"], a["Y"], a["w"])
    assert max(_scaled_errors(got, want)) <= TOL_K1
    got = psi.psi2_bwd_batched(f["vs"], f["ards"], f["mu"], f["s"], f["Zs"],
                               f["G"], f["w"])
    want = psi.psi2_bwd_batched_reference(a["vs"], a["ards"], a["mu"],
                                          a["s"], a["Zs"], a["G"], a["w"])
    assert max(_scaled_errors(got, want)) <= TOL_K2
    assert psi.LAUNCHES == {"suffstats_batched": 1, "psi2_bwd_batched": 1}


@pytest.mark.cuda
def test_fused_op_gradients_on_card(card):
    """SuffstatsBatchedFused on the card (K1 forward, K2 backward) against
    the same op on the CPU in f64 (plain versions)."""
    a, f = _inputs(card, weighted=True)
    names = ("vs", "ards", "mu", "s", "Zs", "Y", "w")

    def run(tensors):
        leaves = [tensors[k].detach().clone().requires_grad_() for k in names]
        p2, p1y = psi.suffstats_batched_fused(*leaves[:6], leaves[6])
        val = torch.sum(p2 ** 2) + torch.sum(torch.sin(p1y))
        return torch.autograd.grad(val, leaves)

    got = run(f)
    want = run({k: a[k].cpu() for k in names})
    for g, w in zip(got, want):
        assert float((g.cpu().double() - w).abs().max()) <= TOL_K2 * float(
            w.abs().max())


@pytest.mark.cuda
def test_wrapper_refuses_float64_on_card(card):
    a, _ = _inputs(card, weighted=False)
    with pytest.raises(TypeError, match="float32"):
        psi.suffstats_batched(a["vs"], a["ards"], a["mu"], a["s"], a["Zs"],
                              a["Y"])
