"""The port's CUDA kernels (K1, K2, K4, K5, K6) and the fused ops built
on them, on the card, against their plain versions in f64. Marked `cuda`;
they skip on a host without a CUDA device.

This file imports neither JAX nor the JAX package, so on the GPU machine
(which has no JAX) it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.ops import psi

T, N, M, Q, D = 3, 37, 6, 3, 4
TINY = dict(T=T, N=N, M=M, Q=Q, D=D)
# the c2_sparse_oil widths: neither M nor N is a multiple of the kernels'
# 4x4 tile, 16-row stage or 64-row block
C2 = dict(T=1, N=1000, M=50, Q=10, D=12)
# the widths of the gated configs c1_bgplvm_toy (the Bayesian GP-LVM:
# K6, K5 and K2 at T = 1) and c5_pose_missing (the DP-GP-LVM on its
# 448-row train split: K1 and K2); both Q take the generic instantiations
C1 = dict(T=1, N=100, M=20, Q=6, D=10)
C5_POSE = dict(T=12, N=448, M=48, Q=8, D=32)
# c6_svi_bigN's minibatch: K1 and K2 at T = 1 through dispatch.suff_stats
C6 = dict(T=1, N=1024, M=64, Q=8, D=32)
# c3_mrd_twoview, one view: its 224 training rows, M below the 4 x 4
# tiles' sweet spot and Q = 4 (the generic instantiations)
C3 = dict(T=1, N=224, M=32, Q=4, D=8)
# c7_dp_svi's minibatch: K1 and K2 at T = 8 through
# dispatch.dp_batched_suffstats
C7 = dict(T=8, N=2048, M=64, Q=8, D=32)
SHAPES = [TINY, C2, C1, C5_POSE, C3, C7]
SHAPE_IDS = ["tiny", "c2", "c1", "c5_pose", "c3", "c7"]
TOL_K1, TOL_K2 = 1e-4, 5e-4   # scaled by max|ref|, as in chip_smoke.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(card, weighted, T=T, N=N, M=M, Q=Q, D=D):
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
            for g, w in zip((x.detach() for x in got),
                            (x.detach() for x in want))]


def _launched(**counts):
    return {**dict.fromkeys(psi.LAUNCHES, 0), **counts}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_kernels_match_plain_on_card(card, weighted, shape):
    a, f = _inputs(card, weighted, **shape)
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
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_bwd_batched=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_psi2_and_psi1_forwards_match_plain_on_card(card, weighted, shape):
    """K4 on the stack, K5 and K6 on its first atom."""
    a, f = _inputs(card, weighted, **shape)
    psi.reset_launch_counts()
    got = psi.psi2_batched(f["vs"], f["ards"], f["mu"], f["s"], f["Zs"],
                           f["w"])
    want = psi.psi2_batched_reference(a["vs"], a["ards"], a["mu"], a["s"],
                                      a["Zs"], a["w"])
    assert max(_scaled_errors([got], [want])) <= TOL_K1

    def one(t):
        return (t["vs"][0], t["ards"][0].contiguous(), t["mu"], t["s"],
                t["Zs"][0].contiguous(), t["w"])

    got = psi.psi2_single(*one(f))
    want = psi.psi2_single_reference(*one(a))
    assert got.shape == want.shape
    assert max(_scaled_errors([got], [want])) <= TOL_K1
    got = psi.psi1(*one(f))
    want = psi.psi1_reference(*one(a))
    assert got.shape == want.shape
    assert max(_scaled_errors([got], [want])) <= TOL_K1
    assert psi.LAUNCHES == _launched(psi2_batched=1, psi2_single=1, psi1=1)


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
@pytest.mark.parametrize("op", ["psi2_batched", "psi2", "psi1"])
def test_single_output_fused_op_gradients_on_card(card, op):
    """Psi2BatchedFused (K4, K2), Psi2Fused (K5, K2 at T = 1) and Psi1Fused
    (K6, plain pullback) on the card against the same op on the CPU in f64
    (plain versions), row weights included where the op takes them."""
    a, f = _inputs(card, weighted=True)

    def run(t):
        if op == "psi2_batched":
            leaves = [t[k] for k in ("vs", "ards", "mu", "s", "Zs", "w")]
            fn = psi.psi2_batched_fused
        else:
            leaves = [t["vs"][0], t["ards"][0], t["mu"], t["s"], t["Zs"][0]]
            leaves += [t["w"]] if op == "psi2" else []
            fn = psi.psi2_fused if op == "psi2" else psi.psi1_fused
        leaves = [x.detach().clone().contiguous().requires_grad_()
                  for x in leaves]
        out = fn(*leaves)
        return torch.autograd.grad(torch.sum(out ** 2) + torch.sum(
            torch.sin(out)), leaves)

    got = run(f)
    want = run({k: v.cpu() for k, v in a.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu().double() - w).abs().max()) <= TOL_K2 * float(
            w.abs().max())


@pytest.mark.cuda
def test_wrapper_refuses_float64_on_card(card):
    a, _ = _inputs(card, weighted=False)
    with pytest.raises(TypeError, match="float32"):
        psi.suffstats_batched(a["vs"], a["ards"], a["mu"], a["s"], a["Zs"],
                              a["Y"])
    with pytest.raises(TypeError, match="float32"):
        psi.psi2_batched(a["vs"], a["ards"], a["mu"], a["s"], a["Zs"])
    with pytest.raises(TypeError, match="float32"):
        psi.psi2_single(a["vs"][0], a["ards"][0], a["mu"], a["s"], a["Zs"][0])
    with pytest.raises(TypeError, match="float32"):
        psi.psi1(a["vs"][0], a["ards"][0], a["mu"], a["s"], a["Zs"][0])


def _k2(t):
    return (t["vs"], t["ards"], t["mu"], t["s"], t["Zs"], t["G"], t["w"])


def _k2_errors(got, want):
    """Scaled errors where an output may be exactly zero (every row weight
    zero): then the kernel's must be zero too."""
    return [float((g.double() - w).abs().max())
            / max(float(w.abs().max()), 1e-30) for g, w in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [1, 3])
@pytest.mark.parametrize("M_", [1, 33, 128])
@pytest.mark.parametrize("N_", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_k2_matches_plain_at_edge_shapes(card, weighted, N_, M_, T_):
    """K2 against its plain version in f64 where its geometry is ragged:
    one row, a block of fewer rows than a batch, one inducing point, M
    across warps and slices, the largest M."""
    a, f = _inputs(card, weighted, T=T_, N=N_, M=M_, Q=10)
    psi.reset_launch_counts()
    got = psi.psi2_bwd_batched(*_k2(f))
    want = psi.psi2_bwd_batched_reference(*_k2(a))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert max(_k2_errors(got, want)) <= TOL_K2
    assert psi.LAUNCHES == _launched(psi2_bwd_batched=1)


@pytest.mark.cuda
@pytest.mark.parametrize("M_", [33, 128])
@pytest.mark.parametrize("Q_", [12, 20, 32, 40])
def test_k2_matches_plain_at_wide_latents(card, Q_, M_):
    """The generic instantiation for Q > 10: passes of 8 gradient columns,
    the last one partial at Q = 12 and 20; Q = 40 fills shared memory at
    M = 128."""
    a, f = _inputs(card, True, T=2, N=70, M=M_, Q=Q_)
    got = psi.psi2_bwd_batched(*_k2(f))
    want = psi.psi2_bwd_batched_reference(*_k2(a))
    assert max(_scaled_errors(got, want)) <= TOL_K2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [C2, dict(T=4, N=300, M=64, Q=10, D=4),
                                   dict(T=2, N=70, M=33, Q=20, D=4)],
                         ids=["c2", "t4", "q20"])
def test_k2_launches_repeat_bit_for_bit(card, shape):
    _, f = _inputs(card, True, **shape)
    first = psi.psi2_bwd_batched(*_k2(f))
    second = psi.psi2_bwd_batched(*_k2(f))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_k2_wrapper_refuses_what_the_kernel_does_not_take(card):
    a, f = _inputs(card, weighted=True)
    with pytest.raises(TypeError, match="float32"):
        psi.psi2_bwd_batched(*_k2(a))
    k2 = list(_k2(f))
    k2[5] = f["G"].mT
    with pytest.raises(ValueError, match="contiguous"):
        psi.psi2_bwd_batched(*k2)
    k2[5] = f["G"][:, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        psi.psi2_bwd_batched(*k2)
    # past both forms: M = 513 is past the tiled form's MAX_M_TILED, and
    # at Q = 256 no block fits an SM at M = 128
    _, big = _inputs(card, False, T=1, N=4, M=513, Q=2)
    with pytest.raises(RuntimeError, match="past the tiled form's M <= 512 "
                                           "at M=513, Q=2"):
        psi.psi2_bwd_batched(*_k2(big))
    _, wide = _inputs(card, False, T=1, N=4, M=128, Q=256)
    with pytest.raises(RuntimeError, match="no block fits an SM at M=128, "
                                           "Q=256"):
        psi.psi2_bwd_batched(*_k2(wide))


def _k1(t):
    return (t["vs"], t["ards"], t["mu"], t["s"], t["Zs"], t["Y"], t["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [1, 3])
@pytest.mark.parametrize("M_", [1, 33, 128])
@pytest.mark.parametrize("N_", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_k1_matches_plain_at_edge_shapes(card, weighted, N_, M_, T_):
    """K1 against its plain version in f64 where its geometry is ragged:
    one row, a block of fewer rows than a stage, one inducing point, M
    across tiles and warps, the largest M; D not a multiple of the 4-wide
    Psi1^T Y tile. Zero weights included (all of them, at N=1 weighted)."""
    a, f = _inputs(card, weighted, T=T_, N=N_, M=M_, Q=10, D=7)
    psi.reset_launch_counts()
    got = psi.suffstats_batched(*_k1(f))
    want = psi.suffstats_batched_reference(*_k1(a))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert max(_k2_errors(got, want)) <= TOL_K1
    assert psi.LAUNCHES == _launched(suffstats_batched=1)


@pytest.mark.cuda
@pytest.mark.parametrize("M_", [33, 128])
@pytest.mark.parametrize("Q_", [12, 20, 40])
def test_k1_matches_plain_at_wide_latents(card, Q_, M_):
    """Q beyond every configuration's 10; Q = 40 at M = 128 stages fewer
    rows at once to fit shared memory."""
    a, f = _inputs(card, True, T=2, N=70, M=M_, Q=Q_, D=5)
    got = psi.suffstats_batched(*_k1(f))
    want = psi.suffstats_batched_reference(*_k1(a))
    assert max(_scaled_errors(got, want)) <= TOL_K1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [C2, dict(T=4, N=300, M=64, Q=10, D=59),
                                   dict(T=2, N=90, M=20, Q=5, D=300)],
                         ids=["c2", "t4", "wide_d"])
def test_k1_launches_repeat_bit_for_bit(card, shape):
    """Two launches on the same inputs give the same bits: at the c2
    widths, at T=4, and where D needs two walks of the rows."""
    _, f = _inputs(card, True, **shape)
    first = psi.suffstats_batched(*_k1(f))
    second = psi.suffstats_batched(*_k1(f))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_k1_wrapper_refuses_what_the_kernel_does_not_take(card):
    a, f = _inputs(card, weighted=True)
    with pytest.raises(TypeError, match="float32"):
        psi.suffstats_batched(*_k1(a))
    k1 = list(_k1(f))
    k1[4] = f["Zs"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        psi.suffstats_batched(*k1)
    k1[4] = f["Zs"]
    k1[5] = f["Y"][:-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        psi.suffstats_batched(*k1)
    # past both forms: Q = 256 fits neither block, at M = 129 (the tiled
    # form's) or M = 128
    _, big = _inputs(card, False, T=1, N=4, M=129, Q=256)
    with pytest.raises(RuntimeError, match="no block fits an SM at M=129, "
                                           "Q=256"):
        psi.suffstats_batched(*_k1(big))
    _, wide = _inputs(card, False, T=1, N=4, M=128, Q=256)
    with pytest.raises(RuntimeError, match="no block fits an SM at M=128, "
                                           "Q=256"):
        psi.suffstats_batched(*_k1(wide))


def _k45(t):
    return (t["vs"], t["ards"], t["mu"], t["s"], t["Zs"], t["w"])


def _one(t):
    """The inputs of K5: the first atom of the stack."""
    return (t["vs"][0], t["ards"][0].contiguous(), t["mu"], t["s"],
            t["Zs"][0].contiguous(), t["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [1, 3])
@pytest.mark.parametrize("M_", [1, 33, 128])
@pytest.mark.parametrize("N_", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_k4_k5_match_plain_at_edge_shapes(card, weighted, N_, M_, T_):
    """K4 on the stack and K5 on its first atom against their plain
    versions in f64 where the shared body's geometry is ragged: one row, a
    block of fewer rows than a stage, one inducing point, M across tiles
    and warps, the largest M. Zero weights included (all of them, at N=1
    weighted)."""
    a, f = _inputs(card, weighted, T=T_, N=N_, M=M_, Q=10)
    psi.reset_launch_counts()
    got = psi.psi2_batched(*_k45(f))
    want = psi.psi2_batched_reference(*_k45(a))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max(_k2_errors([got], [want])) <= TOL_K1
    got = psi.psi2_single(*_one(f))
    want = psi.psi2_single_reference(*_one(a))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max(_k2_errors([got], [want])) <= TOL_K1
    assert psi.LAUNCHES == _launched(psi2_batched=1, psi2_single=1)


@pytest.mark.cuda
@pytest.mark.parametrize("M_", [33, 128])
@pytest.mark.parametrize("Q_", [12, 20, 40])
def test_k4_k5_match_plain_at_wide_latents(card, Q_, M_):
    """Q beyond every configuration's 10, through the generic
    instantiation."""
    a, f = _inputs(card, True, T=2, N=70, M=M_, Q=Q_)
    got = psi.psi2_batched(*_k45(f))
    assert max(_scaled_errors([got], [psi.psi2_batched_reference(
        *_k45(a))])) <= TOL_K1
    got = psi.psi2_single(*_one(f))
    assert max(_scaled_errors([got], [psi.psi2_single_reference(
        *_one(a))])) <= TOL_K1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [C2, dict(T=4, N=300, M=64, Q=10, D=4),
                                   dict(T=2, N=70, M=33, Q=20, D=4)],
                         ids=["c2", "t4", "q20"])
def test_k4_k5_launches_repeat_bit_for_bit(card, shape):
    _, f = _inputs(card, True, **shape)
    assert torch.equal(psi.psi2_batched(*_k45(f)), psi.psi2_batched(*_k45(f)))
    assert torch.equal(psi.psi2_single(*_one(f)), psi.psi2_single(*_one(f)))


# K1 at a fixed input and a fixed launch geometry (no SM count or occupancy
# enters): (T, N, M, Q, D), (groups, stage rows, rows per chunk, chunks) and
# the first 16 hex digits of the sha256 of its Psi2 and Psi1^T Y bytes, as
# K1 gave them on an H100 (compute capability 9.0), built by nvcc 12.9
# (V12.9.86) for sm_90a, before its body was shared with K4 and K5. The
# Q = 10 instantiations at M4 = 64 and 128 and the generic one. Another
# nvcc or CUDA runtime may move the bits of a correct kernel: then record
# them again from the package before the change, on the same card.
K1_BITS = [
    ((3, 200, 64, 10, 59), (4, 32, 67, 3), "4693a0ddddb1f9b9"),
    ((1, 100, 50, 10, 12), (1, 4, 25, 4), "e8501ad308958f06"),
    ((2, 100, 128, 10, 60), (1, 16, 50, 2), "2a575bb9d815ff79"),
]


def k1_fixed_digest(shape, geometry):
    """K1's output digest at `shape` and `geometry` (see K1_BITS), through
    the C entry point of the package on the import path."""
    import hashlib

    from dp_gp_lvm_tpu_torch.ops import build

    T_, N_, M_, Q_, D_ = shape
    _, f = _inputs(torch.device("cuda"), True, T=T_, N=N_, M=M_, Q=Q_, D=D_)
    groups, stage_rows, rows, chunks = geometry
    t4 = -(-M_ // 4)
    kw = dict(dtype=torch.float32, device="cuda")
    part = torch.empty(chunks * T_ * (16 * t4 * (t4 + 1) // 2
                                      + 4 * -(-M_ * D_ // 4)), **kw)
    psi2 = torch.empty(T_, M_, M_, **kw)
    p1y = torch.empty(T_, M_, D_, **kw)
    err = build.function("psi_suffstats")(
        *(f[k].data_ptr() for k in ("vs", "ards", "mu", "s", "w", "Zs", "Y")),
        part.data_ptr(), psi2.data_ptr(), p1y.data_ptr(), T_, N_, M_, Q_, D_,
        groups, stage_rows, rows, chunks,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return hashlib.sha256(psi2.cpu().numpy().tobytes()
                          + p1y.cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,geometry,digest", K1_BITS,
                         ids=["m64", "m50", "m128"])
def test_k1_bits_unchanged_by_the_shared_body(card, shape, geometry, digest):
    assert k1_fixed_digest(shape, geometry) == digest


def _m129_data(card, dtype, n=300):
    r = np.random.default_rng(5)
    return torch.as_tensor(r.normal(size=(n, 12)), dtype=dtype,
                           device=card)


def _model(family, use_fused, m=129):
    """A model at M inducing points (past the single-tile forms) and the c2
    latent width, so that K_uu is well conditioned in f32."""
    from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm

    if family == "dp":
        return dp_gp_lvm, dp_gp_lvm.Config(
            num_latent=10, num_inducing=m, truncation=2,
            use_fused=use_fused)
    return bgplvm, bgplvm.Config(num_latent=10, num_inducing=m,
                                 use_fused=use_fused)


# a step's launches on each family's fused path: K1 forward and K2
# backward (DP-GP-LVM), K6 and K5 forward and K2 backward (Bayesian GP-LVM)
STEP_LAUNCHES = dict(dp=dict(suffstats_batched=1, psi2_bwd_batched=1),
                     bgplvm=dict(psi1=1, psi2_single=1, psi2_bwd_batched=1))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dp", "bgplvm"])
def test_auto_takes_the_tiled_kernels_past_m128(card, family):
    """At M = 129 K1's body and K2 run their tiled forms: "auto" launches
    the kernels of the family's step once each in f32 (the loss within
    chip_smoke.py's 1e-4 of the plain f64 path at the same jitter, every
    gradient finite), and takes the plain path in f64 (no launch; equal
    to the CPU's plain path to rounding)."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy

    model, cfg = _model(family, "auto")
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        Y = _m129_data(card, dtype)
        params = model.init_params(prng.PRNGKey(0), Y, cfg)
        policy = JitterPolicy(initial=JitterPolicy().initial_for(dtype))
        psi.reset_launch_counts()
        loss = model.loss(params, Y, cfg) if dtype == torch.float32 else (
            -model.elbo(params, Y, cfg, policy))
        grads = torch.autograd.grad(loss, list(params.values()))
        assert psi.LAUNCHES == (_launched(**STEP_LAUNCHES[family])
                                if dtype == torch.float32 else _launched())
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        p64 = {k: v.detach().cpu().double() for k, v in params.items()}
        want = -model.elbo(p64, Y.cpu().double(),
                           cfg._replace(use_fused=False), policy)
        assert abs(float(loss.detach()) - float(want)) <= tol * abs(
            float(want))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dp", "bgplvm"])
def test_use_fused_true_raises_past_the_tiled_forms(card, family):
    """At M = 513 (Q = 10), past MAX_M_TILED, K1's body raises in the
    forward; "auto" takes the plain path there instead."""
    model, cfg = _model(family, True, m=513)
    Y = _m129_data(card, torch.float32, n=600)
    params = model.init_params(prng.PRNGKey(0), Y, cfg)
    with pytest.raises(RuntimeError, match="past the tiled form's M <= 512 "
                                           "at M=513, Q=10"):
        model.loss(params, Y, cfg)
    assert not psi.fused_fits_on(card, 513, 10, 12 if family == "dp" else 0)


@pytest.mark.cuda
def test_auto_asks_both_forms_occupancy_queries(card):
    """The queries tell a block that does not fit (0 blocks per SM) from a
    CUDA error (which raises); "auto" takes the kernels where a form of
    each fits: K2's single-tile block refuses Q = 48 at M = 128 and its
    tiled form takes it; neither of K1's takes Q = 256; at M = 256 both
    run tiled; K2's tiled block (whose shared memory does not grow with
    M: its query takes Q only) fits twice an SM at Q = 10, and M = 1024 is
    refused only as past MAX_M_TILED."""
    index = torch.cuda.current_device()
    assert psi._k2_blocks_per_sm(index, 128, 48, 32) == 0
    assert psi._k2_tiled_blocks_per_sm(index, 48) >= 1
    assert psi._k1_blocks_per_sm(index, 128, 256, 5, 1, 1) == 0
    assert psi._k1_tiled_blocks_per_sm(index, 256, 5, 1) == 0
    assert psi._k2_tiled_blocks_per_sm(index, 10) == 2
    assert psi.fused_fits_on(card, 128, 48, 0)
    assert not psi.fused_fits_on(card, 128, 256, 5)
    assert psi.fused_fits_on(card, 256, 10, 60)
    assert psi.fused_fits_on(card, 256, 10, 0)
    assert not psi.fused_fits_on(card, 1024, 10, 0)
    assert psi.fused_fits_on(card, 50, 10, 0)
    assert psi.fused_fits_on(card, 64, 10, 59)


# the tiled forms' widths: M past one tile (129: one row of the last
# super-tile and range; 192, 256: whole ones) at the Q of the reference's
# scaling rows and of every configuration
TILED_M = [129, 192, 256]
TILED_Q = [4, 10, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("Q_", TILED_Q)
@pytest.mark.parametrize("M_", TILED_M)
def test_tiled_k1_k4_k5_match_plain(card, M_, Q_, weighted):
    """K1 (D = 60), K4 and K5 in the tiled form against their plain
    versions in f64, zero weights included; each call launches once."""
    a, f = _inputs(card, weighted, T=3, N=200, M=M_, Q=Q_, D=60)
    assert isinstance(psi.k1_launch_geometry(card, 3, 200, M_, Q_, 60),
                      psi.K1TiledGeometry)
    psi.reset_launch_counts()
    got = psi.suffstats_batched(*_k1(f))
    want = psi.suffstats_batched_reference(*_k1(a))
    assert max(_k2_errors(got, want)) <= TOL_K1
    got = psi.psi2_batched(*_k45(f))
    want = psi.psi2_batched_reference(*_k45(a))
    assert max(_k2_errors([got], [want])) <= TOL_K1
    got = psi.psi2_single(*_one(f))
    want = psi.psi2_single_reference(*_one(a))
    assert got.shape == want.shape
    assert max(_k2_errors([got], [want])) <= TOL_K1
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_batched=1,
                                     psi2_single=1)


@pytest.mark.cuda
@pytest.mark.parametrize("T_,N_,M_", [(3, 200, 512), (20, 2048, 256)],
                         ids=["m512", "t20_n2048_m256"])
def test_tiled_k1_k4_k5_match_plain_at_scale(card, T_, N_, M_):
    """K1 (D = 60), K4 and K5 in the tiled form against their plain
    versions in f64, weighted: at M = 512 (32 blocks a chunk and atom, 28
    off-diagonal, 4 diagonal pairs) and at T = 20, N = 2048, M = 256,
    where each chunk walks many stages of rows."""
    a, f = _inputs(card, True, T=T_, N=N_, M=M_, Q=10, D=60)
    geo = psi.k1_launch_geometry(card, T_, N_, M_, 10, 60)
    assert isinstance(geo, psi.K1TiledGeometry) and geo.balance >= 0.95
    psi.reset_launch_counts()
    got = psi.suffstats_batched(*_k1(f))
    assert max(_k2_errors(got, psi.suffstats_batched_reference(
        *_k1(a)))) <= TOL_K1
    got = psi.psi2_batched(*_k45(f))
    assert max(_k2_errors([got], [psi.psi2_batched_reference(
        *_k45(a))])) <= TOL_K1
    got = psi.psi2_single(*_one(f))
    assert max(_k2_errors([got], [psi.psi2_single_reference(
        *_one(a))])) <= TOL_K1
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_batched=1,
                                     psi2_single=1)


@pytest.mark.cuda
def test_tiled_k1_attributes_are_read_at_run_time(card):
    """The loaded module reports the registers and local memory of the
    tiled K1 body's kernels through cudaFuncGetAttributes: the pair body
    within the 128 registers of two 256-thread blocks an SM, the Psi1^T Y
    kernel within the 64 of four, both with no local memory (no spill) at
    Q = 10."""
    import ctypes

    from dp_gp_lvm_tpu_torch.ops import build

    query = build.function("psi_suffstats", "psi_suffstats_tiled_attributes")
    got = (ctypes.c_int * 5)()
    for Q_ in (10, 16):
        assert query(Q_, ctypes.addressof(got)) == 0
        qc, body_regs, body_local, p1y_regs, p1y_local = got
        assert qc == (10 if Q_ == 10 else 0)
        assert 0 < body_regs <= 128 and 0 < p1y_regs <= 64
        if Q_ == 10:
            assert body_local == 0 and p1y_local == 0
    assert query(0, ctypes.addressof(got)) != 0


@pytest.mark.cuda
def test_tiled_k1_repeats_its_bits_five_times(card):
    """Five launches of the tiled K1, K4 and K5 at M = 256 (T = 20, N =
    2048) give the same bits: no atomics, every sum in a fixed order, two
    blocks an SM and many chunks in flight."""
    _, f = _inputs(card, True, T=20, N=2048, M=256, Q=10, D=60)
    geo = psi.k1_launch_geometry(card, 20, 2048, 256, 10, 60)
    assert isinstance(geo, psi.K1TiledGeometry) and geo.chunks > 1
    first = (psi.suffstats_batched(*_k1(f)), psi.psi2_batched(*_k45(f)),
             psi.psi2_single(*_one(f)))
    for _ in range(4):
        again = (psi.suffstats_batched(*_k1(f)), psi.psi2_batched(*_k45(f)),
                 psi.psi2_single(*_one(f)))
        assert all(torch.equal(x, y) for x, y in zip(first[0], again[0]))
        assert torch.equal(first[1], again[1])
        assert torch.equal(first[2], again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize(
    "T_,N_,M_,Q_", [(3, 150, m, q) for m in TILED_M for q in TILED_Q]
    + [(3, 150, 128, 48), (3, 150, 256, 48), (4, 2048, 256, 10)])
def test_tiled_k2_matches_plain(card, T_, N_, M_, Q_, weighted):
    """K2 in the tiled form against its plain version in f64, zero weights
    included: past M = 128, at Q = 48, which the single-tile block refuses
    at M = 128 (passes of 8 gradient columns), and at N = 2048, where a
    chunk walks many batches of rows (the rows' fetch two batches ahead
    and the panels' read-modify-write of their row scalars)."""
    a, f = _inputs(card, weighted, T=T_, N=N_, M=M_, Q=Q_)
    geo = psi.k2_launch_geometry(card, T_, N_, M_, Q_)
    assert isinstance(geo, psi.K2TiledGeometry)
    if N_ == 2048:
        assert geo.rows >= 4 * 16  # four batches of 16 rows a chunk
    psi.reset_launch_counts()
    got = psi.psi2_bwd_batched(*_k2(f))
    want = psi.psi2_bwd_batched_reference(*_k2(a))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert max(_k2_errors(got, want)) <= TOL_K2
    assert psi.LAUNCHES == _launched(psi2_bwd_batched=1)


# the corners of what README.md says the tiled forms take; the ARD weights
# are scaled by 10 / Q there, so that Psi2 stays far from f32's underflow
TILED_EDGES = [("k1", 512, 128), ("k2", 512, 16), ("k2", 384, 32),
               ("k2", 256, 64), ("k2", 512, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,M_,Q_", TILED_EDGES)
def test_tiled_forms_take_their_stated_edges(card, kernel, M_, Q_):
    """K1 (D = 120), K4 and K5, or K2, at a corner of the stated limits
    against their plain versions in f64, zero weights included."""
    a, f = _inputs(card, True, T=2, N=96, M=M_, Q=Q_, D=120)
    for t in (a, f):
        t["ards"] = t["ards"] * min(1.0, 10.0 / Q_)
    psi.reset_launch_counts()
    if kernel == "k2":
        got = psi.psi2_bwd_batched(*_k2(f))
        assert max(_k2_errors(got, psi.psi2_bwd_batched_reference(
            *_k2(a)))) <= TOL_K2
        assert psi.LAUNCHES == _launched(psi2_bwd_batched=1)
        return
    got = psi.suffstats_batched(*_k1(f))
    assert max(_k2_errors(got, psi.suffstats_batched_reference(
        *_k1(a)))) <= TOL_K1
    got = psi.psi2_batched(*_k45(f))
    assert max(_k2_errors([got], [psi.psi2_batched_reference(
        *_k45(a))])) <= TOL_K1
    got = psi.psi2_single(*_one(f))
    assert max(_k2_errors([got], [psi.psi2_single_reference(
        *_one(a))])) <= TOL_K1
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_batched=1,
                                     psi2_single=1)


@pytest.mark.cuda
def test_tiled_forms_refuse_past_their_edges(card):
    """K2 refuses Q = 128 (its c rows of a batch exceed shared memory, at
    any M); both refuse M = 513 (MAX_M_TILED); "auto" agrees, and takes
    M = 512 at Q = 64."""
    _, f = _inputs(card, False, T=1, N=8, M=512, Q=128)
    with pytest.raises(RuntimeError, match="no block fits an SM at M=512, "
                                           "Q=128"):
        psi.psi2_bwd_batched(*_k2(f))
    _, f = _inputs(card, False, T=1, N=8, M=513, Q=10, D=4)
    with pytest.raises(RuntimeError, match="past the tiled form's M <= 512 "
                                           "at M=513, Q=10, D=4"):
        psi.suffstats_batched(*_k1(f))
    assert psi.fused_fits_on(card, 512, 16, 60)
    assert psi.fused_fits_on(card, 512, 64, 0)
    assert not psi.fused_fits_on(card, 512, 128, 0)
    assert not psi.fused_fits_on(card, 513, 10, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(T=4, N=300, M=256, Q=10, D=60),
                                   dict(T=2, N=90, M=129, Q=16, D=120)],
                         ids=["m256", "m129_d120"])
def test_tiled_launches_repeat_bit_for_bit(card, shape):
    """Two launches of each tiled form on the same inputs give the same
    bits (no atomics): K1 (D = 120 walks the rows twice for Psi1^T Y), K4,
    K5 and K2."""
    _, f = _inputs(card, True, **shape)
    assert all(torch.equal(x, y) for x, y in zip(
        psi.suffstats_batched(*_k1(f)), psi.suffstats_batched(*_k1(f))))
    assert torch.equal(psi.psi2_batched(*_k45(f)), psi.psi2_batched(*_k45(f)))
    assert torch.equal(psi.psi2_single(*_one(f)), psi.psi2_single(*_one(f)))
    assert all(torch.equal(x, y) for x, y in zip(
        psi.psi2_bwd_batched(*_k2(f)), psi.psi2_bwd_batched(*_k2(f))))


@pytest.mark.cuda
def test_tiled_k2_repeats_its_bits_five_times(card):
    """Five launches of the tiled K2 at M = 256, T = 20, N = 2048 give the
    same bits: no atomics, every sum in a fixed order, with two blocks an
    SM and many chunks in flight."""
    _, f = _inputs(card, True, T=20, N=2048, M=256, Q=10)
    geo = psi.k2_launch_geometry(card, 20, 2048, 256, 10)
    assert isinstance(geo, psi.K2TiledGeometry) and geo.chunks > 1
    first = psi.psi2_bwd_batched(*_k2(f))
    for _ in range(4):
        again = psi.psi2_bwd_batched(*_k2(f))
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dp", "bgplvm"])
def test_tiled_fused_gradients_at_m256(card, family):
    """A step's value and gradient at M = 256 through the tiled kernels
    ("auto") against the plain path on the CPU in f64, the fused ops'
    test (sum Psi2^2 + sum sin(Psi1^T Y), or + sum sin(Psi2)) at T = 2."""
    a, f = _inputs(card, True, T=2, N=300, M=256, Q=10, D=12)

    def run(t):
        if family == "dp":
            leaves = [t[k] for k in ("vs", "ards", "mu", "s", "Zs", "Y", "w")]
            leaves = [x.detach().clone().contiguous().requires_grad_()
                      for x in leaves]
            p2, p1y = psi.suffstats_batched_fused(*leaves[:6], leaves[6])
            val = torch.sum(p2 ** 2) + torch.sum(torch.sin(p1y))
        else:
            leaves = [x.detach().clone().contiguous().requires_grad_()
                      for x in _one(t)]
            p2 = psi.psi2_fused(*leaves)
            val = torch.sum(p2 ** 2) + torch.sum(torch.sin(p2))
        return torch.autograd.grad(val, leaves)

    psi.reset_launch_counts()
    got = run(f)
    assert psi.LAUNCHES == _launched(
        **({"suffstats_batched": 1} if family == "dp"
           else {"psi2_single": 1}), psi2_bwd_batched=1)
    want = run({k: v.cpu() for k, v in a.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu().double() - w).abs().max()) <= TOL_K2 * float(
            w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [C1, C5_POSE, C3],
                         ids=["c1", "c5_pose", "c3"])
def test_auto_takes_the_kernels_at_the_gated_shapes(card, shape):
    """"auto" takes the kernels at c1's, c5_pose's and c3's widths: the
    Psi2-only path (D = 0: K6, K5, K2; c3's posterior build) and the
    suff-stats path (K1, K2; the DP models and each MRD view)."""
    from dp_gp_lvm_tpu_torch.ops import dispatch

    M_, Q_, D_ = shape["M"], shape["Q"], shape["D"]
    assert psi.fused_fits_on(card, M_, Q_, 0)
    assert psi.fused_fits_on(card, M_, Q_, D_)
    assert dispatch.resolve_fused("auto", "ard_rbf", card, M_, Q_)
    assert dispatch.resolve_fused("auto", "ard_rbf", card, M_, Q_, D_)


def _k6(t):
    """The inputs of K6: the first atom of the stack, unweighted."""
    return (t["vs"][0], t["ards"][0].contiguous(), t["mu"], t["s"],
            t["Zs"][0].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("Q_", [1, 10, 12, 40])
@pytest.mark.parametrize("M_", [1, 33, 50, 128, 129, 256])
@pytest.mark.parametrize("N_", [1, 5, 1000, 8192])
def test_k6_matches_plain_at_any_m(card, N_, M_, Q_):
    """K6 against its plain version in f64, unweighted and with mask-style
    weights (zeros included; all of them at N=1): the fixed (Q = 10) and
    the generic instantiation; one row, a step of fewer rows than a warp
    prepares, the c2 and the scale N; one column, M across lanes, odd
    (scalar stores), even (8-byte), a multiple of 4 (16-byte), past one
    column tile of 128. Each call launches K6 once."""
    a, f = _inputs(card, True, T=1, N=N_, M=M_, Q=Q_)
    psi.reset_launch_counts()
    for w32, w64 in ((None, None), (f["w"], a["w"])):
        got = psi.psi1(*_k6(f), w32)
        want = psi.psi1_reference(*_k6(a), w64)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert max(_k2_errors([got], [want])) <= TOL_K1
    assert psi.LAUNCHES == _launched(psi1=2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [C2, dict(T=1, N=8192, M=128, Q=10, D=4),
                                   dict(T=1, N=300, M=129, Q=12, D=4)],
                         ids=["c2", "scale", "m129_q12"])
def test_k6_launches_repeat_bit_for_bit(card, shape):
    _, f = _inputs(card, True, **shape)
    assert torch.equal(psi.psi1(*_k6(f), f["w"]), psi.psi1(*_k6(f), f["w"]))
    assert torch.equal(psi.psi1(*_k6(f)), psi.psi1(*_k6(f)))


@pytest.mark.cuda
def test_psi1_fused_gradient_past_one_column_tile(card):
    """Psi1Fused at M = 129 (K6 forward over two column tiles, the plain
    pullback) on the card against the same op on the CPU in f64."""
    a, f = _inputs(card, True, T=1, N=70, M=129, Q=10)

    def run(t):
        leaves = [x.detach().clone().contiguous().requires_grad_()
                  for x in _k6(t)]
        out = psi.psi1_fused(*leaves)
        return torch.autograd.grad(torch.sum(out ** 2) + torch.sum(
            torch.sin(out)), leaves)

    psi.reset_launch_counts()
    got = run(f)
    assert psi.LAUNCHES == _launched(psi1=1)
    want = run({k: v.cpu() for k, v in a.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu().double() - w).abs().max()) <= TOL_K2 * float(
            w.abs().max())


@pytest.mark.cuda
def test_k6_wrapper_refuses_what_the_kernel_does_not_take(card):
    a, f = _inputs(card, weighted=True, T=1, M=129)
    with pytest.raises(TypeError, match="float32"):
        psi.psi1(*_k6(a))
    k6 = list(_k6(f))
    k6[4] = f["Zs"][0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        psi.psi1(*k6)
    with pytest.raises(ValueError, match="shape"):
        psi.psi1(*_k6(f), f["w"][:-1].contiguous())
    # the generic instantiation's Z tile (Q x 128 floats) past the card's
    # shared memory
    _, wide = _inputs(card, False, T=1, N=4, M=3, Q=512)
    with pytest.raises(RuntimeError, match="no block fits an SM at Q=512"):
        psi.psi1(*_k6(wide))


@pytest.mark.cuda
def test_suff_stats_on_card_equals_the_plain_f64_path(card):
    """`dispatch.suff_stats` at c6's minibatch shape: K1 (T = 1) on the
    card, its value and gradient against the plain path in f64."""
    from dp_gp_lvm_tpu_torch.ops import dispatch

    a, f = _inputs(card, False, **C6)
    assert dispatch.resolve_fused("auto", "ard_rbf", card, C6["M"], C6["Q"],
                                  C6["D"])
    one = ("vs", "ards", "Zs")     # the T = 1 atom's hypers and Z
    leaves32, leaves64 = ([(t[k][0] if k in one else t[k]).clone()
                           .requires_grad_()
                           for k in ("vs", "ards", "mu", "s", "Zs")]
                          for t in (f, a))
    psi.reset_launch_counts()
    got = dispatch.suff_stats(*leaves32, f["Y"])
    want = dispatch.suff_stats(*leaves64, a["Y"], use_fused=False)
    assert max(_scaled_errors((got.psi2, got.psi1T_y),
                              (want.psi2, want.psi1T_y))) <= TOL_K1
    assert abs(float(got.psi0) - float(want.psi0)) <= 1e-6 * float(want.psi0)
    assert float(got.n) == C6["N"]
    G2 = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 64)),
                         device=card)
    g32 = torch.autograd.grad((got.psi2 * G2.float()).sum()
                              + got.psi1T_y.sum(), leaves32)
    g64 = torch.autograd.grad((want.psi2 * G2).sum() + want.psi1T_y.sum(),
                              leaves64)
    assert max(_scaled_errors(g32, g64)) <= TOL_K2
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_bwd_batched=1)


def _mrd_setup(card, dtype):
    """c3's widths on a two_view draw: 224 rows, two views of 8 dims."""
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.models import mrd

    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(0), n=C3["N"], d1=C3["D"],
                                   d2=C3["D"], q_shared=2,
                                   private_weight=0.5, dtype=dtype,
                                   device=card)
    cfg = mrd.Config(num_latent=C3["Q"], num_inducing=C3["M"], num_views=2)
    return [Y1, Y2], mrd.init_params(prng.PRNGKey(0), [Y1, Y2], cfg), cfg


@pytest.mark.cuda
def test_mrd_loss_and_gradient_fused_match_plain_on_card(card):
    """MRD at c3's widths: each view's K1 forward and K2 backward, value and
    every leaf's gradient against the plain path in f64 at the same
    jitter."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import mrd
    from dp_gp_lvm_tpu_torch.train.loop import flat_leaves

    Ys, params, cfg = _mrd_setup(card, torch.float32)
    leaves = flat_leaves(params)
    p64 = {"qx_mean": params["qx_mean"].detach().double().requires_grad_(),
           "raw_qx_var": params["raw_qx_var"].detach().double()
           .requires_grad_(),
           "views": [{k: v.detach().double().requires_grad_()
                      for k, v in view.items()}
                     for view in params["views"]]}
    same_jitter = JitterPolicy(
        initial=JitterPolicy().initial_for(torch.float32))
    psi.reset_launch_counts()
    loss32 = mrd.loss(params, Ys, cfg)
    g32 = torch.autograd.grad(loss32, list(leaves.values()))
    assert psi.LAUNCHES == _launched(suffstats_batched=2, psi2_bwd_batched=2)
    loss64 = -mrd.elbo(p64, [y.double() for y in Ys],
                       cfg._replace(use_fused=False), same_jitter)
    g64 = torch.autograd.grad(loss64, list(flat_leaves(p64).values()))
    assert abs(float(loss32) - float(loss64)) <= 1e-4 * abs(float(loss64))
    assert max(_scaled_errors(g32, g64)) <= 5e-3   # chip_smoke's TOL_GRAD


@pytest.mark.cuda
def test_mrd_cross_view_predictor_defaults_to_the_card(card):
    """Given CPU tensors and no device, the server builds its two caches on
    the card (K6 and K5 once per view) and answers there."""
    from dp_gp_lvm_tpu_torch.models import serving

    Ys, params, cfg = _mrd_setup(card, torch.float32)
    cpu = {"qx_mean": params["qx_mean"].detach().cpu(),
           "raw_qx_var": params["raw_qx_var"].detach().cpu(),
           "views": [{k: v.detach().cpu() for k, v in view.items()}
                     for view in params["views"]]}
    psi.reset_launch_counts()
    predict = serving.make_mrd_cross_view_predictor(
        cpu, [y.cpu() for y in Ys], cfg, observed_view=0, target_view=1,
        num_steps=20)
    assert psi.LAUNCHES == _launched(psi1=2, psi2_single=2)
    mean, var = predict(Ys[0][:8].cpu())
    assert mean.device.type == var.device.type == "cuda"
    assert mean.shape == var.shape == (8, C3["D"])
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


def _svi_setup(card, n=2048, batch=1024):
    """c6's widths (M=64, Q=8, D=32, batch 1024) on a mocap_like draw."""
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
    from dp_gp_lvm_tpu_torch.models import svi_gplvm
    from dp_gp_lvm_tpu_torch.train.loop import TrainState, gp_optimizer

    Y, _ = mocap_like(prng.PRNGKey(0), n=n, d=32, dtype=torch.float32,
                      device=card)
    cfg = svi_gplvm.Config(num_latent=8, num_inducing=64, batch=batch)
    params = svi_gplvm.init_params(prng.PRNGKey(0), Y, cfg)
    opt = gp_optimizer(params, lr=3e-3, ngd_lr=1.0, decay_steps=20)
    step = svi_gplvm.make_svi_natgrad_step(cfg, n, opt, rho=0.2)
    idx = prng.randint(prng.fold_in(prng.PRNGKey(1), torch.arange(20)),
                       (batch,), 0, n).long().to(card)
    return Y, TrainState(opt), step, idx


@pytest.mark.cuda
def test_svi_natgrad_step_launches_k1_twice_and_k2_once(card):
    """A step: K1 for the gradient pass, K2 in its backward, K1 again for
    the blend at the updated parameters."""
    Y, state, step, idx = _svi_setup(card)
    psi.reset_launch_counts()
    losses = torch.stack([step(t, idx[t], Y) for t in range(3)])
    assert bool(torch.isfinite(losses).all())
    assert psi.LAUNCHES == _launched(suffstats_batched=6, psi2_bwd_batched=3)


@pytest.mark.cuda
def test_checkpoint_restore_on_card_is_bit_identical(card, tmp_path):
    """Save at step 5, run on to 10; restore the checkpoint into a fresh
    state and run the same five steps: the same bits."""
    from dp_gp_lvm_tpu_torch.train.checkpoint import Checkpointer

    Y, state, step, idx = _svi_setup(card)
    for t in range(5):
        step(t, idx[t], Y)
    state.step = 5
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(state)
    for t in range(5, 10):
        step(t, idx[t], Y)
    first = {k: v.detach().clone() for k, v in state.params.items()}
    Y2, fresh, step2, _ = _svi_setup(card)
    assert ck.restore(fresh).step == 5
    for t in range(5, 10):
        step2(t, idx[t], Y2)
    for k, v in fresh.params.items():
        assert torch.equal(v, first[k]), k


def _svi_step(card, Y, streaming):
    """A natural-gradient step at c6's widths on fresh parameters."""
    from dp_gp_lvm_tpu_torch.models import svi_gplvm
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    cfg = svi_gplvm.Config(num_latent=8, num_inducing=64, batch=1024)
    params = svi_gplvm.init_params(prng.PRNGKey(0), Y, cfg)
    opt = gp_optimizer(params, lr=3e-3, ngd_lr=1.0, decay_steps=20)
    return params, svi_gplvm.make_svi_natgrad_step(
        cfg, Y.shape[0], opt, rho=0.2, streaming=streaming)


@pytest.mark.cuda
def test_streamed_step_is_the_resident_step_on_card(card):
    """The same rows fed from the host or gathered on the card: the same
    loss and parameters, bit for bit, over three steps."""
    Y, _, _, idx = _svi_setup(card)
    p_res, res = _svi_step(card, Y, streaming=False)
    p_str, st = _svi_step(card, Y, streaming=True)
    for t in range(3):
        rows = Y[idx[t]].cpu().pin_memory().to(card, non_blocking=True)
        assert torch.equal(res(t, idx[t], Y), st(t, (idx[t], rows)))
    for k in p_res:
        assert torch.equal(p_res[k], p_str[k]), k


@pytest.mark.cuda
def test_pinned_chunk_stream_feeds_the_card_without_a_torn_buffer(
        card, tmp_path):
    """The native gather into pinned buffers, copied to the card without
    blocking while the card works on the previous chunk: every chunk of 24
    holds exactly the rows at its indices (a refill racing its copy would
    tear one), and the indices are the host stream's."""
    from dp_gp_lvm_tpu_torch.data import stream

    n, d, batch, chunk = 4096, 32, 1024, 4
    Y = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    path = stream.write_rows(str(tmp_path / "y.f32"), Y)
    Y_card = torch.from_numpy(Y).to(card)
    with stream.ChunkStream(stream.open_loader(path, n, d), batch=batch,
                            chunk=chunk, seed=7) as host:
        want = [host.next_chunk()[0].copy() for _ in range(24)]
    assert stream.native_available()
    work = torch.randn(2048, 2048, device=card)
    with stream.ChunkStream(stream.StreamLoader(path, n, d), batch=batch,
                            chunk=chunk, seed=7, device=card) as cs:
        for k in range(24):
            idx, y = cs.next_chunk()
            assert idx.is_cuda and y.is_cuda and y.dtype == torch.float32
            for _ in range(4):              # keep the card busy
                work = torch.tanh(work @ work)
            assert torch.equal(y, Y_card[idx]), k
            assert torch.equal(idx.cpu(), torch.from_numpy(want[k]).long())
    assert bool(torch.isfinite(work).all())


@pytest.mark.cuda
def test_sgpr_and_gp_regression_f32_on_card_match_f64(card):
    """SGPR's bound and predictive and the exact marginal in float32 on the
    card against float64 on the CPU, at the same 1e-4 jitter: 1e-4 of the
    value (bound, marginal) and of max|ref| (predictive)."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import gp_regression, sparse_gp

    r = np.random.default_rng(0)
    X, Y, Xs = (r.normal(size=s) for s in ((200, 3), (200, 4), (20, 3)))
    policy = JitterPolicy(initial=1e-4)
    got, want = {}, {}
    for out, dev, dtype in ((got, card, torch.float32),
                            (want, "cpu", torch.float64)):
        x, y, xs = (torch.tensor(a, dtype=dtype, device=dev)
                    for a in (X, Y, Xs))
        ps = sparse_gp.init_params(prng.PRNGKey(0), x, 10)
        pg = gp_regression.init_params(3, dtype=dtype, device=dev)
        with torch.no_grad():
            out["elbo"] = sparse_gp.elbo(ps, x, y, policy)
            out["lm"] = gp_regression.log_marginal(pg, x, y, policy)
            out["mean"], out["var"] = sparse_gp.predict(ps, x, y, xs, policy)
    for k in ("elbo", "lm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(
            float(want[k])), k
    assert float(want["elbo"]) <= float(want["lm"])
    for k in ("mean", "var"):
        assert max(_scaled_errors([got[k]], [want[k].to(card)])) <= 1e-3, k


@pytest.mark.cuda
def test_k1_holds_at_c7_full_n(card):
    """K1 over all of c7's 131072 training rows at T = 8 (the final ELBO's
    and, at T = 1, the residual ladder's one call) against its plain
    version in f64."""
    a, f = _inputs(card, False, **dict(C7, N=131072))
    psi.reset_launch_counts()
    got = psi.suffstats_batched(f["vs"], f["ards"], f["mu"], f["s"], f["Zs"],
                                f["Y"])
    want = psi.suffstats_batched_reference(a["vs"], a["ards"], a["mu"],
                                           a["s"], a["Zs"], a["Y"],
                                           block_n=2048)
    assert max(_scaled_errors(got, want)) <= TOL_K1
    assert psi.LAUNCHES == _launched(suffstats_batched=1)


def _chol_stack(card, dtype):
    """Four symmetric 6 x 6 matrices whose smallest eigenvalues are 0.5,
    -3e-6, -3e-4 and -3e2 times the mean diagonal."""
    gen = np.random.default_rng(4)
    out = []
    for lo in (0.5, -3e-6, -3e-4, -3e2):
        rot, _ = np.linalg.qr(gen.standard_normal((6, 6)))
        w = np.linspace(1.0, 2.0, 6)
        w[0] = lo * w.mean()
        out.append((rot * w) @ rot.T)
    return torch.as_tensor(np.stack(out), dtype=dtype, device=card)


@pytest.mark.cuda
def test_per_member_cholesky_on_card(card):
    """Each member's own jitter on the card, as on the CPU (1e-6, 1e-5,
    1e-3 and the last rung in f64; in f32 from 1e-4: 1e-4, 1e-4, 1e-3),
    the same factors, and no host read in a call (the rung is chosen on
    the device)."""
    import warnings

    from dp_gp_lvm_tpu_torch.linalg import safe_cholesky_members

    stack = _chol_stack(card, torch.float64)
    L, jitter = safe_cholesky_members(stack)
    L_cpu, jitter_cpu = safe_cholesky_members(stack.cpu())
    assert jitter.cpu().tolist() == jitter_cpu.tolist() == pytest.approx(
        [1e-6, 1e-5, 1e-3, 1.0])
    np.testing.assert_allclose(L[:3].cpu().numpy(), L_cpu[:3].numpy(),
                               rtol=1e-10, atol=1e-12)
    L32, jitter32 = safe_cholesky_members(_chol_stack(card, torch.float32))
    assert jitter32[:3].cpu().tolist() == pytest.approx([1e-4, 1e-4, 1e-3])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            safe_cholesky_members(stack[:1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert [str(w.message) for w in caught if "synchroniz" in str(w.message)
            and "prototype" not in str(w.message)] == []


def _dp_svi_setup(card, dtype, n=4096):
    """c7's widths (D=32 in four planted groups, Q=8, M=64, T=8, batch
    2048) on a grouped_dims_big draw, parameters at init."""
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.models import dp_svi

    Y, _, _ = synthetic.grouped_dims_big(
        prng.PRNGKey(0), n=n, dims_per_group=(8, 8, 8, 8), q=8, dtype=dtype,
        device=card)
    cfg = dp_svi.Config(num_latent=8, num_inducing=64, truncation=8,
                        batch=2048, psi2_block=8192, ard_init=1.0 / 8)
    return Y, cfg, dp_svi.init_params(prng.PRNGKey(0), Y, cfg)


@pytest.mark.cuda
def test_dp_svi_step_f32_on_card_matches_plain_f64(card):
    """One DP-SVI step at c7's widths: f32 through K1 (once) and K2 (once,
    in the backward) against the plain f64 step on the same inputs at the
    same jitter: the loss, every gradient and the blended q(u | t)."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import dp_svi
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    Y, cfg, p32 = _dp_svi_setup(card, torch.float32)
    p64 = {k: torch.nn.Parameter(v.detach().double()) for k, v in p32.items()}
    Y64 = Y.double()
    idx = dp_svi.minibatch_indices(prng.fold_in(prng.PRNGKey(1),
                                                torch.arange(1)), 2048,
                                   Y.shape[0])[0].to(card)
    same_jitter = JitterPolicy(initial=JitterPolicy().initial_for(
        torch.float32))
    cfg64 = cfg._replace(use_fused=False)
    psi.reset_launch_counts()
    loss32 = dp_svi.loss_minibatch(p32, Y[idx], idx, Y.shape[0], cfg)
    g32 = torch.autograd.grad(loss32, [p32[k] for k in ("qx_mean", "z",
                                                        "raw_ard",
                                                        "raw_noise",
                                                        "phi_logits")])
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_bwd_batched=1)
    loss64 = -dp_svi.elbo_minibatch(p64, Y64[idx], idx, Y.shape[0], cfg64,
                                    same_jitter)
    g64 = torch.autograd.grad(loss64, [p64[k] for k in ("qx_mean", "z",
                                                        "raw_ard",
                                                        "raw_noise",
                                                        "phi_logits")])
    loss32, loss64 = float(loss32.detach()), float(loss64.detach())
    assert abs(loss32 - loss64) <= 1e-4 * abs(loss64)
    assert max(_scaled_errors(g32, g64)) <= 5e-3   # chip_smoke's TOL_GRAD
    steps = {}
    for name, p, c in (("f32", p32, cfg), ("f64", p64, cfg64)):
        opt = gp_optimizer(p, lr=3e-3, ngd_lr=1.0, decay_steps=10)
        steps[name] = dp_svi.make_dp_svi_step(c, Y.shape[0], opt, rho=0.3,
                                              policy=same_jitter)
    psi.reset_launch_counts()
    steps["f32"](0, idx, Y)
    assert psi.LAUNCHES == _launched(suffstats_batched=1, psi2_bwd_batched=1)
    steps["f64"](0, idx, Y64)
    for k in ("u_h", "u_lam", "raw_gamma1", "raw_gamma2"):
        assert max(_scaled_errors([p32[k]], [p64[k]])) <= 1e-3, k


@pytest.mark.cuda
def test_dp_svi_imputer_defaults_to_the_card(card):
    """Given CPU parameters and no device, the DP-SVI server builds on the
    card (no kernel: its psi statistics are plain) and answers there."""
    from dp_gp_lvm_tpu_torch.models import serving

    Y, cfg, params = _dp_svi_setup(card, torch.float32, n=2048)
    cpu = {k: v.detach().cpu() for k, v in params.items()}
    psi.reset_launch_counts()
    impute = serving.make_dp_svi_imputer(cpu, cfg, num_steps=10)
    mask = torch.zeros(8, 32)
    mask[:, ::2] = 1.0
    mean, var = impute(Y[:8].cpu(), mask)
    assert psi.LAUNCHES == _launched()
    assert mean.device.type == var.device.type == "cuda"
    assert mean.shape == var.shape == (8, 32)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


# the amortized q(X) at c8's widths: the encoder of a 32-dim row to Q = 8
# through 64 hidden units, c8's floors, its runner's stabilisers
C8_FLOORS = dict(noise_floor=1e-3, qx_var_floor=1e-2)
# encode(Y) at init against the PCA scores it is fit to, scaled by
# max|pca|: the readout is solved in f64 against the f32 scores, so f32
# keeps about their own rounding (a CPU in f32 at 4096 rows: 2.5e-5)
TOL_ENCODE_INIT = 5e-4
# the encoder's f32 forward and backward against f64, scaled by max|ref|:
# three small matmuls and a tanh, no cancellation
TOL_ENCODER = 1e-5


def _c8_setup(card, dtype=torch.float32, n=2048, batch=1024):
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
    from dp_gp_lvm_tpu_torch.models import svi_gplvm

    Y, _ = mocap_like(prng.PRNGKey(0), n=n, d=32, dtype=dtype, device=card)
    cfg = svi_gplvm.Config(num_latent=8, num_inducing=64, batch=batch,
                           amortized=True, **C8_FLOORS)
    return Y, cfg, svi_gplvm.init_params(prng.PRNGKey(0), Y, cfg)


@pytest.mark.cuda
def test_amortized_svi_step_launches_k1_twice_and_k2_once(card):
    """c8's step: the encoder's pass feeds K1 for the gradient pass, K2 in
    its backward (the mean and variance gradients flow on into the
    encoder), K1 again for the blend; the encoder moves."""
    from dp_gp_lvm_tpu_torch.models import svi_gplvm
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    Y, cfg, params = _c8_setup(card)
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = gp_optimizer(params, lr=3e-3, decay_steps=20,
                       slow=frozenset({"z"}))
    step = svi_gplvm.make_svi_natgrad_step(cfg, Y.shape[0], opt, rho=0.2,
                                           qu_trust=100.0)
    idx = prng.randint(prng.fold_in(prng.PRNGKey(1), torch.arange(3)),
                       (1024,), 0, Y.shape[0]).long().to(card)
    psi.reset_launch_counts()
    losses = torch.stack([step(t, idx[t], Y) for t in range(3)])
    assert psi.LAUNCHES == _launched(suffstats_batched=6, psi2_bwd_batched=3)
    assert bool(torch.isfinite(losses).all())
    for k in ("enc_wlin", "enc_w1", "enc_wm", "enc_ws"):
        assert not torch.equal(params[k], start[k]), k


@pytest.mark.cuda
def test_encoder_forward_and_backward_f32_on_card_match_f64(card):
    """encode's moments and the gradients of a fixed functional of them to
    every encoder leaf, f32 on the card against f64 on the CPU, off the
    init (the MLP heads nonzero) and with the variance floor."""
    from dp_gp_lvm_tpu_torch.models import amortized

    Y, cfg, params = _c8_setup("cpu", torch.float64, n=512)
    gen = np.random.default_rng(3)
    p64 = {k: (v.detach() + 0.05 * torch.as_tensor(
        gen.standard_normal(v.shape))).requires_grad_()
        for k, v in params.items() if amortized.is_encoder_leaf(k)}
    weights = [torch.as_tensor(gen.standard_normal((512, 8)))
               for _ in range(2)]

    def run(p, y, w):
        # the leaves as the model's constrain passes them, with the floor
        mu, s = amortized.encode(amortized.encoder_leaves(p, cfg), y)
        value = torch.sum(mu * w[0]) + torch.sum(torch.log(s) * w[1])
        return (mu, s, *torch.autograd.grad(value, list(p.values())))

    want = run(p64, Y, weights)
    p32 = {k: v.detach().float().to(card).requires_grad_()
           for k, v in p64.items()}
    got = run(p32, Y.float().to(card), [w.float().to(card) for w in weights])
    assert all(g.is_cuda for g in got)
    errs = _scaled_errors([g.cpu() for g in got], want)
    assert max(errs) <= TOL_ENCODER, dict(zip(["mu", "s", *p64], errs))


@pytest.mark.cuda
def test_encode_at_init_on_card_reproduces_pca(card):
    from dp_gp_lvm_tpu_torch.models import amortized
    from dp_gp_lvm_tpu_torch.train.init import pca_latents

    Y, cfg, params = _c8_setup(card, n=4096)
    with torch.no_grad():
        mu, s = amortized.encode(params, Y)
    x0 = pca_latents(Y, 8)
    assert mu.is_cuda and params["enc_wlin"].dtype == torch.float32
    assert float((mu - x0).abs().max() / x0.abs().max()) <= TOL_ENCODE_INIT
    np.testing.assert_allclose(s.cpu().numpy(), 0.5, rtol=1e-6)


@pytest.mark.cuda
def test_encoder_imputer_defaults_to_the_card(card):
    """Given CPU parameters and no device, the one-pass server builds on the
    card and answers there with no kernel (its psi statistics are
    plain)."""
    from dp_gp_lvm_tpu_torch.models import serving

    Y, cfg, params = _c8_setup(card)
    cpu = {k: v.detach().cpu() for k, v in params.items()}
    psi.reset_launch_counts()
    for refine in (0, 5):
        impute = serving.make_encoder_imputer(cpu, cfg, refine_steps=refine)
        mask = torch.ones(8, 32)
        mask[:, 16:] = 0.0
        mean, var = impute(Y[:8].cpu(), mask)
        assert mean.device.type == var.device.type == "cuda"
        assert mean.shape == var.shape == (8, 32)
        assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    assert psi.LAUNCHES == _launched()


# c9_mrd_svi_bigN, one view: its 1024 aligned minibatch rows at M = 32,
# Q = 4 and 32 dims a view (the generic instantiations)
C9 = dict(T=1, N=1024, M=32, Q=4, D=32)


@pytest.mark.cuda
def test_k1_and_k2_hold_at_c9_view_shape_and_k1_over_its_rows(card):
    """K1 and K2 at a c9 view's minibatch, and K1 over all 131072 training
    rows of a view (the gated ELBO's one call a view), against their plain
    versions in f64."""
    for shape, k2 in ((C9, True), (dict(C9, N=131072), False)):
        a, f = _inputs(card, False, **shape)
        psi.reset_launch_counts()
        got = psi.suffstats_batched(f["vs"], f["ards"], f["mu"], f["s"],
                                    f["Zs"], f["Y"])
        want = psi.suffstats_batched_reference(
            a["vs"], a["ards"], a["mu"], a["s"], a["Zs"], a["Y"],
            block_n=8192)
        assert max(_scaled_errors(got, want)) <= TOL_K1
        if k2:
            got = psi.psi2_bwd_batched(f["vs"], f["ards"], f["mu"], f["s"],
                                       f["Zs"], f["G"])
            want = psi.psi2_bwd_batched_reference(
                a["vs"], a["ards"], a["mu"], a["s"], a["Zs"], a["G"])
            assert max(_scaled_errors(got, want)) <= TOL_K2
        assert psi.LAUNCHES == _launched(suffstats_batched=1,
                                         psi2_bwd_batched=int(k2))


def _c9_setup(card, dtype=torch.float32, n=4096):
    """c9's widths (two views of 32 dims, Q=4, M=32, 1024 aligned rows a
    step, its noise floor) on a two_view_big draw, parameters at init."""
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.models import mrd_svi

    Y1, Y2, _ = synthetic.two_view_big(prng.PRNGKey(0), n=n, dtype=dtype,
                                       device=card)
    cfg = mrd_svi.Config(num_latent=4, num_inducing=32, num_views=2,
                         batch=1024, psi2_block=8192, noise_floor=0.05,
                         view_dims=(32, 32))
    return (Y1, Y2), cfg, mrd_svi.init_params(prng.PRNGKey(0), (Y1, Y2),
                                              cfg)


@pytest.mark.cuda
def test_mrd_svi_step_f32_on_card_matches_plain_f64(card):
    """c9's step: f32 through K1 and K2 once a view (the blend reads the
    gradient pass's statistics), against the plain f64 step on the same
    rows at the same jitter, from each view's optimal q(u^v): the loss,
    the gradients, and each view's blended q(u^v) after the step (which
    the optimizer's first update, +-lr wherever a gradient is near zero,
    does not reach)."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import mrd_svi
    from dp_gp_lvm_tpu_torch.train.loop import flat_leaves, gp_optimizer

    Ys, cfg, p32 = _c9_setup(card)
    Ys64 = tuple(Y.double() for Y in Ys)
    _, _, p64 = _c9_setup(card, torch.float64)
    cfg64 = cfg._replace(use_fused=False)
    with torch.no_grad():                  # the same init, not a re-PCA
        for (k, a), b in zip(flat_leaves(p32).items(),
                             flat_leaves(p64).values()):
            b.copy_(a.double())
        # q(u^v) off the prior, where the bound does not depend on Psi2
        # and the hypers' and Z's gradients vanish: each view's full-data
        # optimum, in f64, given to both
        best = mrd_svi.set_optimal_qu(p64, Ys64, cfg64)
        for v in range(2):
            for k in ("u_mean", "raw_u_scale"):
                p64["views"][v][k].copy_(best["views"][v][k])
                p32["views"][v][k].copy_(best["views"][v][k].float())
    same = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    n = Ys[0].shape[0]
    idx = torch.arange(0, n, 4, device=card)
    names = ("qx_mean", "views.0.z", "views.1.raw_ard", "views.0.raw_noise")
    psi.reset_launch_counts()
    loss32 = -mrd_svi.elbo_minibatch(p32, [Y[idx] for Y in Ys], idx, n, cfg,
                                     same)
    g32 = torch.autograd.grad(loss32, [flat_leaves(p32)[k] for k in names])
    assert psi.LAUNCHES == _launched(suffstats_batched=2, psi2_bwd_batched=2)
    loss64 = -mrd_svi.elbo_minibatch(p64, [Y[idx] for Y in Ys64], idx, n,
                                     cfg64, same)
    g64 = torch.autograd.grad(loss64, [flat_leaves(p64)[k] for k in names])
    loss32, loss64 = float(loss32.detach()), float(loss64.detach())
    assert abs(loss32 - loss64) <= 1e-4 * abs(loss64)
    assert max(_scaled_errors(g32, g64)) <= 5e-3   # chip_smoke's TOL_GRAD
    steps = {}
    for name, p, c in (("f32", p32, cfg), ("f64", p64, cfg64)):
        steps[name] = mrd_svi.make_svi_natgrad_step(
            c, n, gp_optimizer(p, lr=2e-2, decay_steps=10), rho=0.2,
            policy=same)
    psi.reset_launch_counts()
    steps["f32"](0, idx, Ys)
    assert psi.LAUNCHES == _launched(suffstats_batched=2, psi2_bwd_batched=2)
    steps["f64"](0, idx, Ys64)
    for v in range(2):
        for k in ("u_mean", "raw_u_scale"):
            assert max(_scaled_errors([p32["views"][v][k]],
                                      [p64["views"][v][k]])) <= 1e-3, (v, k)


@pytest.mark.cuda
def test_mrd_svi_predictor_and_sampler_default_to_the_card(card):
    """Given CPU parameters and no device, the q(u)-only predictor and the
    cross-view sampler run on the card (no kernel: their psi statistics
    are plain) and answer there."""
    from dp_gp_lvm_tpu_torch.models import mrd_svi, serving

    Ys, cfg, params = _c9_setup(card, n=2048)
    cpu = mrd_svi.on_device(params, "cpu")
    psi.reset_launch_counts()
    predict = serving.make_mrd_svi_predictor(cpu, cfg, 0, 1, num_steps=10)
    mean, var = predict(Ys[0][:8].cpu())
    f = mrd_svi.cross_view_sample(prng.PRNGKey(1), cpu, {0: Ys[0][:8].cpu()},
                                  1, cfg, num_samples=4, num_steps=10,
                                  num_features=64)
    assert psi.LAUNCHES == _launched()
    assert mean.device.type == var.device.type == f.device.type == "cuda"
    assert mean.shape == var.shape == (8, 32) and f.shape == (4, 8, 32)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    assert bool(torch.isfinite(f).all())


@pytest.mark.cuda
def test_native_amc_parser_matches_python_on_a_generated_file(card,
                                                              tmp_path):
    """The g++-built AMC parser (`csrc/amc_parser.cpp`) on the card's
    machine: the Python parser's values and the written ones, to the
    bit."""
    from dp_gp_lvm_tpu_torch.data import mocap, native_io

    r = np.random.default_rng(3)
    Y = r.normal(size=(300, 7)) * 30.0
    path = mocap.write_amc(str(tmp_path / "g.amc"), Y,
                           [("root", 3), ("lfemur", 3), ("lhand", 1)])
    assert native_io.available()
    native = native_io.parse_amc_native(path)
    python, _ = mocap.parse_amc(path)
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(native, Y)


@pytest.mark.cuda
def test_fit_lbfgs_f32_on_card_tracks_f64(card):
    """optax's L-BFGS (`train/loop.py::fit_lbfgs`) on a Bayesian GP-LVM
    bound (N=200, D=12, Q=4, M=20): f32 through K6, K5 and K2 (once each
    a loss evaluation, line-search trials included) against f64 through
    the plain path, from one init at one jitter. The first loss agrees at
    1e-4; both fall; the last within 1e-2 of each other."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data.synthetic import oil_flow_like
    from dp_gp_lvm_tpu_torch.models import bgplvm
    from dp_gp_lvm_tpu_torch.train.loop import fit_lbfgs

    key = prng.PRNGKey(0)
    Y, _, _ = oil_flow_like(key, n=200, d=12, dtype=torch.float32,
                            device=card)
    cfg = bgplvm.Config(num_latent=4, num_inducing=20)
    params = bgplvm.init_params(key, Y, cfg)
    jitter = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    out = {}
    # "auto" takes the kernels for f32 and the plain path for f64
    for dtype, c in ((torch.float32, cfg), (torch.float64, cfg)):
        info = {}
        psi.reset_launch_counts()
        _, losses = fit_lbfgs(
            lambda p, y: -bgplvm.elbo(p, y, c, jitter),
            {k: v.detach().to(dtype) for k, v in params.items()},
            (Y.to(dtype),), 10, info=info)
        out[dtype] = (losses.double().cpu().numpy(), info, dict(psi.LAUNCHES))
    (l32, info32, launches32), (l64, _, launches64) = out.values()
    n = info32["evaluations"]
    assert {k: v for k, v in launches32.items() if v} == dict(
        psi1=n, psi2_single=n, psi2_bwd_batched=n)
    assert not any(launches64.values())
    assert abs(l32[0] - l64[0]) <= 1e-4 * abs(l64[0])
    assert l32[-1] < l32[0] and l64[-1] < l64[0]
    assert abs(l32[-1] - l64[-1]) <= 1e-2 * abs(l64[-1])


# ---------------------------------------------------------------------------
# "auto" and the inputs the kernels do not take; the mesh at world size 1
# ---------------------------------------------------------------------------

C4 = dict(T=20, N=1024, M=64, Q=10, D=59)


def _c4_dp(card, dtype, use_fused="auto"):
    """c4_dp_mocap's widths on a mocap_like draw, with its init."""
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm

    key = prng.PRNGKey(0)
    Y, _ = mocap_like(key, n=C4["N"], d=C4["D"], dtype=dtype, device=card)
    cfg = dp_gp_lvm.Config(num_latent=C4["Q"], num_inducing=C4["M"],
                           truncation=C4["T"], use_fused=use_fused)
    return Y, dp_gp_lvm.init_params(key, Y, cfg), cfg


def _loss_and_grads(model, params, Y, cfg):
    loss = model.loss(params, Y, cfg)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


@pytest.mark.cuda
def test_auto_takes_the_plain_path_for_float64_at_c4(card):
    """f64 inputs under "auto" at c4's widths: no kernel launches, and the
    value and every gradient are those of use_fused=False."""
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm

    Y, params, cfg = _c4_dp(card, torch.float64)
    psi.reset_launch_counts()
    loss, grads = _loss_and_grads(dp_gp_lvm, params, Y, cfg)
    assert psi.LAUNCHES == _launched()
    want, want_grads = _loss_and_grads(dp_gp_lvm, params, Y,
                                       cfg._replace(use_fused=False))
    assert torch.equal(loss, want)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_a_transposed_y_gives_the_bits_of_its_contiguous_copy(card):
    """A non-contiguous Y (the transpose of a row-major D x N array) goes
    through K1 and K2 (`suffstats_batched_fused`, which "auto" takes) at
    c4's widths and gives the same bits as Y itself, forward and every
    gradient."""
    a, f = _inputs(card, False, **C4)
    Y_t = f["Y"].T.contiguous().T
    assert not Y_t.is_contiguous() and torch.equal(Y_t, f["Y"])
    r = np.random.default_rng(11)
    G1 = torch.as_tensor(r.normal(size=(C4["T"], C4["M"], C4["D"])),
                         dtype=torch.float32, device=card)
    out = []
    for y in (f["Y"], Y_t):
        leaves = [f[k].clone().requires_grad_()
                  for k in ("vs", "ards", "mu", "s", "Zs")]
        leaves.append(y.clone().requires_grad_())
        psi.reset_launch_counts()
        p2, p1y = psi.suffstats_batched_fused(*leaves)
        grads = torch.autograd.grad((p2 * f["G"]).sum() + (p1y * G1).sum(),
                                    leaves)
        assert psi.LAUNCHES == _launched(suffstats_batched=1,
                                         psi2_bwd_batched=1)
        out.append((p2, p1y, *grads))
    for x, x_t in zip(*out):
        assert torch.equal(x, x_t)


@pytest.mark.cuda
def test_use_fused_true_still_refuses_float64(card):
    """Where the caller asks for the kernel, f64 raises: no silent plain
    path."""
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm

    Y, params, cfg = _c4_dp(card, torch.float64, use_fused=True)
    with pytest.raises(TypeError, match="float32"):
        dp_gp_lvm.loss(params, Y, cfg)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1 x 1 mesh over an NCCL process group of one rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import torch.distributed as dist

    from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(1, 1, "cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    mesh_lib.close_distributed()


def _sharded_family(card, family):
    """(model name, model module, full params, data tuple, config) at
    c5_pose's (DP), c1's (Bayesian GP-LVM) and c3's (MRD) widths."""
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like, toy_gplvm
    from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, mrd

    key = prng.PRNGKey(0)
    if family == "dp_gp_lvm":
        Y, _ = mocap_like(key, n=C5_POSE["N"], d=C5_POSE["D"],
                          dtype=torch.float32, device=card)
        cfg = dp_gp_lvm.Config(num_latent=C5_POSE["Q"],
                               num_inducing=C5_POSE["M"],
                               truncation=C5_POSE["T"])
        return dp_gp_lvm, dp_gp_lvm.init_params(key, Y, cfg), (Y,), cfg
    if family == "bgplvm":
        Y, _ = toy_gplvm(key, n=C1["N"], d=C1["D"], q_true=2,
                         q_total=C1["Q"], dtype=torch.float32, device=card)
        cfg = bgplvm.Config(num_latent=C1["Q"], num_inducing=C1["M"])
        return bgplvm, bgplvm.init_params(key, Y, cfg), (Y,), cfg
    Ys, params, cfg = _mrd_setup(card, torch.float32)
    return mrd, params, tuple(Ys), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dp_gp_lvm", "bgplvm", "mrd"])
def test_sharded_loss_at_world_size_one_equals_the_fused_path(
        card, nccl_mesh, family):
    """The sharded loss and its gradient on a 1 x 1 mesh over NCCL equal
    the unsharded fused path (f32; the sharded Bayesian GP-LVM takes K1 at
    T = 1 where the unsharded one takes K6 and K5). The sharded step
    launches K1 and K2 once per view."""
    from dp_gp_lvm_tpu_torch.parallel import recipe
    from dp_gp_lvm_tpu_torch.train.loop import flat_leaves

    model, params, data, cfg = _sharded_family(card, family)
    views = family == "mrd"
    leaves = flat_leaves(params)
    loss = model.loss(params, list(data) if views else data[0], cfg)
    want = torch.autograd.grad(loss, list(leaves.values()))
    setup = recipe.sharded_setup(family, params, data, cfg, nccl_mesh)
    psi.reset_launch_counts()
    sharded = setup.loss_fn(setup.params, *setup.data)
    local = flat_leaves(setup.params)
    got = torch.autograd.grad(sharded, list(local.values()))
    assert psi.LAUNCHES == _launched(suffstats_batched=len(data),
                                     psi2_bwd_batched=len(data))
    assert abs(float(sharded) - float(loss)) <= 1e-4 * abs(float(loss))
    assert max(_scaled_errors(got, want)) <= 5e-3   # chip_smoke's TOL_GRAD


C9_VIEW = dict(T=1, N=1024, M=32, Q=4, D=32)   # one c9 view's minibatch


def _svi_family(card, family):
    """(model module, its step factory, fresh full params, data, batch
    rows, config, step launches of K1 and K2) at c6's (SVI-GPLVM), c7's
    (DP-SVI, T = 8) and c9's (MRD-SVI, two views) minibatch widths, on a
    draw of 4 batches' rows."""
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.models import dp_svi, mrd_svi, svi_gplvm

    key = prng.PRNGKey(0)
    if family == "svi_gplvm":
        s = C6
        Y, _ = synthetic.mocap_like(key, n=4 * s["N"], d=s["D"],
                                    dtype=torch.float32, device=card)
        cfg = svi_gplvm.Config(num_latent=s["Q"], num_inducing=s["M"],
                               batch=s["N"])
        return (svi_gplvm, lambda c, n, o, mesh=None:
                svi_gplvm.make_svi_natgrad_step(c, n, o, mesh=mesh),
                lambda: svi_gplvm.init_params(key, Y, cfg), Y, cfg, (2, 1))
    if family == "dp_svi":
        s = C7
        Y, _ = synthetic.mocap_like(key, n=4 * s["N"], d=s["D"],
                                    dtype=torch.float32, device=card)
        cfg = dp_svi.Config(num_latent=s["Q"], num_inducing=s["M"],
                            truncation=s["T"], batch=s["N"])
        return (dp_svi, lambda c, n, o, mesh=None: dp_svi.make_dp_svi_step(
                    c, n, o, rho=0.3, phi_update="cavi", mesh=mesh),
                lambda: dp_svi.init_params(key, Y, cfg), Y, cfg, (1, 1))
    s = C9_VIEW
    Y1, Y2, _ = synthetic.two_view(key, n=4 * s["N"], d1=s["D"], d2=s["D"],
                                   q_shared=2, dtype=torch.float32,
                                   device=card)
    cfg = mrd_svi.Config(num_latent=s["Q"], num_inducing=s["M"],
                         num_views=2, batch=s["N"])
    return (mrd_svi, lambda c, n, o, mesh=None:
            mrd_svi.make_svi_natgrad_step(c, n, o, mesh=mesh),
            lambda: mrd_svi.init_params(key, [Y1, Y2], cfg), [Y1, Y2], cfg,
            (2, 2))


def _scaled_or_zero(got, want):
    return max(float((g.double() - w.double()).abs().max()
                     / max(float(w.abs().max()), 1e-30))
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["svi_gplvm", "dp_svi", "mrd_svi"])
def test_sharded_svi_at_world_size_one_equals_the_fused_path(
        card, nccl_mesh, family):
    """The sharded minibatch bound (its loss and every leaf's gradient) on
    a 1 x 1 mesh over NCCL equals the unsharded fused path at the same
    rows, and so does a whole step, the q(u) blend (and the DP-SVI's phi
    CAVI) included; the mesh step launches K1 and K2 as the unsharded step
    does: the SVI-GPLVM's K1 twice (blend_at="updated"), each MRD-SVI
    view's once, the DP-SVI's once at T = 8."""
    from dp_gp_lvm_tpu_torch.parallel import recipe
    from dp_gp_lvm_tpu_torch.parallel import sharded_elbo as se
    from dp_gp_lvm_tpu_torch.train.loop import flat_leaves, gp_optimizer

    model, make_step, init, data, cfg, (k1, k2) = _svi_family(card, family)
    first = data[0] if family == "mrd_svi" else data
    n = first.shape[0]
    idx = torch.arange(0, 2 * cfg.batch, 2, device=card)
    rows = [y[idx] for y in data] if family == "mrd_svi" else data[idx]
    sharded_fn = {"svi_gplvm": se.svi_loss_sharded,
                  "dp_svi": se.dp_svi_loss_sharded,
                  "mrd_svi": se.mrd_svi_loss_sharded}[family]

    params = init()
    leaves = flat_leaves(params)
    loss = model.loss_minibatch(params, rows, idx, n, cfg)
    want = torch.autograd.grad(loss, list(leaves.values()))
    local, _, table = recipe.place_svi(family, init(), (), nccl_mesh)
    sharded = sharded_fn(local, rows, idx, n, cfg, nccl_mesh)
    got = torch.autograd.grad(sharded, list(flat_leaves(local).values()))
    assert abs(float(sharded) - float(loss)) <= 1e-5 * abs(float(loss))
    assert _scaled_or_zero(got, want) <= 5e-3       # chip_smoke's TOL_GRAD

    step = make_step(cfg, n, gp_optimizer(params, lr=1e-2))
    opt = gp_optimizer(local, lr=1e-2, mesh=nccl_mesh, placement=table)
    mesh_step = make_step(cfg, n, opt, mesh=nccl_mesh)
    loss_u = step(0, idx, data)
    psi.reset_launch_counts()
    loss_m = mesh_step(0, idx, data)
    assert psi.LAUNCHES == _launched(suffstats_batched=k1,
                                     psi2_bwd_batched=k2)
    assert abs(float(loss_m) - float(loss_u)) <= 1e-5 * abs(float(loss_u))
    after = flat_leaves(params)
    assert _scaled_or_zero(list(flat_leaves(local).values()),
                           list(after.values())) <= 1e-4


# ---------------------------------------------------------------------------
# chunks replayed from CUDA graphs (train/loop.py::StepGraph)
# ---------------------------------------------------------------------------

GRAPH_CASES = ["c6", "c6_stream", "c7", "c8", "c9", "c4"]


def _graph_case(card, name, n=4096, chunk=4):
    """fresh(graphed) -> (go, optimizer): a fresh copy of the step the
    runner takes for `name` at the config's widths on an n-row draw (c7:
    stage 2c at T = 8; c9: phase B; c4: the full-batch DP-GP-LVM on its
    1024 rows); go(t0, k) runs its steps t0, ..., t0 + k - 1 (t0 + k <=
    chunk) as one chunk, eagerly or replayed, and returns their losses.
    The minibatches are drawn once, so every copy steps on the same
    rows."""
    from dp_gp_lvm_tpu_torch.core import config as config_lib
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm, dp_svi, mrd_svi
    from dp_gp_lvm_tpu_torch.models import svi_gplvm
    from dp_gp_lvm_tpu_torch.train import mrd_recipe
    from dp_gp_lvm_tpu_torch.train.loop import (
        MinibatchChunks,
        gp_optimizer,
        make_multi_step_fn,
    )

    cfg = config_lib.get({"c4": "c4_dp_mocap", "c6": "c6_svi_bigN",
                          "c6_stream": "c6_svi_bigN", "c7": "c7_dp_svi",
                          "c8": "c8_amortized_svi",
                          "c9": "c9_mrd_svi_bigN"}[name])
    key = prng.PRNGKey(cfg.seed)
    f32 = dict(dtype=torch.float32, device=card)
    if name == "c4":
        Y, _ = synthetic.mocap_like(key, n=cfg.n, d=cfg.d, **f32)
        mcfg = runner._model_config(cfg, None)

        def fresh_c4(graphed):
            params = dp_gp_lvm.init_params(key, Y, mcfg)
            opt = gp_optimizer(params, lr=cfg.lr, ard_lr=cfg.ard_lr,
                               decay_steps=cfg.steps, ngd_lr=cfg.ngd_lr)
            multi = make_multi_step_fn(
                lambda _, y: dp_gp_lvm.loss(params, y, mcfg), opt, chunk,
                eager=not graphed)
            return (lambda t0, k: multi(Y, steps=k)), opt
        return fresh_c4
    if name == "c7":
        Y, _, _ = synthetic.grouped_dims_big(
            key, n=n, dims_per_group=runner.grouped_dims_per_group(cfg.d),
            q=cfg.q, **f32)
    elif name == "c9":
        Y = synthetic.two_view_big(key, n=n, d1=cfg.views[0],
                                   d2=cfg.views[1], **f32)[:2]
    else:
        Y, _ = synthetic.mocap_like(key, n=n, d=cfg.d, **f32)
    mcfg = runner._model_config(cfg, None)
    first = Y[0] if name == "c9" else Y

    def fresh():
        if name == "c7":
            params = dp_svi.init_params(key, Y, mcfg)
            opt = gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                               decay_steps=cfg.steps)
            return opt, dp_svi.make_dp_svi_step(mcfg, n, opt, rho=0.3,
                                                phi_update="frozen")
        if name == "c9":
            params = mrd_recipe._as_parameters(mrd_recipe.recalibrated(
                mrd_svi.init_params(key, Y, mcfg), 0.4, 0.25))
            opt = gp_optimizer(params, lr=cfg.lr, decay_steps=cfg.steps,
                               freeze=mrd_recipe.FROZEN_STRUCTURE)
            return opt, runner._svi_step(cfg, mcfg, n, opt, False)
        params = svi_gplvm.init_params(key, Y, mcfg)
        opt = gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                           decay_steps=cfg.steps,
                           slow=frozenset({"z"}) if cfg.amortized
                           else frozenset())
        return opt, runner._svi_step(cfg, mcfg, n, opt,
                                     name == "c6_stream")

    idx = dp_svi.minibatch_indices(
        prng.fold_in(prng.PRNGKey(1), torch.arange(chunk)), mcfg.batch,
        n).to(card)
    rows = first[idx]

    def fresh_svi(graphed):
        opt, step = fresh()
        streamed = name == "c6_stream"
        chunks = MinibatchChunks(step, None if streamed else Y,
                                 streaming=streamed, eager=not graphed)

        def go(t0, k):
            return chunks(t0, idx[t0:t0 + k],
                          rows[t0:t0 + k] if streamed else None)
        return go, opt
    return fresh_svi


def _same_state(a, b):
    """The names of the state's tensors whose bits differ."""
    if torch.is_tensor(a):
        return [] if torch.equal(a, b) else [""]
    return [f"{k}.{d}".rstrip(".") for k in a for d in _same_state(a[k],
                                                                  b[k])]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CASES)
def test_replayed_steps_are_the_eager_steps(card, name):
    """A warm-up step, a capture and three replays against four eager
    steps from the same state on the same minibatches: the same losses
    and optimizer state, bit for bit, and the same launch and step
    counts; and the hand kernels the card ran, read from a profiler
    trace of each run (`perf.launches`) and from the counters on the card
    (`ops.psi.count_on_card`), are those the counts say, so the counts a
    replay adds on the host are what the graph launched."""
    from torch.profiler import ProfilerActivity, profile

    from dp_gp_lvm_tpu_torch.perf import launches
    from dp_gp_lvm_tpu_torch.train import loop

    fresh = _graph_case(card, name)
    counts = {}
    psi.count_on_card(card)
    try:
        for graphed in (False, True):
            go, opt = fresh(graphed)
            psi.reset_launch_counts()
            loop.reset_step_count()
            loop.reset_graph_counts()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                losses = go(0, 4)
                torch.cuda.synchronize()
            counts[graphed] = (losses, opt.state_dict(), dict(psi.LAUNCHES),
                               loop.STEPS["taken"],
                               launches.traced_launches(prof)[0],
                               psi.card_counts())
    finally:
        psi.count_on_card(None)
    assert loop.GRAPHS == {"captures": 1, "replays": 3}
    (l_e, s_e, n_e, t_e, k_e, c_e), (l_g, s_g, n_g, t_g, k_g, c_g) = (
        counts[False], counts[True])
    assert bool(torch.isfinite(l_e).all())
    assert torch.equal(l_e, l_g)
    assert _same_state(s_e, s_g) == []
    assert n_e == n_g == c_e == c_g and t_e == t_g == 4
    assert k_e == k_g == launches.families(n_e)
    assert sum(k_g.values()) >= 8               # K1 and K2 each step


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CASES)
def test_eager_steps_make_no_host_sync(card, name):
    """PyTorch's sync debug mode in "error" raises at any synchronizing
    call of a chunk of eager steps after a warm-up chunk."""
    go, _ = _graph_case(card, name)(False)
    go(0, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = go(1, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(losses).all())


@pytest.mark.cuda
@pytest.mark.parametrize("members", [False, True])
def test_forced_repair_inside_a_graph_picks_the_eager_jitter(card, members):
    """K_uu of inducing inputs with duplicated rows in f32, under a policy
    whose first rungs sit below f32's resolution: the factor at the first
    rungs fails, and the jitter a replay picks (and its factor) is the
    one the eager ladder picks."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.kernels import ard_rbf
    from dp_gp_lvm_tpu_torch.linalg import chol
    from dp_gp_lvm_tpu_torch.train.loop import StepGraph

    policy = JitterPolicy(initial=1e-10, initial_f32=1e-10)
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(3, 32, 4, generator=gen)
    z[:, 16:] = z[:, :16]                      # every row twice
    z = z.to(card)
    variance = torch.ones(3, device=card)
    ard = torch.ones(3, 4, device=card)
    fn = chol.safe_cholesky_members if members else chol.safe_cholesky_spec

    def factor():
        kuu = torch.stack([ard_rbf.gram(variance[t], ard[t], z[t])
                           for t in range(3)])
        return fn(kuu, policy)

    want_L, want_j = factor()
    assert bool((want_j > 1e-10).all())        # the ladder repaired it
    out = {}

    def body():
        out["L"], out["j"] = factor()

    StepGraph(body, graphed=True).run(2)       # a warm-up and a replay
    torch.cuda.synchronize()
    assert torch.equal(out["j"], want_j)
    assert torch.equal(out["L"], want_L)


@pytest.mark.cuda
def test_a_capture_survives_an_earlier_graph_left_in_a_cycle(card):
    """A dropped chunk loop (a MinibatchChunks and its StepGraph hold each
    other) leaves its CUDA graph to the collector. Freeing that graph
    inside a later capture invalidates the capture
    (`tools/graph_capture_probe.py`), so `StepGraph` collects before it
    captures: a body that collects inside the capture (not in its
    warm-up) must still capture and replay."""
    import gc

    from dp_gp_lvm_tpu_torch.train.loop import MinibatchChunks, StepGraph

    x = torch.zeros((), device=card)

    def step(t, idx, data):
        x.add_(1.0)
        return x * 1.0

    old = MinibatchChunks(step, torch.zeros(4, device=card))
    old(0, torch.zeros(3, 2, dtype=torch.int64, device=card))
    assert old.graph.graph is not None          # captured and replayed
    del old                                     # now garbage in a cycle

    def body():
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        x.add_(1.0)

    StepGraph(body, graphed=True).run(3)       # a warm-up and two replays
    torch.cuda.synchronize()
    assert float(x) == 6.0
