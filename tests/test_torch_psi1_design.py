"""What K6 (`dp_gp_lvm_tpu_torch/csrc/psi1.cu`) rests on, checked on the
CPU in f64: its arithmetic and its launch geometry.

The kernel prepares per row sa_q = sqrt(a_nq log2(e) / 2), c_q = sa_q mu_nq
and ln2_n = log2(e) log_norm_n, sums d = c_q - sa_q z_mq squared over q,
clamps ln2_n - quad at 0 before var w_n multiplies and raises 2 to it. An
f64 emulation of that arithmetic, walked over `psi.k6_geometry`'s blocks,
warps, steps and column tiles, is held against the port's plain version
(1e-12) and against the JAX package's Pallas kernel in interpret mode
(2e-6: its dots are pinned to f32 whatever the input type). The geometry
must write every (row, column) once, with whole warps of 32 lanes of four
columns.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.ops.pallas import psi as jpsi
from dp_gp_lvm_tpu_torch.ops import psi

N, Q = 100, 10
TOL = 1e-12
TOL_PALLAS = 2e-6    # f32 dots inside the Pallas kernel
LOG2E = 1.0 / math.log(2.0)
H100_SMS = 132


def _inputs(M, weighted, seed=3):
    r = np.random.default_rng(seed)
    w = (r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
    w[:2] = 0.0
    arrs = dict(v=np.array(r.uniform(0.5, 1.5)), ard=r.uniform(0.3, 2.0, Q),
                mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
                Z=r.normal(size=(M, Q)), w=w if weighted else None)
    return {k: None if v is None else torch.as_tensor(v, dtype=torch.float64)
            for k, v in arrs.items()}


def _walk(geo, N_, M_):
    """(rows, columns) of each warp step of each block and column tile, as
    csrc/psi1.cu indexes them: warp step g = block * K6_WARPS + warp, then
    grid-stride; lane l owns columns tile * K6_COLS + 4 l .. + 3, those
    below M."""
    S = geo.step_rows
    steps = math.ceil(N_ / S)
    lanes = np.arange(32)
    for tile in range(geo.col_tiles):
        cols = (tile * psi.K6_COLS + 4 * lanes[:, None]
                + np.arange(4)).ravel()
        cols = cols[cols < M_]
        for bx in range(geo.row_blocks):
            for warp in range(psi.K6_WARPS):
                g = bx * psi.K6_WARPS + warp
                k = 0
                while g < steps:
                    yield np.arange(g * S, min(N_, g * S + S)), cols
                    g += geo.row_blocks * psi.K6_WARPS
                    k += 1
                assert k <= geo.steps


def _emulate(a, geo):
    """K6's arithmetic in f64, filled in over the walk of `geo`."""
    v, ard, mu, s, Z, w = (a[k] for k in ("v", "ard", "mu", "s", "Z", "w"))
    out = torch.full((mu.shape[0], Z.shape[0]), float("nan"),
                     dtype=torch.float64)
    for rows, cols in _walk(geo, *out.shape):
        rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
        u = ard * s[rows] + 1.0
        sa = torch.sqrt(ard / u * (0.5 * LOG2E))
        c = sa * mu[rows]
        ln2 = -0.5 * torch.sum(torch.log2(u), dim=1)
        d = c[:, None, :] - sa[:, None, :] * Z[cols][None]
        quad = torch.sum(d * d, dim=-1)
        scale = v * (torch.ones_like(ln2) if w is None else w[rows])
        out[rows[:, None], cols[None]] = scale[:, None] * torch.exp2(
            torch.clamp(ln2[:, None] - quad, max=0.0))
    return out


def _scaled(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("M", [1, 50, 129])
def test_kernel_arithmetic_is_the_plain_psi1(M, weighted):
    """On a one-SM card, so that warps walk several steps grid-stride."""
    a = _inputs(M, weighted)
    geo = psi.k6_geometry(N, M, Q, sms=1, blocks_per_sm=1)
    assert geo.steps > 1
    got = _emulate(a, geo)
    assert not torch.isnan(got).any()       # every entry written
    want = psi.psi1_reference(a["v"], a["ard"], a["mu"], a["s"], a["Z"],
                              a["w"])
    assert _scaled(got, want) <= TOL


M_PALLAS = 129


@pytest.fixture(scope="module")
def pallas_psi1():
    """psi1_pallas in interpret mode, jitted once at (N, M_PALLAS, Q):
    {weighted: output} with the mask-style weights and with ones."""
    fn = jax.jit(functools.partial(jpsi.psi1_pallas, block_n=8,
                                   interpret=True))
    outs = {}
    for weighted in (False, True):
        a = _inputs(M_PALLAS, True)
        w = a["w"].numpy() if weighted else np.ones(N)
        outs[weighted] = torch.as_tensor(np.array(fn(
            *(jnp.asarray(a[k].numpy()) for k in ("v", "ard", "mu", "s",
                                                   "Z")),
            weights=jnp.asarray(w))))
    return outs


@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_arithmetic_matches_the_pallas_kernel(pallas_psi1, weighted):
    a = _inputs(M_PALLAS, weighted)
    geo = psi.k6_geometry(N, M_PALLAS, Q, sms=2, blocks_per_sm=1)
    got = _emulate(a, geo)
    assert _scaled(got, pallas_psi1[weighted]) <= TOL_PALLAS


# (N, M): the c2 step, the scale shape, and ragged edges
GEOMETRY_SHAPES = [(1000, 50), (8192, 128)] + [
    (n, m) for m in (1, 129, 256) for n in (1, 5)]


@pytest.mark.parametrize("blocks_per_sm", [1, 8])
@pytest.mark.parametrize("N_,M_", GEOMETRY_SHAPES)
def test_k6_geometry_writes_every_output_once(N_, M_, blocks_per_sm):
    geo = psi.k6_geometry(N_, M_, Q, H100_SMS, blocks_per_sm)
    assert psi.K6_COLS == 4 * 32                  # whole warps of 4 columns
    assert geo.col_tiles == math.ceil(M_ / psi.K6_COLS)
    assert geo.row_blocks * geo.col_tiles <= max(
        geo.col_tiles, H100_SMS * blocks_per_sm)  # at most one wave
    # one step a warp, unless a step already holds the most rows
    assert geo.steps == 1 or geo.step_rows == psi.k6_max_step_rows(Q)
    count = np.zeros((N_, M_), np.int32)
    for rows, cols in _walk(geo, N_, M_):
        count[rows[:, None], cols[None]] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 4, 8])
def test_k6_geometry_fills_the_card_at_the_scale_shape(blocks_per_sm):
    geo = psi.k6_geometry(8192, 128, Q, H100_SMS, blocks_per_sm)
    assert geo.row_blocks * geo.col_tiles >= H100_SMS
    # 2 blocks a SM (96 registers a thread, as ptxas gives K6 at Q = 10):
    # 4 rows a step, 256 blocks, one step a warp
    if blocks_per_sm == 2:
        assert (geo.step_rows, geo.row_blocks, geo.steps) == (4, 256, 1)
