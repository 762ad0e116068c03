"""What the K2 kernel's design (`dp_gp_lvm_tpu_torch/csrc/psi2_bwd.cu`)
rests on, checked on the CPU in f64, and the wrapper's launch geometry.

The kernel lets the thread that owns row m of a row's M x M tile compute
W_ml + W_lm from its own exponent, because the exponent and its mask are
symmetric in (m, l); it carries S = var^2 sum_n w_n (E o mask) and forms
V = G o S afterwards; gw_n is var^2 <E_n, G> summed over the atoms. The
identities are held to the plain version's outputs, with row weights that
hold zeros. No JAX here: the plain version is the port's own oracle.
"""
import math

import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.ops import psi

T, N, M, Q = 3, 13, 6, 4
TOL = 1e-12


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(5)
    w = (r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
    w[:2] = 0.0
    arrs = dict(vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
                mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
                Zs=r.normal(size=(T, M, Q)), G=r.normal(size=(T, M, M)), w=w)
    a = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in arrs.items()}
    log_e = ard_rbf._log_e(a["ards"], a["Zs"])
    u, b, expo = ard_rbf._forward_pieces(a["vs"], a["ards"], a["mu"],
                                         a["s"], a["Zs"], log_e)
    E = torch.exp(torch.clamp(expo, max=0.0))            # (T, N, M, M)
    em = E * (expo < 0.0).to(E.dtype)
    raw = psi.psi2_bwd_batched_reference(a["vs"], a["ards"], a["mu"], a["s"],
                                         a["Zs"], a["G"], a["w"])
    return a, u, b, E, em, raw


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_symmetrised_w_needs_only_the_owners_exponent(case):
    a, _, _, _, em, raw = case
    v2w = (a["vs"] ** 2)[:, None, None, None] * a["w"][None, :, None, None]
    G = a["G"][:, None]
    W = v2w * em * G
    assert _close(W + W.mT, v2w * em * (G + G.mT))
    # the thread that owns row m sums its row of W + W^T against Z; with
    # the per-row scalars built from it the plain outputs follow
    WS = v2w * em * (G + G.mT)
    rsum = WS.sum(-1)                                      # (T, N, M)
    wsz = torch.einsum("tnml,tlq->tnmq", WS, a["Zs"])
    A = 0.5 * rsum.sum(-1)
    Zs, mu, s, b, u = a["Zs"], a["mu"], a["s"], case[2], case[1]
    rz, rz2 = rsum @ Zs, rsum @ (Zs * Zs)
    U = 0.5 * torch.einsum("tnmq,tmq->tnq", wsz, Zs)
    gb = -mu * mu * A[..., None] + mu * rz - 0.25 * rz2 - 0.5 * U
    gmu = torch.sum(b * (-2.0 * mu * A[..., None] + rz), dim=0)
    gs = torch.sum(gb * (-2.0 * b * b) - A[..., None] * b, dim=0)
    gard = torch.sum(gb / (u * u) - A[..., None] * s / u, dim=1)
    gz = (torch.einsum("tnm,tnq->tmq", rsum, b * mu)
          - 0.5 * Zs * torch.einsum("tnm,tnq->tmq", rsum, b)
          - 0.5 * torch.einsum("tnmq,tnq->tmq", wsz, b))
    for got, want in zip((gard, gz, gmu, gs), (raw[1], raw[2], raw[4],
                                               raw[5])):
        assert _close(got, want)


def test_v_is_g_times_s(case):
    a, _, _, _, em, raw = case
    S = (a["vs"] ** 2)[:, None, None] * torch.sum(
        a["w"][None, :, None, None] * em, dim=1)
    assert _close(a["G"] * S, raw[3])


def test_gw_and_gvar_from_the_unmasked_exponent(case):
    a, _, _, E, _, raw = case
    p = torch.sum(E * a["G"][:, None], dim=-1)             # (T, N, M)
    gw = torch.sum((a["vs"] ** 2)[:, None] * p.sum(-1), dim=0)
    assert _close(gw, raw[6])
    assert float(gw[:2].abs().min()) > 0.0   # zero-weight rows keep gw
    assert _close(torch.einsum("n,tnm->tm", a["w"], p), raw[0])


# (T, N, M, Q, SMs, blocks per SM) -> (rows per block, chunks); blocks per
# SM as csrc/psi2_bwd.cu's occupancy query gives them on an H100 (132 SMs)
GEOMETRY = {
    "c4": ((20, 1024, 64, 10, 132, 2), (79, 13)),
    "c2": ((1, 1000, 50, 10, 132, 2), (4, 250)),
    "scale": ((20, 8192, 128, 10, 132, 1), (631, 13)),
    "n1": ((20, 1, 64, 10, 132, 2), (1, 1)),
    "q40": ((2, 70, 33, 40, 132, 1), (4, 18)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_k2_geometry_covers_every_row_once(name):
    (T_, N_, M_, Q_, sms, occ), (rows, chunks) = GEOMETRY[name]
    geo = psi.k2_geometry(T_, N_, M_, Q_, sms, occ)
    assert (geo.rows, geo.chunks) == (rows, chunks)
    starts = range(0, geo.chunks * geo.rows, geo.rows)
    covered = [n for c in starts for n in range(c, min(N_, c + geo.rows))]
    assert covered == list(range(N_))
    assert all(c < N_ for c in starts)            # no block without rows
    assert geo.rows >= min(N_, psi.K2_MIN_ROWS)
    assert geo.threads % 32 == 0
    assert geo.slice_width == (32 if M_ > 64 or Q_ > 10 else 16)
    assert geo.threads <= (256 if geo.slice_width == 16 else 512)
    assert geo.threads >= M_ * math.ceil(M_ / geo.slice_width)
    assert geo.part_floats == geo.chunks * T_ * (M_ + Q_ + M_ * Q_ + M_ * M_)
    assert geo.row_floats == T_ * N_ * (2 * Q_ + 1)


def test_k2_scratch_at_c4_is_under_16_mb():
    """The per-chunk partials carry S (M x M) per atom as V did; what
    shrinks them is the chunk count, at any occupancy c4's 74 KB blocks
    allow (at most 3 per SM)."""
    for occ in (1, 2, 3):
        geo = psi.k2_geometry(20, 1024, 64, 10, 132, occ)
        assert geo.scratch_bytes < 16 * 2 ** 20
