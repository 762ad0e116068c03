"""What the K1 kernel's design (`dp_gp_lvm_tpu_torch/csrc/psi_suffstats.cu`)
rests on, checked on the CPU in f64, and the wrapper's launch geometry.

The kernel takes the pair exponent as ln - (le + sum_q (c_m + c_l)^2) / 4
with c = sqrt(b) (mu - z) staged per row; it stores only the 4x4 tiles of
Psi2's upper triangle in its partials and lets the chunk reduction mirror
them; and it sums rows per group of a block, the groups in group order and
the chunks in chunk order. Each identity is held to the plain version's
outputs, with row weights that hold zeros. No JAX here: the plain version
is the port's own oracle.
"""
import math

import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.ops import psi

T, N, M, Q, D = 3, 23, 10, 4, 5
TOL = 1e-12


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(11)
    w = (r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
    w[:2] = 0.0
    arrs = dict(vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
                mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
                Zs=r.normal(size=(T, M, Q)), Y=r.normal(size=(N, D)), w=w)
    a = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in arrs.items()}
    want = psi.suffstats_batched_reference(a["vs"], a["ards"], a["mu"],
                                           a["s"], a["Zs"], a["Y"], a["w"])
    return a, want


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


def _pair_terms(a):
    """Per (atom, row, m, l) the kernel's E = exp(min(expo, 0)), from c."""
    al, Zs, mu, s = a["ards"], a["Zs"], a["mu"], a["s"]
    u = 2.0 * al[:, None, :] * s + 1.0                     # (T, N, Q)
    b = al[:, None, :] / u
    ln = -0.5 * torch.log(u).sum(-1)                       # (T, N)
    c = b.sqrt()[:, :, None, :] * (mu[None, :, None, :] - Zs[:, None])
    quad = ((c[:, :, :, None, :] + c[:, :, None, :, :]) ** 2).sum(-1)
    df = Zs[:, :, None, :] - Zs[:, None, :, :]
    le = (al[:, None, None, :] * df * df).sum(-1)          # (T, M, M)
    expo = ln[..., None, None] - 0.25 * (le[:, None] + quad)
    return torch.exp(torch.clamp(expo, max=0.0)), expo


def test_c_sum_exponent_is_the_references(case):
    a, _ = case
    _, expo = _pair_terms(a)
    log_e = ard_rbf._log_e(a["ards"], a["Zs"])
    _, _, ref = ard_rbf._forward_pieces(a["vs"], a["ards"], a["mu"], a["s"],
                                        a["Zs"], log_e)
    assert float((expo - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert float(expo.max()) <= 0.0        # each term is non-positive


def _upper_tiles(m):
    """(tm, tl) of each upper-triangle 4x4 tile in the kernel's order."""
    t4 = math.ceil(m / 4)
    return [(tm, tl) for tm in range(t4) for tl in range(tm, t4)]


def _store_tiles(full):
    """The kernel's Psi2 partial: 16 values per upper-triangle tile of the
    zero-padded (T, M4, M4) stack, tile-major."""
    t, m = full.shape[0], full.shape[-1]
    m4 = 4 * math.ceil(m / 4)
    pad = torch.zeros(t, m4, m4, dtype=full.dtype)
    pad[:, :m, :m] = full
    return torch.stack([pad[:, 4 * tm:4 * tm + 4, 4 * tl:4 * tl + 4]
                        .reshape(t, 16) for tm, tl in _upper_tiles(m)], 1)


def _mirror(tiles, m):
    """The chunk reduction's write-out: entry (i, j) of tile (tm, tl) to
    (4 tm + i, 4 tl + j) and to its mirror, inside M."""
    out = torch.full((tiles.shape[0], m, m), float("nan"), dtype=tiles.dtype)
    for k, (tm, tl) in enumerate(_upper_tiles(m)):
        for e in range(16):
            i, j = 4 * tm + e // 4, 4 * tl + e % 4
            if i < m and j < m:
                out[:, i, j] = out[:, j, i] = tiles[:, k, e]
    return out


def test_mirrored_upper_tiles_are_psi2(case):
    a, (psi2, _) = case
    E, _ = _pair_terms(a)
    full = (a["vs"] ** 2)[:, None, None] * torch.einsum("n,tnml->tml",
                                                        a["w"], E)
    tiles = _store_tiles(full)
    assert tiles.shape == (T, len(_upper_tiles(M)), 16)
    got = _mirror(tiles, M)
    assert not torch.isnan(got).any()      # every entry written
    assert _close(got, psi2)


@pytest.mark.parametrize("groups,stage_rows,rows", [(1, 4, 23), (2, 8, 9),
                                                    (3, 6, 5), (8, 32, 4)])
def test_group_and_chunk_sums_in_fixed_order_are_the_one_pass_sum(
        case, groups, stage_rows, rows):
    """Chunks of `rows` rows, each walked in stages of `stage_rows` whose
    row r goes to group r % groups; groups summed in group order, chunks
    in chunk order, Psi1^T Y per chunk over all its rows."""
    a, (psi2, p1y) = case
    E, _ = _pair_terms(a)
    wE = a["w"][None, :, None, None] * E
    psi1 = ard_rbf.psi1(a["vs"], a["ards"], a["mu"], a["s"], a["Zs"], a["w"])
    p2_sum = torch.zeros_like(psi2)
    p1y_sum = torch.zeros_like(p1y)
    for r0 in range(0, N, rows):
        n_chunk = min(rows, N - r0)
        acc = [torch.zeros_like(psi2) for _ in range(groups)]
        for st in range(0, n_chunk, stage_rows):
            for r in range(min(stage_rows, n_chunk - st)):
                acc[r % groups] = acc[r % groups] + wE[:, r0 + st + r]
        part = acc[0]
        for g in range(1, groups):
            part = part + acc[g]
        p2_sum = p2_sum + (a["vs"] ** 2)[:, None, None] * part
        sl = slice(r0, r0 + n_chunk)
        p1y_sum = p1y_sum + psi1[:, sl].mT @ a["Y"][sl]
    assert _close(p2_sum, psi2)
    assert _close(p1y_sum, p1y)


def _h100_occupancy(M_, Q_, D_, registers=96):
    """Blocks per SM of an H100 (132 SMs, 64 K registers, 2048 threads,
    227 KB of shared memory) for K1's block at `registers` a thread (what
    ptxas gave the kernel for sm_90a) and the source's shared-memory
    layout."""
    t4 = math.ceil(M_ / 4)
    tiles, m4, d4 = t4 * (t4 + 1) // 2, 4 * t4, 4 * math.ceil(D_ / 4)

    def occupancy(groups, stage_rows):
        threads = 32 * math.ceil(groups * tiles / 32)
        ri = 4 * math.ceil((6 * Q_ + 3) / 4)
        floats = (Q_ * m4 + 4 * math.ceil(Q_ / 4) + 3 * stage_rows * ri
                  + 3 * stage_rows * d4 + 2 * stage_rows * Q_ * m4
                  + 2 * stage_rows * m4)
        floats = max(floats, (groups - 1) * 16 * tiles)
        if 4 * floats > 232448:
            return 0
        return min(2048 // threads, 65536 // (registers * threads),
                   233472 // (4 * floats + 1024))
    return occupancy


# (T, N, M, Q, D) -> (groups, threads, rows per chunk, chunks) on an H100
GEOMETRY = {
    "c4": ((20, 1024, 64, 10, 59), (4, 544, 171, 6)),
    "scale": ((20, 8192, 128, 10, 60), (1, 544, 1366, 6)),
    "c2": ((1, 1000, 50, 10, 12), (1, 96, 4, 250)),
    "ragged": ((3, 37, 6, 3, 4), (8, 32, 13, 3)),
    "n1": ((20, 1, 64, 10, 59), (4, 544, 1, 1)),
    "q40": ((2, 70, 128, 40, 5), (1, 544, 4, 18)),
    "wide_d": ((2, 90, 20, 5, 300), (8, 128, 8, 12)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_k1_geometry_covers_every_row_once_with_whole_warps(name):
    (T_, N_, M_, Q_, D_), (groups, threads, rows, chunks) = GEOMETRY[name]
    geo = psi.k1_geometry(T_, N_, M_, Q_, D_, 132,
                          _h100_occupancy(M_, Q_, D_))
    assert (geo.groups, geo.threads, geo.rows, geo.chunks) == (
        groups, threads, rows, chunks)
    assert geo.threads % 32 == 0 and geo.threads <= psi.K1_MAX_THREADS
    t4 = math.ceil(M_ / 4)
    assert geo.tiles == t4 * (t4 + 1) // 2
    assert geo.threads - 32 < geo.groups * geo.tiles <= geo.threads
    assert geo.stage_rows % geo.groups == 0
    starts = range(0, geo.chunks * geo.rows, geo.rows)
    covered = [n for c in starts for n in range(c, min(N_, c + geo.rows))]
    assert covered == list(range(N_))
    assert all(c < N_ for c in starts)            # no block without rows
    assert geo.p1y_passes == math.ceil(t4 * math.ceil(D_ / 4) / geo.threads)
    assert geo.part_floats == geo.chunks * T_ * (
        16 * geo.tiles + 4 * math.ceil(M_ * D_ / 4))


@pytest.mark.parametrize("name", ["c4", "scale"])
def test_k1_geometry_fills_the_card(name):
    """At the main path's shapes the blocks fill at least 90% of their
    waves' slots and at least 90% of a block's threads own a tile."""
    (T_, N_, M_, Q_, D_), _ = GEOMETRY[name]
    geo = psi.k1_geometry(T_, N_, M_, Q_, D_, 132,
                          _h100_occupancy(M_, Q_, D_))
    assert geo.slot_fill >= 0.9
    assert geo.lane_use >= 0.9
    assert geo.p1y_passes == 1


def test_k1_geometry_refuses_a_block_that_fits_no_sm():
    with pytest.raises(RuntimeError, match="no block fits an SM at M=128, "
                                           "Q=256"):
        psi.k1_geometry(1, 4, 128, 256, 5, 132, lambda g, rs: 0)


def test_k1_scratch_shrinks():
    """The partials hold the upper-triangle tiles and Psi1^T Y once per
    chunk: under 8 MB at c4 (the first K1's 440 blocks wrote 13.9 MB)."""
    geo = psi.k1_geometry(20, 1024, 64, 10, 59, 132,
                          _h100_occupancy(64, 10, 59))
    assert 4 * geo.part_floats < 8 * 2 ** 20
