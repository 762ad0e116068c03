"""What K4 and K5, the Psi2-only body of
`dp_gp_lvm_tpu_torch/csrc/psi_suffstats.cu`, rest on, checked on the CPU in
f64, and the rule that sends "auto" to the fused kernels.

K4 (`psi2_batched`) and K5 (`psi2_single`) run K1's body with Psi1^T Y
compiled out, at K1's launch geometry for D = 0: no walks of the rows for
Psi1^T Y, partials of 16 floats per upper-triangle 4x4 tile per (chunk,
atom), mirrored by the chunk reduction. `dispatch.resolve_fused` takes the
kernels for "auto" only where every kernel of the path takes the shape
(`psi.fused_fits`: a single-tile or a tiled form of each). No JAX here:
the plain versions are the port's own oracle.
"""
import math

import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.ops import dispatch, psi

T, N, M, Q = 3, 23, 10, 4
TOL = 1e-12


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(12)
    w = (r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
    w[:2] = 0.0
    arrs = dict(vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
                mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
                Zs=r.normal(size=(T, M, Q)), w=w)
    return {k: torch.as_tensor(v, dtype=torch.float64)
            for k, v in arrs.items()}


def _upper_tiles(m):
    t4 = math.ceil(m / 4)
    return [(tm, tl) for tm in range(t4) for tl in range(tm, t4)]


def _chunk_partials(a, rows):
    """Per chunk of `rows` rows, the body's partial: var^2 sum_n w_n E_n
    over the chunk, 16 values per upper-triangle tile of the zero-padded
    (T, M4, M4) stack, tile-major: (chunks, T, tiles, 16)."""
    t, m = a["Zs"].shape[:2]
    m4 = 4 * math.ceil(m / 4)
    parts = []
    for r0 in range(0, a["mu"].shape[0], rows):
        sl = slice(r0, r0 + rows)
        full = psi.psi2_batched_reference(a["vs"], a["ards"], a["mu"][sl],
                                          a["s"][sl], a["Zs"], a["w"][sl])
        pad = torch.zeros(t, m4, m4, dtype=full.dtype)
        pad[:, :m, :m] = full
        parts.append(torch.stack(
            [pad[:, 4 * tm:4 * tm + 4, 4 * tl:4 * tl + 4].reshape(t, 16)
             for tm, tl in _upper_tiles(m)], 1))
    return torch.stack(parts)


def _reduce_chunks(parts, m):
    """The chunk reduction: partials summed in chunk order, entry (i, j) of
    tile (tm, tl) written to (4 tm + i, 4 tl + j) and mirrored, inside M."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    out = torch.full((acc.shape[0], m, m), float("nan"), dtype=acc.dtype)
    for k, (tm, tl) in enumerate(_upper_tiles(m)):
        for e in range(16):
            i, j = 4 * tm + e // 4, 4 * tl + e % 4
            if i < m and j < m:
                out[:, i, j] = out[:, j, i] = acc[:, k, e]
    return out


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("rows", [4, 9, 23])
def test_mirrored_upper_tile_partials_are_the_psi2_stack(case, rows):
    parts = _chunk_partials(case, rows)
    assert parts.shape[2:] == (len(_upper_tiles(M)), 16)
    got = _reduce_chunks(parts, M)
    assert not torch.isnan(got).any()      # every entry written
    want = psi.psi2_batched_reference(case["vs"], case["ards"], case["mu"],
                                      case["s"], case["Zs"], case["w"])
    assert _close(got, want)


def test_mirrored_upper_tile_partials_are_one_kernels_psi2(case):
    one = dict(case, vs=case["vs"][:1], ards=case["ards"][:1],
               Zs=case["Zs"][:1])
    got = _reduce_chunks(_chunk_partials(one, 5), M)[0]
    want = psi.psi2_single_reference(case["vs"][0], case["ards"][0],
                                     case["mu"], case["s"], case["Zs"][0],
                                     case["w"])
    assert _close(got, want)


def _h100_occupancy(M_, Q_, registers=96):
    """Blocks per SM of an H100 (64 K registers, 2048 threads, 227 KB of
    shared memory) for the Psi2-only block at `registers` a thread and the
    source's shared-memory layout at D = 0 (no Y or Psi1 rows)."""
    t4 = math.ceil(M_ / 4)
    tiles, m4 = t4 * (t4 + 1) // 2, 4 * t4

    def occupancy(groups, stage_rows):
        threads = 32 * math.ceil(groups * tiles / 32)
        ri = 4 * math.ceil((6 * Q_ + 3) / 4)
        floats = (Q_ * m4 + 4 * math.ceil(Q_ / 4) + 3 * stage_rows * ri
                  + 2 * stage_rows * Q_ * m4)
        floats = max(floats, (groups - 1) * 16 * tiles)
        if 4 * floats > 232448:
            return 0
        return min(2048 // threads, 65536 // (registers * threads),
                   233472 // (4 * floats + 1024))
    return occupancy


# (N, M) of the c2 step, the c4 widths and the scale shape, all Q = 10
SHAPES = {"c2": (1000, 50), "c4": (1024, 64), "scale": (8192, 128)}


@pytest.mark.parametrize("T_", [1, 20])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_psi2_only_geometry_covers_every_row_once_with_whole_warps(name, T_):
    N_, M_ = SHAPES[name]
    geo = psi.k1_geometry(T_, N_, M_, 10, 0, 132, _h100_occupancy(M_, 10))
    assert geo.p1y_passes == 0
    assert geo.threads % 32 == 0 and geo.threads <= psi.K1_MAX_THREADS
    t4 = math.ceil(M_ / 4)
    assert geo.tiles == t4 * (t4 + 1) // 2
    assert geo.threads - 32 < geo.groups * geo.tiles <= geo.threads
    assert geo.stage_rows % geo.groups == 0
    starts = range(0, geo.chunks * geo.rows, geo.rows)
    covered = [n for c in starts for n in range(c, min(N_, c + geo.rows))]
    assert covered == list(range(N_))
    assert all(c < N_ for c in starts)            # no block without rows
    assert geo.part_floats == geo.chunks * T_ * 16 * geo.tiles


def _never(*_):
    raise AssertionError("queried a form that is not needed")


def test_fused_fits_takes_the_wrappers_limits():
    """The single-tile forms where M <= MAX_M and their blocks fit; else
    the tiled forms' queries decide; past MAX_M the single-tile ones are
    never asked."""
    occ = _h100_occupancy(128, 10)
    assert psi.fused_fits(128, 10, 0, occ, _never, lambda: 1, _never)
    assert psi.fused_fits(128, 10, 60, occ, _never, lambda: 1, _never)
    # K2's single-tile block does not fit (its query gives 0 blocks per SM)
    # and its tiled block does not either, or neither K1 body finds a block
    assert not psi.fused_fits(128, 48, 0, occ, _never, lambda: 0,
                              lambda: 0)
    assert not psi.fused_fits(128, 256, 5, lambda g, rs: 0, lambda rs: 0,
                              lambda: 1, _never)
    assert psi.fused_fits(psi.MAX_M + 1, 10, 0, _never, lambda rs: 1,
                          _never, lambda: 1)
    assert not psi.fused_fits(psi.MAX_M + 1, 10, 0, _never, lambda rs: 1,
                              _never, lambda: 0)


def test_resolve_fused_auto_decides_by_device_and_shape(monkeypatch):
    """"auto": never on the CPU; on the card what `psi.fused_fits_on`
    answers, past MAX_M too (the tiled forms); True and False as given."""
    asked = []

    def fits(device, M, Q, D):
        asked.append((M, Q, D))
        return M <= 256

    monkeypatch.setattr(psi, "fused_fits_on", fits)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for D in (0, 59):
        assert not dispatch.resolve_fused("auto", "ard_rbf", cpu, 64, 10, D)
        assert dispatch.resolve_fused("auto", "ard_rbf", cuda,
                                      psi.MAX_M + 1, 10, D)
        assert not dispatch.resolve_fused("auto", "ard_rbf", cuda, 1024, 10,
                                          D)
        assert dispatch.resolve_fused(True, "ard_rbf", cpu, 64, 10, D)
        assert dispatch.resolve_fused(True, "ard_rbf", cuda, 129, 10, D)
        assert not dispatch.resolve_fused(False, "ard_rbf", cuda, 64, 10, D)
        assert not dispatch.resolve_fused(True, "linear", cuda, 64, 10, D)
    assert asked == [(129, 10, 0), (1024, 10, 0), (129, 10, 59),
                     (1024, 10, 59)]
