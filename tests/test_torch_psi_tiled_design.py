"""What the tiled forms of K1's body and K2 (the M > 128 halves of
`dp_gp_lvm_tpu_torch/csrc/psi_suffstats.cu` and `csrc/psi2_bwd.cu`) rest
on, checked on the CPU in f64, and their launch geometry.

The tiled K1 body cuts Psi2's upper triangle into super-tiles of K1_TILE x
K1_TILE: block (chunk, atom, k) stages two ranges (a, b) and sums its rows'
var^2 w_n E_n over the pairs of an off-diagonal super-tile (a, b), a 4x4
tile a thread, or of the upper triangles of the diagonal super-tiles (a,
a) and (b, b), whose last warp takes the 32 diagonal 4x4 tiles (pairs m
<= l) and the halves of 16 strictly upper ones; K1's Psi1^T Y runs a
block per (chunk, atom, range a), a 4 x 4 tile of (m, d) a thread over
walks of 64 columns of Y. The reduction sums the chunks in chunk order
and reads (l, m) below the diagonal. The tiled K2 gives block (chunk, atom, range a) the 32 rows m of
range a and walks the columns in panels of P: thread (m, slice j, row slot
rs) takes the slice's columns of each panel for the rows rs, rs + RS, ...
of every batch of B. When a panel ends, S is summed over the row slots;
gvar and gz add up over the panels in each thread and over the threads in
(slot, slice) order when the pass ends; every per-row scalar is linear in
the sums over (m, l), so each panel adds its share of gmu, gs and gw to
the range's rows in panel order, and the finish sums the ranges in range
order. Each emulation walks the geometry the wrappers launch and is held
to the plain version's outputs at 1e-12, with row weights that hold zeros.
No JAX here: the plain versions are the port's own oracle.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.ops import psi

T, N, Q, D = 2, 30, 3, 5
TP = psi.K1_TILE
TOL = 1e-12
SMS = 132


def _r4(x):
    return 4 * math.ceil(x / 4)


def _r32(x):
    return 32 * math.ceil(x / 32)


def k1_tiled_occupancy(Q_, D_, registers=128):
    """Blocks per SM of an H100 (64 K registers, 2048 threads, 227 KB of
    shared memory a block) for the tiled K1 pair body of K1_TILED_THREADS
    at `registers` a thread (its launch bounds cap them at 128) and its
    source's shared-memory layout (`tiled_layout`: two ranges of staged
    columns, three stages of row scalars, two of c), by staged rows; none
    where, at D > 0, the Psi1^T Y kernel's block (`p1y_smem_floats`) fits
    no SM."""
    def occupancy(stage_rows):
        rs, tw = stage_rows, 2 * TP
        floats = (Q_ * tw + _r4(Q_) + 3 * rs * _r4(4 * Q_ + 3)
                  + 2 * rs * Q_ * tw)
        p1y = Q_ * TP + 32 * _r4(3 * Q_ + 2) + 32 * TP + 32 * 64
        if 4 * floats > 232448 or (D_ > 0 and 4 * p1y > 232448):
            return 0
        threads = psi.K1_TILED_THREADS
        return min(2048 // threads, 65536 // (registers * threads),
                   233472 // (4 * floats + 1024))
    return occupancy


def k2_tiled_occupancy(Q_, registers=128):
    """Blocks per SM of an H100 for the tiled K2 block (256 threads at
    `registers` a thread; ptxas gave 128 for sm_90a) with panels of
    K2_TILE_PANEL columns, by its source's shared-memory layout
    (`tiled_layout`): one pass of 10 gradient columns at Q <= 10, 16 rows
    between barriers; passes of 8 columns beyond, 4 rows. None of it
    depends on M."""
    def occupancy():
        chunked = Q_ > 10
        P = psi.K2_TILE_PANEL
        qt, b = (8, 4) if chunked else (10, 16)
        qp = qt * math.ceil(Q_ / qt) if chunked else _r4(qt)
        slices, pp = P // 32, P | 1
        slots = 8 // slices
        c = b * ((32 + P) if chunked else P) * qp
        total = (3 * _r4(32 * pp) + 32 * qp + P * qp + qp
                 + _r4(max(c, (slots - 1) * 32 * pp)) + (qt + 1) * 256
                 + 3 * b * _r4(5 * qp + 2) + b * slices * _r32(3 * qt + 2)
                 + _r4(b * qt) + 2 * _r4(b * (2 * Q_ + 1)))
        if 4 * total > 232448:
            return 0
        return min(2048 // 256, 65536 // (registers * 256),
                   233472 // (4 * total + 1024))
    return occupancy


def _inputs(M_, seed=17):
    r = np.random.default_rng(seed)
    w = (r.uniform(size=N) > 0.3) * r.uniform(0.5, 1.5, N)
    w[:2] = 0.0
    arrs = dict(vs=r.uniform(0.5, 1.5, T), ards=r.uniform(0.3, 2.0, (T, Q)),
                mu=r.normal(size=(N, Q)), s=r.uniform(0.05, 0.6, (N, Q)),
                Zs=r.normal(size=(T, M_, Q)), Y=r.normal(size=(N, D)),
                G=r.normal(size=(T, M_, M_)), w=w)
    return {k: torch.as_tensor(v, dtype=torch.float64)
            for k, v in arrs.items()}


def _pairs(a):
    """Per (atom, row, m, l) the kernels' E = exp(min(expo, 0)) with the
    exponent in its c-sum form, and the exponent."""
    al, Zs, mu, s = a["ards"], a["Zs"], a["mu"], a["s"]
    u = 2.0 * al[:, None, :] * s + 1.0                     # (T, N, Q)
    ln = -0.5 * torch.log(u).sum(-1)
    c = (al[:, None, :] / u).sqrt()[:, :, None, :] * (mu[None, :, None, :]
                                                      - Zs[:, None])
    quad = torch.zeros(c.shape[:3] + (c.shape[2],), dtype=c.dtype)
    for q in range(c.shape[-1]):                     # in q order, as staged
        quad += (c[..., :, None, q] + c[..., None, :, q]) ** 2
    df = Zs[:, :, None, :] - Zs[:, None, :, :]
    le = (al[:, None, None, :] * df * df).sum(-1)
    expo = ln[..., None, None] - 0.25 * (le[:, None] + quad)
    return torch.exp(torch.clamp(expo, max=0.0)), expo, u


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread while an emulation runs its thousands of small
    ops: with a test worker's threads on every core beside other workers,
    they wait on each other (the K2 emulation at M = 512 took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


def _upper(s):
    """(a, b) of each upper-triangle tile of an s x s grid, in the
    kernels' order (`upper_tile`)."""
    return [(i, j) for i in range(s) for j in range(i, s)]


def _chunks(rows, chunks, n):
    return [slice(c * rows, min(n, (c + 1) * rows)) for c in range(chunks)]


T4 = TP // 4
EDGE0 = psi.K1_TILED_THREADS - 32     # the last warp of a block
STRICT = [(i, j) for i in range(T4) for j in range(i + 1, T4)]


def _thread_pairs(diagonal, tid):
    """Thread `tid`'s pairs (jm, jl) in a block's staged columns (range a
    below K1_TILE, range b from it), as its source assigns them."""
    if not diagonal:
        m0, l0 = 4 * (tid // T4), TP + 4 * (tid % T4)
        return [(m0 + i, l0 + j) for i in range(4) for j in range(4)]
    k = tid if tid < EDGE0 else EDGE0 + (tid - EDGE0) // 2
    base = k // len(STRICT) * TP
    tm, tl = STRICT[k % len(STRICT)]
    m0, l0 = base + 4 * tm, base + 4 * tl
    if tid < EDGE0:
        return [(m0 + i, l0 + j) for i in range(4) for j in range(4)]
    lane = tid - EDGE0
    h0 = m0 + 2 * (lane % 2)
    d0 = lane // T4 * TP + 4 * (lane % T4)
    return ([(d0 + i, d0 + j) for i in range(4) for j in range(i, 4)]
            + [(h0 + i, l0 + j) for i in range(2) for j in range(4)])


def _k1_owners(S):
    """Per pair some thread of some block writes: (block, thread, super-
    tile, row and column in it, m, l), the kernel's ownership at S ranges;
    a range past the last (b = S) is not written."""
    tile = {ab: k for k, ab in enumerate(_upper(S))}
    out = []
    for k, (ra, rb, diag) in enumerate(psi.k1_tiled_blocks(S)):
        for tid in range(psi.K1_TILED_THREADS):
            for jm, jl in _thread_pairs(diag, tid):
                am, al = (ra, rb)[jm // TP], (ra, rb)[jl // TP]
                if al < S:
                    out.append((k, tid, tile[am, al], jm % TP, jl % TP,
                                am * TP + jm % TP, al * TP + jl % TP))
    return np.array(out)


def _k1_p1y_owners(S, D_):
    """Per Psi1^T Y entry (m, d) of the padded ranges the (block, thread)
    that sums it: block (range a) over walks of 64 columns of Y, thread
    tid a 4 x 4 tile at row 4 (tid % 16) of the range, column 4 (tid // 16)
    of the walk; columns past D are not written."""
    out = []
    for ra in range(S):
        for dw in range(0, D_, 64):
            for tid in range(psi.K1_TILED_THREADS):
                m0, d0 = 4 * (tid % T4), dw + 4 * (tid // T4)
                out += [(ra, tid, ra * TP + m0 + i, d0 + j)
                        for i in range(4) for j in range(4) if d0 + j < D_]
    return np.array(out)


def _k1_emulated(a, geo, M_):
    """The tiled K1 body's partials over `geo`, written by the blocks'
    threads as they own the pairs and the Psi1^T Y slices, and its
    reduction in chunk order."""
    E, _, _ = _pairs(a)
    wE = (a["vs"] ** 2)[:, None, None, None] * a["w"][None, :, None,
                                                        None] * E
    psi1 = ard_rbf.psi1(a["vs"], a["ards"], a["mu"], a["s"], a["Zs"], a["w"])
    S = geo.ranges
    pad = S * TP
    wE_p = torch.zeros(T, N, pad, pad, dtype=E.dtype)
    wE_p[:, :, :M_, :M_] = wE
    psi1_p = torch.zeros(T, N, pad, dtype=E.dtype)
    psi1_p[:, :, :M_] = psi1
    own = torch.as_tensor(_k1_owners(S))
    tile, lm, ll, m, l = own[:, 2], own[:, 3], own[:, 4], own[:, 5], own[:, 6]
    p1y_own = torch.as_tensor(_k1_p1y_owners(S, D))
    pr, pm, pd = p1y_own[:, 0], p1y_own[:, 2], p1y_own[:, 3]
    part2 = torch.full((geo.chunks, T, S * (S + 1) // 2, TP, TP),
                       float("nan"), dtype=E.dtype)
    part1 = torch.full((geo.chunks, T, S, TP, D), float("nan"),
                       dtype=E.dtype)
    for c, rows in enumerate(_chunks(geo.rows, geo.chunks, N)):
        part2[c][:, tile, lm, ll] = wE_p[:, rows].sum(1)[:, m, l]
        p1y = psi1_p[:, rows].mT @ a["Y"][rows]          # (T, pad, D)
        part1[c][:, pr, pm % TP, pd] = p1y[:, pm, pd]
    mm, ml = torch.meshgrid(torch.arange(M_), torch.arange(M_),
                            indexing="ij")
    lo, hi = torch.minimum(mm, ml), torch.maximum(mm, ml)
    ra, rb = lo // TP, hi // TP                 # the reduction's tile
    tiles = ra * S - ra * (ra - 1) // 2 + rb - ra
    psi2 = part2[0][:, tiles, lo % TP, hi % TP]
    for c in range(1, geo.chunks):
        psi2 = psi2 + part2[c][:, tiles, lo % TP, hi % TP]
    p1y = part1[0]
    for c in range(1, geo.chunks):
        p1y = p1y + part1[c]
    return psi2, p1y.reshape(T, S * TP, D)[:, :M_]


@pytest.mark.parametrize("M_", [129, 256])
def test_tiled_k1_partials_reduce_to_psi2_and_psi1ty(M_):
    a = _inputs(M_)
    geo = psi.k1_tiled_geometry(T, N, M_, Q, D, SMS,
                                k1_tiled_occupancy(Q, D))
    assert geo.chunks > 1                     # the chunk sum is walked
    with _one_thread():
        psi2, p1y = _k1_emulated(a, geo, M_)
    assert not torch.isnan(psi2).any()        # every output read a partial
    assert not torch.isnan(p1y).any()
    want = psi.suffstats_batched_reference(a["vs"], a["ards"], a["mu"],
                                           a["s"], a["Zs"], a["Y"], a["w"])
    assert _close(psi2, want[0]) and _close(p1y, want[1])
    assert torch.equal(psi2, psi2.mT)         # mirrored, the same bits


def _k2_emulated(a, geo, M_):
    """The tiled K2's partials over `geo` (ranges, panels, row slots, slice
    threads) and its finish."""
    Zs, mu, s, G, w = a["Zs"], a["mu"], a["s"], a["G"], a["w"]
    TR, P = geo.range_rows, geo.panel_width
    A, slots, B = geo.ranges, geo.row_slots, 16
    slices = P // psi.K2_TILE_COLS
    v2 = (a["vs"] ** 2)[:, None]
    gvar = torch.zeros(geo.chunks, T, M_, dtype=torch.float64)
    gz = torch.zeros(geo.chunks, T, M_, Q, dtype=torch.float64)
    Sp = torch.zeros(geo.chunks, T, M_, M_, dtype=torch.float64)
    gard = torch.zeros(geo.chunks, A, T, Q, dtype=torch.float64)
    rowpart = torch.zeros(A, T, N, 2 * Q + 1, dtype=torch.float64)
    E_all, expo_all, u_all = _pairs(a)                    # every row's
    em_all = E_all * (expo_all < 0.0).to(E_all.dtype)
    for c, rows in enumerate(_chunks(geo.rows, geo.chunks, N)):
        E, em, u = E_all[:, rows], em_all[:, rows], u_all[:, rows]
        b = a["ards"][:, None, :] / u                     # (T, n, Q)
        n = E.shape[1]
        # row slot of each row: its place in its batch of B, modulo slots
        slot = (torch.arange(n) % B) % slots
        f = v2 * w[None, rows]                            # (T, n)
        bn, mn, sn, un = b, mu[rows], s[rows], u
        for ra in range(A):
            ms = slice(ra * TR, min(M_, (ra + 1) * TR))
            zr = Zs[:, ms]                                # (T, r, Q)
            for pan in range(geo.panels):
                ls = slice(pan * P, min(M_, (pan + 1) * P))
                gsum = G[:, ms, ls] + G[:, ls, ms].mT
                WS = f[..., None, None] * em[:, :, ms, ls] * gsum[:, None]
                rsum = WS.sum(-1)                         # (T, n, r)
                wsz = WS @ Zs[:, None, ls]                # (T, n, r, Q)
                pp = (E[:, :, ms, ls] * G[:, None, ms, ls]).sum(-1)
                # the panel's share of each row scalar
                Asum = 0.5 * rsum.sum(-1)[..., None]
                rz = rsum @ zr
                rz2 = rsum @ (zr * zr)
                U = 0.5 * (wsz * zr[:, None]).sum(2)
                gb = -mn * mn * Asum + mn * rz - 0.25 * rz2 - 0.5 * U
                share = torch.cat([bn * (-2.0 * mn * Asum + rz),
                                   gb * (-2.0 * bn * bn) - Asum * bn,
                                   v2[..., None] * pp.sum(-1, keepdim=True)],
                                  dim=-1)
                rowpart[ra, :, rows] = rowpart[ra, :, rows] + share
                gard[c, ra] += (gb / (un * un) - Asum * sn / un).sum(1)
                # each thread (slot, slice) adds its rows' and columns'
                # share of gvar and gz; the slots' S summed in slot order
                S = torch.zeros(T, ms.stop - ms.start, ls.stop - ls.start,
                                dtype=torch.float64)
                # the range's rows and the panel's columns cut first,
                # then each slot's rows taken from the cut
                em_p, E_p = em[:, :, ms, ls], E[:, :, ms, ls]
                for r_ in range(slots):
                    mine = slot == r_
                    S = S + torch.einsum("tn,tnrl->trl", f[:, mine],
                                         em_p[:, mine])
                    for j in range(slices):
                        cs = slice(j * 32, (j + 1) * 32)
                        WSj = WS[:, mine][..., cs]
                        rj = WSj.sum(-1)
                        wj = WSj @ Zs[:, None, ls][:, :, cs]
                        pj = (E_p[:, mine][..., cs]
                              * G[:, None, ms, ls][..., cs]).sum(-1)
                        bj, mj = bn[:, mine], mn[mine]
                        gvar[c, :, ms] += torch.einsum(
                            "n,tnr->tr", w[rows][mine], pj)
                        gz[c, :, ms] += torch.einsum(
                            "tnq,tnrq->trq", bj,
                            rj[..., None] * (mj[None, :, None, :]
                                             - 0.5 * zr[:, None])
                            - 0.5 * wj)
                Sp[c, :, ms, ls] = S

    def in_order(parts):
        acc = parts[0]
        for x in parts[1:]:
            acc = acc + x
        return acc

    rows_sum = in_order([rowpart[ra, t] for t in range(T)
                         for ra in range(A)])
    gard_sum = in_order([gard[c, ra] for c in range(geo.chunks)
                         for ra in range(A)])
    return (in_order(gvar), gard_sum, in_order(gz), G * in_order(Sp),
            rows_sum[:, :Q], rows_sum[:, Q:2 * Q], rows_sum[:, 2 * Q])


@pytest.mark.parametrize("M_", [129, 256, 512])
def test_tiled_k2_range_shares_sum_to_the_pullback(M_):
    """The panels' shares, summed in panel order, and the row slots' and
    slices' partials reduce to the plain pullback, zero weights included."""
    a = _inputs(M_, seed=18)
    geo = psi.k2_tiled_geometry(T, N, M_, Q, SMS, k2_tiled_occupancy(Q))
    assert geo.chunks > 1 and geo.ranges > 1 and geo.panels > 1
    with _one_thread():
        got = _k2_emulated(a, geo, M_)
    want = psi.psi2_bwd_batched_reference(a["vs"], a["ards"], a["mu"],
                                          a["s"], a["Zs"], a["G"], a["w"])
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert _close(g, w_)


GEOMETRY_M = [129, 192, 256, 512]


def _covered_once(geo, n):
    starts = range(0, geo.chunks * geo.rows, geo.rows)
    covered = [r for c in starts for r in range(c, min(n, c + geo.rows))]
    return covered == list(range(n)) and all(c < n for c in starts)


@pytest.mark.parametrize("M_", GEOMETRY_M)
def test_tiled_k1_geometry_writes_every_output_once(M_):
    """Every thread of every pair block owns 16 or 18 pairs; every (m <= l)
    is one thread's, read from the super-tile entry it wrote, and no two
    threads write one entry; every Psi1^T Y entry of every range is one
    thread's; the chunks walk every row once; at the m256 phase's DP
    shape (T = 20, N = 8192, D = 60)."""
    geo = psi.k1_tiled_geometry(20, 8192, M_, 10, 60, SMS,
                                k1_tiled_occupancy(10, 60))
    S = math.ceil(M_ / TP)
    blocks = psi.k1_tiled_blocks(S)
    assert (geo.ranges, geo.super_tiles) == (S, S * (S + 1) // 2)
    assert geo.blocks == len(blocks) == S * (S - 1) // 2 + (S + 1) // 2
    assert geo.threads == psi.K1_TILED_THREADS == T4 * T4
    assert _covered_once(geo, 8192) and geo.slot_fill >= 0.95
    for _, _, diag in blocks[-1:] + blocks[:1]:
        counts = [len(_thread_pairs(diag, tid)) for tid in range(geo.threads)]
        assert set(counts) == ({16, 18} if diag else {16})
    own = _k1_owners(S)
    entries = {tuple(e) for e in own[:, 2:5]}
    assert len(entries) == len(own)               # one writer an entry
    pairs = own[:, 5:7]
    assert (pairs[:, 0] <= pairs[:, 1]).all()
    real = pairs[(pairs < M_).all(1)]
    assert len({tuple(p) for p in real}) == len(real) == M_ * (M_ + 1) // 2
    index = {ab: k for k, ab in enumerate(_upper(S))}
    for m in range(M_):
        for l in range(m, M_):
            assert (index[m // TP, l // TP], m % TP, l % TP) in entries
    cells = sorted(map(tuple, _k1_p1y_owners(S, 60)[:, 2:]))
    assert cells == [(m, d) for m in range(S * TP) for d in range(60)]
    assert geo.part_floats == geo.chunks * 20 * (
        geo.super_tiles * TP * TP + S * TP * 60)


@pytest.mark.parametrize("M_", [256, 512])
def test_tiled_k1_blocks_carry_the_same_pair_work(M_):
    """At M = 256 and 512 every pair block owns the same useful pairs to 5%
    (4096 an off-diagonal super-tile, 4160 a diagonal pair), and every
    Psi1^T Y block a range's K1_TILE x D entries; the geometry's balance
    is that ratio, and its waves count blocks, each a unit of work."""
    geo = psi.k1_tiled_geometry(20, 8192, M_, 10, 60, SMS,
                                k1_tiled_occupancy(10, 60))
    own = _k1_owners(geo.ranges)
    useful = (own[:, 5:7] < M_).all(1)
    pairs = np.bincount(own[useful, 0], minlength=geo.blocks)
    assert pairs.sum() == M_ * (M_ + 1) // 2
    assert geo.balance == pairs.min() / pairs.max() >= 0.95
    assert sorted(set(pairs)) == [TP * TP, TP * (TP + 1)]
    cells = np.bincount(_k1_p1y_owners(geo.ranges, 60)[:, 0])
    assert (cells == TP * 60).all() and len(cells) == geo.ranges
    slots = SMS * geo.blocks_per_sm
    blocks = geo.chunks * 20 * geo.blocks
    assert geo.waves == blocks / slots
    assert geo.slot_fill == blocks / (math.ceil(blocks / slots) * slots)


@pytest.mark.parametrize("M_", GEOMETRY_M)
def test_tiled_k2_geometry_walks_every_pair_once(M_):
    """Thread (lane, slice, slot) of each range's block covers every pair
    (m, l) of the tile once over the panels, each row of a batch is one
    slot's, within the block's threads, and the chunks walk every row
    once; at the m256 phase's DP shape."""
    geo = psi.k2_tiled_geometry(20, 8192, M_, 10, SMS, k2_tiled_occupancy(10))
    TR, P, A = geo.range_rows, geo.panel_width, geo.ranges
    slices, slots = P // psi.K2_TILE_COLS, geo.row_slots
    assert (A, geo.panels) == (math.ceil(M_ / TR), math.ceil(M_ / P))
    assert TR * slices * slots == geo.threads == psi.K2_TILED_THREADS
    assert _covered_once(geo, 8192)
    seen = np.zeros((M_, M_), dtype=int)
    for ra in range(A):
        for pan in range(geo.panels):
            for tid in range(geo.threads):
                lane, warp = tid % 32, tid // 32
                m = ra * TR + lane
                l0 = pan * P + (warp % slices) * 32
                if warp // slices == 0 and m < M_:   # one row slot's pairs
                    seen[m, l0:min(M_, l0 + 32)] += 1
    assert (seen == 1).all()
    B = 16
    walked = sorted(rs + slots * i for rs in range(slots)
                    for i in range(B // slots))
    assert walked == list(range(B))
    assert geo.row_floats == A * 20 * 8192 * 21
    assert geo.part_floats == geo.chunks * (20 * M_ + A * 20 * 10
                                            + 20 * M_ * 10
                                            + 20 * M_ * M_)


def test_k2_tiled_block_takes_the_most_resident_threads():
    """At M = 256, Q = 10 the H100 holds two 256-thread blocks (16 warps)
    with panels of 64 columns, within 128 registers a thread and its 110 KB
    of shared memory; past Q = 10 one block; at Q = 128 none; past 128
    registers a thread one."""
    def block(occ):
        geo = psi.k2_tiled_geometry(20, 8192, 256, 10, SMS, occ)
        return None if geo is None else (geo.panel_width, geo.blocks_per_sm)

    assert block(k2_tiled_occupancy(10)) == (64, 2)
    assert block(k2_tiled_occupancy(64)) == (64, 1)
    assert block(k2_tiled_occupancy(128)) is None
    assert block(k2_tiled_occupancy(10, registers=255)) == (64, 1)


@pytest.mark.parametrize("T_,N_,M_", [(20, 8192, 256), (1, 8192, 256),
                                      (20, 8192, 512), (4, 2048, 129)])
def test_tiled_k2_grid_fills_its_last_wave(T_, N_, M_):
    """The chunks give whole waves of the card's block slots: at least 95%
    of the last wave's slots are filled (a grid of at most four waves
    filled 91% at T = 20, M = 256 with one block an SM)."""
    geo = psi.k2_tiled_geometry(T_, N_, M_, 10, SMS, k2_tiled_occupancy(10))
    blocks = geo.chunks * T_ * geo.ranges
    slots = SMS * geo.blocks_per_sm
    assert geo.waves == blocks / slots
    assert geo.slot_fill == blocks / (math.ceil(blocks / slots) * slots)
    assert geo.slot_fill >= 0.95 and _covered_once(geo, N_)


def _never(*_):
    raise AssertionError("queried a form that is not needed")


def test_fused_fits_takes_a_form_of_each_kernel():
    """The single-tile forms where they fit; the tiled forms past M = 128
    or a Q the single-tile block refuses; neither past the tiled ones."""
    single = lambda g, rs: 1          # noqa: E731
    assert psi.fused_fits(128, 10, 60, single, _never, lambda: 1, _never)
    # K2's single-tile block refuses Q = 48 at M = 128 (0 blocks per SM):
    # its tiled form takes it
    assert psi.fused_fits(128, 48, 0, single, _never, lambda: 0,
                          k2_tiled_occupancy(48))
    # neither of K1's forms takes Q = 256
    assert not psi.fused_fits(128, 256, 5, lambda g, rs: 0,
                              k1_tiled_occupancy(256, 5), lambda: 1, _never)
    for M_, Q_, fits in ((256, 10, True), (256, 64, True), (512, 16, True),
                         (512, 64, True), (512, 128, False)):
        for D_ in (0, 60):
            assert psi.fused_fits(M_, Q_, D_, _never,
                                  k1_tiled_occupancy(Q_, D_), _never,
                                  k2_tiled_occupancy(Q_)) is fits
    # past MAX_M_TILED without a query
    assert not psi.fused_fits(psi.MAX_M_TILED + 1, 10, 0, _never, _never,
                              _never, _never)


def test_plans_choose_the_form_and_raise_past_both():
    assert isinstance(psi.k1_plan(20, 8192, 128, 10, 60, SMS,
                                  lambda g, rs: 1, _never), psi.K1Geometry)
    assert isinstance(psi.k1_plan(20, 8192, 256, 10, 60, SMS, _never,
                                  k1_tiled_occupancy(10, 60)),
                      psi.K1TiledGeometry)
    assert isinstance(psi.k2_plan(20, 8192, 128, 10, SMS, lambda: 1,
                                  _never), psi.K2Geometry)
    assert isinstance(psi.k2_plan(20, 8192, 256, 10, SMS, _never,
                                  k2_tiled_occupancy(10)),
                      psi.K2TiledGeometry)
    with pytest.raises(RuntimeError, match="no block fits an SM at M=128, "
                                           "Q=256"):
        psi.k1_plan(1, 4, 128, 256, 5, SMS, lambda g, rs: 0,
                    k1_tiled_occupancy(256, 5))
    with pytest.raises(RuntimeError, match="no block fits an SM at M=512, "
                                           "Q=128"):
        psi.k2_plan(1, 4, 512, 128, SMS, _never, k2_tiled_occupancy(128))
    with pytest.raises(RuntimeError, match="past the tiled form's M <= 512 "
                                           "at M=513, Q=10, D=60"):
        psi.k1_plan(1, 4, 513, 10, 60, SMS, _never, _never)
    with pytest.raises(RuntimeError, match="past the tiled form's M <= 512 "
                                           "at M=513, Q=10"):
        psi.k2_plan(1, 4, 513, 10, SMS, _never, _never)
