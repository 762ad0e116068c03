r"""Fused psi-statistics kernels (counterpart of
`dp_gp_lvm_tpu/ops/pallas/psi.py`), hand-written in CUDA:

- K1 `suffstats_batched` (csrc/psi_suffstats.cu): per-atom Psi2 (T, M, M)
  and Psi1^T Y (T, M, D) in one pass over the rows; Psi1 never reaches
  device memory; its launch geometry is `k1_geometry`. Replaces
  `_suffstats_batched_kernel`.
- K2 `psi2_bwd_batched` (csrc/psi2_bwd.cu): the analytic Psi2 pullback,
  atoms on the grid, per-chunk partials summed by a second kernel; its
  launch geometry is `k2_geometry`. Replaces `_psi2_bwd_batched_kernel`.
- K4 `psi2_batched` and K5 `psi2_single`: the Psi2 stack (T, M, M) and
  one kernel's Psi2 (M, M) (the stack at T = 1), K1's body with Psi1^T Y
  compiled out (csrc/psi_suffstats.cu, entry `psi2_batched_f32`),
  launched at `k1_geometry` for D = 0. Replace `_psi2_batched_kernel` and
  `_psi2_kernel`.
- K6 `psi1` (csrc/psi1.cu): Psi1 (N, M), columns tiled over the grid so
  that any M runs; its launch geometry is `k6_geometry`. Replaces
  `_psi1_kernel`.

K1's body and K2 each have two forms. The single-tile form holds an M x M
tile in one block (M <= MAX_M) and runs wherever its block fits an SM.
Elsewhere (M > MAX_M, or a Q too wide for that block) the tiled form puts
tiles of M on the grid, up to M = MAX_M_TILED: `k1_tiled_geometry`
(super-tiles of K1_TILE x K1_TILE of Psi2's upper triangle, the same pair
work a block, K1's Psi1^T Y in a kernel of its own; entries
`*_tiled_f32`) and `k2_tiled_geometry` (ranges of rows of the tile, the
columns walked in panels).
`_k1_form` and `_k2_form` choose the form, `k1_plan` and `k2_plan` the
geometry.

Beside each is its plain PyTorch version (`*_reference`), blocked over N.
A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel (float32 only; a shape one of its forms
takes, see `fused_fits`) or raises. Each launch adds one to
`LAUNCHES[<name>]` (on the host) and, once `count_on_card` is on, to a
counter on the card on the launch's stream, which a captured CUDA graph
replays with the kernel. `fused_fits` says, before any launch, whether
every kernel of a fused path takes a shape.

The differentiable ops pair them as in the reference:
`SuffstatsBatchedFused` (K1, K2 + plain Psi1 pullback),
`Psi2BatchedFused` (K4, K2), `Psi2Fused` (K5, K2 at T = 1) and
`Psi1Fused` (K6, plain pullback). The n-independent E0 finish of K2 is
plain torch, as it is pure JAX outside any kernel in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.kernels.ard_rbf_vjp import (
    _e0_pulls,
    _psi1_bwd,
)

LAUNCHES = {"suffstats_batched": 0, "psi2_bwd_batched": 0,
            "psi2_batched": 0, "psi2_single": 0, "psi1": 0}
MAX_M = 128          # the single-tile forms of K1's body and K2 (M x M tile)
MAX_M_TILED = 512    # the tiled forms: as far as the card has held them
K1_TILE = 64         # super-tile width of K1's tiled body (TP in its source)
K1_TILED_THREADS = 256   # threads of a tiled K1 block: (K1_TILE / 4)^2
K1_TILED_MAX_WAVES = 16  # most waves `k1_tiled_geometry` looks through
K2_TILE_ROWS = 32        # rows of a tiled K2 range, a lane each (TR)
K2_TILE_COLS = 32        # columns of a tiled K2 thread's slice (TLC)
K2_TILE_PANEL = 64       # columns of a tiled K2 panel (TILED_PANEL)
K2_TILED_THREADS = 256   # threads of a tiled K2 block: 8 warps
K2_TILED_MAX_WAVES = 16  # most waves `k2_tiled_geometry` looks through
K2_MIN_ROWS = 4      # fewest rows a K2 block walks
_K2_ONE_PASS_Q = 10  # largest Q of K2's one-pass instantiations (QF)
K1_MAX_THREADS = 576  # K1's launch bounds (MAX_THREADS in its source)
K1_MAX_GROUPS = 8     # most row groups of a K1 block
_K1_GROUP_ROWS = (16, 8, 4, 2, 1)  # rows per group and stage, largest first
K6_WARPS = 8          # warps of a K6 block (WARPS in its source)
K6_COLS = 128         # columns of a K6 column tile, four per lane
K6_MAX_STEP_ROWS = 8  # most rows a K6 warp prepares at once (its source's)


# the launches counted on the card too (`count_on_card`): a 0-d int64
# counter a wrapper, none while counting is off
CARD_COUNTS: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counter in CARD_COUNTS.values():
        counter.zero_()


def count_on_card(device=None) -> None:
    """Count each launch on `device` as well as on the host (None: stop).
    A replayed CUDA graph runs no Python, so `train.loop.StepGraph` adds
    the capture's host counts once per replay; a counter on the card is
    bumped on the launch's stream by the graph itself, so `card_counts`
    reads what the replays really launched, to hold the host counts
    against. The counters are made here, never inside a capture."""
    CARD_COUNTS.clear()
    if device is not None:
        for k in LAUNCHES:
            CARD_COUNTS[k] = torch.zeros((), dtype=torch.int64,
                                         device=device)


def card_counts() -> dict:
    """The launches counted on the card since `count_on_card` or the last
    reset, keyed as LAUNCHES (one host read)."""
    if not CARD_COUNTS:
        return {}
    values = torch.stack(list(CARD_COUNTS.values())).tolist()
    return dict(zip(CARD_COUNTS, values))


def _launched(name: str) -> None:
    LAUNCHES[name] += 1
    counter = CARD_COUNTS.get(name)
    if counter is not None:
        counter.add_(1)                 # on the launch's (current) stream


def _ones_weights(mu, weights):
    if weights is None:
        return torch.ones(mu.shape[0], dtype=mu.dtype, device=mu.device)
    return weights


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the on-card oracle)
# ---------------------------------------------------------------------------


def suffstats_batched_reference(variances, ards, mu, s, Zs, Y, weights=None,
                                block_n: int = 64):
    """Plain K1: (Psi2 (T,M,M), Psi1^T Y (T,M,D)), blocked over N."""
    T, M, _ = Zs.shape
    N, D = Y.shape
    w = _ones_weights(mu, weights)
    log_e = ard_rbf._log_e(ards, Zs)
    psi2 = torch.zeros(T, M, M, dtype=mu.dtype, device=mu.device)
    p1y = torch.zeros(T, M, D, dtype=mu.dtype, device=mu.device)
    v2 = (variances * variances)[:, None, None]
    for i in range(0, N, block_n):
        sl = slice(i, i + block_n)
        mu_b, s_b, w_b = mu[sl], s[sl], w[sl]
        _, _, expo = ard_rbf._forward_pieces(variances, ards, mu_b, s_b,
                                             Zs, log_e)
        contrib = torch.sum(
            torch.exp(torch.clamp(expo, max=0.0)) * w_b[None, :, None, None],
            dim=1,
        )
        psi2 = psi2 + v2 * contrib
        psi1 = ard_rbf.psi1(variances, ards, mu_b, s_b, Zs, w_b)
        p1y = p1y + psi1.mT @ Y[sl]
    return psi2, p1y


def psi2_batched_reference(variances, ards, mu, s, Zs, weights=None,
                           block_n: int = 64):
    """Plain K4: the per-atom Psi2 stack (T, M, M), blocked over N."""
    T, M, _ = Zs.shape
    w = _ones_weights(mu, weights)
    log_e = ard_rbf._log_e(ards, Zs)
    psi2 = torch.zeros(T, M, M, dtype=mu.dtype, device=mu.device)
    v2 = (variances * variances)[:, None, None]
    for i in range(0, mu.shape[0], block_n):
        sl = slice(i, i + block_n)
        _, _, expo = ard_rbf._forward_pieces(variances, ards, mu[sl], s[sl],
                                             Zs, log_e)
        psi2 = psi2 + v2 * torch.sum(
            torch.exp(torch.clamp(expo, max=0.0)) * w[sl][None, :, None, None],
            dim=1,
        )
    return psi2


def psi2_single_reference(variance, ard, mu, s, Z, weights=None,
                          block_n: int = 64):
    """Plain K5: one kernel's Psi2 (M, M), blocked over N."""
    return ard_rbf.psi2(variance, ard, mu, s, Z, weights, block_n)


def psi1_reference(variance, ard, mu, s, Z, weights=None,
                   block_n: int = 128):
    """Plain K6: Psi1 (N, M), blocked over N."""
    return torch.cat([
        ard_rbf.psi1(variance, ard, mu[i:i + block_n], s[i:i + block_n], Z,
                     None if weights is None else weights[i:i + block_n])
        for i in range(0, mu.shape[0], block_n)
    ])


def psi2_bwd_batched_reference(variances, ards, mu, s, Zs, G, weights=None,
                               block_n: int = 64):
    """Plain K2: the raw kernel outputs
    (gvar_m (T,M), gard (T,Q), gz (T,M,Q), V (T,M,M), gmu, gs (N,Q), gw (N,)),
    gard and gz without the E0 pull (`finish_psi2_bwd` adds it)."""
    T, M, Q = Zs.shape
    N = mu.shape[0]
    w = _ones_weights(mu, weights)
    log_e = ard_rbf._log_e(ards, Zs)
    kw = dict(dtype=mu.dtype, device=mu.device)
    gvar_m = torch.zeros(T, M, **kw)
    gard = torch.zeros(T, Q, **kw)
    gz = torch.zeros(T, M, Q, **kw)
    V = torch.zeros(T, M, M, **kw)
    gmu, gs, gw = [], [], []
    v2 = (variances * variances)[:, None, None, None]
    for i in range(0, N, block_n):
        sl = slice(i, i + block_n)
        mu_b, s_b, w_b = mu[sl], s[sl], w[sl]
        u, b, expo = ard_rbf._forward_pieces(variances, ards, mu_b, s_b, Zs,
                                             log_e)
        e_raw = torch.exp(torch.clamp(expo, max=0.0))
        e = e_raw * w_b[None, :, None, None]
        Gb = G[:, None]
        gvar_m = gvar_m + torch.sum(e * Gb, dim=(1, 3))
        gw.append(torch.sum(v2 * e_raw * Gb, dim=(0, 2, 3)))
        W = v2 * e * (expo < 0.0).to(mu.dtype) * Gb          # (T,B,M,M)
        WS = W + W.transpose(-1, -2)
        A = torch.sum(W, dim=(-2, -1))                          # (T,B)
        rsum = torch.sum(WS, dim=-1)                            # (T,B,M)
        wsz = torch.einsum("tbml,tlq->tbmq", WS, Zs)
        U = 0.5 * torch.einsum("tbmq,tmq->tbq", wsz, Zs)
        rz = rsum @ Zs
        rz2 = rsum @ (Zs * Zs)
        V = V + torch.sum(W, dim=1)
        gb = (-mu_b * mu_b * A[..., None] + mu_b * rz - 0.25 * rz2
              - 0.5 * U)
        gmu.append(torch.sum(b * (-2.0 * mu_b * A[..., None] + rz), dim=0))
        gs.append(torch.sum(gb * (-2.0 * b * b) - A[..., None] * b, dim=0))
        gard = gard + torch.sum(gb / (u * u), dim=1) - torch.sum(
            A[..., None] * s_b / u, dim=1
        )
        bz_t = torch.einsum("tbm,tbq->tmq", rsum, b * mu_b)
        bz_p = torch.einsum("tbm,tbq->tmq", rsum, b)
        bz_c = torch.einsum("tbmq,tbq->tmq", wsz, b)
        gz = gz + bz_t - 0.5 * Zs * bz_p - 0.5 * bz_c
    return (gvar_m, gard, gz, V, torch.cat(gmu), torch.cat(gs),
            torch.cat(gw))


def finish_psi2_bwd(variances, ards, Zs, raw):
    """K2's raw outputs -> (gvar, gard, gmu, gs, gz, gw), adding the
    n-independent E0 pulls from V (plain torch, as in the reference)."""
    gvar_m, gard, gz, V, gmu, gs, gw = raw
    gard, gz = _e0_pulls(ards, Zs, V, gard, gz)
    return 2.0 * variances * torch.sum(gvar_m, dim=1), gard, gmu, gs, gz, gw


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card
# ---------------------------------------------------------------------------


def _check_cuda(name, tensors, shapes):
    for key, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {x.device}, expected cuda")
        if x.dtype != torch.float32:
            raise TypeError(
                f"{name}: {key} is {x.dtype}, the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if tuple(x.shape) != shapes[key]:
            raise ValueError(
                f"{name}: {key} has shape {tuple(x.shape)}, "
                f"expected {shapes[key]}"
            )
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")


def _is_cpu(*xs):
    return all(x.device.type == "cpu" for x in xs if x is not None)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


class K1Geometry(NamedTuple):
    """How `suffstats_batched` launches csrc/psi_suffstats.cu: `groups` of
    `tiles` threads each (one 4x4 upper-triangle tile of Psi2 a thread) in
    blocks of `threads`, `stage_rows` rows staged at once, `blocks_per_sm`
    resident; `chunks` x T blocks of `rows` rows each, filling
    `slot_fill` of the block slots of their waves; `p1y_passes` walks of
    the rows for the Psi1^T Y tiles (none at D = 0, the Psi2-only body of
    K4 and K5); the floats of the per-(chunk, atom) partials, 16 per
    upper-triangle tile and M x D of Psi1^T Y."""
    groups: int
    tiles: int
    threads: int
    stage_rows: int
    blocks_per_sm: int
    rows: int
    chunks: int
    slot_fill: float
    p1y_passes: int
    part_floats: int

    @property
    def lane_use(self) -> float:
        """Share of the block's threads that own a Psi2 tile."""
        return self.groups * self.tiles / self.threads


def _round32(x):
    return 32 * math.ceil(x / 32)


def _chunking(T, N, min_rows, slots, target, max_waves=4):
    """(rows, chunks, fill): the fewest waves (up to `max_waves`) of
    `slots` block slots whose T x chunks blocks fill at least `target` of
    them (else the best fill), each chunk walking at least `min_rows` rows
    (or all N)."""
    cap = max(1, math.ceil(N / min_rows))
    best = None
    for waves in range(1, max_waves + 1):
        chunks = max(1, min(cap, waves * slots // T))
        rows = math.ceil(N / chunks)
        chunks = math.ceil(N / rows)
        fill = chunks * T / (math.ceil(chunks * T / slots) * slots)
        if best is None or fill > best[2]:
            best = (rows, chunks, fill)
        if fill >= target or chunks == cap:
            break
    return best


def _k1_block(M, Q, D, occupancy):
    """(groups, tiles, threads, stage_rows, blocks per SM, Psi1^T Y passes)
    of the block `k1_geometry` takes, None where no block fits an SM."""
    t4 = math.ceil(M / 4)
    tiles = t4 * (t4 + 1) // 2
    best = None
    for groups in range(1, K1_MAX_GROUPS + 1):
        threads = _round32(groups * tiles)
        if threads > K1_MAX_THREADS:
            break
        per_sm = occupancy(groups, groups)
        if per_sm < 1:
            continue
        per_group = next(k for k in _K1_GROUP_ROWS
                         if occupancy(groups, groups * k) == per_sm)
        passes = math.ceil(t4 * math.ceil(D / 4) / threads)
        key = (passes, -per_sm * groups * tiles, -groups)
        if best is None or key < best[0]:
            best = (key, groups, tiles, threads, groups * per_group, per_sm,
                    passes)
    return None if best is None else best[1:]


def k1_geometry(T, N, M, Q, D, sms, occupancy) -> K1Geometry:
    """K1's launch geometry on `sms` SMs, and at D = 0 that of K4 and K5.
    `occupancy(groups, stage_rows)` is how many blocks of that shape fit
    on an SM (0 if none). Of the group counts whose block fits within
    K1_MAX_THREADS, it takes the one with the fewest walks of the rows for
    Psi1^T Y, then the most tile-owning threads resident per SM, then the
    most groups: the groups of a block share each stage's staging, and
    fewer blocks write fewer partials (on an H100 at c4, 4 groups in one
    block per SM beat 2 in two). Each stages the most rows per group (of
    16, 8, 4, 2, 1) that keep as many of its blocks on an SM as one row
    per group does. Then `_chunking` at one block per chunk and atom."""
    block = _k1_block(M, Q, D, occupancy)
    if block is None:
        raise RuntimeError(f"psi_suffstats: no block fits an SM at "
                           f"M={M}, Q={Q}, D={D}")
    groups, tiles, threads, stage_rows, per_sm, passes = block
    rows, chunks, fill = _chunking(T, N, stage_rows, sms * per_sm, 0.9)
    part = chunks * T * (16 * tiles + 4 * math.ceil(M * D / 4))
    return K1Geometry(groups, tiles, threads, stage_rows, per_sm, rows,
                      chunks, fill, passes, part)


@functools.lru_cache(maxsize=None)
def _k1_blocks_per_sm(device_index, M, Q, D, groups, stage_rows):
    from dp_gp_lvm_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        blocks = build.function("psi_suffstats", "psi_suffstats_blocks_per_sm")(
            M, Q, D, groups, stage_rows)
    if blocks < 0:
        raise RuntimeError(f"psi_suffstats: occupancy query failed at "
                           f"M={M}, Q={Q}, D={D} (CUDA error {-blocks})")
    return blocks


def _device_index(device):
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


class K1TiledGeometry(NamedTuple):
    """How `suffstats_batched` (at D = 0 `psi2_batched`, `psi2_single`)
    launches the tiled form of csrc/psi_suffstats.cu: Psi2's upper
    triangle in `super_tiles` = S (S + 1) / 2 super-tiles of K1_TILE x
    K1_TILE (S = `ranges` = ceil(M / K1_TILE) a side), `blocks` blocks of
    `threads` per chunk and atom (`k1_tiled_blocks`: an off-diagonal
    super-tile, or two diagonal ones), every block the same pair work to
    `balance` (its fewest useful pairs over its most); `stage_rows` rows
    staged at once, `blocks_per_sm` resident; `chunks` chunks of `rows`
    rows in `waves` waves of the card's block slots, `slot_fill` of them
    filled (every block computes the same pairs to 1.6%); K1's Psi1^T Y
    in a kernel of its own, a block per (chunk, atom, range); the floats
    of the partials (a K1_TILE^2 block per (chunk, atom, super-tile),
    K1_TILE x D of Psi1^T Y per (chunk, atom, range))."""
    ranges: int
    super_tiles: int
    blocks: int
    threads: int
    stage_rows: int
    blocks_per_sm: int
    rows: int
    chunks: int
    waves: float
    slot_fill: float
    balance: float
    part_floats: int


def k1_tiled_blocks(S):
    """(a, b, diagonal) of each block of a chunk and atom in the tiled K1
    body, in its grid order (`tiled_block` in its source): the
    off-diagonal super-tiles (a, b), a < b, row by row, then the diagonal
    ones in pairs (a, a + 1); with S odd the last pairs with none (b = S,
    past M)."""
    off = [(a, b, False) for a in range(S) for b in range(a + 1, S)]
    return off + [(a, a + 1, True) for a in range(0, S, 2)]


def k1_tiled_pairs(M, a, b, diagonal):
    """The useful pairs (m <= l < M) of Psi2 a tiled K1 block owns."""
    def width(r):
        return max(0, min(K1_TILE, M - r * K1_TILE))
    if not diagonal:
        return width(a) * width(b)
    return sum(n * (n + 1) // 2 for n in (width(a), width(b)))


def _k1_tiled_block(M, occupancy):
    """(stage rows, blocks per SM) of the tiled K1 block, None where none
    fits an SM. `occupancy(stage_rows)` is how many blocks fit on an SM; it
    stages the most rows (of 16, 8, 4, 2, 1) that keep as many blocks on
    an SM as one row does."""
    per_sm = occupancy(1)
    if per_sm < 1:
        return None
    return next(k for k in _K1_GROUP_ROWS if occupancy(k) == per_sm), per_sm


def k1_tiled_geometry(T, N, M, Q, D, sms, occupancy):
    """The tiled form's launch geometry on `sms` SMs (`_k1_tiled_block`),
    None where its block fits no SM. The chunks fill whole waves by work:
    every block computes all pairs of its tiles, columns past M included,
    K1_TILE^2 (an off-diagonal super-tile) or K1_TILE (K1_TILE + 1) (a
    diagonal pair), the same to 1.6%, so a block is a unit of work and
    `_chunking` takes the fewest waves (up to K1_TILED_MAX_WAVES) whose
    T x chunks x `blocks` fill at least 98% of their slots (on an H100 at
    M = 256, T = 20: 13 chunks in 7.9 waves, 1% faster than 8 in 4.8)."""
    block = _k1_tiled_block(M, occupancy)
    if block is None:
        return None
    stage_rows, per_sm = block
    ranges = math.ceil(M / K1_TILE)
    tiles = ranges * (ranges + 1) // 2
    blocks = k1_tiled_blocks(ranges)
    pairs = [k1_tiled_pairs(M, *b) for b in blocks]
    slots = sms * per_sm
    rows, chunks, fill = _chunking(T * len(blocks), N, stage_rows, slots,
                                   0.98, K1_TILED_MAX_WAVES)
    part = chunks * T * (tiles * K1_TILE * K1_TILE + ranges * K1_TILE * D)
    return K1TiledGeometry(ranges, tiles, len(blocks), K1_TILED_THREADS,
                           stage_rows, per_sm, rows, chunks,
                           chunks * T * len(blocks) / slots, fill,
                           min(pairs) / max(pairs), part)


def _refuse(name, M, Q, rest=""):
    why = (f"past the tiled form's M <= {MAX_M_TILED}" if M > MAX_M_TILED
           else "no block fits an SM")
    raise RuntimeError(f"{name}: {why} at M={M}, Q={Q}{rest}")


def _k1_form(M, Q, D, occupancy, tiled_occupancy):
    """The form K1's body takes (M, Q, D) in: "single" where M <= MAX_M
    and `_k1_block` fits an SM (`occupancy(groups, stage_rows)`), else
    "tiled" where M <= MAX_M_TILED and `_k1_tiled_block` does
    (`tiled_occupancy(stage_rows)`); None where neither. The queries run
    only as far as the answer needs them."""
    if M <= MAX_M and _k1_block(M, Q, D, occupancy) is not None:
        return "single"
    if M <= MAX_M_TILED and _k1_tiled_block(M, tiled_occupancy) is not None:
        return "tiled"
    return None


def k1_plan(T, N, M, Q, D, sms, occupancy, tiled_occupancy):
    """The geometry K1's body launches with in its form (`_k1_form`):
    `k1_geometry` or `k1_tiled_geometry`; raises where it has none."""
    form = _k1_form(M, Q, D, occupancy, tiled_occupancy)
    if form is None:
        _refuse("psi_suffstats", M, Q, f", D={D}")
    if form == "single":
        return k1_geometry(T, N, M, Q, D, sms, occupancy)
    return k1_tiled_geometry(T, N, M, Q, D, sms, tiled_occupancy)


@functools.lru_cache(maxsize=None)
def _k1_tiled_blocks_per_sm(device_index, Q, D, stage_rows):
    from dp_gp_lvm_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        blocks = build.function(
            "psi_suffstats", "psi_suffstats_tiled_blocks_per_sm")(
                Q, D, stage_rows)
    if blocks < 0:
        raise RuntimeError(f"psi_suffstats: tiled occupancy query failed at "
                           f"Q={Q}, D={D} (CUDA error {-blocks})")
    return blocks


def _k1_occupancies(index, M, Q, D):
    """(single-tile, tiled) occupancy queries of K1's body on the card."""
    return (lambda g, rs: _k1_blocks_per_sm(index, M, Q, D, g, rs),
            lambda rs: _k1_tiled_blocks_per_sm(index, Q, D, rs))


def k1_launch_geometry(device, T, N, M, Q, D):
    """The geometry `suffstats_batched` (or at D = 0 `psi2_batched` and
    `psi2_single`) launches with on CUDA `device` (`k1_plan`), from its SM
    count and the kernel's occupancy there."""
    index = _device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return k1_plan(T, N, M, Q, D, sms, *_k1_occupancies(index, M, Q, D))


def suffstats_batched(variances, ards, mu, s, Zs, Y, weights=None,
                      block_n: int = 64):
    """K1: (Psi2 (T,M,M), Psi1^T Y (T,M,D)). `block_n` sizes the plain
    version's blocks; the kernel picks its own chunking (`k1_geometry`)."""
    if _is_cpu(variances, ards, mu, s, Zs, Y, weights):
        return suffstats_batched_reference(variances, ards, mu, s, Zs, Y,
                                           weights, block_n)
    from dp_gp_lvm_tpu_torch.ops import build

    T, M, Q = Zs.shape
    N, D = Y.shape
    tensors = dict(variances=variances, ards=ards, mu=mu, s=s, Zs=Zs, Y=Y)
    shapes = dict(variances=(T,), ards=(T, Q), mu=(N, Q), s=(N, Q),
                  Zs=(T, M, Q), Y=(N, D))
    if weights is not None:
        tensors["w"], shapes["w"] = weights, (N,)
    _check_cuda("suffstats_batched", tensors, shapes)
    geo = k1_launch_geometry(mu.device, T, N, M, Q, D)
    kw = dict(dtype=mu.dtype, device=mu.device)
    part = torch.empty(geo.part_floats, **kw)
    psi2 = torch.empty(T, M, M, **kw)
    p1y = torch.empty(T, M, D, **kw)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    ptrs = (variances.data_ptr(), ards.data_ptr(), mu.data_ptr(),
            s.data_ptr(), None if weights is None else weights.data_ptr(),
            Zs.data_ptr(), Y.data_ptr(), part.data_ptr(), psi2.data_ptr(),
            p1y.data_ptr(), T, N, M, Q, D)
    if isinstance(geo, K1TiledGeometry):
        err = build.function("psi_suffstats", "psi_suffstats_tiled_f32")(
            *ptrs, geo.stage_rows, geo.rows, geo.chunks, stream)
    else:
        err = build.function("psi_suffstats")(
            *ptrs, geo.groups, geo.stage_rows, geo.rows, geo.chunks, stream)
    _raise_on(err, "suffstats_batched")
    _launched("suffstats_batched")
    return psi2, p1y


class K2Geometry(NamedTuple):
    """How `psi2_bwd_batched` launches csrc/psi2_bwd.cu: `threads` per
    block, each owning one row of the M x M tile and `slice_width` of its
    columns, `blocks_per_sm` resident; `chunks` x T blocks of `rows` rows
    each; the float counts of the per-(chunk, atom) and per-(atom, row)
    partials."""
    slice_width: int
    threads: int
    blocks_per_sm: int
    rows: int
    chunks: int
    part_floats: int
    row_floats: int

    @property
    def scratch_bytes(self) -> int:
        return 4 * (self.part_floats + self.row_floats)


def k2_slice_width(M, Q) -> int:
    """Tile columns a K2 thread owns: 16 keeps a block at M <= 64 within 256
    threads, 32 one at M <= 128 within 512 (the generic instantiation for
    Q > 10 serves only 32). On an H100 16 beat 32 at M=64 (PERF.md)."""
    return 32 if M > 64 or Q > _K2_ONE_PASS_Q else 16


def k2_geometry(T, N, M, Q, sms, blocks_per_sm) -> K2Geometry:
    """K2's launch geometry for `sms` SMs that hold `blocks_per_sm` of its
    blocks each: the fewest waves (up to 4) whose blocks fill at least 95%
    of their slots, each block walking at least `K2_MIN_ROWS` rows."""
    width = k2_slice_width(M, Q)
    threads = _round32(M * math.ceil(M / width))
    rows, chunks, _ = _chunking(T, N, K2_MIN_ROWS,
                                max(1, sms * blocks_per_sm), 0.95)
    return K2Geometry(width, threads, blocks_per_sm, rows, chunks,
                      chunks * T * (M + Q + M * Q + M * M),
                      T * N * (2 * Q + 1))


@functools.lru_cache(maxsize=None)
def _k2_blocks_per_sm(device_index, M, Q, width):
    """K2's blocks per SM, 0 where its block's shared memory exceeds the
    card's."""
    from dp_gp_lvm_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        blocks = build.function("psi2_bwd", "psi2_bwd_blocks_per_sm")(
            M, Q, width)
    if blocks < 0:
        raise RuntimeError(f"psi2_bwd_batched: occupancy query failed at "
                           f"M={M}, Q={Q} (CUDA error {-blocks})")
    return blocks


class K2TiledGeometry(NamedTuple):
    """How `psi2_bwd_batched` launches the tiled form of csrc/psi2_bwd.cu:
    the tile's rows in `ranges` ranges of `range_rows` (K2_TILE_ROWS, a
    lane each), one block of `threads` per (chunk, atom, range) walking the
    columns in `panels` panels of `panel_width`; `blocks_per_sm` resident;
    `chunks` chunks of `rows` rows, `waves` waves of the card's block slots
    whose last is `slot_fill` full on average; the float counts of the
    per-chunk partials ([gvar_m | gard per range | gz | S]) and the
    per-(range, atom, row) ones."""
    range_rows: int
    ranges: int
    panel_width: int
    panels: int
    threads: int
    blocks_per_sm: int
    rows: int
    chunks: int
    waves: float
    slot_fill: float
    part_floats: int
    row_floats: int

    @property
    def scratch_bytes(self) -> int:
        return 4 * (self.part_floats + self.row_floats)

    @property
    def row_slots(self) -> int:
        """Threads of a block that share each pair of the panel, each
        walking its own rows of every batch."""
        return self.threads // (self.range_rows
                                * (self.panel_width // K2_TILE_COLS))


def k2_tiled_geometry(T, N, M, Q, sms, blocks_per_sm):
    """The tiled form's launch geometry on `sms` SMs that hold
    `blocks_per_sm()` of its blocks (its shared memory depends on Q, not
    on M), None where none fits. The chunks fill whole waves: the fewest
    waves, up to K2_TILED_MAX_WAVES, whose T x ranges x chunks blocks fill
    at least 95% of their slots (`_chunking`)."""
    per_sm = blocks_per_sm()
    if per_sm < 1:
        return None
    P = K2_TILE_PANEL
    ranges = math.ceil(M / K2_TILE_ROWS)
    slots = sms * per_sm
    rows, chunks, fill = _chunking(T * ranges, N, K2_MIN_ROWS, slots, 0.95,
                                   K2_TILED_MAX_WAVES)
    part = chunks * (T * M + ranges * T * Q + T * M * Q + T * M * M)
    return K2TiledGeometry(K2_TILE_ROWS, ranges, P, math.ceil(M / P),
                           K2_TILED_THREADS, per_sm, rows, chunks,
                           chunks * T * ranges / slots, fill, part,
                           ranges * T * N * (2 * Q + 1))


def _k2_form(M, blocks_per_sm, tiled_blocks_per_sm):
    """The form K2 takes M (and the Q its queries ask about) in: "single"
    where M <= MAX_M and its block fits an SM (`blocks_per_sm()` >= 1),
    else "tiled" where M <= MAX_M_TILED and its tiled block fits
    (`tiled_blocks_per_sm()` >= 1); None where neither."""
    if M <= MAX_M and blocks_per_sm() >= 1:
        return "single"
    if M <= MAX_M_TILED and tiled_blocks_per_sm() >= 1:
        return "tiled"
    return None


def k2_plan(T, N, M, Q, sms, blocks_per_sm, tiled_blocks_per_sm):
    """The geometry K2 launches with in its form (`_k2_form`):
    `k2_geometry` or `k2_tiled_geometry`; raises where it has none."""
    form = _k2_form(M, blocks_per_sm, tiled_blocks_per_sm)
    if form is None:
        _refuse("psi2_bwd_batched", M, Q)
    if form == "single":
        return k2_geometry(T, N, M, Q, sms, blocks_per_sm())
    return k2_tiled_geometry(T, N, M, Q, sms, tiled_blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _k2_tiled_blocks_per_sm(device_index, Q):
    """The tiled K2's blocks per SM at Q (any M), 0 where its block's
    shared memory exceeds the card's."""
    from dp_gp_lvm_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        blocks = build.function("psi2_bwd",
                                "psi2_bwd_tiled_blocks_per_sm")(Q)
    if blocks < 0:
        raise RuntimeError(f"psi2_bwd_batched: tiled occupancy query failed "
                           f"at Q={Q} (CUDA error {-blocks})")
    return blocks


def _k2_occupancies(index, M, Q):
    """(single-tile, tiled) occupancy queries of K2 on the card."""
    return (lambda: _k2_blocks_per_sm(index, M, Q, k2_slice_width(M, Q)),
            lambda: _k2_tiled_blocks_per_sm(index, Q))


def k2_launch_geometry(device, T, N, M, Q):
    """The geometry `psi2_bwd_batched` launches with on CUDA `device`
    (`k2_plan`), from its SM count and the kernel's occupancy there."""
    index = _device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return k2_plan(T, N, M, Q, sms, *_k2_occupancies(index, M, Q))


def fused_fits(M, Q, D, k1_occupancy, k1_tiled_occupancy, k2_blocks_per_sm,
               k2_tiled_blocks_per_sm) -> bool:
    """Whether every kernel of a fused path takes (M, Q, D), by the limits
    its wrappers enforce: D > 0 is K1 with K2 as its backward, D = 0 is K4
    or K5 (K1's body without Psi1^T Y) and K6, with K2. K6 takes any M.
    K1's body and K2 each take a shape one of their forms takes
    (`_k1_form` with `k1_occupancy`, `k1_tiled_occupancy`; `_k2_form`
    with `k2_blocks_per_sm`, `k2_tiled_blocks_per_sm`), the tiled forms up
    to M = MAX_M_TILED. On an H100 the card has run K1's body at M = 512,
    Q = 128, D = 120, and K2's tiled form at M = 512 with Q = 16 and 64,
    at M = 384, Q = 32 and at M = 256, Q = 64: it walks the columns in
    panels, so its shared memory does not grow with M, only with Q (its
    c rows of a batch); it refuses Q = 128. Past those a wrapper raises for
    a CUDA tensor."""
    return (_k2_form(M, k2_blocks_per_sm, k2_tiled_blocks_per_sm) is not None
            and _k1_form(M, Q, D, k1_occupancy,
                         k1_tiled_occupancy) is not None)


def fused_fits_on(device, M, Q, D) -> bool:
    """`fused_fits` on CUDA `device`, from the kernels' occupancy there
    (building them at first use); decided once per device and shape."""
    return _fused_fits_at(_device_index(device), M, Q, D)


@functools.lru_cache(maxsize=None)
def _fused_fits_at(index, M, Q, D) -> bool:
    return fused_fits(M, Q, D, *_k1_occupancies(index, M, Q, D),
                      *_k2_occupancies(index, M, Q))


def psi2_bwd_batched(variances, ards, mu, s, Zs, G, weights=None,
                     block_n: int = 64):
    """K2: raw outputs (gvar_m, gard, gz, V, gmu, gs, gw); see
    `psi2_bwd_batched_reference` and `finish_psi2_bwd`."""
    if _is_cpu(variances, ards, mu, s, Zs, G, weights):
        return psi2_bwd_batched_reference(variances, ards, mu, s, Zs, G,
                                          weights, block_n)
    from dp_gp_lvm_tpu_torch.ops import build

    T, M, Q = Zs.shape
    N = mu.shape[0]
    w = _ones_weights(mu, weights)
    _check_cuda(
        "psi2_bwd_batched",
        dict(variances=variances, ards=ards, mu=mu, s=s, Zs=Zs, G=G, w=w),
        dict(variances=(T,), ards=(T, Q), mu=(N, Q), s=(N, Q), Zs=(T, M, Q),
             G=(T, M, M), w=(N,)),
    )
    geo = k2_launch_geometry(mu.device, T, N, M, Q)
    kw = dict(dtype=mu.dtype, device=mu.device)
    part = torch.empty(geo.part_floats, **kw)
    rowpart = torch.empty(geo.row_floats, **kw)
    gvar_m = torch.empty(T, M, **kw)
    gard = torch.empty(T, Q, **kw)
    gz = torch.empty(T, M, Q, **kw)
    V = torch.empty(T, M, M, **kw)
    gmu = torch.empty(N, Q, **kw)
    gs = torch.empty(N, Q, **kw)
    gw = torch.empty(N, **kw)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    ptrs = (variances.data_ptr(), ards.data_ptr(), mu.data_ptr(),
            s.data_ptr(), w.data_ptr(), Zs.data_ptr(), G.data_ptr(),
            part.data_ptr(), rowpart.data_ptr(), gvar_m.data_ptr(),
            gard.data_ptr(), gz.data_ptr(), V.data_ptr(), gmu.data_ptr(),
            gs.data_ptr(), gw.data_ptr(), T, N, M, Q)
    if isinstance(geo, K2TiledGeometry):
        err = build.function("psi2_bwd", "psi2_bwd_tiled_f32")(
            *ptrs, geo.rows, geo.chunks, stream)
    else:
        err = build.function("psi2_bwd")(
            *ptrs, geo.slice_width, geo.rows, geo.chunks, stream)
    _raise_on(err, "psi2_bwd_batched")
    _launched("psi2_bwd_batched")
    return gvar_m, gard, gz, V, gmu, gs, gw


def _psi2_forward(name, variances, ards, mu, s, Zs, weights):
    """Launch K1's body without Psi1^T Y (csrc/psi_suffstats.cu) at K1's
    geometry for D = 0, in either form; inputs carry the atom dim."""
    from dp_gp_lvm_tpu_torch.ops import build

    T, M, Q = Zs.shape
    N = mu.shape[0]
    tensors = dict(variances=variances, ards=ards, mu=mu, s=s, Zs=Zs)
    shapes = dict(variances=(T,), ards=(T, Q), mu=(N, Q), s=(N, Q),
                  Zs=(T, M, Q))
    if weights is not None:
        tensors["w"], shapes["w"] = weights, (N,)
    _check_cuda(name, tensors, shapes)
    geo = k1_launch_geometry(mu.device, T, N, M, Q, 0)
    part = torch.empty(geo.part_floats, dtype=mu.dtype, device=mu.device)
    out = torch.empty(T, M, M, dtype=mu.dtype, device=mu.device)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    ptrs = (variances.data_ptr(), ards.data_ptr(), mu.data_ptr(),
            s.data_ptr(), None if weights is None else weights.data_ptr(),
            Zs.data_ptr(), part.data_ptr(), out.data_ptr(), T, N, M, Q)
    if isinstance(geo, K1TiledGeometry):
        err = build.function("psi_suffstats", "psi2_batched_tiled_f32")(
            *ptrs, geo.stage_rows, geo.rows, geo.chunks, stream)
    else:
        err = build.function("psi_suffstats", "psi2_batched_f32")(
            *ptrs, geo.groups, geo.stage_rows, geo.rows, geo.chunks, stream)
    _raise_on(err, name)
    _launched(name)
    return out


def psi2_batched(variances, ards, mu, s, Zs, weights=None, block_n: int = 64):
    """K4: the per-atom Psi2 stack (T, M, M). `block_n` sizes the plain
    version's blocks; the kernel picks its own chunking."""
    if _is_cpu(variances, ards, mu, s, Zs, weights):
        return psi2_batched_reference(variances, ards, mu, s, Zs, weights,
                                      block_n)
    return _psi2_forward("psi2_batched", variances, ards, mu, s, Zs,
                         weights)


def psi2_single(variance, ard, mu, s, Z, weights=None, block_n: int = 64):
    """K5: Psi2 (M, M) of one kernel: variance (), ard (Q,), Z (M, Q)."""
    if _is_cpu(variance, ard, mu, s, Z, weights):
        return psi2_single_reference(variance, ard, mu, s, Z, weights,
                                     block_n)
    return _psi2_forward("psi2_single", variance.reshape(1), ard[None], mu,
                         s, Z[None], weights)[0]


class K6Geometry(NamedTuple):
    """How `psi1` launches csrc/psi1.cu: blocks of K6_WARPS warps,
    `col_tiles` column tiles of K6_COLS columns (four a lane) on the
    grid's y axis and `row_blocks` blocks on its x axis; each warp
    prepares `step_rows` rows at once and walks at most `steps` such steps
    grid-stride; `blocks_per_sm` of its blocks fit on an SM."""
    step_rows: int
    col_tiles: int
    row_blocks: int
    steps: int
    blocks_per_sm: int


def k6_max_step_rows(Q) -> int:
    """Most rows a K6 warp prepares at once: two passes of its lanes over
    the (row, q) pairs (6 rows at Q = 10), at least one, at most
    K6_MAX_STEP_ROWS."""
    return max(1, min(K6_MAX_STEP_ROWS, 64 // Q))


def k6_geometry(N, M, Q, sms, blocks_per_sm) -> K6Geometry:
    """K6's launch geometry on `sms` SMs that hold `blocks_per_sm` of its
    blocks each (at `k6_max_step_rows`): the fewest rows a warp step that
    let one wave of resident blocks, over all column tiles, take every
    row in one step (on an H100 one row a step at c2, four at N = 8192,
    M = 128: more rows a step than that only lengthen each warp's chain,
    fewer make warps walk a second step), up to `k6_max_step_rows`;
    as many blocks as those steps need, at most one wave; each block
    reads its tile of Z once, and the warps of a larger N walk their
    steps grid-stride."""
    col_tiles = math.ceil(M / K6_COLS)
    wave = max(1, sms * blocks_per_sm // col_tiles)
    step_rows = min(k6_max_step_rows(Q),
                    max(1, math.ceil(N / (wave * K6_WARPS))))
    warp_steps = math.ceil(N / step_rows)
    row_blocks = max(1, min(math.ceil(warp_steps / K6_WARPS), wave))
    steps = math.ceil(warp_steps / (row_blocks * K6_WARPS))
    return K6Geometry(step_rows, col_tiles, row_blocks, steps, blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _k6_blocks_per_sm(device_index, Q):
    from dp_gp_lvm_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        blocks = build.function("psi1", "psi1_blocks_per_sm")(
            Q, k6_max_step_rows(Q))
    if blocks < 0:
        raise RuntimeError(f"psi1: occupancy query failed at Q={Q} "
                           f"(CUDA error {-blocks})")
    return blocks


def k6_launch_geometry(device, N, M, Q) -> K6Geometry:
    """The geometry `psi1` launches with on CUDA `device`, from its SM
    count and the kernel's occupancy there."""
    index = _device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    per_sm = _k6_blocks_per_sm(index, Q)
    if per_sm < 1:
        raise RuntimeError(f"psi1: no block fits an SM at Q={Q}")
    return k6_geometry(N, M, Q, sms, per_sm)


def psi1(variance, ard, mu, s, Z, weights=None, block_n: int = 128):
    """K6: Psi1 (N, M) of one kernel, optionally row-weighted. `block_n`
    sizes the plain version's blocks; the kernel takes `k6_geometry`."""
    if _is_cpu(variance, ard, mu, s, Z, weights):
        return psi1_reference(variance, ard, mu, s, Z, weights, block_n)
    from dp_gp_lvm_tpu_torch.ops import build

    M, Q = Z.shape
    N = mu.shape[0]
    tensors = dict(variance=variance, ard=ard, mu=mu, s=s, Z=Z)
    shapes = dict(variance=(), ard=(Q,), mu=(N, Q), s=(N, Q), Z=(M, Q))
    if weights is not None:
        tensors["w"], shapes["w"] = weights, (N,)
    _check_cuda("psi1", tensors, shapes)
    geo = k6_launch_geometry(mu.device, N, M, Q)
    out = torch.empty(N, M, dtype=mu.dtype, device=mu.device)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    err = build.function("psi1")(
        variance.data_ptr(), ard.data_ptr(), mu.data_ptr(), s.data_ptr(),
        None if weights is None else weights.data_ptr(), Z.data_ptr(),
        out.data_ptr(), N, M, Q, geo.step_rows, geo.row_blocks, stream,
    )
    _raise_on(err, "psi1")
    _launched("psi1")
    return out


# ---------------------------------------------------------------------------
# forward and backward paired as differentiable ops
# ---------------------------------------------------------------------------


def _contiguous(*xs):
    """The inputs in the layout the kernels take: the fused ops accept any
    strides (a transposed Y, a view cut from a larger q(X)) and copy only
    what is not contiguous; None stays None."""
    return tuple(None if x is None else x.contiguous() for x in xs)


class SuffstatsBatchedFused(torch.autograd.Function):
    """(Psi2 (T,M,M), Psi1^T Y (T,M,D)): K1 forward; backward K2 for the
    Psi2 pullback plus the plain-torch Psi1 pullback. Row weights are
    differentiable."""

    @staticmethod
    def forward(ctx, variances, ards, mu, s, Zs, Y, weights, block_n):
        variances, ards, mu, s, Zs, Y, weights = _contiguous(
            variances, ards, mu, s, Zs, Y, weights)
        ctx.save_for_backward(variances, ards, mu, s, Zs, Y, weights)
        ctx.block_n = block_n
        return suffstats_batched(variances, ards, mu, s, Zs, Y, weights,
                                 block_n)

    @staticmethod
    def backward(ctx, G2, G1Y):
        variances, ards, mu, s, Zs, Y, weights = ctx.saved_tensors
        raw = psi2_bwd_batched(variances, ards, mu, s, Zs,
                               G2.contiguous(), weights, ctx.block_n)
        gvar2, gard2, gmu2, gs2, gz2, gw2 = finish_psi2_bwd(
            variances, ards, Zs, raw)
        # P1Y = (w . psi1)^T Y  =>  dL/dpsi1 = w (Y G1Y^T);
        # dL/dY = w (psi1 G1Y);  dL/dw_n = <psi1_n, (Y G1Y^T)_n>
        yg = Y @ G1Y.mT                                        # (T,N,M)
        g_psi1 = yg if weights is None else yg * weights[:, None]
        gv1, ga1, gm1, gs1, gz1 = _psi1_bwd(variances, ards, mu, s, Zs,
                                            g_psi1)
        psi1 = ard_rbf.psi1(variances, ards, mu, s, Zs)
        gy = torch.sum(psi1 @ G1Y, dim=0)
        if weights is not None:
            gy = gy * weights[:, None]
        gw = None if weights is None else gw2 + torch.sum(psi1 * yg,
                                                          dim=(0, 2))
        return (gvar2 + gv1, gard2 + ga1, gmu2 + torch.sum(gm1, dim=0),
                gs2 + torch.sum(gs1, dim=0), gz2 + gz1, gy, gw, None)


def suffstats_batched_fused(variances, ards, mu, s, Zs, Y, weights=None,
                            block_n: int = 64):
    return SuffstatsBatchedFused.apply(variances, ards, mu, s, Zs, Y,
                                       weights, block_n)


class Psi2BatchedFused(torch.autograd.Function):
    """Psi2 stack (T, M, M): K4 forward, K2 backward. Row weights are
    differentiable."""

    @staticmethod
    def forward(ctx, variances, ards, mu, s, Zs, weights, block_n):
        variances, ards, mu, s, Zs, weights = _contiguous(
            variances, ards, mu, s, Zs, weights)
        ctx.save_for_backward(variances, ards, mu, s, Zs, weights)
        ctx.block_n = block_n
        return psi2_batched(variances, ards, mu, s, Zs, weights, block_n)

    @staticmethod
    def backward(ctx, G):
        variances, ards, mu, s, Zs, weights = ctx.saved_tensors
        raw = psi2_bwd_batched(variances, ards, mu, s, Zs, G.contiguous(),
                               weights, ctx.block_n)
        gvar, gard, gmu, gs, gz, gw = finish_psi2_bwd(variances, ards, Zs,
                                                      raw)
        return (gvar, gard, gmu, gs, gz, None if weights is None else gw,
                None)


def psi2_batched_fused(variances, ards, mu, s, Zs, weights=None,
                       block_n: int = 64):
    return Psi2BatchedFused.apply(variances, ards, mu, s, Zs, weights,
                                  block_n)


class Psi2Fused(torch.autograd.Function):
    """Psi2 (M, M) of one kernel: K5 forward; backward K2 with the atom
    dim set to one. Row weights are differentiable."""

    @staticmethod
    def forward(ctx, variance, ard, mu, s, Z, weights, block_n):
        variance, ard, mu, s, Z, weights = _contiguous(
            variance, ard, mu, s, Z, weights)
        ctx.save_for_backward(variance, ard, mu, s, Z, weights)
        ctx.block_n = block_n
        return psi2_single(variance, ard, mu, s, Z, weights, block_n)

    @staticmethod
    def backward(ctx, G):
        variance, ard, mu, s, Z, weights = ctx.saved_tensors
        vs, ards, Zs = variance.reshape(1), ard[None], Z[None]
        raw = psi2_bwd_batched(vs, ards, mu, s, Zs, G.contiguous()[None],
                               weights, ctx.block_n)
        gvar, gard, gmu, gs, gz, gw = finish_psi2_bwd(vs, ards, Zs, raw)
        return (gvar.reshape(variance.shape), gard[0], gmu, gs, gz[0],
                None if weights is None else gw, None)


def psi2_fused(variance, ard, mu, s, Z, weights=None, block_n: int = 64):
    return Psi2Fused.apply(variance, ard, mu, s, Z, weights, block_n)


class Psi1Fused(torch.autograd.Function):
    """Psi1 (N, M) of one kernel, unweighted: K6 forward, the hand-derived
    plain-torch pullback backward (as in the reference)."""

    @staticmethod
    def forward(ctx, variance, ard, mu, s, Z):
        variance, ard, mu, s, Z = _contiguous(variance, ard, mu, s, Z)
        ctx.save_for_backward(variance, ard, mu, s, Z)
        return psi1(variance, ard, mu, s, Z)

    @staticmethod
    def backward(ctx, G):
        return _psi1_bwd(*ctx.saved_tensors, G)


def psi1_fused(variance, ard, mu, s, Z):
    return Psi1Fused.apply(variance, ard, mu, s, Z)
