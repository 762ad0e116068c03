"""The reference's random stream: the parts of `jax.random` that its data,
initialization and SVI loop draw from, without JAX.

Keys are threefry2x32 keys, int64 tensors of shape (2,) holding two 32-bit
words (every word is kept masked to 32 bits). The stream is JAX's default
`jax_threefry_partitionable=True` one:

- the bits of a draw of shape S come from `threefry2x32(key, hi, lo)` over
  the 64-bit flat index of each element split into its (hi, lo) words;
  32-bit draws are `bits1 ^ bits2`, 64-bit draws `bits1 << 32 | bits2`;
- `split(key, n)` is the pair (bits1, bits2) at indices 0..n-1, and
  `fold_in(key, d)` the pair at the index (0, d);
- `uniform` sets the mantissa of 1.0 from the top bits and subtracts 1,
  `normal` is `sqrt(2) erfinv(u)` over u in [nextafter(-1, 0), 1) with
  XLA's `ErfInv` polynomials (f32: two branches, f64: three), `randint`
  is the two-draw modulus construction, `permutation` sorts by fresh
  32-bit keys for ceil(3 ln n / ln(2^32 - 1)) rounds, `gumbel` is
  -log(-log u) over u uniform in [tiny, 1) (JAX's default low-range
  mode), and `categorical` the Gumbel-max argmax over the logits.

Everything draws on the CPU: a run draws its data and initial parameters
once and moves them to its device, so a draw does not depend on the
device. Keys, bits, `randint`, `permutation`, `uniform` and the
assignments `categorical` draws match `jax.random` bit for bit
(`uniform` where minval is 0 or maxval - minval rounds to a power of
two: elsewhere XLA fuses its multiply-add, which rounds once where this
rounds twice); `normal` matches it within a few ulps (XLA's log1p is
copied here; the ulps left are its own rounding), and so does `gumbel`
in float32 (the logarithms are the host's; float64 agrees to the bit).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CPU = torch.device("cpu")


def _u32(x):
    return torch.as_tensor(x, dtype=torch.int64, device=_CPU) & MASK


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2)
    under the key (k1, k2): the pair of 32-bit outputs."""
    k1, k2, x1, x2 = (_u32(v) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int):
    """The raw threefry key of an integer seed: (seed >> 32, seed & mask)."""
    return _u32([(int(seed) >> 32) & MASK, int(seed) & MASK])


def _hash_iota(key, shape):
    """(bits1, bits2), each of shape key.shape[:-1] + shape: the hash of
    each element's flat index, as a (hi, lo) pair of 32-bit words, under
    each key of a batch of keys (..., 2)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=_CPU)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32,
                        idx & MASK)
    out = tuple(key.shape[:-1]) + shape
    return a.reshape(out), b.reshape(out)


def split(key, num: int = 2):
    """`num` new keys of each key: shape key.shape[:-1] + (num, 2)."""
    a, b = _hash_iota(key, (num,))
    return torch.stack([a, b], dim=-1)


def fold_in(key, data):
    """The key of `data` (an int or an integer tensor, taken as uint32)
    folded into `key`; a tensor of data gives one key per element."""
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, _u32(data))
    return torch.stack([a, b], dim=-1)


def random_bits(key, bit_width: int, shape):
    """Uniform random bits of shape key.shape[:-1] + shape: 32-bit words
    as int64 in [0, 2^32), or 64-bit words as int64 holding the uint64
    pattern (two's complement)."""
    a, b = _hash_iota(key, shape)
    if bit_width == 32:
        return a ^ b
    if bit_width == 64:
        return (a << 32) | b
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _floats_in_unit(key, shape, dtype):
    """Uniform floats in [0, 1): the top mantissa bits of random bits with
    the exponent of 1.0, minus 1."""
    a, b = _hash_iota(key, shape)
    if dtype == torch.float32:
        mant = (a ^ b) >> 9                              # 23 bits
        return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        mant = (a << 20) | (b >> 12)                     # 52 bits
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    raise ValueError(f"dtype must be float32 or float64, got {dtype}")


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """Uniform values in [minval, maxval)."""
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    floats = _floats_in_unit(key, shape, dtype)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv (Giles, "Approximating the erfinv function"): Horner
# coefficients from the highest degree down, per branch of w = -log1p(-x^2)
_ERFINV_F32 = (
    (5.0, 2.5, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)),
    (math.inf, 3.0, (-0.000200214257, 0.000100950558, 0.00134934322,
                     -0.00367342844, 0.00573950773, -0.0076224613,
                     0.00943887047, 1.00167406, 2.83297682)),
)
_ERFINV_F64 = (
    (6.25, 3.125, (
        -3.6444120640178196996e-21, -1.685059138182016589e-19,
        1.2858480715256400167e-18, 1.115787767802518096e-17,
        -1.333171662854620906e-16, 2.0972767875968561637e-17,
        6.6376381343583238325e-15, -4.0545662729752068639e-14,
        -8.1519341976054721522e-14, 2.6335093153082322977e-12,
        -1.2975133253453532498e-11, -5.4154120542946279317e-11,
        1.051212273321532285e-09, -4.1126339803469836976e-09,
        -2.9070369957882005086e-08, 4.2347877827932403518e-07,
        -1.3654692000834678645e-06, -1.3882523362786468719e-05,
        0.0001867342080340571352, -0.00074070253416626697512,
        -0.0060336708714301490533, 0.24015818242558961693,
        1.6536545626831027356)),
    (16.0, 3.25, (
        2.2137376921775787049e-09, 9.0756561938885390979e-08,
        -2.7517406297064545428e-07, 1.8239629214389227755e-08,
        1.5027403968909827627e-06, -4.013867526981545969e-06,
        2.9234449089955446044e-06, 1.2475304481671778723e-05,
        -4.7318229009055733981e-05, 6.8284851459573175448e-05,
        2.4031110387097893999e-05, -0.0003550375203628474796,
        0.00095328937973738049703, -0.0016882755560235047313,
        0.0024914420961078508066, -0.0037512085075692412107,
        0.005370914553590063617, 1.0052589676941592334,
        3.0838856104922207635)),
    (math.inf, 5.0, (
        -2.7109920616438573243e-11, -2.5556418169965252055e-10,
        1.5076572693500548083e-09, -3.7894654401267369937e-09,
        7.6157012080783393804e-09, -1.4960026627149240478e-08,
        2.9147953450901080826e-08, -6.7711997758452339498e-08,
        2.2900482228026654717e-07, -9.9298272942317002539e-07,
        4.5260625972231537039e-06, -1.9681778105531670567e-05,
        7.5995277030017761139e-05, -0.00021503011930044477347,
        -0.00013871931833623122026, 1.0103004648645343977,
        4.8499064014085844221)),
)


# XLA's log1p below sqrt(2) - 1 (Cephes): x - x^2/2 + x^3 P(x) / Q(x)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972e-1,
            6.5787325942061044846e0, 2.9911919328553073277e1,
            6.0949667980987787057e1, 5.7112963590585538103e1,
            2.0039553499201281259e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469e1,
            2.2176239823732856465e2, 3.0909872225312059774e2,
            2.1642788614495947685e2, 6.0118660497603843919e1)


def _horner(x, coeffs):
    p = torch.zeros_like(x)
    for c in coeffs:
        p = p * x + c
    return p


def _log1p(x):
    """log(1 + x) as XLA computes it: a rational form for |x| below
    sqrt(2) - 1, log(1 + x) above."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(x, _LOG1P_P)
                                         / _horner(x, _LOG1P_Q)))
    return torch.where(torch.abs(x) < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erfinv(x):
    """XLA's ErfInv for float32 or float64 x (erfinv(+-1) = +-inf)."""
    table = _ERFINV_F32 if x.dtype == torch.float32 else _ERFINV_F64
    w = -_log1p(-x * x)
    sqrt_w = torch.sqrt(w)
    out = torch.zeros_like(x)
    below = torch.zeros_like(x, dtype=torch.bool)
    for first, (bound, shift, coeffs) in enumerate(table):
        sel = (w < bound) & ~below
        below |= sel
        v = (w if first == 0 else sqrt_w) - shift
        p = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            p = c + p * v
        out = torch.where(sel, p * x, out)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, out)


def normal(key, shape=(), dtype=torch.float32):
    """Standard normal values: sqrt(2) erfinv(u), u uniform in
    [nextafter(-1, 0), 1)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype))
    u = uniform(key, shape, dtype, lo.item(), 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=dtype) * erfinv(u)


def randint(key, shape, minval: int, maxval: int, bits: int = 32):
    """Integers in [minval, maxval), int32 (bits=32) or int64 (bits=64), as
    `jax.random.randint` draws them at that width: two draws of random bits
    reduced modulo the span in wrapping unsigned arithmetic (numpy's). A
    batch of keys (..., 2) draws key.shape[:-1] + shape at once."""
    utype, itype = {32: (np.uint32, torch.int32),
                    64: (np.uint64, torch.int64)}[bits]
    lim = 2 ** (bits - 1)
    if not (-lim <= minval and maxval <= lim - 1):
        raise ValueError(f"randint takes int{bits} bounds")
    keys = split(key)
    higher, lower = (random_bits(keys[..., i, :], bits, shape).numpy()
                     .view(np.uint64).astype(utype) for i in (0, 1))
    span = np.array([maxval - minval if maxval > minval else 1], utype)
    multiplier = np.array([2 ** (bits // 2)], utype) % span
    multiplier = (multiplier * multiplier) % span
    offset = ((higher % span) * multiplier + lower % span) % span
    offset = torch.from_numpy(offset.astype(np.int64))
    return (minval + offset).to(itype)


def permutation(key, n: int):
    """A permutation of range(n): JAX's shuffle by stable sorts on fresh
    32-bit keys, ceil(3 ln n / ln(2^32 - 1)) rounds."""
    x = torch.arange(n, dtype=torch.int64)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, 32, (n,)), stable=True).indices
        x = x[order]
    return x


def gumbel(key, shape=(), dtype=torch.float32):
    """Standard Gumbel values, as `jax.random.gumbel` draws them in its
    default mode: -log(-log(u)) over u uniform in [tiny, 1), tiny the
    dtype's smallest normal number. A batch of keys (..., 2) draws
    key.shape[:-1] + shape at once."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0)))


def categorical(key, logits, shape=None):
    """Draws from the categorical distributions softmax(logits) over the
    last axis of `logits`, as `jax.random.categorical` makes them with
    replacement: the argmax over K of the logits plus Gumbel values of
    shape `shape` + (K,). For one key, logits (..., K) has the batch shape
    logits.shape[:-1], which `shape` (default: that batch) must end with.
    A batch of keys (B..., 2) draws for each key, as `jax.vmap` over the
    keys and logits.shape[:len(B)] does: key b reads the logits
    logits[b], and the result is B + shape. int64 on the CPU."""
    kb = tuple(key.shape[:-1])
    logits = torch.as_tensor(logits).cpu()
    if tuple(logits.shape[:len(kb)]) != kb:
        raise ValueError(f"logits {tuple(logits.shape)} do not lead with "
                         f"the keys' batch {kb}")
    per = tuple(logits.shape[len(kb):])
    batch = per[:-1]
    shape = batch if shape is None else tuple(shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"shape {shape} does not end with the logits' "
                         f"batch shape {batch}")
    g = gumbel(key, shape + per[-1:], logits.dtype)
    prefix = (1,) * (len(shape) - len(batch))
    return torch.argmax(g + logits.reshape(kb + prefix + per), dim=-1)
