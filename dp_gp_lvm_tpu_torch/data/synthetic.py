"""Synthetic datasets (counterpart of `dp_gp_lvm_tpu/data/synthetic.py`):
`toy_gplvm` (c1), `oil_flow_like` (c2), `two_view` (c3), `mocap_like`
(c4, c5, c6, c8), `pose_like` (c5_pose), `grouped_dims` and
`grouped_dims_big` (c7), `two_view_big` (c9). Each takes a key of the
reference's random stream (`core/prng.py`) and draws what the reference
draws from it, in the same order, on the CPU; the result is moved to
`device` (the card unless the caller says "cpu")."""
from __future__ import annotations

import math

import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.types import resolve_device
from dp_gp_lvm_tpu_torch.kernels import ard_rbf
from dp_gp_lvm_tpu_torch.linalg import safe_cholesky


def _standardize(Y):
    return (Y - Y.mean(dim=0)) / Y.std(dim=0, correction=0)


def _linspace(stop: float, n: int, dtype):
    """`jnp.linspace(0, stop, n)`: stop * (i / (n - 1)), the last exactly
    stop."""
    stop = torch.tensor(stop, dtype=dtype)
    step = torch.arange(n - 1, dtype=dtype) / (n - 1)
    return torch.cat([stop * step, stop[None]])


def _gp_draws(key, X, ard, num_out, noise, variance=1.0):
    """num_out independent GP function values over the rows of X, plus
    observation noise of variance `noise`."""
    n = X.shape[0]
    k = ard_rbf.gram(torch.tensor(variance, dtype=X.dtype), ard, X)
    L, _ = safe_cholesky(k)
    r1, r2 = prng.split(key)
    f = L @ prng.normal(r1, (n, num_out), X.dtype)
    return f + math.sqrt(noise) * prng.normal(r2, (n, num_out), X.dtype)


def toy_gplvm(key, n: int = 100, d: int = 10, q_true: int = 2,
              q_total: int | None = None, noise: float = 0.01,
              dtype=torch.float64, device=None):
    """Config-1 data: D outputs driven by q_true active latent dims; with
    q_total > q_true the generating ARD weights are zero on the inactive
    dims. Returns (Y, X_true)."""
    device = resolve_device(device)
    q_total = q_total or q_true
    r1, r2 = prng.split(key)
    X = prng.normal(r1, (n, q_total), dtype)
    ard = torch.cat([torch.ones(q_true, dtype=dtype),
                     torch.zeros(q_total - q_true, dtype=dtype)])
    Y = _standardize(_gp_draws(r2, X, ard, d, noise))
    return Y.to(device), X.to(device)


def two_view(key, n: int = 100, d1: int = 8, d2: int = 8,
             q_shared: int = 1, q_private: int = 1, noise: float = 0.01,
             dtype=torch.float64, private_weight: float = 1.0,
             device=None):
    """Config-3 data: two views sharing q_shared latent dims, each with its
    own q_private dims, X = [shared, private 1, private 2]. Each view is a
    GP draw whose ARD weights are 1 on the shared dims, `private_weight`
    on its own private dims and 0 on the other view's, standardized over
    the whole series. Returns (Y1, Y2, X) on `device` (the card unless the
    caller says "cpu")."""
    device = resolve_device(device)
    r0, r1, r2 = prng.split(key, 3)
    q = q_shared + 2 * q_private
    X = prng.normal(r0, (n, q), dtype)
    ones = torch.ones(q_shared, dtype=dtype)
    own = private_weight * torch.ones(q_private, dtype=dtype)
    off = torch.zeros(q_private, dtype=dtype)
    Y1 = _standardize(_gp_draws(r1, X, torch.cat([ones, own, off]), d1,
                                noise))
    Y2 = _standardize(_gp_draws(r2, X, torch.cat([ones, off, own]), d2,
                                noise))
    return Y1.to(device), Y2.to(device), X.to(device)


def two_view_big(key, n: int = 131072, d1: int = 32, d2: int = 32,
                 q_shared: int = 2, q_private: int = 1, noise: float = 0.05,
                 private_weight: float = 0.5, num_features: int = 64,
                 lengthscale: float = 1.5, dtype=torch.float64, device=None):
    """Big-N two views (c9): `two_view`'s shared/private ARD signature
    through random Fourier features, an O(n) stand-in for its GP draw.
    View v's frequencies are N(0, 1) draws scaled per latent dim by
    sqrt(ard_v) / lengthscale (key fold_in(rf, v)), its phases uniform in
    [0, 2 pi) (fold_in(rf, 100 + v)), its amplitudes fold_in(ra, v); each
    view is scaled to unit signal, takes noise of standard deviation
    `noise` (fold_in(rn, v)) and is standardized per column. Returns (Y1,
    Y2, X), X = [shared, private 1, private 2], on `device` (the card
    unless the caller says "cpu")."""
    device = resolve_device(device)
    q = q_shared + 2 * q_private
    r0, rf, ra, rn = prng.split(key, 4)
    X = prng.normal(r0, (n, q), dtype)
    ones = torch.ones(q_shared, dtype=dtype)
    own = private_weight * torch.ones(q_private, dtype=dtype)
    off = torch.zeros(q_private, dtype=dtype)
    ards = (torch.cat([ones, own, off]), torch.cat([ones, off, own]))
    Ys = []
    for v, (ard, d_v) in enumerate(zip(ards, (d1, d2))):
        freq = prng.normal(prng.fold_in(rf, v), (q, num_features), dtype) * (
            torch.sqrt(ard)[:, None] / lengthscale)
        b = prng.uniform(prng.fold_in(rf, 100 + v), (num_features,), dtype,
                         0.0, 2.0 * math.pi)
        feats = math.sqrt(2.0 / num_features) * torch.cos(X @ freq + b[None])
        y = feats @ prng.normal(prng.fold_in(ra, v), (num_features, d_v),
                                dtype)
        y = y / y.std(dim=0, correction=0)      # unit signal, then noise
        y = y + noise * prng.normal(prng.fold_in(rn, v), tuple(y.shape),
                                    dtype)
        Ys.append(_standardize(y).to(device))
    return Ys[0], Ys[1], X.to(device)


def grouped_dims(key, n: int = 100, dims_per_group=(6, 6), q: int = 3,
                 noise: float = 0.01, dtype=torch.float64, device=None):
    """Planted-group recovery data: groups of output dims, group g a GP
    draw on latent dim g (mod q) alone, standardized. Returns (Y, labels,
    X) on `device` (the card unless the caller says "cpu")."""
    device = resolve_device(device)
    keys = prng.split(key, len(dims_per_group) + 1)
    X = prng.normal(keys[0], (n, q), dtype)
    Ys, labels = [], []
    for g, dg in enumerate(dims_per_group):
        ard = torch.zeros(q, dtype=dtype)
        ard[g % q] = 1.0
        Ys.append(_gp_draws(keys[g + 1], X, ard, dg, noise))
        labels += [g] * dg
    Y = _standardize(torch.cat(Ys, dim=1))
    return Y.to(device), torch.tensor(labels).to(device), X.to(device)


def grouped_dims_big(key, n: int = 65536, dims_per_group=(16, 16),
                     q: int = 4, noise=(0.05, 0.25, 0.6, 1.2),
                     lengthscales=4.0, num_features: int = 64,
                     dtype=torch.float64, device=None):
    """Big-N planted groups (c7): group g's dims are random-Fourier-feature
    functions of latent dim g (mod q) alone (an O(n) stand-in for the GP
    draw), scaled to unit signal, plus noise of standard deviation
    noise[g]; the groups differ in noise, which a single atom cannot absorb
    (the reference's docstring says why). noise and lengthscales: a scalar
    or one per group. Returns (Y, labels, X) on `device` (the card unless
    the caller says "cpu")."""
    device = resolve_device(device)
    num_groups = len(dims_per_group)
    if not isinstance(noise, (tuple, list)):
        noise = (float(noise),) * num_groups
    if not isinstance(lengthscales, (tuple, list)):
        lengthscales = (float(lengthscales),) * num_groups
    keys = prng.split(key, 2 * num_groups + 2)
    X = prng.normal(keys[0], (n, q), dtype)
    Ys, labels = [], []
    for g, dg in enumerate(dims_per_group):
        x_g = X[:, g % q][:, None]
        w = prng.normal(keys[2 * g + 1], (1, num_features),
                        dtype) / lengthscales[g]
        b = prng.uniform(keys[2 * g + 2], (num_features,), dtype, 0.0,
                         2.0 * math.pi)
        feats = math.sqrt(2.0 / num_features) * torch.cos(x_g @ w + b[None])
        amp = prng.normal(prng.fold_in(keys[-1], g), (num_features, dg),
                          dtype)
        y_g = feats @ amp
        # unit signal, then noise: the noise level survives the final
        # standardization
        y_g = y_g / y_g.std(dim=0, correction=0)
        y_g = y_g + noise[g] * prng.normal(prng.fold_in(keys[-1], 1000 + g),
                                           tuple(y_g.shape), dtype)
        Ys.append(y_g)
        labels += [g] * dg
    Y = _standardize(torch.cat(Ys, dim=1))
    return Y.to(device), torch.tensor(labels).to(device), X.to(device)


def oil_flow_like(key, n: int = 1000, d: int = 12, dtype=torch.float64,
                  device=None):
    """Three-regime multiphase-flow surrogate (config-2 shape: N=1000,
    D=12): three well-separated clusters in a 2-dim latent, mapped through
    random Fourier features. Returns (Y, labels, X). The labels are drawn
    at the integer width the reference draws them at: 64 bits with
    float64 (its 64-bit mode), else 32."""
    device = resolve_device(device)
    r0, r1, r2, r3 = prng.split(key, 4)
    labels = prng.randint(r0, (n,), 0, 3,
                          bits=64 if dtype == torch.float64 else 32)
    centers = torch.tensor([[-2.0, 0.0], [2.0, 0.0], [0.0, 2.5]],
                           dtype=dtype)
    X = centers[labels.long()] + 0.3 * prng.normal(r1, (n, 2), dtype)
    W = prng.normal(r2, (2, d), dtype)
    b = prng.uniform(r3, (d,), dtype, 0.0, 2.0 * math.pi)
    Y = _standardize(torch.sin(X @ W + b[None, :]))
    return Y.to(device), labels.to(device), X.to(device)


def mocap_like(key, n: int = 1024, d: int = 59, q_true: int = 4,
               noise: float = 0.02, dtype=torch.float64, device=None):
    """CMU-mocap-shaped surrogate (N~1k, D~60; c6 draws N=131072, D=32):
    smooth low-dimensional trajectories through a high-dimensional
    joint-angle space. Returns (Y, X) on `device` (the card unless the
    caller says "cpu")."""
    device = resolve_device(device)
    r1, r2 = prng.split(key)
    t = _linspace(8.0 * math.pi, n, dtype)[:, None]
    freqs = 0.5 + torch.arange(q_true, dtype=dtype)[None, :] * 0.35
    phases = prng.uniform(r1, (1, q_true), dtype, 0.0, 2.0 * math.pi)
    X = torch.sin(t * freqs + phases)
    W = prng.normal(r2, (q_true, d), dtype) / math.sqrt(q_true)
    Y = X @ W + noise * prng.normal(key, (n, d), dtype)
    return _standardize(Y).to(device), X.to(device)


# 2D articulated figure for pose_like: (parent, length, base_angle,
# gait_group) per joint; joint 0 is the root (pelvis). Groups: 0 spine/head,
# 1 left leg, 2 right leg, 3 left arm, 4 right arm.
_POSE_SKELETON = (
    (-1, 0.0, 0.0, 0),    # 0 pelvis (root)
    (0, 0.5, 1.571, 0),   # 1 lower spine
    (1, 0.5, 1.571, 0),   # 2 upper spine
    (2, 0.3, 1.571, 0),   # 3 head
    (0, 0.5, -1.271, 1),  # 4 left hip
    (4, 0.5, -1.571, 1),  # 5 left knee
    (5, 0.25, -1.871, 1),  # 6 left foot
    (0, 0.5, -1.871, 2),  # 7 right hip
    (7, 0.5, -1.571, 2),  # 8 right knee
    (8, 0.25, -1.271, 2),  # 9 right foot
    (2, 0.45, -0.771, 3),  # 10 left shoulder
    (10, 0.45, -1.271, 3),  # 11 left elbow
    (11, 0.2, -1.571, 3),   # 12 left hand
    (2, 0.45, -2.371, 4),   # 13 right shoulder
    (13, 0.45, -1.871, 4),  # 14 right elbow
    (14, 0.2, -1.571, 4),   # 15 right hand
)


def pose_from_draws(phases, mix, noise_draw, noise: float = 0.01):
    """The deterministic part of `pose_like`: gait signals -> joint angles
    per limb group -> 2D forward kinematics -> noise -> standardization.

    phases (1, q) in [0, 2 pi), mix (5, q) (the groups' weights, before the
    opposite limbs are mirrored), noise_draw (n, 32) standard normal.
    Returns (Y (n, 32), gait (n, q), joint_groups (16,))."""
    n, q = noise_draw.shape[0], phases.shape[1]
    kw = dict(dtype=phases.dtype, device=phases.device)
    t = _linspace(6.0 * math.pi, n, phases.dtype).to(phases.device)
    t = t[:, None]
    freqs = 0.7 + torch.arange(q, **kw)[None, :] * 0.4
    gait = torch.sin(t * freqs + phases)                    # (n, q)
    # opposite limbs get opposite sign (walking anti-phase)
    mix = mix.clone()
    mix[2] = -mix[1]
    mix[4] = -mix[3]
    group_angle = gait @ mix.T                              # (n, groups)

    positions, cum_angles = {}, {}
    for j, (parent, length, base, group) in enumerate(_POSE_SKELETON):
        if parent < 0:
            cum_angles[j] = torch.zeros(n, **kw)
            positions[j] = torch.zeros(n, 2, **kw)
        else:
            ang = cum_angles[parent] * 0.3 + base + group_angle[:, group]
            cum_angles[j] = ang
            step = length * torch.stack([torch.cos(ang), torch.sin(ang)],
                                        dim=-1)
            positions[j] = positions[parent] + step
    Y = torch.cat([positions[j] for j in range(len(_POSE_SKELETON))], dim=1)
    Y = Y + noise * noise_draw
    # the floor keeps a joint that barely moves from being blown up
    sd = torch.clamp(Y.std(dim=0, correction=0), min=1e-3)
    Y = (Y - Y.mean(dim=0)) / sd
    groups = torch.tensor([g for (_, _, _, g) in _POSE_SKELETON],
                          device=phases.device)
    return Y, gait, groups


def pose_like(key, n: int = 512, q_true: int = 3, noise: float = 0.01,
              dtype=torch.float64, device=None):
    """Pose-shaped surrogate (config c5_pose_missing): 2D keypoint
    trajectories of a 16-joint articulated figure walking. A few smooth
    gait signals drive joint angles per limb group through a 2D
    forward-kinematic chain, so the observed dims (x, y per joint) are
    nonlinear in the latents and come in limb groups.
    Returns (Y (n, 32), X_true (n, q_true), joint_groups (16,)) on
    `device` (the card unless the caller says "cpu")."""
    device = resolve_device(device)
    r1, r2, r3 = prng.split(key, 3)
    phases = prng.uniform(r1, (1, q_true), dtype, 0.0, 2.0 * math.pi)
    mix = 0.5 * prng.normal(r2, (5, q_true), dtype)
    noise_draw = prng.normal(r3, (n, 2 * len(_POSE_SKELETON)), dtype)
    Y, gait, groups = pose_from_draws(phases, mix, noise_draw, noise)
    return Y.to(device), gait.to(device), groups.to(device)
