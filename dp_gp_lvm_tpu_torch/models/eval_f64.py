r"""Float64 host evaluation of the uncollapsed SVI bound, numpy and scipy
(counterpart of `dp_gp_lvm_tpu/models/eval_f64.py`).

A gated ELBO must not inherit the training path's precision: a float32
reduction over N = 131072 rows differences beta-scale terms. This module
evaluates `svi_gplvm.elbo` on the host in float64, chunked over rows, and
re-derives the ARD-RBF psi statistics and the whitened Hensman bound from
the math rather than calling the model, so it is an independent oracle of
it as well. The ARD-RBF kernel only; q(X) the resident table or the
amortized encoder, whose forward pass it re-derives too.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg

from dp_gp_lvm_tpu_torch.core.transforms import (
    MIN_NOISE,
    MIN_VARIATIONAL_VAR,
)


def _positive(raw, floor=0.0):
    return np.logaddexp(np.asarray(raw, np.float64), 0.0) + floor


def _numpy(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, np.float64)


def _constrain(params, config):
    p = {k: _numpy(v) for k, v in params.items()}
    floor = max(config.noise_floor, MIN_NOISE) if config.noise_floor \
        else MIN_NOISE
    raw = p["raw_u_scale"]
    c = {
        "z": p["z"],
        "variance": _positive(p["raw_variance"]),
        "ard": _positive(p["raw_ard"]),
        "noise": _positive(p["raw_noise"], floor),
        "u_mean": p["u_mean"],
        "u_scale": np.tril(raw, -1) + np.diag(_positive(np.diagonal(raw))),
    }
    if "qx_mean" in p:
        c["qx_mean"] = p["qx_mean"]
        c["qx_var"] = _positive(p["raw_qx_var"], MIN_VARIATIONAL_VAR)
    c.update({k: v for k, v in p.items() if k.startswith("enc_")})
    return c


def _encode(c, y, var_floor):
    """The encoder's q(x) moments of the rows y (`models/amortized.py`)."""
    yc = y - c["enc_mean"][None, :]
    mu = yc @ c["enc_wlin"] + c["enc_bm"][None, :]
    raw_s = np.broadcast_to(c["enc_bs"][None, :], mu.shape).copy()
    if "enc_w1" in c:
        h = np.tanh(yc @ c["enc_w1"] + c["enc_b1"][None, :])
        mu = mu + h @ c["enc_wm"]
        raw_s = raw_s + h @ c["enc_ws"]
    return mu, _positive(raw_s, MIN_VARIATIONAL_VAR) + var_floor


def _gram(variance, ard, z):
    zs = z * np.sqrt(ard)[None, :]
    n2 = np.sum(zs * zs, axis=-1)
    d2 = np.maximum(n2[:, None] - 2.0 * zs @ zs.T + n2[None, :], 0.0)
    return variance * np.exp(-0.5 * d2)


def _psi_chunk(variance, ard, mu, s, z, log_e):
    """(psi1 (B, M), psi2 (M, M)) of one row chunk."""
    denom1 = ard[None, :] * s + 1.0
    a = ard[None, :] / denom1
    log_norm1 = -0.5 * np.sum(np.log(denom1), axis=-1)
    row = np.sum(a * mu * mu, axis=-1)
    quad = row[:, None] - 2.0 * (a * mu) @ z.T + a @ (z * z).T
    psi1 = variance * np.exp(log_norm1[:, None] - 0.5 * quad)

    denom2 = 2.0 * ard[None, :] * s + 1.0
    b = ard[None, :] / denom2
    log_norm2 = -0.5 * np.sum(np.log(denom2), axis=-1)
    sterm = np.sum(b * mu * mu, axis=-1)
    t = (b * mu) @ z.T
    pq = b @ (z * z).T
    h = t - 0.25 * pq
    # the (B, M, M) exponent built in place in one buffer
    expo = np.matmul(b[:, None, :] * z[None, :, :], z.T)
    expo *= -0.5
    expo += log_e[None, :, :]
    expo += (log_norm2 - sterm)[:, None, None]
    expo += h[:, :, None]
    expo += h[:, None, :]
    return psi1, (variance ** 2) * np.sum(np.exp(expo, out=expo), axis=0)


def elbo_f64(params, Y, config, chunk: int = 8192) -> float:
    """Full-batch whitened Hensman bound in host float64, term for term as
    `svi_gplvm.elbo`, with K_uu factored under a 1e-12 ridge instead of
    the jitter policy (float64 at these scales needs no more). `params`
    and `Y` may be torch tensors (any device) or arrays."""
    if config.kernel != "ard_rbf":
        raise NotImplementedError(
            f"elbo_f64 supports ard_rbf only, got {config.kernel!r}")
    c = _constrain(params, config)
    Y = _numpy(Y)
    n, d = Y.shape
    z = c["z"]
    m = z.shape[0]
    variance, ard, noise = c["variance"], c["ard"], c["noise"]
    beta = 1.0 / noise

    # log_e[m, m'] = -1/4 sum_q alpha_q (z_mq - z_m'q)^2
    zz = z[:, None, :] - z[None, :, :]
    log_e = -0.25 * np.sum(ard[None, None, :] * zz * zz, axis=-1)
    # the amortized model's q(X) variance floor, as its `constrain` binds it
    var_floor = config.qx_var_floor if config.amortized else 0.0

    psi0 = variance * n
    psi1T_y = np.zeros((m, d))
    psi2 = np.zeros((m, m))
    yty = np.zeros((d,))
    kl_x = 0.0
    for lo in range(0, n, chunk):
        y_b = Y[lo:lo + chunk]
        if "qx_mean" in c:
            mu_b = c["qx_mean"][lo:lo + chunk]
            s_b = c["qx_var"][lo:lo + chunk]
        else:
            mu_b, s_b = _encode(c, y_b, var_floor)
        p1, p2 = _psi_chunk(variance, ard, mu_b, s_b, z, log_e)
        psi1T_y += p1.T @ y_b
        psi2 += p2
        yty += np.sum(y_b * y_b, axis=0)
        kl_x += 0.5 * np.sum(mu_b * mu_b + s_b - np.log(s_b) - 1.0)

    L = np.linalg.cholesky(_gram(variance, ard, z) + 1e-12 * np.eye(m))
    a = scipy.linalg.solve_triangular(L, psi1T_y, lower=True)
    half = scipy.linalg.solve_triangular(L, psi2, lower=True)
    A2 = scipy.linalg.solve_triangular(L, half.T, lower=True)
    A2 = 0.5 * (A2 + A2.T)

    mu_u, ls = c["u_mean"], c["u_scale"]
    tr_sa2 = np.sum((A2 @ ls) * ls)
    quad = np.sum(mu_u * (A2 @ mu_u), axis=0)
    shared = (-0.5 * n * (np.log(2.0 * np.pi) + np.log(noise))
              - 0.5 * beta * (tr_sa2 + psi0 - np.trace(A2)))
    per_dim = shared - 0.5 * beta * (
        yty - 2.0 * np.sum(mu_u * a, axis=0) + quad)
    kl_u = 0.5 * np.sum(mu_u * mu_u) + 0.5 * d * (
        np.sum(ls * ls) - m - 2.0 * np.sum(np.log(np.diagonal(ls))))
    return float(np.sum(per_dim) - kl_u - kl_x)
