r"""Amortized q(X): a recognition network for the SVI model families,
q(x_n) = N(mu_w(y_n), diag s_w(y_n)) (counterpart of
`dp_gp_lvm_tpu/models/amortized.py`, whose docstring gives the why).

In place of the free (N, Q) table of means and variances, a shared encoder
maps each data row to its q(x) moments, so the variational state does not
grow with N: with the host-streamed feed (`data/stream.py`) nothing on the
device scales with N, and a new row's latent comes from one forward pass.
The minibatch bound is the Hensman/Titsias estimate with encode(y_b) in
place of the table gather; it stays a valid ELBO (a restriction of the
variational family).

A PCA-initialized linear readout plus a tanh-MLP correction whose heads
start at zero:

    h      = tanh(y W1 + b1)                       (hidden > 0 only)
    mu     = y Wlin + h Wm + bm
    raw_s  = h Ws + bs_raw                         (softplus + floor)

so encode(Y) at init is the resident init exactly (PCA means, variance
0.5), and the amortized and resident models start from the same q(X).

Every leaf is named "enc_...": the models' `constrain` passes them through
raw, and `gp_optimizer` labels them "var" (full rate). A model's
`constrain` given a config with a `qx_var_floor` adds "enc_var_floor" to
the constrained dict, a 0-d float64 tensor on the host, which `encode`
adds to the encoded variance (adding a host scalar to a tensor on the
card reads nothing back from the card).
"""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import (
    positive_inverse,
    positive_variational_var,
)

ENCODER_PREFIX = "enc_"
# the constrained dict's key of the encoded variance's additive floor
VAR_FLOOR = "enc_var_floor"


def is_encoder_leaf(name: str) -> bool:
    return name.startswith(ENCODER_PREFIX)


def init_encoder(key, Y, x0, hidden: int) -> dict:
    """Encoder leaves whose encode(Y) is the resident init (the PCA
    latents x0 (N, Q) of Y, and variance 0.5), in Y's dtype on its device.

    The readout solves Wlin = lstsq(Y - mean, x0): PCA scores are a linear
    map of the centred rows. The solve is LAPACK's SVD-based `gelsd` (as
    the reference's `jnp.linalg.lstsq`), on the host in float64 whatever
    the device and dtype: it does not assume full rank, which CUDA's QR
    driver does. The MLP correction's weights W1 are drawn from
    split(key)[0]; its heads start at zero."""
    dtype, device = Y.dtype, Y.device
    d, q = Y.shape[1], x0.shape[1]
    host = Y.detach().cpu()
    mean = torch.mean(host, dim=0)
    x0 = x0.detach().cpu()
    wlin = torch.linalg.lstsq((host - mean).double(), x0.double(),
                              driver="gelsd").solution
    half = positive_inverse(torch.tensor(0.5, dtype=dtype))
    params = {
        "enc_mean": mean.to(dtype),
        "enc_wlin": wlin.to(dtype),
        "enc_bm": torch.zeros(q, dtype=dtype),
        # softplus^{-1}(0.5): s(y) starts at 0.5
        "enc_bs": torch.full((q,), half.item(), dtype=dtype),
    }
    if hidden > 0:
        k1, _ = prng.split(key)
        # 1/sqrt(D) in the draw's dtype, as the reference rounds it
        scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=dtype))
        params.update({
            "enc_w1": prng.normal(k1, (d, hidden), dtype) * scale,
            "enc_b1": torch.zeros(hidden, dtype=dtype),
            # zero heads: the MLP adds nothing at init
            "enc_wm": torch.zeros(hidden, q, dtype=dtype),
            "enc_ws": torch.zeros(hidden, q, dtype=dtype),
        })
    return {k: v.to(device) for k, v in params.items()}


def qx_leaves_or_encoder(key, Y, x0, config) -> dict:
    """The q(X) half of a model's init from Y's PCA latents x0: encoder
    leaves drawn from `key` when `config.amortized`, else the resident
    (N, Q) table at the same q(X) (means x0, variance 0.5)."""
    if config.amortized:
        return init_encoder(key, Y, x0, config.encoder_hidden)
    return {"qx_mean": x0,
            "raw_qx_var": positive_inverse(0.5 * torch.ones_like(x0))}


def encoder_leaves(params, config=None) -> dict:
    """The encoder's leaves of a parameter dict, as they pass through a
    model's `constrain`, with "enc_var_floor" where `config` sets a
    `qx_var_floor` (nothing without a config, as in the reference)."""
    out = {k: v for k, v in params.items() if is_encoder_leaf(k)}
    floor = getattr(config, "qx_var_floor", 0.0) if config is not None \
        else 0.0
    if out and floor:
        out[VAR_FLOOR] = torch.tensor(float(floor), dtype=torch.float64)
    return out


def qx_batch(c, y, idx):
    """q(X) moments of data rows from a constrained dict: the table's rows
    `idx` (None: every row) in resident mode, the encoder's forward pass
    of the rows `y` in amortized mode, where no table exists to index."""
    if "qx_mean" in c:
        if idx is None:
            return c["qx_mean"], c["qx_var"]
        return c["qx_mean"][idx], c["qx_var"][idx]
    return encode(c, y)


def encoder_fill_init(c, y_star, mask):
    """One-pass q(x*) means for serving: the missing dims (mask 0) filled
    at the encoder's centre, where they add exactly zero after
    centring."""
    y_fill = torch.where(mask > 0, y_star, c["enc_mean"][None, :])
    return encode(c, y_fill)[0]


def encode(params, y):
    """(mu (B, Q), s (B, Q)): the amortized q(x) moments of the rows y
    (B, D). `params` may be raw or constrained: the encoder's leaves pass
    through `constrain` unchanged. Where the dict holds "enc_var_floor"
    (`encoder_leaves`), it is added to the variance: a lower bound that
    keeps the encoded variances from collapsing, under which the batch psi
    statistics turn hyper-local and the natural-gradient q(u) recursion
    diverges at c8's scale."""
    yc = y - params["enc_mean"][None, :]
    mu = yc @ params["enc_wlin"] + params["enc_bm"][None, :]
    raw_s = params["enc_bs"][None, :].expand(mu.shape)
    if "enc_w1" in params:
        h = torch.tanh(yc @ params["enc_w1"] + params["enc_b1"][None, :])
        mu = mu + h @ params["enc_wm"]
        raw_s = raw_s + h @ params["enc_ws"]
    s = positive_variational_var(raw_s)
    floor = params.get(VAR_FLOOR)
    if floor is not None:
        s = s + floor
    return mu, s

