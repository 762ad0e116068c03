"""Training: the optimizer of the GP-LVM family (counterpart of
`dp_gp_lvm_tpu/train/loop.py::gp_optimizer`, without its schedules).

It reproduces the reference's optax chain
    apply_if_finite(chain(clip_by_global_norm(clip),
                          multi_transform({hyper: adam(lr/10), var: adam(lr),
                                           ngd: chain(ngd_precondition,
                                                      scale(-ngd_lr))})))
written by hand:
  - the global-norm clip is optax's (`clip_grad_norm_` adds 1e-6);
  - a step whose gradients hold a non-finite value changes neither the
    parameters nor the Adam state, and is decided on the device with
    `torch.where`, so the step needs no host sync;
  - Adam is optax's `scale_by_adam` (eps outside the square root).
Cosine decay, warmup and the `ard_lr` group wait for a later slice.
"""
from __future__ import annotations

import torch

from dp_gp_lvm_tpu_torch.core.transforms import positive_variational_var

HYPER_PARAM_NAMES = frozenset(
    {"raw_variance", "raw_ard", "raw_noise", "raw_gamma1", "raw_gamma2",
     "raw_alpha"}
)
NGD_NAMES = frozenset({"qx_mean", "raw_qx_var"})
B1, B2, EPS = 0.9, 0.999, 1e-8


def ngd_precondition(grads, params):
    """Inverse-Fisher preconditioner of the diag-Gaussian q(X) params:
    natgrad_m = s g_m, natgrad_raw = 2 s^2 / sigmoid(raw)^2 g_raw."""
    raw = params["raw_qx_var"]
    s = positive_variational_var(raw)
    sig = torch.sigmoid(raw)
    return {
        "qx_mean": grads["qx_mean"] * s,
        "raw_qx_var": grads["raw_qx_var"] * 2.0 * s * s / (sig * sig + 1e-12),
    }


class GPOptimizer:
    """Adam grouped by label, hypers at `hyper_lr`, optional NGD on q(X).

    `step(grads)` updates the parameter tensors in place."""

    def __init__(self, params, lr, hyper_lr, clip, skip_nonfinite, ngd_lr):
        self.params = params
        self.clip = clip
        self.skip_nonfinite = skip_nonfinite
        self.ngd_lr = ngd_lr
        self.labels = {k: self._label(k) for k in params}
        self.lrs = {"hyper": hyper_lr, "var": lr}
        any_p = next(iter(params.values()))
        self.count = {g: torch.zeros((), dtype=torch.int64,
                                     device=any_p.device)
                      for g in ("hyper", "var")}
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()
                   if self.labels[k] != "ngd"}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()
                   if self.labels[k] != "ngd"}
        self.notfinite_count = torch.zeros((), dtype=torch.int64,
                                           device=any_p.device)

    def _label(self, k):
        if k in HYPER_PARAM_NAMES:
            return "hyper"
        if self.ngd_lr is not None and k in NGD_NAMES:
            return "ngd"
        return "var"

    @torch.no_grad()
    def step(self, grads):
        keys = list(self.params)
        finite = torch.stack(
            [torch.isfinite(grads[k]).all() for k in keys]).all()
        if self.skip_nonfinite:
            self.notfinite_count = torch.where(
                finite, torch.zeros_like(self.notfinite_count),
                self.notfinite_count + 1)
            apply = finite | (self.notfinite_count > self.skip_nonfinite)
        else:
            apply = torch.ones((), dtype=torch.bool, device=finite.device)

        g_norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in keys))
        clipped = {
            k: torch.where(g_norm < self.clip, grads[k],
                           (grads[k] / g_norm) * self.clip)
            for k in keys
        }
        updates = {}
        for group in ("hyper", "var"):
            members = [k for k in keys if self.labels[k] == group]
            if not members:
                continue
            count = self.count[group] + 1
            bc1 = 1.0 - B1 ** count.to(torch.float64)
            bc2 = 1.0 - B2 ** count.to(torch.float64)
            lr = self.lrs[group]
            for k in members:
                g = clipped[k]
                mu = (1.0 - B1) * g + B1 * self.mu[k]
                nu = (1.0 - B2) * (g * g) + B2 * self.nu[k]
                mu_hat = mu / bc1.to(g.dtype)
                nu_hat = nu / bc2.to(g.dtype)
                updates[k] = -lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
                self.mu[k].copy_(torch.where(apply, mu, self.mu[k]))
                self.nu[k].copy_(torch.where(apply, nu, self.nu[k]))
            self.count[group] = torch.where(apply, count, self.count[group])
        if self.ngd_lr is not None:
            nat = ngd_precondition(clipped, self.params)
            for k in NGD_NAMES:
                updates[k] = -self.ngd_lr * nat[k]
        for k in keys:
            p = self.params[k]
            p.copy_(torch.where(apply, p + updates[k], p))
        return apply


def gp_optimizer(params, lr: float = 1e-2, hyper_lr: float | None = None,
                 clip: float = 100.0, skip_nonfinite: int = 100_000,
                 ngd_lr: float | None = None) -> GPOptimizer:
    """Stability-tuned optimizer of the GP-LVM family: hypers at lr/10,
    global-norm clip, non-finite steps skipped, optional NGD on q(X)."""
    hyper_lr = lr / 10.0 if hyper_lr is None else hyper_lr
    return GPOptimizer(params, lr, hyper_lr, clip, skip_nonfinite, ngd_lr)
