"""Staged training schedules (counterpart of `dp_gp_lvm_tpu/train/staged.py`):
train in stages, e.g. q(X) and the inducing inputs with the kernel
hyperparameters frozen, then everything. Each stage is (num_steps,
predicate), predicate(name) saying whether the top-level parameter `name`
trains in that stage, and each stage starts a fresh optimizer.

The optimizer is the reference's
    chain(clip_by_global_norm(clip), masked(adam(lr), trainable),
          masked(set_to_zero(), frozen))
as a `train.loop.GPOptimizer` with a trainable group and a frozen one:
the clip comes first, so the frozen leaves' gradients count in its global
norm; a frozen leaf gets a zero update and has no Adam moments; Adam's
count (one, as optax's) advances every step.
"""
from __future__ import annotations

from typing import Callable, Sequence

from dp_gp_lvm_tpu_torch.train.loop import (
    GPOptimizer,
    flat_leaves,
    leaf_name,
    make_step_fn,
)


def masked_optimizer(lr: float, params, trainable: Callable[[str], bool],
                     clip: float = 1e3) -> GPOptimizer:
    """Adam at `lr` over the parameters `trainable` selects, after a
    global-norm clip over all of them; the rest held. It updates the
    tensors of `params` in place."""
    leaves = flat_leaves(params)
    labels = {k: "var" if trainable(leaf_name(k)) else "frozen"
              for k in leaves}
    return GPOptimizer(leaves, labels, {"var": lr}, clip=clip,
                       skip_nonfinite=0)


def variational_only(name: str) -> bool:
    """Stage 1: q(X) (table or recognition net), inducing inputs and
    assignments train; the hypers are frozen."""
    return (name in ("qx_mean", "raw_qx_var", "z", "phi_logits")
            or name.startswith("enc_"))


def everything(name: str) -> bool:
    return True


def staged_fit(loss_fn: Callable, params, data: tuple,
               stages: Sequence[tuple[int, Callable[[str], bool]]] = None,
               lr: float = 1e-2, callback: Callable | None = None):
    """Run a stage schedule on `params` (updated in place); returns
    (params, the ELBO of each stage's last step). `loss_fn(params, *data)`;
    `callback(i, metrics)` after every step. The default schedule is the
    reference's: 200 steps variational-only, then 1000 of everything."""
    if stages is None:
        stages = [(200, variational_only), (1000, everything)]
    elbos = []
    for num_steps, pred in stages:
        opt = masked_optimizer(lr, params, pred)
        step = make_step_fn(lambda _, *d: loss_fn(params, *d), opt)
        metrics = None
        for i in range(num_steps):
            metrics = step(*data)
            if callback is not None:
                callback(i, metrics)
        elbos.append(float(metrics["elbo"]) if metrics else None)
    return params, elbos
