r"""Analytic cost model of the DP-GP-LVM training step and its utilization
on an H100 (counterpart of `dp_gp_lvm_tpu/perf/flops.py`).

The hot op is the per-atom Psi2 statistic: every (n, m, l) cell costs one
exp and ~7 elementwise flops, fed by contractions of depth K = Q. The
counts are the algorithm's work, the reference's rules (per atom and
step; N rows, M inducing, Q latents, D output dims):

forward (K1, fused Psi2 + Psi1^T Y):
    matmul-shaped: the c-contraction 2NM^2Q; t, p 4NMQ; psi1 4NMQ;
                   psi1^T Y 2NMD
    elementwise:   ~7 NM^2
    exp:           NM^2 + NM
backward (K2, the Psi2 pullback, and the analytic psi1 pullback):
    matmul-shaped: recompute 2NM^2Q, pullback ~4NM^2Q + 2NMD + 4NMQ
    elementwise:   ~12 NM^2
    exp:           NM^2 + NM
bound algebra: two Cholesky factors (M^3/3 each) and solves ~4M^2D per
    atom, small next to the psi terms for N >> M.

Achieved over peak is then a model-flops utilization: padding, launch
floors and host time all show as lost utilization. The peaks are the
H100 SXM's public figures; the port's kernels run on its FP32 pipes, not
its tensor cores, so every flop counts against the FP32 peak.

The reference's `StepCosts` has two fields more, `mxu_geom_flops` (the
TPU systolic array's K/128 geometry of its small-K stages) and
`lane_pad` (the TPU's 128-lane register padding of M). Neither has a
counterpart on Hopper's FP32 pipes, which issue per thread and pad
nothing to 128 lanes, so they are left out here.
"""
from __future__ import annotations

from typing import NamedTuple

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): the HBM3
# rate, FP32 outside the tensor cores, and the special-function units
# (16 per SM x 132 SMs x 1.98 GHz boost) that evaluate exp
H100_PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,
    "exp_per_s": 16 * 132 * 1.98e9,
}


class StepCosts(NamedTuple):
    mxu_flops: float          # matmul-shaped flops
    vpu_flops: float          # elementwise flops (without exp)
    transcendentals: float    # exp evaluations
    hbm_bytes: float          # least HBM traffic (inputs and outputs once
    #                           a pass; each atom reads q(X) again)


def dp_step_costs(n, d, q, m, t, dtype_bytes: int = 4) -> StepCosts:
    """Cost of one DP-GP-LVM ELBO and gradient step (forward and
    backward), the reference's counts."""
    nm2 = n * m * m
    # forward, backward recompute and pullback contractions
    mxu = t * (8.0 * nm2 * q + 12.0 * n * m * q + 4.0 * n * m * d)
    vpu = t * 19.0 * nm2
    exp = t * 2.0 * (nm2 + n * m)
    # the bound algebra, per atom
    mxu += t * (2.0 * m ** 3 / 3.0 + 6.0 * m * m * d)
    # mu, s, w read per atom forward and backward, Y twice, the psi2 and
    # psi1^T Y stacks written and their cotangents read, gmu and gs
    hbm = dtype_bytes * (
        2.0 * t * n * (2 * q + 1)
        + 2.0 * n * d
        + 2.0 * t * (m * m + m * d)
        + 2.0 * n * q
    )
    return StepCosts(mxu_flops=mxu, vpu_flops=vpu, transcendentals=exp,
                     hbm_bytes=hbm)


def mfu(step_seconds: float, costs: StepCosts,
        peaks: dict = H100_PEAKS) -> dict:
    """Achieved rates and shares of each peak for a step of
    `step_seconds`.

    `mfu_pct` is all flops (matmul-shaped and elementwise) against the
    FP32 peak, as the reference defines it; `roofline_pct` is the
    binding floor's time against the step's: the largest of the flops'
    time at the FP32 peak ("fp32"), the exps' at the SFU rate ("exp") and
    the bytes' at the HBM rate ("hbm")."""
    total_flops = costs.mxu_flops + costs.vpu_flops
    floors = {"fp32": total_flops / peaks["f32_flops"],
              "exp": costs.transcendentals / peaks["exp_per_s"],
              "hbm": costs.hbm_bytes / peaks["hbm_bytes_per_s"]}
    binding = max(floors, key=floors.get)
    floor = floors[binding]
    return {
        "tflops_achieved": total_flops / step_seconds / 1e12,
        "exp_per_s_achieved": costs.transcendentals / step_seconds,
        "mfu_pct": 100.0 * total_flops / step_seconds / peaks["f32_flops"],
        "roofline_pct": 100.0 * floor / step_seconds,
        "binding_floor": binding,
        "floor_ms": floor * 1e3,
    }
