"""Named experiment configurations and their regression gates
(counterpart of `dp_gp_lvm_tpu/core/config.py`). Only the configurations
whose models the port runs are copied, with their gates: the Bayesian
GP-LVM's `c1_bgplvm_toy` and `c2_sparse_oil`, MRD's `c3_mrd_twoview`, the
DP-GP-LVM's `c4_dp_mocap`, `c5_dp_missing` and `c5_pose_missing`, the
minibatch SVI-GPLVM's `c6_svi_bigN`, the minibatch DP-GP-LVM's
`c7_dp_svi`, the amortized SVI-GPLVM's `c8_amortized_svi` and the
minibatch MRD's `c9_mrd_svi_bigN`: every configuration of the reference.
"""
from __future__ import annotations

import dataclasses
import json
import math


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str
    dataset: str
    n: int
    d: int
    q: int
    m: int = 0
    t: int = 1
    alpha: float = 1.0
    views: tuple[int, ...] = ()
    steps: int = 2000
    lr: float = 1e-2
    psi2_block: int | None = None
    dtype: str = "float32"
    seed: int = 0
    missing_fraction: float = 0.0
    restarts: int = 1
    amortized: bool = False
    noise_floor: float = 0.0
    qx_var_floor: float = 0.0
    ngd_lr: float | None = None
    staged: bool = False
    ard_lr: float | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


CONFIGS: dict[str, ExperimentConfig] = {
    "c1_bgplvm_toy": ExperimentConfig(
        name="c1_bgplvm_toy", model="bgplvm", dataset="toy_gplvm",
        n=100, d=10, q=6, m=20, steps=6000, lr=2e-2,
    ),
    "c2_sparse_oil": ExperimentConfig(
        name="c2_sparse_oil", model="bgplvm", dataset="oil_flow",
        n=1000, d=12, q=10, m=50, steps=3000, lr=1e-2, ngd_lr=1.0,
    ),
    # two views sharing 2 of 4 latent dims, the privates at half weight
    # (`data/synthetic.two_view`): at 1 of 2 dims shared and 2000 steps
    # MRD falls into the "independent encodings" optimum (each view in
    # disjoint latent dims, cross-view ratio ~1.0). This recipe recovers
    # the shared structure; the reference measured a cross-view MSE ratio
    # of 0.645 under Adam and 0.621 with ngd_lr=1.0 (results/c3), against
    # 0.485 for an exact GP given the held-out rows' true shared latents
    # (results/mrd_ceiling.json). Non-convex: 3 restarts, best ELBO kept.
    "c3_mrd_twoview": ExperimentConfig(
        name="c3_mrd_twoview", model="mrd", dataset="two_view",
        n=256, d=16, q=4, m=32, views=(8, 8), steps=8000, lr=2e-2,
        restarts=3, ngd_lr=1.0,
    ),
    "c4_dp_mocap": ExperimentConfig(
        name="c4_dp_mocap", model="dp_gp_lvm", dataset="mocap",
        n=1024, d=59, q=10, m=64, t=20, steps=8000, lr=3e-3, ngd_lr=1.0,
    ),
    "c5_dp_missing": ExperimentConfig(
        name="c5_dp_missing", model="dp_gp_lvm", dataset="mocap",
        n=1024, d=59, q=10, m=64, t=20, steps=8000, lr=3e-3, ngd_lr=1.0,
        missing_fraction=0.5,
    ),
    "c5_pose_missing": ExperimentConfig(
        name="c5_pose_missing", model="dp_gp_lvm", dataset="pose",
        n=512, d=32, q=8, m=48, t=12, steps=6000, lr=3e-3, ngd_lr=1.0,
        missing_fraction=0.5,
    ),
    # minibatch SVI-GPLVM at 128x the full-batch configs' data; batch rows
    # a step come from the runner (1024), held-out dims are imputed from
    # q(u) alone
    "c6_svi_bigN": ExperimentConfig(
        name="c6_svi_bigN", model="svi_gplvm", dataset="mocap",
        n=131072, d=32, q=8, m=64, steps=6000, lr=3e-3, ngd_lr=1.0,
        missing_fraction=0.5, psi2_block=8192,
    ),
    # minibatch DP-GP-LVM at the same N, on four planted groups of output
    # dims that differ in noise (`data/synthetic.grouped_dims_big`); batch
    # rows a step come from the runner (2048), the staged split-init
    # recipe is `train/dp_recipe.py`
    "c7_dp_svi": ExperimentConfig(
        name="c7_dp_svi", model="dp_svi", dataset="grouped_big",
        n=131072, d=32, q=8, m=64, t=8, steps=4000, lr=3e-3, ngd_lr=1.0,
        psi2_block=8192,
    ),
    # c6 with the amortized q(X) (models/amortized.py): a recognition
    # network in place of the 131072 x 8 table, so no device state grows
    # with N (with --stream none at all) and a held-out row's latent is one
    # forward pass. The two floors keep the f32 run from diverging (with Z
    # at the hyper rate and the q(u) trust region, experiments/run.py)
    "c8_amortized_svi": ExperimentConfig(
        name="c8_amortized_svi", model="svi_gplvm", dataset="mocap",
        n=131072, d=32, q=8, m=64, steps=6000, lr=3e-3,
        missing_fraction=0.5, psi2_block=8192, amortized=True,
        noise_floor=1e-3, qx_var_floor=1e-2,
    ),
    # the minibatch MRD (models/mrd_svi.py) at 128x c3's data: one shared
    # q(X), each view its own kernel and whitened q(u^v) by natural
    # gradient, cross-view prediction from q(u) alone. c3's signal regime
    # (2 shared dims, the privates at half weight) through the O(n) RFF
    # generator `two_view_big`; trained by the two-phase recipe of
    # train/mrd_recipe.py. The noise floor guards phase B against the
    # noise runaway (the honest per-view residual is ~0.078)
    "c9_mrd_svi_bigN": ExperimentConfig(
        name="c9_mrd_svi_bigN", model="mrd_svi", dataset="two_view_big",
        n=131072, d=64, q=4, m=32, views=(32, 32), steps=24000, lr=3e-3,
        psi2_block=8192, staged=True, noise_floor=0.05,
    ),
}


def get(name: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]


# Regression gates: metric -> (op, threshold), or a list of them for a
# two-sided gate. A finished run fails (`experiments/run.py --check` exits
# 1) if any gated metric is past its threshold. The thresholds carry
# headroom over the reference's committed artifacts in results/.
CHECKS: dict[str, dict[str, tuple[str, float] | list[tuple[str, float]]]] = {
    "c1_bgplvm_toy": {
        "elbo": (">=", -900.0),
        "ard_recall_top2": (">=", 1.0),       # both true dims in the top 2
        "ard_separation_ratio": (">=", 10.0),  # active vs pruned ARD gap
    },
    "c2_sparse_oil": {
        "elbo": (">=", -9000.0),
    },
    # the reference's calibration runs: elbo -4087, ratio 0.645, pll/dim
    # -1.100; the true-latent ceiling of the ratio is 0.485
    "c3_mrd_twoview": {
        "elbo": (">=", -4700.0),
        # cross-view prediction must beat predicting the training mean
        "cross_view_mse_ratio": ("<=", 0.70),
        "cross_view_pll_per_dim": (">=", -1.3),
        # shared/private structure: the weakest per-view ARD weight (the
        # other view's private dim, generator truth 0) over the mean of
        # the two strongest, max over views; flat relevance gives 1.0
        "ard_cross_private_ratio": ("<=", 0.05),
        # err^2 over the mean predictive variance
        "calibration_ratio": [(">=", 0.2), ("<=", 5.0)],
    },
    "c4_dp_mocap": {
        "elbo": (">=", 7000.0),
    },
    "c5_dp_missing": {
        "imputation_mse": ("<=", 0.01),
        "predictive_loglik_per_dim": (">=", 0.3),
        # err^2 over predictive variance: catches overconfidence
        "calibration_ratio": [(">=", 0.005), ("<=", 5.0)],
    },
    "c5_pose_missing": {
        "imputation_mse": ("<=", 0.15),
        "predictive_loglik_per_dim": (">=", -0.2),
        "calibration_ratio": [(">=", 0.2), ("<=", 5.0)],
    },
    "c6_svi_bigN": {
        "imputation_mse": ("<=", 0.05),
        "predictive_loglik_per_dim": (">=", -0.8),
        "rows_per_sec": (">=", 150000.0),
        # the full-data ELBO in float64 at the trained parameters
        "elbo": (">=", -6.0e6),
        "calibration_ratio": [(">=", 0.01), ("<=", 5.0)],
    },
    # the reference's calibration run: elbo -4.33e6, purity 0.75, 4 of 4
    # groups on distinct atoms, pll/dim -0.844, calibration 0.639
    "c7_dp_svi": {
        "elbo": (">=", -5.0e6),
        # every planted group's dims mostly on one atom ...
        "group_purity_min": (">=", 0.6),
        # ... and the four groups on four distinct atoms
        "distinct_atoms_for_groups": (">=", 4.0),
        "rows_per_sec": (">=", 100000.0),
        "predictive_loglik_per_dim": (">=", -1.15),
        "calibration_ratio": [(">=", 0.1), ("<=", 5.0)],
    },
    # the reference's calibration run: mse 0.0079, pll/dim +0.153, f64
    # elbo -1.15e6, calibration 0.073
    "c8_amortized_svi": {
        "imputation_mse": ("<=", 0.02),
        "predictive_loglik_per_dim": (">=", -0.15),
        "rows_per_sec": (">=", 280000.0),
        # two-sided: the noise floor caps any valid bound on this data at
        # ~+1.2e7; a diverged f32 run once reported +4.56e8
        "elbo": [(">=", -1.35e6), ("<=", 1.2e7)],
        "calibration_ratio": [(">=", 0.01), ("<=", 5.0)],
    },
    # the reference's calibration run: elbo -1.87e6, mse ratio 0.429,
    # pll/dim -0.889, calibration 1.33, ARD ratio 0.161, 341k rows/s
    "c9_mrd_svi_bigN": {
        "elbo": (">=", -2.15e6),
        "cross_view_mse_ratio": ("<=", 0.56),
        "cross_view_pll_per_dim": (">=", -1.19),
        "rows_per_sec": (">=", 170000.0),
        # flat relevance gives 1.0; a hypers-only staged run stalled at 0.70
        "ard_cross_private_ratio": ("<=", 0.3),
        # the overconfident single-phase hot run sat at 17.8
        "calibration_ratio": [(">=", 0.2), ("<=", 5.0)],
    },
}

_OPS = {
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
}


def _walk_numeric(obj, path, out):
    if isinstance(obj, bool):
        return
    if isinstance(obj, (int, float)):
        out.append((path, float(obj)))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk_numeric(v, f"{path}.{k}" if path else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk_numeric(v, f"{path}[{i}]", out)


def evaluate_checks(name: str, result: dict) -> list[str]:
    """Human-readable failures of a finished run (empty: all gates pass).

    Every numeric leaf of `result` must be finite, gated or not; then each
    gate of `CHECKS[name]` must hold, and a gated metric missing from the
    result fails."""
    failures = []
    numerics: list[tuple[str, float]] = []
    _walk_numeric(result, "", numerics)
    for path, value in numerics:
        if math.isnan(value) or math.isinf(value):
            failures.append(f"{path}: non-finite value {value}")
    for metric, gates in CHECKS.get(name, {}).items():
        if metric not in result or result[metric] is None:
            failures.append(f"{metric}: MISSING from result")
            continue
        value = result[metric]
        if isinstance(gates, tuple):
            gates = [gates]
        for op, threshold in gates:
            if not _OPS[op](value, threshold):
                failures.append(
                    f"{metric}: {value:.6g} not {op} {threshold:.6g}"
                )
    return failures
