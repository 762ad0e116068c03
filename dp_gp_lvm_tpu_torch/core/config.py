"""Named experiment configurations (counterpart of
`dp_gp_lvm_tpu/core/config.py`). Only the configurations whose models the
port runs are copied: the Bayesian GP-LVM's `c1_bgplvm_toy` and
`c2_sparse_oil`, and the DP-GP-LVM's `c4_dp_mocap` and `c5_dp_missing`.
"""
from __future__ import annotations

import dataclasses
import json


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
    "c4_dp_mocap": ExperimentConfig(
        name="c4_dp_mocap", model="dp_gp_lvm", dataset="mocap",
        n=1024, d=59, q=10, m=64, t=20, steps=8000, lr=3e-3, ngd_lr=1.0,
    ),
    "c5_dp_missing": ExperimentConfig(
        name="c5_dp_missing", model="dp_gp_lvm", dataset="mocap",
        n=1024, d=59, q=10, m=64, t=20, steps=8000, lr=3e-3, ngd_lr=1.0,
        missing_fraction=0.5,
    ),
}
