"""Named experiment configurations (counterpart of
`dp_gp_lvm_tpu/core/config.py`). Only the configuration this slice of the
port trains is copied: `c4_dp_mocap`, the DP-GP-LVM on mocap-shaped data.
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
    "c4_dp_mocap": ExperimentConfig(
        name="c4_dp_mocap", model="dp_gp_lvm", dataset="mocap",
        n=1024, d=59, q=10, m=64, t=20, steps=8000, lr=3e-3, ngd_lr=1.0,
    ),
}
