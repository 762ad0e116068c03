"""The port's cost model (`perf/flops.py`) against the JAX package's: the
step's counts equal the reference's at c4's and at the scale shape, in
both widths; and `mfu`'s fields against the H100 peaks, worked by hand.
No JAX array is made: the reference's model is host arithmetic."""
import math

import pytest

from dp_gp_lvm_tpu.perf import flops as jflops
from dp_gp_lvm_tpu_torch.perf import H100_PEAKS, StepCosts, dp_step_costs, mfu

# (n, d, q, m, t): c4_dp_mocap and the N=8192, M=128 scale shape
SHAPES = ((1024, 59, 10, 64, 20), (8192, 60, 10, 128, 20))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype_bytes", (4, 8))
def test_step_costs_equal_reference(shape, dtype_bytes):
    got = dp_step_costs(*shape, dtype_bytes=dtype_bytes)
    want = jflops.dp_step_costs(*shape, dtype_bytes=dtype_bytes)
    assert set(StepCosts._fields) == set(want._fields) - {"mxu_geom_flops",
                                                          "lane_pad"}
    for field in StepCosts._fields:
        assert getattr(got, field) == getattr(want, field), field


def test_mfu_against_the_h100_peaks():
    assert H100_PEAKS == {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12,
                          "exp_per_s": 16 * 132 * 1.98e9}
    costs = dp_step_costs(*SHAPES[0])
    step = 0.015
    out = mfu(step, costs)
    flops = costs.mxu_flops + costs.vpu_flops
    assert out["tflops_achieved"] == pytest.approx(flops / step / 1e12)
    assert out["exp_per_s_achieved"] == pytest.approx(
        costs.transcendentals / step)
    assert out["mfu_pct"] == pytest.approx(100 * flops / step / 67e12)
    floors = {"fp32": flops / 67e12,
              "exp": costs.transcendentals / H100_PEAKS["exp_per_s"],
              "hbm": costs.hbm_bytes / 3.35e12}
    binding = max(floors, key=floors.get)
    assert out["binding_floor"] == binding
    assert out["floor_ms"] == pytest.approx(1e3 * floors[binding])
    assert out["roofline_pct"] == pytest.approx(
        100 * floors[binding] / step)
    # a step at its floor is at 100% of the roofline
    assert mfu(floors[binding], costs)["roofline_pct"] == pytest.approx(100)
    assert all(math.isfinite(v) for v in out.values()
               if isinstance(v, float))
