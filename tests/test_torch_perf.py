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


# kernel names as torch.profiler prints them on the card (the c4, c6 and
# tiled m256 paths), with the launch family each closes, or None
TRACE_NAMES = [
    ("void (anonymous namespace)::reduce_chunks<true>(float const*, int, "
     "(anonymous namespace)::Dims, float*, float*)", "suffstats_batched"),
    ("void (anonymous namespace)::reduce_tiled<true>(float const*, "
     "(anonymous namespace)::TiledDims, float*, float*)", "suffstats_batched"),
    ("void (anonymous namespace)::reduce_chunks<false>(float const*, int, "
     "(anonymous namespace)::Dims, float*, float*)", "psi2"),
    ("void (anonymous namespace)::reduce_tiled<false>(float const*, "
     "(anonymous namespace)::TiledDims, float*, float*)", "psi2"),
    ("void (anonymous namespace)::finish_kernel(float const*, float const*, "
     "float const*, float const*, (anonymous namespace)::Outputs, "
     "(anonymous namespace)::Dims, int, int)", "psi2_bwd_batched"),
    ("void (anonymous namespace)::finish_tiled_kernel(float const*, float "
     "const*, float const*, float const*, (anonymous namespace)::Outputs, "
     "(anonymous namespace)::TiledDims, int, int)", "psi2_bwd_batched"),
    ("void (anonymous namespace)::psi1_kernel<10>(float const*, float "
     "const*, float const*, float const*, float const*, float const*, "
     "float*, int, int, int, int)", "psi1"),
    ("void (anonymous namespace)::suffstats_kernel<10, 64, true>(float "
     "const*, float const*, float const*)", None),
    ("void (anonymous namespace)::psi2_bwd_kernel<10, 16, false>(float "
     "const*, float const*)", None),
    ("void (anonymous namespace)::p1y_tiled_kernel<10>(float const*)", None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float> > >(at::native::ReduceOp<float>)",
     None),
    ("void potrf_cta_lower_batch<float, float, 16>(int, int, int, float**, "
     "unsigned long, int*)", None),
    ("finish_kernel(float const*)", None),          # not one of ours
]


@pytest.mark.parametrize("name,family", TRACE_NAMES)
def test_trace_names_map_to_their_launch_family(name, family):
    from dp_gp_lvm_tpu_torch.perf import launches

    assert launches.family_of(name) == family


def test_traced_launches_fold_k4_and_k5_and_match_the_wrappers():
    """Every wrapper key has a family; a trace of one c9-like step (K1 and
    K2 twice) and of a Bayesian GP-LVM step (K6, K5, K2) counts as the
    host counts fold; each closing kernel is a kernel of csrc."""
    import pathlib
    import re

    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.perf import launches

    assert set(launches.FAMILY) == set(psi.LAUNCHES)
    names = dict((fam, n) for n, fam in TRACE_NAMES if fam)
    trace = [(n, 2) for n, fam in TRACE_NAMES[:1] + TRACE_NAMES[4:5]] + [
        (n, 7) for n, fam in TRACE_NAMES if fam is None]
    want = dict.fromkeys(psi.LAUNCHES, 0)
    want.update(suffstats_batched=2, psi2_bwd_batched=2)
    assert launches.traced(trace) == launches.families(want)
    want = dict.fromkeys(psi.LAUNCHES, 0)
    want.update(psi1=1, psi2_single=1, psi2_batched=2, psi2_bwd_batched=1)
    trace = [(names["psi1"], 1), (names["psi2"], 3),
             (names["psi2_bwd_batched"], 1)]
    assert launches.traced(trace) == launches.families(want) == {
        "psi1": 1, "psi2": 3, "psi2_bwd_batched": 1, "suffstats_batched": 0}
    csrc = pathlib.Path(launches.__file__).parents[1] / "csrc"
    source = "".join(p.read_text() for p in csrc.glob("*.cu"))
    for name, _ in launches._CLOSING:
        assert re.search(rf"^{name}\(", source, re.M) or re.search(
            rf"\b{name}<(true|false)><<<", source), name


def test_launches_count_on_the_card_beside_the_host():
    """`count_on_card` makes one counter a wrapper; a launch adds one on
    the host and one to its counter; a reset zeroes both; off, nothing is
    counted but on the host. (On the CPU no wrapper launches, so the
    launch is called directly.)"""
    from dp_gp_lvm_tpu_torch.ops import psi

    psi.reset_launch_counts()
    psi.count_on_card("cpu")
    try:
        assert psi.card_counts() == dict.fromkeys(psi.LAUNCHES, 0)
        psi._launched("psi1")
        psi._launched("suffstats_batched")
        psi._launched("psi1")
        assert psi.card_counts() == dict(psi.LAUNCHES) == {
            **dict.fromkeys(psi.LAUNCHES, 0), "psi1": 2,
            "suffstats_batched": 1}
        psi.reset_launch_counts()
        assert psi.card_counts() == dict(psi.LAUNCHES) == dict.fromkeys(
            psi.LAUNCHES, 0)
    finally:
        psi.count_on_card(None)
    psi._launched("psi1")
    assert psi.card_counts() == {} and psi.LAUNCHES["psi1"] == 1
    psi.reset_launch_counts()
