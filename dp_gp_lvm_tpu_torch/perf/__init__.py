from dp_gp_lvm_tpu_torch.perf.flops import (  # noqa: F401
    H100_PEAKS,
    StepCosts,
    dp_step_costs,
    mfu,
)
