from dp_gp_lvm_tpu_torch.core.types import (  # noqa: F401
    JitterPolicy,
    resolve_device,
)
