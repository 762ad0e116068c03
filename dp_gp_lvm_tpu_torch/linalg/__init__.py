from dp_gp_lvm_tpu_torch.linalg.chol import (  # noqa: F401
    logdet_from_chol,
    safe_cholesky,
    safe_cholesky_spec,
    tri_solve,
)
