from dp_gp_lvm_tpu_torch.linalg.chol import (  # noqa: F401
    add_jitter,
    cho_solve,
    logdet_from_chol,
    safe_cholesky,
    safe_cholesky_members,
    safe_cholesky_spec,
    solve_psd,
    tri_solve,
)
