from dp_gp_lvm_tpu_torch.viz.plots import (  # noqa: F401
    plot_ard_weights,
    plot_assignment_matrix,
    plot_elbo_trace,
    plot_latent_scatter,
    plot_skeleton,
    plot_stick_weights,
    require_matplotlib,
)
