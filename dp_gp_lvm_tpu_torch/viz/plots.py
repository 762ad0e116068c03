"""Plots of a trained model (counterpart of `dp_gp_lvm_tpu/viz/plots.py`):
the latent-space scatter, ARD-weight bars, stick weights, the DP
assignment heatmap, ELBO traces and a 3D skeleton. matplotlib with the
headless Agg backend, imported only when a plot is drawn; every function
takes host numpy arrays (or CPU tensors), off the training path. The
card's machine may have no matplotlib: `require_matplotlib` says so
before a run is started.
"""
from __future__ import annotations

import numpy as np


def require_matplotlib() -> None:
    """Raise ImportError now, with what to do, where matplotlib is
    missing: the runner's --plots asks this before it trains."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "--plots needs matplotlib, which this machine does not have; "
            "run without --plots, or plot the run's params.npz on a host "
            "that has it") from e


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_latent_scatter(x_mean, labels=None, dims=(0, 1), path=None, ax=None):
    """Scatter of q(X) means on two latent dims, colored by labels."""
    plt = _plt()
    x = np.asarray(x_mean)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5))
    else:
        fig = ax.figure
    c = None if labels is None else np.asarray(labels)
    sc = ax.scatter(x[:, dims[0]], x[:, dims[1]], c=c, s=12, cmap="tab10")
    ax.set_xlabel(f"latent dim {dims[0]}")
    ax.set_ylabel(f"latent dim {dims[1]}")
    if labels is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_ard_weights(ard, path=None, ax=None, label=None):
    """Bar chart of ARD weights — the dimension-selection readout."""
    plt = _plt()
    w = np.asarray(ard)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 3))
    else:
        fig = ax.figure
    if w.ndim == 1:
        ax.bar(np.arange(len(w)), w, label=label)
    else:  # (views/atoms, Q)
        width = 0.8 / w.shape[0]
        for i, row in enumerate(w):
            ax.bar(np.arange(len(row)) + i * width, row, width=width,
                   label=f"{label or 'series'} {i}")
        ax.legend(fontsize=7)
    ax.set_xlabel("latent dimension")
    ax.set_ylabel("ARD weight")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_stick_weights(gamma1, gamma2, path=None, ax=None):
    """Expected stick-breaking mixture weights E[pi_t] (mean sticks)."""
    plt = _plt()
    g1, g2 = np.asarray(gamma1), np.asarray(gamma2)
    v = g1 / (g1 + g2)
    pis, rem = [], 1.0
    for vt in v:
        pis.append(vt * rem)
        rem *= 1.0 - vt
    pis.append(rem)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 3))
    else:
        fig = ax.figure
    ax.bar(np.arange(len(pis)), pis)
    ax.set_xlabel("atom t")
    ax.set_ylabel("E[pi_t]")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_assignment_matrix(phi, labels=None, path=None, ax=None):
    """Heatmap of the assignment posterior phi (D x T)."""
    plt = _plt()
    p = np.asarray(phi)
    if labels is not None:
        order = np.argsort(np.asarray(labels))
        p = p[order]
    if ax is None:
        fig, ax = plt.subplots(figsize=(4, 6))
    else:
        fig = ax.figure
    im = ax.imshow(p, aspect="auto", cmap="viridis", vmin=0, vmax=1)
    ax.set_xlabel("atom t")
    ax.set_ylabel("output dimension d (sorted)")
    fig.colorbar(im, ax=ax, shrink=0.8)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_elbo_trace(elbos, path=None, ax=None):
    plt = _plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 3))
    else:
        fig = ax.figure
    ax.plot(np.asarray(elbos))
    ax.set_xlabel("step")
    ax.set_ylabel("ELBO")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_skeleton(segments, path=None, ax=None, elev=15, azim=-70):
    """3D stick-figure render of one FK'd mocap frame.

    segments: list of (start (3,), end (3,)) from data/asf.py::fk_frame.
    """
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=(5, 6))
        ax = fig.add_subplot(111, projection="3d")
    else:
        fig = ax.figure
    for s, e in segments:
        ax.plot([s[0], e[0]], [s[2], e[2]], [s[1], e[1]],
                "o-", color="tab:blue", ms=2, lw=1.5)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax
