"""The port's plots (`viz/plots.py`, matplotlib's Agg backend): each of
the six writes a non-empty PNG from host arrays, as the reference's do,
and `require_matplotlib` passes where matplotlib is installed."""
import os

import numpy as np
import pytest

from dp_gp_lvm_tpu_torch import viz
from dp_gp_lvm_tpu_torch.data import asf

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PNG = b"\x89PNG"


def _cases(tmp_path):
    r = np.random.default_rng(0)
    sk = asf.parse_asf(os.path.join(FIXTURES, "demo.asf"))
    frame = asf.parse_amc_frames(os.path.join(FIXTURES, "demo.amc"))[0]
    return dict(
        latent=lambda p: viz.plot_latent_scatter(
            r.normal(size=(30, 3)), labels=r.integers(0, 3, 30), path=p),
        ard=lambda p: viz.plot_ard_weights(r.uniform(size=(2, 5)), path=p),
        sticks=lambda p: viz.plot_stick_weights(
            r.uniform(1, 2, 4), r.uniform(1, 2, 4), path=p),
        assignments=lambda p: viz.plot_assignment_matrix(
            r.dirichlet(np.ones(4), 6), labels=np.arange(6) % 2, path=p),
        elbo=lambda p: viz.plot_elbo_trace(np.cumsum(r.uniform(size=20)),
                                           path=p),
        skeleton=lambda p: viz.plot_skeleton(asf.fk_frame(sk, frame)[1],
                                             path=p))


@pytest.mark.parametrize("name", ["latent", "ard", "sticks", "assignments",
                                  "elbo", "skeleton"])
def test_each_plot_writes_a_png(tmp_path, name):
    viz.require_matplotlib()
    path = tmp_path / f"{name}.png"
    _cases(tmp_path)[name](str(path))
    assert path.read_bytes()[:4] == PNG
