"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the card unless told otherwise, and its
small pure functions agree with the JAX package in f64."""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.core import transforms as jtr
from dp_gp_lvm_tpu.distributions import stick_breaking as jsb
from dp_gp_lvm_tpu_torch.core import prng, transforms
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.data.synthetic import (
    mocap_like,
    oil_flow_like,
    toy_gplvm,
)
from dp_gp_lvm_tpu_torch.data.mocap import load_mocap
from dp_gp_lvm_tpu_torch.data.oil_flow import load_oil_flow
from dp_gp_lvm_tpu_torch.distributions import stick_breaking
from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm, serving

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dp_gp_lvm_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "dp_gp_lvm_tpu" or m.startswith("dp_gp_lvm_tpu."))
mods = sorted(m for m in sys.modules if m.startswith("dp_gp_lvm_tpu_torch"))
print(",".join(mods))
print(",".join(bad))
print("matplotlib" in sys.modules)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    walked = set(out[0].split(","))
    on_disk = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "dp_gp_lvm_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    }
    assert on_disk <= walked, on_disk - walked   # every module was imported
    assert {"dp_gp_lvm_tpu_torch.models.prediction",
            "dp_gp_lvm_tpu_torch.models.serving",
            "dp_gp_lvm_tpu_torch.models.bgplvm",
            "dp_gp_lvm_tpu_torch.data.oil_flow",
            "dp_gp_lvm_tpu_torch.data.mocap",
            "dp_gp_lvm_tpu_torch.data.asf",
            "dp_gp_lvm_tpu_torch.data.native_io",
            "dp_gp_lvm_tpu_torch.perf.flops",
            "dp_gp_lvm_tpu_torch.viz.plots",
            "dp_gp_lvm_tpu_torch.parallel.mesh",
            "dp_gp_lvm_tpu_torch.parallel.collectives",
            "dp_gp_lvm_tpu_torch.parallel.auto",
            "dp_gp_lvm_tpu_torch.parallel.recipe",
            "dp_gp_lvm_tpu_torch.parallel.sharded_elbo"} <= walked
    assert out[1] == "", f"port pulled in {out[1]}"
    # the card's machine has no matplotlib: only a plot imports it
    assert out[2] == "False"


# the reference's parallel/ names the port spells otherwise: its sharding
# constructors are the port's placement tags
PARALLEL_RENAMED = {"mesh.data_sharding": "mesh.DATA_SHARDED",
                    "mesh.atom_sharding": "mesh.ATOM_SHARDED",
                    "mesh.replicated": "mesh.REPLICATED"}
# GSPMD's annotation, which torch.distributed has no partitioner for
PARALLEL_JAX_ONLY = {"auto.auto_sharded_value_and_grad"}


def test_every_name_of_the_reference_parallel_package_has_a_counterpart():
    """Every top-level function and constant the reference's `parallel/`
    modules define (the SVI programs, `place_svi` and the SVI tables
    included) is in the port's module of the same name, under its own
    name or the one PARALLEL_RENAMED gives, but for the JAX-only ones."""
    import importlib
    import inspect
    import re

    missing = []
    for mod in ("auto", "mesh", "recipe", "sharded_elbo"):
        ref = importlib.import_module(f"dp_gp_lvm_tpu.parallel.{mod}")
        port = importlib.import_module(f"dp_gp_lvm_tpu_torch.parallel.{mod}")
        src = inspect.getsource(ref)
        for name, obj in vars(ref).items():
            own = (inspect.isfunction(obj) and obj.__module__ == ref.__name__
                   or re.search(rf"^{name} = ", src, re.M) is not None)
            if name.startswith("_") or not own:
                continue
            key = f"{mod}.{name}"
            if key in PARALLEL_JAX_ONLY:
                continue
            mod2, name2 = PARALLEL_RENAMED.get(key, key).split(".")
            target = importlib.import_module(
                f"dp_gp_lvm_tpu_torch.parallel.{mod2}")
            if not hasattr(target, name2):
                missing.append(key)
        assert port.__doc__
    assert not missing, missing


def test_entry_points_without_a_card_raise(monkeypatch):
    """With no CUDA device and no `device`, entry points refuse instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mocap_like(gen, n=16, d=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"z": np.zeros((2, 3, 1))})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oil_flow_like(gen, n=16, d=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toy_gplvm(gen, n=16, d=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_oil_flow(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_mocap(None, n=16, d=3)
    Y, X = mocap_like(gen, n=16, d=3, device="cpu")
    assert Y.device.type == "cpu" and Y.shape == (16, 3) and X.shape == (16, 4)
    bg_cfg = bgplvm.Config(num_latent=2, num_inducing=4)
    bg = bgplvm.init_params(gen, Y, bg_cfg)
    dp_cfg = dp_gp_lvm.Config(num_latent=2, num_inducing=4, truncation=3)
    dp = dp_gp_lvm.init_params(gen, Y, dp_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.make_bgplvm_imputer(bg, Y, bg_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.make_dp_imputer(dp, Y, dp_cfg)
    mask = torch.ones(2, 3, dtype=Y.dtype)
    for impute in (
            serving.make_bgplvm_imputer(bg, Y, bg_cfg, num_steps=2,
                                        device="cpu"),
            serving.make_dp_imputer(dp, Y, dp_cfg, num_steps=2,
                                    device="cpu")):
        mean, var = impute(Y[:2], mask)
        assert mean.device.type == "cpu" and mean.shape == var.shape == (2, 3)


def test_init_params_layout_on_cpu():
    gen = prng.PRNGKey(1)
    Y, _ = mocap_like(gen, n=40, d=7, device="cpu")
    cfg = dp_gp_lvm.Config(num_latent=3, num_inducing=5, truncation=4,
                           learn_alpha=True)
    p = dp_gp_lvm.init_params(gen, Y, cfg)
    shapes = {k: tuple(v.shape) for k, v in p.items()}
    assert shapes == {
        "qx_mean": (40, 3), "raw_qx_var": (40, 3), "z": (4, 5, 3),
        "raw_variance": (4,), "raw_ard": (4, 3), "raw_noise": (4,),
        "phi_logits": (7, 4), "raw_gamma1": (3,), "raw_gamma2": (3,),
        "raw_alpha": (),
    }
    assert all(v.dtype == torch.float64 and v.requires_grad
               for v in p.values())
    np.testing.assert_allclose(Y.mean(0).numpy(), 0.0, atol=1e-12)


def test_transforms_match_jax_beyond_softplus_threshold():
    """softplus is logaddexp(raw, 0) everywhere, also above torch's
    F.softplus threshold of 20."""
    raw = np.array([-40.0, -3.0, 0.0, 2.5, 19.0, 21.0, 35.0])
    for name in ("positive", "positive_noise", "positive_variational_var"):
        got = getattr(transforms, name)(torch.as_tensor(raw)).numpy()
        want = np.asarray(getattr(jtr, name)(jnp.asarray(raw)))
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    val = np.array([1e-3, 0.1, 1.0, 7.0])
    np.testing.assert_allclose(
        transforms.positive_inverse(torch.as_tensor(val)).numpy(),
        np.asarray(jtr.positive_inverse(jnp.asarray(val))), rtol=1e-13)


def test_dp_kl_terms_match_jax():
    r = np.random.default_rng(3)
    logits = r.normal(size=(9, 5))
    phi = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    g1, g2 = r.uniform(0.5, 3.0, 4), r.uniform(0.5, 3.0, 4)
    for lg in (None, logits):
        want = jsb.dp_kl_terms(jnp.asarray(phi), jnp.asarray(g1),
                               jnp.asarray(g2), 1.3,
                               None if lg is None else jnp.asarray(lg))
        got = stick_breaking.dp_kl_terms(
            torch.as_tensor(phi), torch.as_tensor(g1), torch.as_tensor(g2),
            1.3, None if lg is None else torch.as_tensor(lg))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    np.testing.assert_allclose(
        float(stick_breaking.alpha_log_prior(torch.tensor(2.0))),
        float(jsb.alpha_log_prior(2.0)), rtol=1e-15)


def test_mrd_svi_entry_points_without_a_card_raise(monkeypatch):
    """The minibatch MRD's entry points (its data, the q(u)-only predictor,
    the cross-view sampler, the runner) refuse with no card and no device,
    and run where the caller names the CPU."""
    from dp_gp_lvm_tpu_torch.core.config import get
    from dp_gp_lvm_tpu_torch.data.synthetic import two_view_big
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import mrd_svi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        two_view_big(key, n=16, d1=3, d2=2)
    Y1, Y2, _ = two_view_big(key, n=16, d1=3, d2=2, device="cpu")
    cfg = mrd_svi.Config(num_latent=2, num_inducing=4, num_views=2)
    params = mrd_svi.init_params(key, (Y1, Y2), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.make_mrd_svi_predictor(params, cfg, 0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mrd_svi.cross_view_sample(key, params, {0: Y1[:2]}, 1, cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run(get("c9_mrd_svi_bigN"), steps=1)
    mean, var = serving.make_mrd_svi_predictor(params, cfg, 0, 1, num_steps=2,
                                               device="cpu")(Y1[:2])
    f = mrd_svi.cross_view_sample(key, params, {0: Y1[:2]}, 1, cfg, 3,
                                  num_steps=2, num_features=8, device="cpu")
    assert mean.device.type == f.device.type == "cpu"
    assert mean.shape == var.shape == (2, 2) and f.shape == (3, 2, 2)
