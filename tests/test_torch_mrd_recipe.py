"""The port's two-phase MRD-SVI recipe (`train/mrd_recipe.py`): `plan`
against the reference's; the reference's `tests/test_mrd_recipe.py`
cases (`recalibrated` keeps the predictive mean, phase B holds `raw_ard`
and `raw_variance` to the bit and moves the noise, the resume from
`phaseA.npz` ends on the uninterrupted run's bits); and the recipe
against the JAX package's on the same keys, in float64 on the CPU at the
reference test's N=64, views (6, 7), Q=3, M=8, 16 rows a step, 24 steps
in chunks of 4: the phase-A boundary and the end agree at 1e-8 (the
PCA's column signs are the host LAPACK's, an exact symmetry, compared up
to them). The JAX recipe runs once, in a module-scoped fixture."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import mrd_svi as jms
from dp_gp_lvm_tpu.train import mrd_recipe as jrecipe
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.transforms import positive
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import mrd_svi
from dp_gp_lvm_tpu_torch.train import mrd_recipe
from dp_gp_lvm_tpu_torch.train.loop import flat_leaves

N, CHUNK, STEPS = 64, 4, 24


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg():
    return dict(num_latent=3, num_inducing=8, num_views=2, batch=16)


def _jax_drive(step_fn, state, n_steps, rng, Ys, label=""):
    """The reference test's drive: chunks of steps, step i on
    fold_in(rng, i)."""
    def one(st, r):
        st, m = step_fn(st, r, Ys)
        return st, m["loss"]

    @jax.jit
    def multi(st, start):
        keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(
            start + jnp.arange(CHUNK))
        return jax.lax.scan(one, st, keys)

    done = int(state.step)
    while done < n_steps:
        state, _ = multi(state, jnp.int32(done))
        done += CHUNK
    return state, float("nan"), 0.0


def _drive(step_fn, state, n_steps, key, Ys, label=""):
    """The same drive on the port."""
    idx = step_fn.indices(prng.fold_in(key, torch.arange(state.step,
                                                         n_steps)))
    losses = torch.stack([step_fn(state.step + i, idx[i], Ys)
                          for i in range(n_steps - state.step)])
    assert torch.isfinite(losses).all(), f"{label}loss not finite"
    state.step = n_steps
    return state, float("nan"), 0.0


def _views():
    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(3), n=N, d1=6, d2=7,
                                   device="cpu")
    return (Y1, Y2)


def _run(ckpt_dir=None, resume=False):
    Ys = _views()
    state, _, info = mrd_recipe.staged_mrd_svi(
        prng.PRNGKey(2), prng.PRNGKey(100), Ys, mrd_svi.Config(**_cfg()), N,
        steps=STEPS, chunk=CHUNK, lr=1e-2, drive=_drive, ckpt_dir=ckpt_dir,
        resume=resume, log=lambda s: None)
    return Ys, state, info


def _flat_np(tree):
    return {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in flat_leaves(tree).items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_stages"))
    Y1, Y2, _ = jsyn.two_view(jax.random.PRNGKey(3), n=N, d1=6, d2=7)
    state, _, info = jrecipe.staged_mrd_svi(
        jax.random.PRNGKey(2), jax.random.PRNGKey(100), (Y1, Y2),
        jms.Config(**_cfg()), N, steps=STEPS, chunk=CHUNK, lr=1e-2,
        drive=_jax_drive, ckpt_dir=d, log=lambda s: None)
    with np.load(os.path.join(d, "phaseA.npz")) as f:
        boundary = {k.replace("/", "."): f[k] for k in f.files}
    return {"boundary": boundary,
            "final": _flat_np(jax.tree.map(np.asarray, state.params)),
            "info": info}


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stages"))
    Ys, state, info = _run(ckpt_dir=d)
    return d, Ys, state, info


def test_plan_matches_reference():
    for steps, chunk in ((24, 4), (24000, 250), (500, 250), (40, 20),
                         (7, 5)):
        assert mrd_recipe.plan(steps, chunk) == jrecipe.plan(steps, chunk)
    assert mrd_recipe.plan(500, 250) == {"phase_a_steps": 250,
                                         "phase_b_steps": 250}


def test_recalibrated_keeps_predictive_mean():
    """sigma_f^2 reset with the whitened q(u^v) mean rescaled: the
    predictive mean stays put to the jitter's mismatch of K^{-1/2}."""
    Ys = _views()
    cfg = mrd_svi.Config(**_cfg())
    params = mrd_svi.init_params(prng.PRNGKey(0), Ys, cfg)
    with torch.no_grad():
        for v, vp in enumerate(params["views"]):
            vp["u_mean"].copy_(prng.normal(prng.PRNGKey(v),
                                           tuple(vp["u_mean"].shape),
                                           torch.float64))
            vp["raw_variance"] -= 2.0                  # collapse-ish
    x = prng.normal(prng.PRNGKey(9), (12, 3), torch.float64)
    s = 0.05 * torch.ones_like(x)
    new = mrd_recipe.recalibrated(params, reset_variance=0.4,
                                  reset_noise=0.25)
    for v in range(2):
        with torch.no_grad():
            before = mrd_svi.predict_view(params, x, s, v, cfg)[0]
            after = mrd_svi.predict_view(new, x, s, v, cfg)[0]
        np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(
            float(positive(new["views"][v]["raw_variance"])), 0.4,
            rtol=1e-12)
        np.testing.assert_allclose(
            float(positive(new["views"][v]["raw_noise"])), 0.25, rtol=1e-12)
    # the resident q(X) variance floored at 0.05
    assert float(positive(new["raw_qx_var"]).min()) >= 0.05 - 1e-12


def test_phase_b_pins_structure_and_moves_the_noise(straight):
    d, Ys, state, info = straight
    assert info["phase_a_steps"] + info["phase_b_steps"] == STEPS
    assert "resumed_from" not in info
    assert os.listdir(d) == ["phaseA.npz"]
    params = mrd_svi.nested(state.params)
    recal = mrd_recipe.recalibrated(
        mrd_recipe._load_boundary(d, "cpu"), 0.4, 0.25)
    for vp, want in zip(params["views"], recal["views"]):
        for k in mrd_recipe.FROZEN_STRUCTURE:
            assert torch.equal(vp[k], want[k]), k
        assert float(positive(vp["raw_noise"].detach())) != 0.25
    with torch.no_grad():
        assert np.isfinite(float(mrd_svi.elbo(params, Ys,
                                              mrd_svi.Config(**_cfg()))))


def test_resume_bit_identical(straight, tmp_path):
    d, _, state_full, _ = straight
    with open(os.path.join(d, "phaseA.npz"), "rb") as src, \
            open(tmp_path / "phaseA.npz", "wb") as dst:
        dst.write(src.read())
    _, state_res, info = _run(ckpt_dir=str(tmp_path), resume=True)
    assert info["resumed_from"] == mrd_recipe.PHASE_A
    assert list(state_res.params) == list(state_full.params)
    for k, v in state_full.params.items():
        assert torch.equal(v, state_res.params[k]), k


def test_recipe_matches_reference_at_the_boundary_and_the_end(ref,
                                                               straight):
    d, _, state, info = straight
    assert {k: v for k, v in info.items() if k not in (
        "per_step", "seconds")} == {k: v for k, v in ref["info"].items()
                                    if k not in ("per_step", "seconds")}
    with np.load(os.path.join(d, "phaseA.npz")) as f:
        got = {"boundary": {k.replace("/", "."): f[k] for k in f.files},
               "final": {k: v.detach().numpy()
                         for k, v in state.params.items()}}
    sign = np.sign(np.sum(got["boundary"]["qx_mean"]
                          * ref["boundary"]["qx_mean"], axis=0))
    assert (sign != 0).all()
    for where in ("boundary", "final"):
        assert set(got[where]) == set(ref[where]), where
        for k, want in ref[where].items():
            g = got[where][k]
            if k == "qx_mean" or k.endswith(".z"):
                g = g * sign
            np.testing.assert_allclose(
                g, want, rtol=1e-8,
                atol=1e-8 * max(np.abs(want).max(), 1e-300),
                err_msg=f"{where} {k}")

