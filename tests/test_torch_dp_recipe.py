"""The port's staged split-init recipe (`train/dp_recipe.py`): the
reference's `tests/test_dp_recipe.py` cases without a mesh or an amortized
q(X) (end to end, the boundaries written, a resume from the warmup's
boundary ending on the uninterrupted run's bits, `resume=False` ignoring
checkpoints), and the port's recipe against the JAX package's at every
stage boundary and at the end, in float64 on the CPU, at the reference
test's N=64, D=8, Q=2, M=8, T=3, batch 16 and 20 steps (70 with the
warmup's floor of 50). The JAX recipe runs once, in a module-scoped
fixture."""
import os

import jax
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import dp_svi as jdp
from dp_gp_lvm_tpu.train import dp_recipe as jrecipe
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import dp_svi
from dp_gp_lvm_tpu_torch.train import dp_recipe

STAGES = (dp_recipe.STAGE_SPLIT, dp_recipe.STAGE_WARM,
          dp_recipe.STAGE_ASSIGN)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_drive(step_fn, state, n_steps, rng, Y, label=""):
    """The reference test's drive: a scan over split(rng, n_steps)."""
    def one(st, r):
        st, m = step_fn(st, r, Y)
        return st, m["loss"]

    state, _ = jax.jit(lambda st, rr: jax.lax.scan(one, st, rr))(
        state, jax.random.split(rng, n_steps))
    return state, float("nan"), 0.0


def _drive(step_fn, state, n_steps, key, Y, label=""):
    """The same drive on the port: step i on the i-th key of
    split(key, n_steps)."""
    idx = step_fn.indices(prng.split(key, n_steps))
    losses = torch.stack([step_fn(state.step + i, idx[i], Y)
                          for i in range(n_steps)])
    assert torch.isfinite(losses).all(), f"{label}loss not finite"
    state.step += n_steps
    return state, float("nan"), 0.0


def _cfg():
    return dp_svi.Config(num_latent=2, num_inducing=8, truncation=3,
                         batch=16)


def _run(ckpt_dir=None, resume=False):
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(3), n=64,
                                     dims_per_group=(4, 4), q=2, noise=0.01,
                                     device="cpu")
    state, _, info = dp_recipe.staged_dp_svi(
        prng.PRNGKey(1), prng.PRNGKey(101), Y, _cfg(), Y.shape[0], steps=20,
        chunk=5, lr=1e-2, ngd_lr=None, drive=_drive, ckpt_dir=ckpt_dir,
        resume=resume, log=lambda s: None)
    return Y, state, info


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX recipe's boundaries (as written) and final parameters."""
    d = str(tmp_path_factory.mktemp("jax_stages"))
    Y, _, _ = jsyn.grouped_dims(jax.random.PRNGKey(3), n=64,
                                dims_per_group=(4, 4), q=2, noise=0.01)
    cfg = jdp.Config(num_latent=2, num_inducing=8, truncation=3, batch=16)
    state, _, info = jrecipe.staged_dp_svi(
        jax.random.PRNGKey(1), jax.random.PRNGKey(101), Y, cfg, Y.shape[0],
        steps=20, chunk=5, lr=1e-2, ngd_lr=None, drive=_jax_drive,
        ckpt_dir=d, log=lambda s: None)
    out = {s: dict(np.load(os.path.join(d, s + ".npz"))) for s in STAGES}
    out["final"] = {k: np.asarray(v) for k, v in state.params.items()}
    out["info"] = info
    return out


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The port's uninterrupted run with its boundaries."""
    d = str(tmp_path_factory.mktemp("stages"))
    Y, state, info = _run(ckpt_dir=d)
    return d, Y, state, info


def test_staged_recipe_end_to_end(straight):
    _, Y, state, info = straight
    assert info["recipe"].startswith("split-init")
    assert info["stage1_steps"] + info["stage2_steps"] >= 20
    assert "resumed_from" not in info
    p = state.params
    assert p["u_h"].shape[0] == _cfg().truncation
    with torch.no_grad():
        assert torch.isfinite(dp_svi.elbo(p, Y, _cfg()))


def test_stage_boundaries_written(straight):
    d = straight[0]
    for stage in STAGES:
        assert os.path.exists(os.path.join(d, stage + ".npz")), stage
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_resume_bit_identical(straight, tmp_path):
    """Keep the split and warmup boundaries of a run, drop the
    assignment's, resume: the final parameters are the uninterrupted
    run's, bit for bit."""
    d, _, state_full, _ = straight
    for stage in STAGES[:2]:
        with open(os.path.join(d, stage + ".npz"), "rb") as src, \
                open(tmp_path / (stage + ".npz"), "wb") as dst:
            dst.write(src.read())
    _, state_res, info = _run(ckpt_dir=str(tmp_path), resume=True)
    assert info["resumed_from"] == dp_recipe.STAGE_WARM
    assert list(state_res.params) == list(state_full.params)
    for k, v in state_full.params.items():
        assert torch.equal(v, state_res.params[k]), k


def test_resume_false_ignores_checkpoints(straight):
    _, _, info = _run(ckpt_dir=straight[0], resume=False)
    assert "resumed_from" not in info


def test_plan_matches_reference():
    for steps, chunk in ((20, 5), (4000, 250), (250, 125), (40, 20),
                         (6000, 250)):
        assert dp_recipe.plan(steps, chunk) == jrecipe.plan(steps, chunk)


def test_recipe_matches_reference_at_every_boundary(ref, straight):
    """The same keys in the same order at every stage: the boundaries and
    the end agree in float64 (the stage-1 PCA's column signs are the host
    LAPACK's, an exact symmetry of the model, compared up to them)."""
    d, _, state, info = straight
    assert {k: info[k] for k in ("stage1_steps", "stage2_steps", "recipe")} \
        == {k: ref["info"][k] for k in ("stage1_steps", "stage2_steps",
                                        "recipe")}
    got = {s: dict(np.load(os.path.join(d, s + ".npz"))) for s in STAGES}
    got["final"] = {k: v.detach().numpy() for k, v in state.params.items()}
    sign = np.sign(np.sum(got[STAGES[0]]["qx_mean"]
                          * ref[STAGES[0]]["qx_mean"], axis=0))
    for stage, want in ((s, ref[s]) for s in STAGES + ("final",)):
        assert set(got[stage]) == set(want), stage
        for k, v in want.items():
            g = got[stage][k]
            if k in ("qx_mean", "z"):
                g = g * sign
            np.testing.assert_allclose(g, v, rtol=1e-7, atol=1e-9,
                                       err_msg=f"{stage} {k}")
