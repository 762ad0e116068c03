"""The port's two-phase MRD-SVI recipe (`train/mrd_recipe.py`) against
the JAX package's at c9's own widths and floors (two views of 32 dims,
Q=4, M=32, 1024 aligned rows a step, the noise floor 0.05, the psi2
block) on 2048 rows of `two_view_big`, in float64 on the CPU, through
both phases on the same keys: every leaf at 1e-8, up to the PCA's column
signs. The tiny-shape cases are in `tests/test_torch_mrd_recipe.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import mrd_svi as jms
from dp_gp_lvm_tpu.train import mrd_recipe as jrecipe
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.models import mrd_svi
from dp_gp_lvm_tpu_torch.train import mrd_recipe
from dp_gp_lvm_tpu_torch.train.loop import flat_leaves


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _drive(step_fn, state, n_steps, key, Ys, label=""):
    """The runner's drive without its chunks: step t on fold_in(key, t)."""
    idx = step_fn.indices(prng.fold_in(key, torch.arange(state.step,
                                                         n_steps)))
    for i in range(n_steps - state.step):
        step_fn(state.step + i, idx[i], Ys)
    state.step = n_steps
    return state, float("nan"), 0.0


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flat_leaves(tree).items()}


C9_N, C9_STEPS, C9_CHUNK = 2048, 20, 5


@pytest.fixture(scope="module")
def at_c9_widths(tmp_path_factory):
    """The reference's recipe and the port's at c9's widths (two views of
    32 dims, Q=4, M=32, 1024 aligned rows a step, its noise floor and
    psi2 block) on 2048 rows of `two_view_big`, the same keys, f64."""
    kw = dict(num_latent=4, num_inducing=32, num_views=2, batch=1024,
              psi2_block=8192, noise_floor=0.05, view_dims=(32, 32))
    Y1, Y2, _ = jsyn.two_view_big(jax.random.PRNGKey(0), n=C9_N,
                                  dtype=jnp.float64)
    d = str(tmp_path_factory.mktemp("c9_jax"))
    state, _, _ = jrecipe.staged_mrd_svi(
        jax.random.PRNGKey(0), jax.random.PRNGKey(100), (Y1, Y2),
        jms.Config(**kw), C9_N, steps=C9_STEPS, chunk=C9_CHUNK, lr=3e-3,
        drive=_jax_drive_every(C9_CHUNK), ckpt_dir=d, log=lambda s: None)
    ref = _flat_np(jax.tree.map(np.asarray, state.params))
    Ys = synthetic.two_view_big(prng.PRNGKey(0), n=C9_N, device="cpu")[:2]
    d = str(tmp_path_factory.mktemp("c9_port"))
    state, _, _ = mrd_recipe.staged_mrd_svi(
        prng.PRNGKey(0), prng.PRNGKey(100), Ys, mrd_svi.Config(**kw), C9_N,
        steps=C9_STEPS, chunk=C9_CHUNK, lr=3e-3, drive=_drive, ckpt_dir=d,
        log=lambda s: None)
    return ref, {k: v.detach().numpy() for k, v in state.params.items()}


def _jax_drive_every(chunk):
    def drive(step_fn, state, n_steps, rng, Ys, label=""):
        def one(st, r):
            st, m = step_fn(st, r, Ys)
            return st, m["loss"]

        @jax.jit
        def multi(st, start):
            keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(
                start + jnp.arange(chunk))
            return jax.lax.scan(one, st, keys)

        done = int(state.step)
        while done < n_steps:
            state, _ = multi(state, jnp.int32(done))
            done += chunk
        return state, float("nan"), 0.0

    return drive


def test_recipe_matches_reference_at_c9_widths(at_c9_widths):
    """c9's own widths and floors through both phases at reduced N: every
    leaf at 1e-8 (up to the PCA's column signs)."""
    ref, got = at_c9_widths
    assert set(got) == set(ref)
    sign = np.sign(np.sum(got["qx_mean"] * ref["qx_mean"], axis=0))
    assert (sign != 0).all()
    for k, want in ref.items():
        g = got[k] * sign if k == "qx_mean" or k.endswith(".z") else got[k]
        np.testing.assert_allclose(
            g, want, rtol=1e-8, atol=1e-8 * max(np.abs(want).max(), 1e-300),
            err_msg=k)
