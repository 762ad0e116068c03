"""The port's random stream (`core/prng.py`) against `jax.random` on the
CPU: keys, `split`, `fold_in`, bits, `uniform`, `randint` and
`permutation` bit for bit, `normal` within 4 ulps, in float32 and float64;
each synthetic generator against the reference's on the same key; and
the runner's data and initial parameters against the reference runner's
for every ported config at a reduced N. The reference's float32 draws are
made with its 64-bit mode off, as its float32 runs make them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.data import mocap as jmocap
from dp_gp_lvm_tpu.data import oil_flow as joil
from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu_torch.core import config, prng
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.experiments import run as runner

SEEDS = (0, 7, 2 ** 31 - 1)
DTYPES = {"f32": (jnp.float32, torch.float32, np.int32),
          "f64": (jnp.float64, torch.float64, np.int64)}


def _x64(name):
    """The reference's 64-bit mode of a draw at this float width."""
    return jax.enable_x64(name == "f64")


def _words(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_bitwise(seed):
    key, mine = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert (_words(key) == mine.numpy()).all()
    assert (_words(jax.random.split(key, 5)) == prng.split(mine, 5).numpy()
            ).all()
    for data in (0, 1, 123456, 2 ** 32 - 1):
        assert (_words(jax.random.fold_in(key, data))
                == prng.fold_in(mine, data).numpy()).all()
    # a batch of keys: the SVI loop's step keys fold_in(r1, t)
    steps = jnp.arange(10, 16)
    want = jax.vmap(lambda t: jax.random.fold_in(key, t))(steps)
    got = prng.fold_in(mine, torch.arange(10, 16))
    assert (_words(want) == got.numpy()).all()


SHAPES = ((7,), (3, 5))
# the ranges the reference draws (normal's is held by the normal test):
# with minval = 0 XLA's fused multiply-add rounds as the port's product and
# sum do
RANGES = ((0.0, 1.0), (0.0, 2 * np.pi))


def _draws(key, jdt, name):
    """One jitted program's worth of jax.random draws from `key`."""
    out = {str(("bits", shape)): jax.random.bits(key, shape, jnp.uint32)
           for shape in SHAPES}
    out.update({str(("uniform", shape, lo, hi)): jax.random.uniform(
        key, shape, jdt, lo, hi) for shape in SHAPES for lo, hi in RANGES})
    out["randint32"] = jax.random.randint(key, (1000,), 0, 131072,
                                          dtype=jnp.int32)
    out["randint"] = jax.random.randint(key, (50,), 0, 3)  # default width
    if name == "f64":
        out["bits64"] = jax.random.bits(key, (9,), jnp.uint64)
    return out


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_bits_uniform_and_randint_are_bitwise(name):
    """randint: int32 as every run draws the SVI minibatches (and the
    float32 oil-flow surrogate its labels), the default width (int64 in
    the 64-bit mode) as the float64 oil-flow surrogate draws labels."""
    jdt, tdt, view = DTYPES[name]
    with _x64(name):
        draw = jax.jit(lambda k: _draws(k, jdt, name))
        for seed in SEEDS:
            want = jax.tree.map(np.asarray, draw(jax.random.PRNGKey(seed)))
            mine = prng.PRNGKey(seed)
            for shape in SHAPES:
                assert (_words(want[str(("bits", shape))])
                        == prng.random_bits(mine, 32, shape).numpy()).all()
                for lo, hi in RANGES:
                    got = prng.uniform(mine, shape, tdt, lo, hi).numpy()
                    assert (want[str(("uniform", shape, lo, hi))].view(view)
                            == got.view(view)).all()
            got = prng.randint(mine, (1000,), 0, 131072)
            assert got.dtype == torch.int32
            assert (want["randint32"] == got.numpy()).all()
            got = prng.randint(mine, (50,), 0, 3,
                               bits=64 if name == "f64" else 32)
            assert (want["randint"] == got.numpy()).all()
            if name == "f64":
                got = prng.random_bits(mine, 64, (9,)).numpy()
                assert (want["bits64"].view(np.int64) == got).all()


def test_randint_draws_a_chunk_of_minibatches_at_once():
    """(steps, B) indices from (steps, 2) keys, as the SVI loop draws a
    chunk's minibatches."""
    keys = jax.vmap(lambda t: jax.random.fold_in(jax.random.PRNGKey(3), t))(
        jnp.arange(4))
    want = jax.vmap(lambda k: jax.random.randint(k, (32,), 0, 1000,
                                                 dtype=jnp.int32))(keys)
    got = prng.randint(prng.fold_in(prng.PRNGKey(3), torch.arange(4)),
                       (32,), 0, 1000)
    assert (np.asarray(want) == got.numpy()).all()


@pytest.mark.parametrize("n", [1, 5, 100, 1000, 131072])
def test_permutation_is_bitwise(n):
    for seed in SEEDS[:2]:
        want = jax.random.permutation(jax.random.PRNGKey(seed), n)
        got = prng.permutation(prng.PRNGKey(seed), n)
        assert (np.asarray(want) == got.numpy()).all()


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_normal_is_within_4_ulps(name):
    jdt, tdt, view = DTYPES[name]
    with _x64(name):
        for seed in SEEDS[:2]:
            want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                                (200000,), jdt))
            got = prng.normal(prng.PRNGKey(seed), (200000,), tdt).numpy()
            ulps = np.abs(want.view(view).astype(np.int64)
                          - got.view(view).astype(np.int64))
            assert ulps.max() <= 4, ulps.max()
            assert (ulps == 0).mean() > 0.8
    x = torch.tensor([-1.0, 1.0], dtype=tdt)
    assert prng.erfinv(x).tolist() == [-np.inf, np.inf]


GENERATORS = {
    "toy_gplvm": (lambda k, dt: jsyn.toy_gplvm(k, n=40, d=5, q_true=2,
                                               q_total=4, dtype=dt),
                  lambda k, dt: synthetic.toy_gplvm(k, n=40, d=5, q_true=2,
                                                    q_total=4, dtype=dt,
                                                    device="cpu")),
    "oil_flow_like": (lambda k, dt: jsyn.oil_flow_like(k, n=60, d=7,
                                                       dtype=dt),
                      lambda k, dt: synthetic.oil_flow_like(
                          k, n=60, d=7, dtype=dt, device="cpu")),
    "mocap_like": (lambda k, dt: jsyn.mocap_like(k, n=64, d=9, dtype=dt),
                   lambda k, dt: synthetic.mocap_like(k, n=64, d=9, dtype=dt,
                                                      device="cpu")),
    "pose_like": (lambda k, dt: jsyn.pose_like(k, n=48, dtype=dt),
                  lambda k, dt: synthetic.pose_like(k, n=48, dtype=dt,
                                                    device="cpu")),
}
TOL = {"f32": 1e-5, "f64": 1e-12}
# the toy's GP draw goes through the Cholesky of a near-singular Gram
# matrix (jitter 1e-4 in f32, 1e-6 in f64): two LAPACKs round it apart by
# ~1e3 of their precision, so its Y is held to that
TOY_Y_TOL = {"f32": 1e-3, "f64": 1e-9}


@pytest.fixture(scope="module")
def reference():
    """Every reference generator's draw from PRNGKey(3) at both float
    widths, and every config's reference data and init (float64): one
    jitted program per width, each in the 64-bit mode of that width."""
    out = {}
    for name, (jdt, _, _) in DTYPES.items():
        def program(k, jdt=jdt, name=name):
            draws = {gen: fns[0](k, jdt) for gen, fns in GENERATORS.items()}
            if name == "f32":
                return {"draws": draws}
            return {"draws": draws, "runs": {
                run: _reference_data_and_init(_small(run))
                for run in SMALL_N}}
        with _x64(name):
            out[name] = jax.tree.map(np.asarray, jax.jit(program)(
                jax.random.PRNGKey(3)))
    return out


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_generators_equal_the_references_on_the_same_key(gen, name,
                                                        reference):
    want = reference[name]["draws"][gen]
    got = GENERATORS[gen][1](prng.PRNGKey(3), DTYPES[name][1])
    for i, (w, g) in enumerate(zip(want, got)):
        g = g.numpy()
        assert w.shape == g.shape
        if w.dtype.kind in "iu":
            assert (w == g).all()
            continue
        tol = TOY_Y_TOL[name] if (gen, i) == ("toy_gplvm", 0) else TOL[name]
        # standardized, unit-scale data: the same tolerance absolute
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


SMALL_N = {"c1_bgplvm_toy": 60, "c2_sparse_oil": None, "c4_dp_mocap": 96,
           "c5_dp_missing": 96, "c5_pose_missing": 96, "c6_svi_bigN": 160}
JMODELS = {"bgplvm": jbg, "dp_gp_lvm": jdp, "svi_gplvm": jsvi}


def _reference_data_and_init(cfg):
    """The reference runner's data, training split and initial parameters
    (experiments/run.py:153-295) from PRNGKey(cfg.seed), float64."""
    rng = jax.random.PRNGKey(cfg.seed)
    if cfg.dataset == "toy_gplvm":
        Y, _ = jsyn.toy_gplvm(rng, n=cfg.n, d=cfg.d, q_true=2, q_total=cfg.q,
                              dtype=jnp.float64)
    elif cfg.dataset == "oil_flow":
        Y, _, _ = joil.load_oil_flow(None, dtype=jnp.float64)
    elif cfg.dataset == "pose":
        Y, _, _ = jsyn.pose_like(rng, n=cfg.n, dtype=jnp.float64)
    else:
        Y, _ = jmocap.load_mocap(None, n=cfg.n, d=cfg.d, dtype=jnp.float64,
                                 rng=rng)
    Y_train = Y
    if cfg.missing_fraction > 0:
        keep = np.ones(Y.shape[0], bool)
        keep[7::8] = False
        Y_keep = Y[np.flatnonzero(keep)]
        Y_train = ((Y_keep - Y_keep.mean(axis=0))
                   / (Y_keep.std(axis=0) + 1e-8))
    if cfg.model == "bgplvm":
        mcfg = jbg.Config(num_latent=cfg.q, num_inducing=cfg.m)
    elif cfg.model == "dp_gp_lvm":
        mcfg = jdp.Config(num_latent=cfg.q, num_inducing=cfg.m,
                          truncation=cfg.t, alpha=cfg.alpha)
    else:
        mcfg = jsvi.Config(num_latent=cfg.q, num_inducing=cfg.m, batch=1024)
    return Y, Y_train, JMODELS[cfg.model].init_params(rng, Y_train, mcfg)


def _small(name):
    cfg = config.get(name)
    return dataclasses.replace(cfg, n=SMALL_N[name]) if SMALL_N[name] \
        else cfg


@pytest.mark.parametrize("name", sorted(SMALL_N))
def test_runner_data_and_init_equal_the_reference_runners(name, reference):
    """float64. The PCA latents (and Z, drawn from them) are compared up to
    each column's sign: the SVD's signs are LAPACK's choice, and flipping
    a latent coordinate is an exact symmetry of every model."""
    cfg = _small(name)
    Y_ref, Y_train_ref, want = reference["f64"]["runs"][name]
    Y, _ = runner.load_data(cfg, torch.float64, "cpu")
    tol = TOY_Y_TOL["f64"] if cfg.dataset == "toy_gplvm" else TOL["f64"]
    np.testing.assert_allclose(Y.numpy(), Y_ref, rtol=tol, atol=tol)
    Y_train = (torch.tensor(runner.holdout_split(Y.numpy())[0])
               if cfg.missing_fraction > 0 else Y)
    np.testing.assert_allclose(Y_train.numpy(), Y_train_ref, rtol=tol,
                               atol=tol)
    model = runner.MODELS[cfg.model]
    got = {k: v.detach().numpy() for k, v in model.init_params(
        prng.PRNGKey(cfg.seed), Y_train, runner._model_config(cfg, None)
    ).items()}
    assert sorted(got) == sorted(want)
    sign = np.sign(np.sum(got["qx_mean"] * want["qx_mean"], axis=0))
    assert (sign != 0).all()
    for k in got:
        g = got[k] * sign if k in ("qx_mean", "z") else got[k]
        np.testing.assert_allclose(g, want[k], rtol=1e-8, atol=1e-8,
                                   err_msg=k)
