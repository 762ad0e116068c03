"""The port's mesh (`dp_gp_lvm_tpu_torch/parallel/`) on 4 gloo ranks on the
CPU, in f64, against the JAX package's single-device programs: the
reference's full-batch cases of `tests/test_parallel.py` (the sharded
Bayesian GP-LVM, DP-GP-LVM and MRD ELBOs and their gradients, the
hyperprior and learnable-alpha terms, the placement tables), `place`
followed by `gather`, five of c4's optimizer steps on a 2 x 2 mesh with a
binding clip against the port's single-device steps, the skip of a step
whose gradient is not finite on one rank, the psum's gradient rule and
the runner's refusal of a mesh that does not divide the rows or atoms.

The ranks are spawned once for the module (`tests/torch_parallel_ranks.py`,
which imports no JAX) and meet at a file store in the test's temporary
directory; the reference's inputs go to them through `torch.save`, and
the JAX oracle is compiled while they run.
"""
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as ranks
from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import bgplvm as jbg
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.models import mrd as jmrd
from dp_gp_lvm_tpu.parallel import auto as jauto
from dp_gp_lvm_tpu.parallel import mesh as jmesh
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm
from dp_gp_lvm_tpu_torch.parallel import auto
from dp_gp_lvm_tpu_torch.train import loop

RANKS_TIMEOUT = 240.0
LOSS_RTOL = 1e-9
BG_GRAD = dict(rtol=1e-7, atol=1e-9)    # the reference's, Bayesian GP-LVM
DP_GRAD = dict(rtol=1e-6, atol=1e-8)    # and MRD; and DP-GP-LVM's
STEPS_RTOL = 1e-10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """The reference's `toy` and `two_view` fixtures and its initial
    parameters of each family, as numpy (one jitted program)."""
    dp_alpha = jdp.Config(num_latent=ranks.Q, num_inducing=ranks.M,
                          truncation=ranks.T, hyperprior_std=ranks.HP_DP,
                          learn_alpha=True)

    def program():
        toy, _ = jsyn.toy_gplvm(jax.random.PRNGKey(0), n=48, d=6, q_true=2,
                                q_total=3)
        v1, v2, _ = jsyn.two_view(jax.random.PRNGKey(3), n=48, d1=5, d2=7)
        return {
            "toy": toy, "view1": v1, "view2": v2,
            "bg_params": jbg.init_params(jax.random.PRNGKey(1), toy,
                                         jbg.Config(ranks.Q, ranks.M)),
            "dp_params": jdp.init_params(
                jax.random.PRNGKey(2), toy,
                jdp.Config(ranks.Q, ranks.M, ranks.T)),
            "dp_alpha_params": jdp.init_params(jax.random.PRNGKey(2), toy,
                                               dp_alpha),
            "mrd_params": jmrd.init_params(jax.random.PRNGKey(4), [v1, v2],
                                           jmrd.Config(ranks.Q, ranks.M, 2)),
        }

    return _np(jax.jit(program)())


def _oracle(inp):
    """The reference's single-device ELBOs and loss gradients, one jitted
    program."""
    bg, bg_hp = jbg.Config(ranks.Q, ranks.M), jbg.Config(
        ranks.Q, ranks.M, hyperprior_std=ranks.HP_BG)
    dp = jdp.Config(ranks.Q, ranks.M, ranks.T)
    dp_alpha = dp._replace(hyperprior_std=ranks.HP_DP, learn_alpha=True)
    mr = jmrd.Config(ranks.Q, ranks.M, 2)
    mr_hp = mr._replace(hyperprior_std=ranks.HP_BG)

    def program(p):
        Y, Ys = p["toy"], [p["view1"], p["view2"]]
        return {
            "bgplvm": {
                "elbo": jbg.elbo(p["bg_params"], Y, bg),
                "grads": jax.grad(jbg.loss)(p["bg_params"], Y, bg),
                "elbo_hp": jbg.elbo(p["bg_params"], Y, bg_hp)},
            "dp": {
                "elbo": jdp.elbo(p["dp_params"], Y, dp),
                "grads": jax.grad(jdp.loss)(p["dp_params"], Y, dp)},
            "dp_hp_alpha": {
                "elbo": jdp.elbo(p["dp_alpha_params"], Y, dp_alpha),
                "grads": jax.grad(jdp.loss)(p["dp_alpha_params"], Y,
                                            dp_alpha)},
            "mrd": {
                "elbo": jmrd.elbo(p["mrd_params"], Ys, mr),
                "grads": jax.grad(lambda q: jmrd.loss(q, Ys, mr))(
                    p["mrd_params"]),
                "elbo_hp": jmrd.elbo(p["mrd_params"], Ys, mr_hp)},
        }

    return _np(jax.jit(program)(inp))


def _single_device_steps(inp):
    """The port's five single-device steps of the same optimizer."""
    params = params_from_jax(inp["dp_params"], "cpu")
    cfg = ranks.dp_config()
    opt = ranks.dp_optimizer(params)
    step = loop.make_step_fn(lambda _, y: dp_gp_lvm.loss(params, y, cfg),
                             opt)
    Y = torch.tensor(inp["toy"])
    norms = [step(Y)["grad_norm"] for _ in range(ranks.OPT_STEPS)]
    return ({k: v.detach().numpy() for k, v in params.items()},
            torch.stack(norms).numpy())


def _join(ctx):
    deadline = time.monotonic() + RANKS_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the ranks ran past {RANKS_TIMEOUT} s")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference inputs, JAX oracle, single-device steps, each rank's
    results): the ranks run while the oracle compiles."""
    tmp = tmp_path_factory.mktemp("ranks")
    inp = _inputs()
    torch.save(jax.tree.map(torch.tensor, inp), tmp / "inputs.pt")
    ctx = mp.start_processes(
        ranks.main, nprocs=ranks.WORLD, join=False, start_method="spawn",
        args=(ranks.WORLD, str(tmp / "store"), str(tmp / "inputs.pt"),
              str(tmp)))
    try:
        oracle = _oracle(inp)
        steps = _single_device_steps(inp)
    finally:
        _join(ctx)
    results = [torch.load(tmp / f"rank{r}.pt") for r in range(ranks.WORLD)]
    return inp, oracle, steps, results


def _case(run, name, rank=0):
    got = run[3][rank][name]
    if isinstance(got, dict) and "error" in got:
        pytest.fail(f"rank {rank}, case {name}:\n{got['error']}")
    return got


def _flat(tree, prefix="", leaf=np.asarray):
    """A reference tree flattened as the port's `flat_leaves` names it."""
    out = {}
    for k, v in tree.items():
        if k == "views":
            for i, view in enumerate(v):
                out.update(_flat(view, f"views.{i}.", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


def _grads_close(got, want, tol):
    want = _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **tol)


def test_bgplvm_sharded_matches_single_device(run):
    got, want = _case(run, "bgplvm"), run[1]["bgplvm"]
    np.testing.assert_allclose(float(got["elbo"]), want["elbo"],
                               rtol=LOSS_RTOL)


def test_bgplvm_sharded_gradients_match(run):
    _grads_close(_case(run, "bgplvm")["grads"], run[1]["bgplvm"]["grads"],
                 BG_GRAD)


def test_bgplvm_sharded_hyperprior_matches(run):
    got, want = _case(run, "bgplvm"), run[1]["bgplvm"]
    np.testing.assert_allclose(float(got["elbo_hp"]), want["elbo_hp"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", ["4x1", "2x2", "1x4"])
def test_dp_sharded_2d_mesh_matches_single_device(run, mesh):
    np.testing.assert_allclose(float(_case(run, "dp")[mesh]["elbo"]),
                               run[1]["dp"]["elbo"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", ["4x1", "2x2", "1x4"])
def test_dp_sharded_gradients_match(run, mesh):
    _grads_close(_case(run, "dp")[mesh]["grads"], run[1]["dp"]["grads"],
                 DP_GRAD)


def test_dp_sharded_includes_hyperprior_and_alpha_terms(run):
    """The hyperprior and the learned alpha's Gamma prior are in the
    sharded objective, value and gradient (raw_alpha's included)."""
    got, want = _case(run, "dp")["hp_alpha"], run[1]["dp_hp_alpha"]
    assert "raw_alpha" in got["grads"]
    np.testing.assert_allclose(float(got["elbo"]), want["elbo"],
                               rtol=LOSS_RTOL)
    _grads_close(got["grads"], want["grads"], DP_GRAD)


@pytest.mark.parametrize("family", ["dp", "mrd"])
def test_sharded_fused_ops_match_single_device(run, family):
    """`use_fused=True` inside the mesh program (DP on 2 x 2, MRD on
    4 x 1): the fused autograd ops with K2's pullback, their plain
    versions on the CPU, give the reference's value and gradient."""
    got, want = _case(run, family)["fused"], run[1][family]
    np.testing.assert_allclose(float(got["elbo"]), want["elbo"],
                               rtol=LOSS_RTOL)
    _grads_close(got["grads"], want["grads"],
                 DP_GRAD if family == "dp" else BG_GRAD)


def test_mrd_sharded_matches_single_device(run):
    got, want = _case(run, "mrd"), run[1]["mrd"]
    np.testing.assert_allclose(float(got["elbo"]), want["elbo"],
                               rtol=LOSS_RTOL)
    _grads_close(got["grads"], want["grads"], BG_GRAD)


def test_mrd_sharded_hyperprior_matches(run):
    got, want = _case(run, "mrd"), run[1]["mrd"]
    np.testing.assert_allclose(float(got["elbo_hp"]), want["elbo_hp"],
                               rtol=LOSS_RTOL)


def _reference_axis(sharding):
    spec = tuple(sharding.spec)
    return spec[0] if spec else None


@pytest.mark.parametrize("family", ["bgplvm", "dp_gp_lvm", "mrd"])
def test_placement_tables_match_the_reference(family):
    """Each leaf lies where the reference's `auto.*_shardings` puts it
    (its 4 x 2 mesh of fake devices), and the data rows over "data"."""
    mesh = jmesh.make_mesh(data=4, model=2)
    want, want_row = {"bgplvm": lambda: jauto.bgplvm_shardings(mesh),
                      "dp_gp_lvm": lambda: jauto.dp_shardings(mesh),
                      "mrd": lambda: jauto.mrd_shardings(mesh, 2)}[family]()
    got, got_row = {"bgplvm": auto.bgplvm_shardings,
                    "dp_gp_lvm": auto.dp_shardings,
                    "mrd": lambda: auto.mrd_shardings(2)}[family]()
    assert ({k: p.axis for k, p in loop.flat_leaves(got).items()}
            == {k: _reference_axis(s)
                for k, s in _flat(want, leaf=lambda s: s).items()})
    assert got_row.axis == _reference_axis(want_row)


@pytest.mark.parametrize("family", ["bgplvm", "dp_gp_lvm", "mrd"])
def test_place_then_gather_is_the_identity(run, family):
    for rank in range(ranks.WORLD):
        got = _case(run, "roundtrip", rank)[family]
        assert got["max_diff"] == 0.0
        assert got["is_leaf"]
        assert got["local_rows"] == 48 // (2 if family == "dp_gp_lvm"
                                           else 4)


def test_optimizer_steps_on_2x2_equal_single_device_steps(run):
    """Five of c4's steps (NGD on q(X), Adam by label, a decayed rate, a
    clip that binds) on the 2 x 2 mesh equal the port's single-device
    steps, and so does the logical gradient norm of each step."""
    want_params, want_norms = run[2]
    assert want_norms[0] > 10 * ranks.CLIP       # the clip binds
    for rank in range(ranks.WORLD):
        got = _case(run, "steps", rank)
        np.testing.assert_allclose(got["grad_norms"].numpy(), want_norms,
                                   rtol=STEPS_RTOL)
        for k, w in want_params.items():
            np.testing.assert_allclose(
                got["params"][k].numpy(), w, rtol=STEPS_RTOL,
                atol=STEPS_RTOL * np.abs(w).max(), err_msg=k)


def test_whole_leaves_are_the_same_bits_on_every_rank(run):
    first = _case(run, "steps", 0)["whole"]
    assert set(first) == {"phi_logits", "raw_gamma1", "raw_gamma2"}
    for rank in range(1, ranks.WORLD):
        other = _case(run, "steps", rank)["whole"]
        for k, v in first.items():
            assert torch.equal(other[k], v), (rank, k)


def test_a_nonfinite_gradient_on_one_rank_skips_the_step_everywhere(run):
    for rank in range(ranks.WORLD):
        got = _case(run, "skip", rank)
        assert not got["applied"], rank
        assert got["unchanged"], rank


def test_psum_backward_gives_the_single_device_gradient(run):
    """loss = (sum_r theta y_r)^2 over 4 ranks, y_r = r + 1: before the
    reduction each rank holds its share 2 theta S y_r, after it the
    single-device gradient 2 theta S^2 (S = 10), on every rank."""
    theta, S = 1.5, 10.0
    for rank in range(ranks.WORLD):
        got = _case(run, "psum_rule", rank)
        assert float(got["loss"]) == (theta * S) ** 2
        assert float(got["share"]) == 2 * theta * S * (rank + 1)
        assert float(got["grad"]) == 2 * theta * S * S


def test_runner_refuses_a_mesh_that_does_not_divide(run):
    got = _case(run, "runner_uneven")
    assert "not evenly divisible by the 'data' axis" in got["rows"]
    assert "not evenly divisible by the 'model' axis" in got["atoms"]
