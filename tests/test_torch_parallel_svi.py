"""The port's mesh for the minibatch families (`dp_gp_lvm_tpu_torch/
parallel/`: the SVI programs of `sharded_elbo.py`, `place_svi`, the step
factories with `mesh=`, the staged recipe and the checkpoint on a mesh) on
4 gloo ranks on the CPU, in f64, against the JAX package's single-device
programs and the port's own single-device steps.

The reference's mesh cases, on 2 x 2 and 4 x 1 meshes where the reference
takes 4 x 2 and 8 x 1: the sharded SVI-GPLVM, amortized, MRD-SVI and
DP-SVI bounds and gradients (`tests/test_svi.py`, `test_amortized.py`,
`test_mrd_svi.py`, `test_parallel.py`, a noise floor that binds included),
three mesh steps of the DP-SVI and SVI-GPLVM, one of the MRD-SVI and
three of the amortized DP-SVI against the reference's steps with
`sample_idx` and against the port's unsharded steps, the streamed mesh
step against the resident one (`test_stream.py`, `test_amortized.py`,
`test_mrd_svi.py`), the staged DP-SVI recipe on 2 x 2 against the
single-device recipe (`test_dp_recipe.py`), the staged MRD-SVI recipe
likewise, and the checkpoint of a DP-SVI state with
its Adam moments (`test_checkpoint.py`'s sharded case) and a mesh resume
to the bit. Beside them: whole leaves the same bits on every rank after
the steps, `all_gather`'s order, the placement tables against the
reference's, and the refusals.

The ranks are spawned once for the module (`tests/torch_parallel_svi_
ranks.py`, which imports no JAX) and meet at a file store in the test's
temporary directory; the reference's inputs go to them through
`torch.save`, and the JAX oracle is compiled while they run. Alone the
file takes ~20 s, most of it compiling the oracle.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_svi_ranks as ranks
from dp_gp_lvm_tpu.data import synthetic as jsyn
from dp_gp_lvm_tpu.models import dp_svi as jdp
from dp_gp_lvm_tpu.models import mrd_svi as jmrd
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu.parallel import auto as jauto
from dp_gp_lvm_tpu.parallel import mesh as jmesh
from dp_gp_lvm_tpu.train.loop import gp_optimizer as jgp_optimizer
from dp_gp_lvm_tpu.train.loop import init_state
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.parallel import auto
from dp_gp_lvm_tpu_torch.train import loop

RANKS_TIMEOUT = 240.0
VALUE_RTOL = 1e-9
SVI_GRAD = dict(rtol=1e-7, atol=1e-9)   # the reference's, SVI, amortized,
DP_GRAD = dict(rtol=1e-6, atol=1e-8)    # MRD-SVI; and DP-SVI's
STEP_LOSS_RTOL = 1e-7                   # the reference's mesh steps
STEP_LEAVES = dict(rtol=2e-5, atol=1e-7)
UNSHARDED_RTOL = 1e-10                  # against the port's own steps


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _step_idx(key, n):
    """The reference's mesh-step minibatches: randint of each split."""
    rng, out = jax.random.PRNGKey(key), []
    for _ in range(ranks.STEPS):
        rng, sub = jax.random.split(rng)
        out.append(jax.random.randint(sub, (16,), 0, n, dtype=jnp.int32))
    return jnp.stack(out)


def _inputs():
    """The reference tests' data, initial parameters (q(u) at its optimum
    where the reference sets it) and step minibatches, as numpy (one
    jitted program)."""
    return _np(jax.jit(_input_program)())


def _input_program():
    svi_y, _ = jsyn.toy_gplvm(jax.random.PRNGKey(0), n=64, d=5, q_true=2,
                              q_total=2)
    toy, _ = jsyn.toy_gplvm(jax.random.PRNGKey(0), n=48, d=6, q_true=2,
                            q_total=3)
    v1, v2, _ = jsyn.two_view(jax.random.PRNGKey(0), n=48, d1=5, d2=7,
                              q_shared=1, q_private=1)
    g40, _, _ = jsyn.grouped_dims(jax.random.PRNGKey(3), n=40,
                                  dims_per_group=(4, 4), q=2, noise=0.01)
    s96, _, _ = jsyn.grouped_dims(jax.random.PRNGKey(0), n=96,
                                  dims_per_group=(3, 3), q=2, noise=0.01)
    svi_cfg, am_cfg = _cfg(ranks.SVI), _cfg(ranks.AMORTIZED)
    mrd_cfg, dp_cfg = _cfg(ranks.MRD), _cfg(ranks.DP)
    floor_cfg = _cfg(ranks.DP_FLOOR)
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    dp_init = jdp.init_params(k2, toy, dp_cfg)
    dp_floor = jdp.set_optimal_qu(jdp.init_params(k2, toy, floor_cfg), toy,
                                  floor_cfg)
    dp_floor["raw_noise"] = dp_floor["raw_noise"] - 5.0
    return {
        "svi_y": svi_y, "toy": toy, "view1": v1, "view2": v2,
        "grouped40": g40, "stream_y": s96,
        "svi_params": jsvi.set_optimal_qu(
            jsvi.init_params(k1, svi_y, svi_cfg), svi_y, svi_cfg),
        "amortized_params": jsvi.set_optimal_qu(
            jsvi.init_params(k1, svi_y, am_cfg), svi_y, am_cfg),
        "mrd_params": jmrd.set_optimal_qu(
            jmrd.init_params(k1, (v1, v2), mrd_cfg), (v1, v2), mrd_cfg),
        "mrd_init": jmrd.init_params(k1, (v1, v2), mrd_cfg),
        "mrd_amortized_params": jmrd.init_params(
            k1, (v1, v2), _cfg(ranks.MRD_AMORTIZED)),
        "dp_params": jdp.set_optimal_qu(dp_init, toy, dp_cfg),
        "dp_floor_params": dp_floor,
        "dp_hp_alpha_params": jdp.set_optimal_qu(
            jdp.init_params(k2, toy, _cfg(ranks.DP_HP_ALPHA)), toy,
            _cfg(ranks.DP_HP_ALPHA)),
        "dp_init": dp_init,
        "dp_amortized_params": jdp.init_params(k1, g40,
                                               _cfg(ranks.DP_AMORTIZED)),
        "stream_params": jdp.init_params(k1, s96, _cfg(ranks.DP_STREAM)),
        "svi_step_params": jsvi.init_params(k2, toy,
                                            _cfg(ranks.SVI_STEPS)),
        "dp_step_idx": _step_idx(9, 48),
        "svi_step_idx": _step_idx(11, 48),
    }


def _cfg(port_cfg):
    """The reference's config of a port config of the same fields."""
    mod = {"svi_gplvm": jsvi, "dp_svi": jdp, "mrd_svi": jmrd}[
        port_cfg.__module__.rsplit(".", 1)[-1]]
    fields = {k: v for k, v in port_cfg._asdict().items()
              if k in mod.Config._fields}
    fields.pop("use_fused", None)
    return mod.Config(**fields)


def _oracle(inp):
    """The reference's single-device minibatch bounds and gradients (one
    jitted program) and its steps with `sample_idx` (each step function
    jitted once)."""
    svi_cfg, am_cfg = _cfg(ranks.SVI), _cfg(ranks.AMORTIZED)
    mrd_cfg, dp_cfg = _cfg(ranks.MRD), _cfg(ranks.DP)
    floor_cfg = _cfg(ranks.DP_FLOOR)

    def value_and_grad(elbo, loss, p, ys, idx, n, cfg):
        return {"elbo": elbo(p, ys, idx, n, cfg),
                "grads": jax.grad(loss)(p, ys, idx, n, cfg)}

    def program(p):
        i32, i16 = jnp.arange(32), jnp.arange(16)
        views = [p["view1"][i32], p["view2"][i32]]
        return {
            "svi": value_and_grad(jsvi.elbo_minibatch, jsvi.loss_minibatch,
                                  p["svi_params"], p["svi_y"][i32], i32,
                                  64, svi_cfg),
            "amortized": value_and_grad(
                jsvi.elbo_minibatch, jsvi.loss_minibatch,
                p["amortized_params"], p["svi_y"][i32], i32, 64, am_cfg),
            "mrd_svi": value_and_grad(
                jmrd.elbo_minibatch, jmrd.loss_minibatch, p["mrd_params"],
                views, i32, 48, mrd_cfg),
            "dp_svi": value_and_grad(
                jdp.elbo_minibatch, jdp.loss_minibatch, p["dp_params"],
                p["toy"][i16], i16, 48, dp_cfg),
            "dp_svi_floor": value_and_grad(
                jdp.elbo_minibatch, jdp.loss_minibatch,
                p["dp_floor_params"], p["toy"][i16], i16, 48, floor_cfg),
            "dp_svi_hp_alpha": value_and_grad(
                jdp.elbo_minibatch, jdp.loss_minibatch,
                p["dp_hp_alpha_params"], p["toy"][i16], i16, 48,
                _cfg(ranks.DP_HP_ALPHA)),
            "dp_svi_unfloored": jdp.elbo_minibatch(
                p["dp_floor_params"], p["toy"][i16], i16, 48, dp_cfg),
        }

    out = _np(jax.jit(program)(inp))

    def steps(params, make, data, idx, **opt_kw):
        """The steps on the rows idx[k], step k's key (0, k) selecting
        them: one compiled step function for all."""
        table = jnp.asarray(idx)
        opt = jgp_optimizer(params, **opt_kw)
        step = make(opt, lambda r: table[r[1]])
        state, losses = init_state(params, opt), []
        for k in range(len(idx)):
            state, m = step(state, jnp.array([0, k], jnp.uint32), data)
            losses.append(m["loss"])
        return np.asarray(losses), _np(state.params)

    out["steps"] = {
        "dp_svi": steps(
            inp["dp_init"], lambda opt, s: jdp.make_dp_svi_step(
                dp_cfg, 48, opt, rho=0.5, sample_idx=s),
            inp["toy"], inp["dp_step_idx"], lr=1e-2, ngd_lr=1.0),
        "svi": steps(
            inp["svi_step_params"], lambda opt, s: jsvi.make_svi_natgrad_step(
                _cfg(ranks.SVI_STEPS), 48, opt, rho=0.5, sample_idx=s),
            inp["toy"], inp["svi_step_idx"], lr=1e-2, ngd_lr=1.0),
        "mrd_svi": steps(
            inp["mrd_init"], lambda opt, s: jmrd.make_svi_natgrad_step(
                mrd_cfg, 48, opt, rho=0.3, sample_idx=s),
            [inp["view1"], inp["view2"]], np.arange(16)[None], lr=2e-2),
        "dp_amortized": steps(
            inp["dp_amortized_params"], lambda opt, s: jdp.make_dp_svi_step(
                _cfg(ranks.DP_AMORTIZED), 40, opt, rho=0.5, sample_idx=s),
            inp["grouped40"], np.tile(np.arange(16), (ranks.STEPS, 1)),
            lr=1e-2),
    }
    return out


def _join(ctx):
    deadline = time.monotonic() + RANKS_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the ranks ran past {RANKS_TIMEOUT} s")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference inputs, JAX oracle, each rank's results): the ranks start
    while the inputs are drawn and run while the oracle compiles."""
    tmp = tmp_path_factory.mktemp("svi_ranks")
    ctx = mp.start_processes(
        ranks.main, nprocs=ranks.WORLD, join=False, start_method="spawn",
        args=(ranks.WORLD, str(tmp / "store"), str(tmp / "inputs.pt"),
              str(tmp)))
    try:
        inp = _inputs()
        torch.save(jax.tree.map(torch.tensor, inp), tmp / "inputs.tmp")
        (tmp / "inputs.tmp").rename(tmp / "inputs.pt")
        oracle = _oracle(inp)
    finally:
        _join(ctx)
    results = [torch.load(tmp / f"rank{r}.pt") for r in range(ranks.WORLD)]
    return inp, oracle, results


def _case(run, name, rank=0):
    got = run[2][rank][name]
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


def _close(got, want, **tol):
    want = _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **tol)


FAMILIES = {"svi": SVI_GRAD, "amortized": SVI_GRAD, "mrd_svi": SVI_GRAD,
            "dp_svi": DP_GRAD, "dp_svi_floor": DP_GRAD,
            "dp_svi_hp_alpha": DP_GRAD}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_sharded_bound_matches_single_device(run, family, mesh):
    """The sharded minibatch bound equals the reference's elbo_minibatch
    on the same rows, on every rank."""
    for rank in range(ranks.WORLD):
        elbo, _ = _case(run, "values", rank)[family][mesh]
        np.testing.assert_allclose(float(elbo), run[1][family]["elbo"],
                                   rtol=VALUE_RTOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_sharded_gradient_matches_single_device(run, family, mesh):
    """Every leaf's gradient (the encoder's of the amortized model, each
    view's of the MRD-SVI, the atoms' and q(u | t)'s of the DP-SVI),
    reduced across the ranks, equals the reference's."""
    _, grads = _case(run, "values")[family][mesh]
    if family == "amortized":
        assert any(k.startswith("enc_") for k in grads)
    if family == "dp_svi_hp_alpha":
        assert "raw_alpha" in grads
    _close(grads, run[1][family]["grads"], **FAMILIES[family])


def test_the_noise_floor_binds_on_the_mesh(run):
    """The floored bound differs from the unfloored one, so the floored
    sharded value equal to the reference's is not vacuous."""
    assert abs(run[1]["dp_svi_unfloored"]
               - run[1]["dp_svi_floor"]["elbo"]) > 1e-3


STEP_CASES = {"dp_svi": ("4x1", "2x2"), "svi": ("4x1",),
              "mrd_svi": ("4x1", "2x2"), "dp_amortized": ("2x2",)}


@pytest.mark.parametrize("family,mesh", [(f, m) for f, ms in
                                         sorted(STEP_CASES.items())
                                         for m in ms])
def test_mesh_steps_match_the_reference_steps(run, family, mesh):
    """The mesh steps' losses and final leaves against the reference's
    single-device steps with `sample_idx`, at its tolerances."""
    want_losses, want_params = run[1]["steps"][family]
    losses, params, _ = _case(run, "steps")[family][mesh]
    np.testing.assert_allclose(losses.numpy(), want_losses,
                               rtol=STEP_LOSS_RTOL)
    _close(params, want_params, **STEP_LEAVES)


@pytest.mark.parametrize("family,mesh", [
    (f, m) for f, ms in sorted({**STEP_CASES, "dp_svi_cavi": ("2x2",)}
                               .items()) for m in ms])
def test_mesh_steps_match_the_unsharded_steps(run, family, mesh):
    """The same steps against the port's single-device steps, at 1e-10:
    the sums over ranks reorder the arithmetic and nothing else (the
    "cavi" DP-SVI reads every atom's free energies through all_gather)."""
    got = _case(run, "steps")[family]
    (want_l, want_p, _), (losses, params, _) = got["single"], got[mesh]
    np.testing.assert_allclose(losses.numpy(), want_l.numpy(),
                               rtol=UNSHARDED_RTOL)
    for k, w in want_p.items():
        np.testing.assert_allclose(
            params[k].numpy(), w.numpy(), rtol=UNSHARDED_RTOL,
            atol=UNSHARDED_RTOL * float(w.abs().max()), err_msg=k)


WHOLE = {"svi": {"u_mean", "raw_u_scale", "qx_mean", "raw_qx_var"},
         "dp_svi_cavi": {"phi_logits", "raw_gamma1", "raw_gamma2"},
         "mrd_svi": {"views.0.u_mean", "views.1.raw_u_scale"},
         "dp_amortized": {"phi_logits", "raw_gamma1", "enc_wlin",
                          "enc_w1"}}


@pytest.mark.parametrize("family", sorted(WHOLE))
def test_whole_leaves_are_the_same_bits_on_every_rank(run, family):
    """After the mesh steps every whole leaf (q(u), q(X), the encoder,
    phi, the sticks) holds the same bits on every rank: the blends read
    statistics summed over "data", phi's CAVI the gathered free
    energies."""
    mesh = STEP_CASES.get(family, ("2x2",))[-1]
    first = _case(run, "steps", 0)[family][mesh][2]
    assert WHOLE[family] <= set(first)
    for rank in range(1, ranks.WORLD):
        other = _case(run, "steps", rank)[family][mesh][2]
        assert set(other) == set(first)
        for k, v in first.items():
            assert torch.equal(other[k], v), (rank, k)


@pytest.mark.parametrize("family", ["dp_svi", "dp_amortized",
                                    "mrd_amortized"])
def test_streamed_mesh_step_equals_the_resident_mesh_step(run, family):
    """The host-fed (idx, rows) step on 2 x 2 is the resident mesh step at
    equal rows, to the bit: each rank cuts the same block either way."""
    got = _case(run, "stream")[family]
    (loss_r, p_r), (loss_s, p_s) = got["resident"], got["streamed"]
    assert torch.equal(loss_r, loss_s)
    for k, v in p_r.items():
        assert torch.equal(v, p_s[k]), k


def test_staged_recipe_on_2x2_matches_the_single_device_recipe(run):
    """The staged DP-SVI recipe (T = 4: stage 1 and the split whole on
    every rank, stages 2a-2c on the mesh) ends where the single-device
    recipe ends. The reference allows 5e-3 on the ELBO and 0.05 / 1e-4 on
    the leaves (f32 psums); in f64 the two agree to ~2e-15 of each leaf's
    scale and the final ELBO to the bit, held here at 1e-12."""
    got = _case(run, "recipe")
    assert got["boundary_atoms"] == ranks.RECIPE.truncation
    single, mesh = got["single"], got["2x2"]
    assert np.isfinite(float(mesh["elbo"]))
    np.testing.assert_allclose(float(mesh["elbo"]), float(single["elbo"]),
                               rtol=1e-12)
    for k, w in single["params"].items():
        np.testing.assert_allclose(
            mesh["params"][k].numpy(), w.numpy(), rtol=1e-12,
            atol=1e-12 * float(w.abs().max()), err_msg=k)


def test_staged_mrd_recipe_on_2x2_matches_the_single_device_recipe(run):
    """The staged MRD-SVI recipe on 2 x 2 (both phases with each batch's
    rows over "data") ends on the single-device recipe's leaves at 1e-12
    of each leaf's scale on every rank, and its phase-A boundary, gathered
    and written by rank 0, is the single-device run's to the same
    tolerance."""
    single = _case(run, "mrd_recipe", 0)
    for rank in range(ranks.WORLD):
        got = _case(run, "mrd_recipe", rank)["2x2"]
        for k, w in single["single"].items():
            np.testing.assert_allclose(
                got[k].numpy(), w.numpy(), rtol=1e-12,
                atol=1e-12 * float(w.abs().max()), err_msg=k)
    a, b = single["boundary_single"], single["boundary_2x2"]
    assert sorted(a) == sorted(b)
    for k, w in a.items():
        np.testing.assert_allclose(b[k].numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(w.abs().max()),
                                   err_msg=k)


def test_sharded_checkpoint_round_trips_and_resumes_to_the_bit(run):
    """The DP-SVI checkpoint on 2 x 2 holds the full state (the atoms'
    Adam moments at T = 4 in the file, T = 2 on a rank); restored and cut
    again it is every rank's state to the bit, and the resumed steps end
    on the straight run's bits."""
    for rank in range(ranks.WORLD):
        got = _case(run, "checkpoint", rank)
        assert got["restored_step"] == 2
        assert got["restored_equal"]
        assert got["resumed_equal"], rank
        assert got["file_shapes"]["z"][0] == ranks.DP.truncation
        assert got["local_shapes"]["z"][0] == ranks.DP.truncation // 2


def test_all_gather_joins_the_blocks_in_coordinate_order(run):
    for rank in range(ranks.WORLD):
        got = _case(run, "gather_order", rank)
        d, m = divmod(rank, 2)
        assert got["data"].tolist() == [[0.0, m], [1.0, m]]
        assert got["model"].tolist() == [[d, 0.0], [d, 1.0]]


def test_the_mesh_refuses_what_does_not_cut(run):
    got = _case(run, "refusals")
    assert got["batch"] == ("batch: leading dim 30 is not evenly divisible "
                            "by the 'data' axis of size 4")
    assert "not evenly divisible by the 'model' axis of size 4" in \
        got["atoms"]
    assert "gp_optimizer(..., mesh=, placement=)" in got["optimizer"]
    assert "not an SVI family" in got["family"]


def _reference_axis(sharding):
    spec = tuple(sharding.spec)
    return spec[0] if spec else None


@pytest.mark.parametrize("family", ["svi_gplvm", "amortized", "mrd_svi",
                                    "dp_svi", "dp_amortized"])
def test_svi_placement_tables_match_the_reference(run, family):
    """Each leaf lies where the reference's `svi_shardings` /
    `dp_svi_shardings` put it (on its 4 x 2 mesh of fake devices), the
    data whole."""
    inp = run[0]
    key, port_table, ref_table = {
        "svi_gplvm": ("svi_params", auto.svi_shardings, jauto.svi_shardings),
        "amortized": ("amortized_params", auto.svi_shardings,
                      jauto.svi_shardings),
        "mrd_svi": ("mrd_params", auto.svi_shardings, jauto.svi_shardings),
        "dp_svi": ("dp_params", auto.dp_svi_shardings,
                   jauto.dp_svi_shardings),
        "dp_amortized": ("dp_amortized_params", auto.dp_svi_shardings,
                         jauto.dp_svi_shardings)}[family]
    want, want_data = ref_table(jmesh.make_mesh(data=4, model=2), inp[key])
    got, got_data = port_table(params_from_jax(inp[key], "cpu"))
    if family == "dp_svi":
        assert got["u_h"].axis == "model"
    assert ({k: p.axis for k, p in loop.flat_leaves(got).items()}
            == {k: _reference_axis(s)
                for k, s in _flat(want, leaf=lambda s: s).items()})
    assert got_data.axis is None and _reference_axis(want_data) is None
