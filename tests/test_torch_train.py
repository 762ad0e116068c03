"""The port's training support against the JAX package, f64 on the CPU:
the rate schedules against optax's, `gp_optimizer` against the
reference's optax chain case by case on a cheap quadratic over the
model's leaf names, ten decayed DP-GP-LVM steps through the port's driver
against the reference's `make_multi_step_fn`, and `NonFiniteGuard`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dp_gp_lvm_tpu.data import synthetic
from dp_gp_lvm_tpu.models import dp_gp_lvm as jdp
from dp_gp_lvm_tpu.train import loop as jloop
from dp_gp_lvm_tpu_torch.core.params import params_from_jax
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm as pdp
from dp_gp_lvm_tpu_torch.train import loop


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


DECAY = 40
SCHEDULES = {
    "cosine": (lambda m: m.cosine_decay_schedule(0.3, DECAY, alpha=0.05)),
    "warmup_cosine": (lambda m: m.warmup_cosine_decay_schedule(
        0.0, 0.3, 7, DECAY, end_value=0.05 * 0.3)),
    "warmup_cosine_no_warmup": (lambda m: m.warmup_cosine_decay_schedule(
        0.0, 0.3, 0, DECAY, end_value=0.05 * 0.3)),
    "linear": (lambda m: m.linear_schedule(0.0, 0.3, DECAY)),
    "linear_constant": (lambda m: m.linear_schedule(0.2, 0.3, 0)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    """Compiled, at one int32 count at a time, as the reference's update
    evaluates them from its state."""
    counts = np.arange(2 * DECAY + 1)
    schedule = jax.jit(SCHEDULES[name](optax))
    want = np.array([float(schedule(jnp.int32(c))) for c in counts])
    got = SCHEDULES[name](loop)(torch.as_tensor(counts))
    assert got.shape == counts.shape
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-12,
                               atol=0)


# a quadratic over the DP-GP-LVM's leaves: 0.5 sum a (p - c)^2, with
# gradients large enough that the global-norm clip at 100 binds
SHAPES = {"qx_mean": (6, 3), "raw_qx_var": (6, 3), "z": (2, 4, 3),
          "raw_variance": (2,), "raw_ard": (2, 3), "raw_noise": (2,),
          "phi_logits": (5, 2), "raw_gamma1": (1,), "raw_gamma2": (1,)}
STEPS, NAN_AT = 12, 4

CASES = {
    "decay": dict(decay_steps=10),
    "decay_ngd": dict(decay_steps=10, ngd_lr=0.5),
    "hyper_warmup": dict(decay_steps=10, hyper_warmup=4),
    "ard_decay": dict(decay_steps=30, ard_lr=0.05),
    "ard_decay_warmup": dict(decay_steps=10, ard_lr=0.05, ard_warmup=5),
    "ard_ramp": dict(ard_lr=0.05),
    "ard_ramp_warmup": dict(ard_lr=0.05, ard_warmup=5),
    "freeze_slow": dict(decay_steps=10, ngd_lr=0.5, freeze=frozenset({"z"}),
                        slow=frozenset({"phi_logits"})),
    "ngd_frozen_away": dict(ngd_lr=0.5,
                            freeze=frozenset({"qx_mean", "raw_qx_var"})),
    "nonfinite_at_4": dict(decay_steps=10, ngd_lr=1.0, hyper_warmup=3),
}


def _quadratic():
    """(p0, a, c). q(X)'s targets lie near its start, where the natural
    gradient's preconditioner stays O(1)."""
    r = np.random.default_rng(11)
    p0 = {k: r.normal(size=s) for k, s in SHAPES.items()}
    a = {k: r.uniform(1.0, 5.0, s) for k, s in SHAPES.items()}
    c = {k: p0[k] + (0.3 if k in loop.NGD_NAMES else 10.0)
         * r.normal(size=s) for k, s in SHAPES.items()}
    return p0, a, c


@pytest.mark.parametrize("case", sorted(CASES))
def test_gp_optimizer_matches_optax(case):
    kw = CASES[case]
    p0, a, c = _quadratic()

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = jloop.gp_optimizer(jp, lr=0.05, **kw)
    state = opt.init(jp)
    update = jax.jit(opt.update)
    for i in range(STEPS):
        g = {k: jnp.asarray(a[k]) * (jp[k] - jnp.asarray(c[k])) for k in jp}
        if case == "nonfinite_at_4" and i == NAN_AT:
            g["z"] = g["z"].at[0, 0, 0].set(jnp.nan)
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = params_from_jax(p0, "cpu", torch.float64)
    topt = loop.gp_optimizer(tp, lr=0.05, **kw)
    applied = []
    for i in range(STEPS):
        with torch.no_grad():
            g = {k: torch.as_tensor(a[k]) * (tp[k] - torch.as_tensor(c[k]))
                 for k in tp}
        if case == "nonfinite_at_4" and i == NAN_AT:
            g["z"][0, 0, 0] = float("nan")
        applied.append(bool(topt.step(g)))

    assert applied == [case != "nonfinite_at_4" or i != NAN_AT
                       for i in range(STEPS)]
    for k in tp:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(want).max()))
    # every group counts the applied steps only
    skipped = case == "nonfinite_at_4"
    assert {g: int(n) for g, n in topt.count.items()} == dict.fromkeys(
        topt.rates, STEPS - skipped)
    assert ("ngd" in topt.rates) == (kw.get("ngd_lr") is not None
                                     and case != "ngd_frozen_away")
    if "freeze" in kw:
        for k in kw["freeze"]:
            assert np.array_equal(tp[k].detach().numpy(), p0[k])


def test_step_fn_metrics_and_time_steps():
    """make_step_fn reports the loss, the ELBO and the unclipped gradient
    norm as device tensors; time_steps trains on; the driver counts every
    step it takes."""
    p0, a, c = _quadratic()
    tp = params_from_jax(p0, "cpu", torch.float64)
    opt = loop.gp_optimizer(tp, lr=0.05, decay_steps=10)

    def loss_fn(p, scale):
        return scale * sum(
            0.5 * torch.sum(torch.as_tensor(a[k])
                            * (p[k] - torch.as_tensor(c[k])) ** 2)
            for k in p)

    g_norm = float(np.sqrt(sum(np.sum((a[k] * (p0[k] - c[k])) ** 2)
                               for k in p0)))
    loop.reset_step_count()
    step = loop.make_step_fn(loss_fn, opt)
    m = step(1.0)
    assert all(torch.is_tensor(v) and v.ndim == 0 for v in m.values())
    assert float(m["elbo"]) == -float(m["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]), g_norm, rtol=1e-12)
    assert g_norm > 100.0                        # the clip bound
    per_step = loop.time_steps(step, (1.0,), num_steps=3, warmup=2)
    assert per_step > 0.0
    assert all(int(n) == 6 for n in opt.count.values())
    losses = loop.make_multi_step_fn(loss_fn, opt, 4)(1.0)
    assert losses.shape == (4,) and bool(torch.all(losses[1:] < losses[:-1]))
    assert loop.STEPS["taken"] == 1 + 5 + 4


@functools.lru_cache(maxsize=1)
def _dp_reference():
    """Ten decayed NGD steps of a tiny DP-GP-LVM through the reference's
    make_multi_step_fn."""
    Y, _, _ = synthetic.grouped_dims(jax.random.PRNGKey(5), n=40,
                                     dims_per_group=(3, 3), q=2,
                                     dtype=jnp.float64)
    cfg = jdp.Config(num_latent=2, num_inducing=6, truncation=3)
    params = jdp.init_params(jax.random.PRNGKey(5), Y, cfg)
    opt = jloop.gp_optimizer(params, lr=1e-2, decay_steps=10, ngd_lr=1.0)
    multi = jloop.make_multi_step_fn(lambda p, y: jdp.loss(p, y, cfg), opt,
                                     num_inner=10)
    init = {k: np.asarray(v) for k, v in params.items()}   # donated below
    state, losses = multi(jloop.init_state(params, opt), Y)
    return init, np.asarray(Y), state.params, np.asarray(losses)


def test_ten_decayed_dp_steps_match_make_multi_step_fn():
    params, Y, want_params, want_losses = _dp_reference()
    tp = params_from_jax(params, "cpu", torch.float64)
    cfg = pdp.Config(num_latent=2, num_inducing=6, truncation=3)
    opt = loop.gp_optimizer(tp, lr=1e-2, decay_steps=10, ngd_lr=1.0)
    multi = loop.make_multi_step_fn(lambda p, y: pdp.loss(p, y, cfg), opt,
                                    10)
    losses = multi(torch.tensor(Y))
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-8)
    for k in tp:
        want = np.asarray(want_params[k])
        np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=1e-8,
                                   atol=1e-8 * float(np.abs(want).max()))


SEQUENCES = {
    "transient": [[1.0, 2.0], [np.nan, 1.0], [1.0, 1.0], [np.inf], [0.5]],
    "persistent": [[1.0], [np.nan], [np.nan, np.nan], [-np.inf], [np.nan]],
    "two_then_recover": [[np.nan], [np.inf], [3.0], [np.nan], [np.nan]],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_nonfinite_guard_matches_reference(name):
    ref, port = jloop.NonFiniteGuard(k=3), loop.NonFiniteGuard(k=3)
    for i, chunk in enumerate(SEQUENCES[name]):
        step = 50 * (i + 1) - 1
        assert port.update(torch.tensor(chunk), step) == ref.update(
            np.array(chunk), step)
        assert (port.consecutive, port.first_bad_step) == (
            ref.consecutive, ref.first_bad_step)
