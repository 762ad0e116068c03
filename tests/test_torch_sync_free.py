"""The training step without host reads, on the CPU in float64: the
device-side Cholesky repair (`linalg/chol.py`) and the natural-gradient
blend's factor of C against the JAX package, the device step counter's
rho against the host formula, and the guard of `tests/torch_sync_guard.py`
on c6-, c7-, c8- and c9-shaped minibatch steps and a full-batch DP-GP-LVM
step: it fails where a step reads a tensor back to the host, copies host
data to a device, or calls an aten op whose CUDA kernel reads a value or
a size back (forward or backward: torch.trace's backward did) — each a
host sync, or a copy a CUDA graph cannot capture, on the card.

The JAX oracles are jitted once per module at small f64 shapes; the
stacks are a healthy one, one whose first factor fails and which the
ladder repairs at rungs 2 and 3, and one that fails at every rung."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu.linalg import chol as jchol
from dp_gp_lvm_tpu.models import svi_gplvm as jsvi
from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
from dp_gp_lvm_tpu_torch.data import synthetic
from dp_gp_lvm_tpu_torch.linalg import chol
from dp_gp_lvm_tpu_torch.models import (
    dp_gp_lvm,
    dp_svi,
    mrd_svi,
    svi_gplvm,
)
from dp_gp_lvm_tpu_torch.train.loop import (
    MinibatchChunks,
    gp_optimizer,
    make_multi_step_fn,
)
from torch_sync_guard import (
    HostReadError,
    NoHostReads,
    NoSyncingOps,
    guarded as _guarded,
)

M = 6
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _with_min_eigenvalue(rng, rel):
    """A symmetric (M, M) matrix whose smallest eigenvalue is `rel` times
    its mean |diagonal| (to first order), the rest 2..M."""
    q, _ = np.linalg.qr(rng.normal(size=(M, M)))
    lam = np.arange(1.0, M + 1.0)
    lam[0] = 0.0
    scale = np.mean(np.abs(np.diag(q @ np.diag(lam) @ q.T)))
    lam[0] = rel * scale
    return q @ np.diag(lam) @ q.T


def _stacks():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, M, M))
    healthy = x @ x.transpose(0, 2, 1) + np.eye(M)
    # rung 2 (1e-4) is the first to factor member 1, rung 3 member 2
    repaired = np.stack([healthy[0], _with_min_eigenvalue(rng, -5e-5),
                         _with_min_eigenvalue(rng, -5e-4)])
    exhausted = np.stack([healthy[0], _with_min_eigenvalue(rng, -30.0),
                          healthy[1]])
    return {"healthy": healthy, "repaired": repaired, "exhausted": exhausted}


W = np.tril(np.random.default_rng(1).normal(size=(M, M)))


@pytest.fixture(scope="module")
def chol_oracle():
    """One jitted JAX program: (L, jitter, dL.W/dA) of the reference's
    safe_cholesky_spec, safe_cholesky and vmap(safe_cholesky)."""
    w = jnp.asarray(W)
    fns = {"spec": jchol.safe_cholesky_spec, "search": jchol.safe_cholesky,
           "members": jax.vmap(jchol.safe_cholesky)}

    @jax.jit
    def oracle(a):
        out = {}
        for name, fn in fns.items():
            L, jit = fn(a)
            grad = jax.grad(lambda b: jnp.sum(fn(b)[0] * w))(a)
            out[name] = (L, jit, grad)
        return out

    return oracle


# the rung each stack takes: one for the batch, or one a member
RUNG = {"spec": {"healthy": 0, "repaired": 3, "exhausted": 6},
        "members": {"healthy": [0, 0, 0], "repaired": [0, 2, 3],
                    "exhausted": [0, 6, 0]}}
RUNG["search"] = RUNG["spec"]
PORT = {"spec": chol.safe_cholesky_spec, "search": chol.safe_cholesky,
        "members": chol.safe_cholesky_members}


@pytest.mark.parametrize("stack", ["healthy", "repaired", "exhausted"])
@pytest.mark.parametrize("fn", ["spec", "search", "members"])
def test_device_repair_matches_the_reference(chol_oracle, stack, fn):
    """Value, jitter and gradient against the reference. The spec's
    gradient is held against the reference's search-first
    `safe_cholesky` (the same jitter and factor): the reference's own spec
    gradient is NaN for a member whose speculative factor failed, 0 times
    NaN in its `lax.cond`'s discarded branch, which the port does not
    copy (`linalg/chol.py::safe_cholesky_spec`)."""
    A = _stacks()[stack]
    out = chol_oracle(jnp.asarray(A))
    L_j, jit_j, _ = (np.asarray(v) for v in out[fn])
    grad_j = np.asarray(out["search" if fn == "spec" else fn][2])
    a = torch.tensor(A, requires_grad=True)
    L, jit = PORT[fn](a)
    (grad,) = torch.autograd.grad(torch.sum(L * torch.as_tensor(W)), a)
    np.testing.assert_array_equal(jit.detach().numpy(), jit_j)
    np.testing.assert_allclose(L.detach().numpy(), L_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=TOL, atol=TOL)
    rungs = chol.jitter_rungs(JitterPolicy(), torch.float64, "cpu").numpy()
    np.testing.assert_array_equal(jit.detach().numpy(), np.broadcast_to(
        rungs[np.asarray(RUNG[fn][stack])], jit.shape))


def test_good_path_factor_keeps_its_bits():
    """Where the initial jitter factors, the factor is the one of
    A + init * scale * I, bit for bit."""
    A = torch.as_tensor(_stacks()["healthy"])
    eye = torch.eye(M, dtype=A.dtype)
    init = JitterPolicy().initial_for(A.dtype)
    want = torch.linalg.cholesky(A + init * chol._scale(A) * eye)
    for fn in PORT.values():
        assert torch.equal(fn(A)[0], want)


def test_no_tries_keeps_one_factorization():
    A = torch.as_tensor(_stacks()["repaired"])
    L, jit = chol.safe_cholesky_members(A, JitterPolicy(max_tries=0))
    assert torch.isnan(torch.diagonal(L[1])).all()
    assert torch.isfinite(L[0]).all()
    assert torch.equal(jit, torch.full((3,), 1e-6, dtype=A.dtype))


def _blend_inputs():
    """Whitened statistics whose C = (1 - rho) I + rho ls^T (I + beta A2)
    ls has a smallest eigenvalue of -5e-4: the unjittered factor fails
    and rung 3 (1e-3) of the ladder repairs it."""
    rng = np.random.default_rng(4)
    ls = np.tril(rng.normal(size=(M, M)), -1) * 0.3 + np.diag(
        rng.uniform(0.8, 1.2, M))
    rho, beta = 0.4, 2.0
    q, _ = np.linalg.qr(rng.normal(size=(M, M)))
    c = q @ np.diag(np.r_[-5e-4, np.linspace(0.5, 2.0, M - 1)]) @ q.T
    ls_inv = np.linalg.inv(ls)
    g = (c - (1.0 - rho) * np.eye(M)) / rho
    A2 = (ls_inv.T @ g @ ls_inv - np.eye(M)) / beta
    A2 = 0.5 * (A2 + A2.T)
    return (rng.normal(size=(M, 3)), ls, rng.normal(size=(M, 3)), A2,
            np.float64(beta), rho)


def test_blend_factor_of_c_needs_the_jitter_and_matches_the_reference():
    u_mean, ls, a, A2, beta, rho = _blend_inputs()
    C = (1 - rho) * np.eye(M) + rho * ls.T @ (ls + beta * A2 @ ls)
    assert np.linalg.eigvalsh(0.5 * (C + C.T))[0] < 0
    want = jax.jit(jsvi.natgrad_blend_qu, static_argnums=(5,))(
        *map(jnp.asarray, (u_mean, ls, a, A2, beta)), rho)
    got = svi_gplvm.natgrad_blend_qu(
        *map(torch.as_tensor, (u_mean, ls, a, A2, beta)), rho)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_device_rho_is_the_host_formula():
    rho, t0, kappa = 0.3, 37.0, 0.6
    rho_at = svi_gplvm.robbins_monro(rho, t0, kappa)
    for t in (0, 1, 5, 99, 1234, 50_000):
        want = rho * (1.0 + t / t0) ** (-kappa)
        got = rho_at(torch.tensor(t))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(float(got), want, rtol=1e-15, atol=0)
    assert svi_gplvm.robbins_monro(rho, None, kappa)(torch.tensor(3)) == rho


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------


def test_the_guard_sees_each_read():
    x = torch.ones(3)
    for read in (lambda: x.sum().item(), lambda: bool(x[0]),
                 lambda: float(x[0]), lambda: x.tolist(),
                 lambda: torch.tensor(1.0, device="cpu"),
                 lambda: x[torch.tensor(1)],
                 lambda: x.cpu()):
        with pytest.raises(HostReadError), NoHostReads():
            read()
    x = torch.ones(3, 3, requires_grad=True)
    with pytest.raises(HostReadError), NoSyncingOps():
        torch.autograd.grad(torch.trace(x), x)


def _chunk(step, data, n_total, batch, steps=3, seed=0):
    """`steps` steps through `MinibatchChunks` on rows drawn on the host,
    the first outside the guard (it builds the jitter ladder), the rest
    inside it."""
    idx = torch.as_tensor(np.random.default_rng(seed).integers(
        0, n_total, (steps, batch)))
    chunks = MinibatchChunks(step, data)
    chunks(0, idx[:1])
    with _guarded():
        losses = chunks(1, idx[1:])
    assert torch.isfinite(losses).all()


def _mocap(n=64, d=5):
    return synthetic.mocap_like(prng.PRNGKey(0), n=n, d=d, device="cpu")[0]


@pytest.mark.parametrize("amortized", [False, True], ids=["c6", "c8"])
def test_svi_step_reads_nothing_back(amortized):
    Y = _mocap()
    cfg = svi_gplvm.Config(num_latent=2, num_inducing=5, batch=16,
                           amortized=amortized, encoder_hidden=4,
                           qx_var_floor=1e-3 if amortized else 0.0)
    opt = gp_optimizer(svi_gplvm.init_params(prng.PRNGKey(1), Y, cfg),
                       lr=1e-2, ngd_lr=None if amortized else 0.05,
                       decay_steps=50)
    step = svi_gplvm.make_svi_natgrad_step(
        cfg, Y.shape[0], opt, rho=0.2, rho_t0=10.0,
        qu_trust=100.0 if amortized else None)
    _chunk(step, Y, Y.shape[0], cfg.batch)


def test_dp_svi_stage_2c_step_reads_nothing_back():
    Y, _, _ = synthetic.grouped_dims(prng.PRNGKey(3), n=48, dims_per_group=(
        3, 3), q=2, device="cpu")
    cfg = dp_svi.Config(num_latent=2, num_inducing=5, truncation=3,
                        batch=16)
    opt = gp_optimizer(dp_svi.init_params(prng.PRNGKey(1), Y, cfg), lr=1e-2,
                       decay_steps=50, ngd_lr=0.05)
    step = dp_svi.make_dp_svi_step(cfg, Y.shape[0], opt, rho=0.3,
                                   rho_t0=10.0, phi_update="frozen")
    _chunk(step, Y, Y.shape[0], cfg.batch)


def test_mrd_svi_step_reads_nothing_back():
    Y1, Y2, _ = synthetic.two_view(prng.PRNGKey(0), n=48, d1=4, d2=5,
                                   device="cpu")
    cfg = mrd_svi.Config(num_latent=2, num_inducing=5, num_views=2, batch=16)
    opt = gp_optimizer(mrd_svi.init_params(prng.PRNGKey(1), (Y1, Y2), cfg),
                       lr=1e-2, decay_steps=50)
    step = mrd_svi.make_svi_natgrad_step(cfg, Y1.shape[0], opt, rho=0.2,
                                         rho_t0=10.0)
    _chunk(step, (Y1, Y2), Y1.shape[0], cfg.batch)


def test_full_batch_dp_step_reads_nothing_back():
    Y = _mocap(n=40, d=6)
    cfg = dp_gp_lvm.Config(num_latent=2, num_inducing=5, truncation=3)
    params = dp_gp_lvm.init_params(prng.PRNGKey(1), Y, cfg)
    opt = gp_optimizer(params, lr=1e-2, decay_steps=50, ngd_lr=0.05)
    multi = make_multi_step_fn(
        lambda p, y: dp_gp_lvm.loss(params, y, cfg), opt, 3)
    multi(Y, steps=1)
    with _guarded():
        losses = multi(Y, steps=2)
    assert torch.isfinite(losses).all()
