"""Training: the optimizer of the GP-LVM family and the training driver
(counterpart of `dp_gp_lvm_tpu/train/loop.py`: `gp_optimizer` with its
schedules, `NonFiniteGuard`, `make_step_fn`, `make_multi_step_fn`,
`time_steps`, `make_streaming_scan_fn`, `fit`, `fit_lbfgs`), and
`STEPS`, the count of steps the training loop has taken.

`gp_optimizer` reproduces the reference's optax chain
    apply_if_finite(chain(
        clip_by_global_norm(clip),
        multi_transform({hyper: adam(hyper_rate), var: adam(rate),
                         ard: adam(ard_rate), frozen: set_to_zero(),
                         ngd: chain(ngd_precondition,
                                    scale_by_schedule(-ngd_rate))})))
written by hand:
  - the global-norm clip is optax's (`clip_grad_norm_` adds 1e-6); the
    frozen group's gradients count in it and in the finiteness test;
  - a step whose gradients hold a non-finite value changes neither the
    parameters nor any group's state, and is decided on the device with
    `torch.where`, so the step needs no host sync;
  - Adam is optax's `scale_by_adam` (eps outside the square root);
  - each group keeps one count of applied steps. optax's `scale_by_adam`
    and `scale_by_schedule` hold a count each, but both advance on every
    applied step only, so they are equal: the bias correction reads
    count + 1 and the rate schedule reads count (step 1 runs at
    schedule(0)). The NGD group has its count too.
Schedules are optax's formulas, evaluated on the device from the count
tensor. `TrainState` is what the SVI loop of the runner carries and
`train/checkpoint.py` saves. `fit_lbfgs` is optax's L-BFGS with its zoom
line search, as a loop of autograd evaluations.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Callable

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.core.transforms import positive_variational_var
from dp_gp_lvm_tpu_torch.parallel import collectives

HYPER_PARAM_NAMES = frozenset(
    {"raw_variance", "raw_ard", "raw_noise", "raw_gamma1", "raw_gamma2",
     "raw_alpha"}
)
NGD_NAMES = frozenset({"qx_mean", "raw_qx_var"})
B1, B2, EPS = 0.9, 0.999, 1e-8
# optimizer steps the driver has taken (applied or skipped) since
# `reset_step_count`: a host-side count, no device read
STEPS = {"taken": 0}


def reset_step_count() -> None:
    STEPS["taken"] = 0


# ---------------------------------------------------------------------------
# schedules: integer count tensor -> rate tensor on its device
# ---------------------------------------------------------------------------


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule: init_value to alpha * init_value over
    decay_steps, constant after."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.to(torch.float64), max=float(decay_steps))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule: init_value to end_value over
    transition_steps, constant after; constant init_value when
    transition_steps <= 0. In float32, as optax gives it from the int32
    count of its state (JAX takes int32 / int to float32 even with 64-bit
    types on), and with XLA's arithmetic for it in the compiled update: the
    division by the constant becomes a product with its float32
    reciprocal, and both multiply-adds are fused, rounded once."""
    if transition_steps <= 0:
        return lambda count: torch.full(
            count.shape, float(init_value), dtype=torch.float64,
            device=count.device)
    # float32 operands as Python floats: their products are exact in float64
    f32 = torch.float32
    recip = (torch.tensor(1.0, dtype=f32) / transition_steps).item()
    slope = torch.tensor(init_value - end_value, dtype=f32).item()
    end = torch.tensor(end_value, dtype=f32).item()

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps).to(torch.float64)
        frac = (1.0 - c * recip).to(f32).to(torch.float64)
        return (slope * frac + end).to(f32)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: a linear warmup to peak_value,
    then a cosine decay to end_value; decay_steps counts the warmup. In
    float32 after a warmup, as optax gives it from an int32 count: its
    join takes the warmup's float32 and the decay's weakly typed float64
    to float32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count):
        head = warm(count)
        return torch.where(count < warmup_steps, head,
                           decay(count - warmup_steps)).to(head.dtype)

    return schedule


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def ngd_precondition(grads, params):
    """Inverse-Fisher preconditioner of the diag-Gaussian q(X) params:
    natgrad_m = s g_m, natgrad_raw = 2 s^2 / sigmoid(raw)^2 g_raw."""
    raw = params["raw_qx_var"]
    s = positive_variational_var(raw)
    sig = torch.sigmoid(raw)
    return {
        "qx_mean": grads["qx_mean"] * s,
        "raw_qx_var": grads["raw_qx_var"] * 2.0 * s * s / (sig * sig + 1e-12),
    }


def flat_leaves(params) -> dict:
    """{name: tensor} over `params`, MRD's `views` list of per-view dicts
    flattened as `views.{i}.{key}` over the same tensors. A loss over the
    nested dict closes over it; the optimizer takes the flat one."""
    leaves = {}
    for k, v in params.items():
        if k == "views":
            for i, view in enumerate(v):
                for kk, vv in view.items():
                    leaves[f"views.{i}.{kk}"] = vv
        else:
            leaves[k] = v
    return leaves


def leaf_name(path: str) -> str:
    """The parameter's own key of a `flat_leaves` name: `raw_ard` of
    `views.1.raw_ard`."""
    return path.rsplit(".", 1)[-1]


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm of a dict of tensors."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


class GPOptimizer:
    """Adam grouped by label, each group at its own rate, optional NGD on
    q(X), frozen leaves held.

    `labels` maps each parameter to its group: "hyper", "var", "ard",
    "ngd" or "frozen". `rates` maps every group but "frozen" to its rate:
    a float, or a schedule (integer count tensor -> rate tensor). `clip`
    is the global-norm clip (None: no clip).
    `step(grads)` updates the parameter tensors in place and returns
    whether it applied the update (a 0-d bool tensor, not read here).

    Across ranks (`mesh`, a `parallel.mesh.Mesh`, with `placement`, the
    flat table of where each leaf lies): `params` are the rank's shards,
    and `reduce(grads)` turns the rank's share of the gradient into the
    logical one (`parallel.collectives.reduce_grads`). The global norm
    then counts each shard of a cut leaf once and each whole leaf once,
    optax's norm of the logical tree, and the finiteness test is one
    decision for all ranks, so every rank applies or skips the same step
    and the whole leaves stay the same bits on every rank."""

    def __init__(self, params, labels, rates, clip, skip_nonfinite,
                 mesh=None, placement=None):
        self.params = params
        self.labels = labels
        self.rates = rates
        self.clip = clip
        self.skip_nonfinite = skip_nonfinite
        if (mesh is None) != (placement is None):
            raise ValueError("a mesh needs its placement table, and a "
                             "table its mesh")
        self.mesh, self.placement = mesh, placement
        device = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int64, device=device)
        self.count = {g: zero.clone() for g in rates}
        adam = [k for k, g in labels.items() if g not in ("ngd", "frozen")]
        self.mu = {k: torch.zeros_like(params[k]) for k in adam}
        self.nu = {k: torch.zeros_like(params[k]) for k in adam}
        self.notfinite_count = zero.clone()

    def _across_ranks(self) -> bool:
        return self.mesh is not None and self.mesh.world_size > 1

    def reduce(self, grads):
        """The logical gradient from this rank's share (the identity on
        one rank)."""
        if not self._across_ranks():
            return grads
        return collectives.reduce_grads(grads, self.placement, self.mesh)

    def global_norm(self, grads) -> torch.Tensor:
        """optax's global norm of the (logical) gradient tree."""
        if not self._across_ranks():
            return global_norm(grads)
        return collectives.global_norm(grads, self.placement, self.mesh)

    @torch.no_grad()
    def step(self, grads):
        keys = list(self.params)
        finite = torch.stack(
            [torch.isfinite(grads[k]).all() for k in keys]).all()
        if self._across_ranks():
            finite = collectives.all_true(finite, self.mesh)
        if self.skip_nonfinite:
            self.notfinite_count.copy_(torch.where(
                finite, torch.zeros_like(self.notfinite_count),
                self.notfinite_count + 1))
            apply = finite | (self.notfinite_count > self.skip_nonfinite)
        else:
            apply = torch.ones((), dtype=torch.bool, device=finite.device)

        if self.clip is None:
            clipped = grads
        else:
            g_norm = self.global_norm(grads)
            clipped = {
                k: torch.where(g_norm < self.clip, grads[k],
                               (grads[k] / g_norm) * self.clip)
                for k in keys
            }
        updates = {}
        for group, rate_fn in self.rates.items():
            # a group's count advances with or without members, as optax's,
            # in place (a captured step replays on the same tensors) once
            # the group's update has read it
            count = self.count[group]
            advanced = torch.where(apply, count + 1, count)
            members = [k for k in keys if self.labels[k] == group]
            if not members:
                count.copy_(advanced)
                continue
            rate = rate_fn(count) if callable(rate_fn) else rate_fn
            if group == "ngd":
                direction = ngd_precondition(clipped, self.params)
            else:
                direction = {}
                bc1 = 1.0 - B1 ** (count + 1).to(torch.float64)
                bc2 = 1.0 - B2 ** (count + 1).to(torch.float64)
                for k in members:
                    g = clipped[k]
                    mu = (1.0 - B1) * g + B1 * self.mu[k]
                    nu = (1.0 - B2) * (g * g) + B2 * self.nu[k]
                    mu_hat = mu / bc1.to(g.dtype)
                    nu_hat = nu / bc2.to(g.dtype)
                    direction[k] = mu_hat / (torch.sqrt(nu_hat) + EPS)
                    self.mu[k].copy_(torch.where(apply, mu, self.mu[k]))
                    self.nu[k].copy_(torch.where(apply, nu, self.nu[k]))
            for k in members:
                step = (-rate).to(direction[k].dtype) if torch.is_tensor(
                    rate) else -rate
                updates[k] = step * direction[k]
            count.copy_(advanced)
        for k, u in updates.items():
            p = self.params[k]
            p.copy_(torch.where(apply, p + u, p))
        return apply

    def state_dict(self) -> dict:
        """The parameters, the Adam moments, every group's count of applied
        steps (which drives its schedule) and the non-finite count:
        everything a step reads."""
        return {"params": self.params, "mu": self.mu, "nu": self.nu,
                "count": self.count,
                "notfinite_count": self.notfinite_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` into this optimizer's tensors in place (the
        tensors a step function closes over stay the ones it updates)."""
        for name in ("params", "mu", "nu", "count"):
            mine = getattr(self, name)
            if set(mine) != set(state[name]):
                raise ValueError(f"{name}: keys {sorted(state[name])} do not "
                                 f"match {sorted(mine)}")
            for k, v in state[name].items():
                mine[k].copy_(v)
        self.notfinite_count.copy_(state["notfinite_count"])


def gp_optimizer(params, lr: float = 1e-2, hyper_lr: float | None = None,
                 clip: float = 100.0, skip_nonfinite: int = 100_000,
                 decay_steps: int | None = None, ngd_lr: float | None = None,
                 ard_lr: float | None = None, ard_warmup: int | None = None,
                 hyper_warmup: int | None = None,
                 freeze: frozenset = frozenset(),
                 slow: frozenset = frozenset(), mesh=None,
                 placement=None) -> GPOptimizer:
    """Stability-tuned optimizer of the GP-LVM family: hypers at lr/10,
    global-norm clip, non-finite steps skipped, optional NGD on q(X).

    decay_steps cosine-decays lr, the hyper rate and the NGD rate to 5%
    of their value over that horizon (the hyper rate after a linear
    warmup of hyper_warmup steps when given). ard_lr gives raw_ard alone
    a hot Adam rate, ramped from 0 over ard_warmup steps: with
    decay_steps a warmup-cosine (default warmup min(2000, decay_steps //
    10)), without it a linear ramp (default 2000 steps), then constant.
    `freeze` leaves get a zero update; `slow` leaves move at the hyper
    rate. The NGD group is dropped when no leaf carries its label. MRD's
    per-view leaves are labelled by their own key, as the reference
    labels its `views` subtree; the optimizer holds them flat
    (`flat_leaves`). `mesh` and `placement` (the params' table,
    `parallel/auto.py`, nested as the params are) train the rank's
    shards of a sharded loss (`parallel/recipe.py::sharded_setup`).
    """
    hyper_lr = lr / 10.0 if hyper_lr is None else hyper_lr
    lr_rate, hyper_rate, ngd_rate, ard_rate = lr, hyper_lr, ngd_lr, None
    if decay_steps:
        if ngd_lr is not None:
            ngd_rate = cosine_decay_schedule(ngd_lr, decay_steps, alpha=0.05)
        lr_rate = cosine_decay_schedule(lr, decay_steps, alpha=0.05)
        if hyper_warmup:
            hyper_rate = warmup_cosine_decay_schedule(
                0.0, hyper_lr, hyper_warmup, decay_steps,
                end_value=0.05 * hyper_lr)
        else:
            hyper_rate = cosine_decay_schedule(hyper_lr, decay_steps,
                                               alpha=0.05)
        if ard_lr is not None:
            warm = (ard_warmup if ard_warmup is not None
                    else min(2000, decay_steps // 10))
            ard_rate = warmup_cosine_decay_schedule(
                0.0, ard_lr, warm, decay_steps, end_value=0.05 * ard_lr)
    elif ard_lr is not None:
        warm = 2000 if ard_warmup is None else ard_warmup
        ard_rate = linear_schedule(0.0, ard_lr, max(warm, 1))

    def label(k):
        if k in freeze:
            return "frozen"
        if ard_lr is not None and k == "raw_ard":
            return "ard"
        if k in HYPER_PARAM_NAMES or k in slow:
            return "hyper"
        if ngd_lr is not None and k in NGD_NAMES:
            return "ngd"
        return "var"

    leaves = flat_leaves(params)
    labels = {k: label(leaf_name(k)) for k in leaves}
    rates = {"hyper": hyper_rate, "var": lr_rate}
    if ard_lr is not None:
        rates["ard"] = ard_rate
    if "ngd" in labels.values():
        rates["ngd"] = ngd_rate
    return GPOptimizer(leaves, labels, rates, clip, skip_nonfinite, mesh,
                       None if placement is None else flat_leaves(placement))


@dataclasses.dataclass
class TrainState:
    """What the SVI loop carries from step to step (the reference's
    TrainState(params, opt_state, step)): the optimizer, which holds the
    parameters, its moments and its counts, and the global step, a host
    integer (the loop knows it without reading the card)."""

    optimizer: GPOptimizer
    step: int = 0

    @property
    def params(self):
        return self.optimizer.params


class NonFiniteGuard:
    """K-consecutive-non-finite-chunks abort for chunked training loops.

    apply_if_finite skips bad updates, but nothing halts a loop once the
    parameters themselves are poisoned. Feed each chunk's losses (one
    tensor: one host read) to `update`; when `k` consecutive chunks hold a
    non-finite value it returns True and the loop must stop and fail the
    run. One finite chunk resets the counter, so a transient
    skip-and-recover does not end a run."""

    def __init__(self, k: int = 3):
        self.k = k
        self.consecutive = 0
        self.first_bad_step: int | None = None

    def update(self, losses, step: int) -> bool:
        if bool(torch.isfinite(torch.as_tensor(losses)).all()):
            self.consecutive = 0
            self.first_bad_step = None
            return False
        if self.consecutive == 0:
            self.first_bad_step = step
        self.consecutive += 1
        return self.consecutive >= self.k


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _gradient_step(loss_fn: Callable, optimizer: GPOptimizer):
    keys = list(optimizer.params)
    leaves = [optimizer.params[k] for k in keys]

    def one(*data):
        loss = loss_fn(optimizer.params, *data)
        grads = optimizer.reduce(
            dict(zip(keys, torch.autograd.grad(loss, leaves))))
        optimizer.step(grads)
        STEPS["taken"] += 1
        return loss.detach(), grads

    return one


def make_step_fn(loss_fn: Callable, optimizer: GPOptimizer):
    """`step(*data) -> metrics`: one loss, gradient and update of
    `optimizer.params` in place. `loss`, `elbo` and `grad_norm` (of the
    unclipped gradient) are 0-d device tensors; nothing is read back."""
    one = _gradient_step(loss_fn, optimizer)

    def step(*data):
        loss, grads = one(*data)
        return {"loss": loss, "elbo": -loss,
                "grad_norm": optimizer.global_norm(grads)}

    return step


# ---------------------------------------------------------------------------
# chunks of steps replayed from a CUDA graph (the reference's jitted chunk)
# ---------------------------------------------------------------------------

# graphs captured and replays run since `reset_graph_counts`
GRAPHS = {"captures": 0, "replays": 0}


def reset_graph_counts() -> None:
    GRAPHS["captures"] = GRAPHS["replays"] = 0


def _host_counts():
    """The host-side counters a step bumps, as (dict, key) pairs: the
    training loop's STEPS and the kernel wrappers' launches."""
    from dp_gp_lvm_tpu_torch.ops import psi

    return [(STEPS, "taken")] + [(psi.LAUNCHES, k) for k in psi.LAUNCHES]


class StepGraph:
    """One step, `body()`, run `n` times a chunk: captured once as a CUDA
    graph and replayed on the card, called eagerly elsewhere.

    `body` takes every input from tensors whose storage stays put (the
    parameters and optimizer state it updates in place, the chunk's
    buffers, a step counter on the device) and writes what the chunk
    returns into such tensors; it reads nothing back to the host. The
    first step on the card is the warm-up: `body` eagerly on a side
    stream (it builds the kernels, handles and workspaces, and is a real
    step of the chunk); then one capture, and every later step is a
    replay. A replay runs no Python, so the host counts a step bumps
    (`STEPS`, `ops.psi.LAUNCHES`) get what the capture counted once per
    replay, and the capture itself counts nothing (the card tests and
    `chip_smoke.py` hold those counts against a profiler trace of the
    replays). A failed capture or replay raises: there is no fall back to
    the eager loop. `graphed` False (the CPU, a mesh, a debugging run)
    calls `body` every step."""

    def __init__(self, body: Callable, graphed: bool):
        self.body = body
        self.graphed = graphed
        self.graph = None
        self.delta = None

    def run(self, n: int) -> None:
        if not self.graphed:
            for _ in range(n):
                self.body()
            return
        if self.graph is None and n > 0:
            self._capture()
            n -= 1
        counts = _host_counts()
        for _ in range(n):
            self.graph.replay()
            for (table, key), d in zip(counts, self.delta):
                table[key] += d
        GRAPHS["replays"] += n

    def _capture(self) -> None:
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.body()                       # the warm-up: a real step
        stream.wait_stream(side)
        counts = _host_counts()
        before = [table[key] for table, key in counts]
        graph = torch.cuda.CUDAGraph()
        # a graph captured before that is now garbage in a reference cycle
        # (a dropped MinibatchChunks and its StepGraph) must not be freed
        # during this capture: destroying a CUDA graph is a call a capture
        # forbids, and it invalidates the capture. So collect first, and
        # do not collect while capturing.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.body()
        finally:
            if collecting:
                gc.enable()
        self.delta = [table[key] - b for (table, key), b in zip(counts,
                                                                before)]
        for (table, key), b in zip(counts, before):
            table[key] = b
        self.graph = graph
        GRAPHS["captures"] += 1


def replayed(device: torch.device, mesh, eager: bool) -> bool:
    """Whether a chunked loop replays its steps from a CUDA graph: on the
    card, off a mesh (no capture there yet), unless the caller asks for
    eager steps. The one place this is decided."""
    return device.type == "cuda" and mesh is None and not eager


def make_multi_step_fn(loss_fn: Callable, optimizer: GPOptimizer,
                       num_inner: int, eager: bool = False):
    """`multi_step(*data, steps=num_inner) -> losses`: `steps` (at most
    num_inner) full-batch steps on fixed `data`; their losses come back as
    one (steps,) device tensor, so the caller reads the host once per
    chunk. On the card (off a mesh, unless `eager`) the step is captured
    once (`StepGraph`) and replayed; new data objects capture it anew."""
    one = _gradient_step(loss_fn, optimizer)
    device = next(iter(optimizer.params.values())).device
    held = {"data": None}
    losses = None
    row = torch.zeros((), dtype=torch.int64, device=device)

    def body():
        loss = one(*held["data"])[0]
        losses.index_copy_(0, row.view(1), loss.reshape(1))
        row.add_(1)

    graph = StepGraph(body, replayed(device, optimizer.mesh, eager))

    def multi_step(*data, steps: int = num_inner):
        nonlocal losses, graph
        if steps > num_inner:
            raise ValueError(f"{steps} steps do not fit a chunk of "
                             f"{num_inner}")
        if held["data"] is None or len(data) != len(held["data"]) or any(
                a is not b for a, b in zip(data, held["data"])):
            held["data"] = data
            graph = StepGraph(body, graph.graphed)
        if losses is None:
            dtype = next(iter(optimizer.params.values())).dtype
            losses = torch.zeros(num_inner, dtype=dtype, device=device)
        row.zero_()
        graph.run(steps)
        return losses[:steps].clone()

    multi_step.num_inner = num_inner
    return multi_step


class MinibatchChunks:
    """Chunks of a minibatch step on rows the host drew, one call a chunk:
    `chunks(t0, idx) -> losses` runs steps t0, ..., t0 + n - 1 on the rows
    idx (n, B) of the resident `data` (`step(t, idx_b, data)`), or with
    `streaming` `chunks(t0, idx, y)` on the fed rows y (n, B, D)
    (`step(t, (idx_b, y_b))`). The losses come back as one (n,) device
    tensor: nothing is read back here.

    The chunk's rows are copied once into fixed device buffers and step i
    selects its row with a step counter on the device, which also hands
    the step its global step t (a 0-d int64 tensor); the step advances
    both. On the card (off a `mesh`, unless `eager`) the step is
    captured once (`StepGraph`) and replayed for each step of every
    chunk; a chunk longer than the buffers makes them anew and captures
    again."""

    def __init__(self, step_fn: Callable, data=None, *,
                 streaming: bool = False, eager: bool = False, mesh=None):
        self.step_fn, self.data, self.streaming = step_fn, data, streaming
        self.eager, self.mesh = eager, mesh
        self.idx = self.y = self.losses = self.graph = None

    def _body(self):
        row = self.row.view(1)
        idx_b = self.idx.index_select(0, row)[0]
        if self.streaming:
            y_b = self.y.index_select(0, row)[0]
            loss = self.step_fn(self.t, (idx_b, y_b))
        else:
            loss = self.step_fn(self.t, idx_b, self.data)
        self.losses.index_copy_(0, row, loss.detach().reshape(1))
        self.t.add_(1)
        self.row.add_(1)

    def _buffers(self, idx, y, dtype):
        n = idx.shape[0]
        if self.idx is not None and n <= self.idx.shape[0] and (
                not self.streaming or y.shape[1:] == self.y.shape[1:]):
            return
        device = idx.device
        self.idx = torch.empty(idx.shape, dtype=torch.int64, device=device)
        self.y = (torch.empty(y.shape, dtype=y.dtype, device=device)
                  if self.streaming else None)
        self.losses = torch.zeros(n, dtype=dtype, device=device)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = StepGraph(self._body,
                               replayed(device, self.mesh, self.eager))

    def __call__(self, t0: int, idx, y=None):
        n = idx.shape[0]
        first = self.data[0] if isinstance(self.data, (tuple, list)) \
            else self.data
        dtype = y.dtype if self.streaming else first.dtype
        self._buffers(idx, y, dtype)
        self.idx[:n].copy_(idx)
        if self.streaming:
            self.y[:n].copy_(y)
        self.t.fill_(t0)
        self.row.zero_()
        self.graph.run(n)
        return self.losses[:n].clone()


def _wait(tensor):
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def time_steps(multi_step, data: tuple, num_steps: int,
               warmup: int = 2) -> float:
    """Wall-clock seconds per step of a `make_multi_step_fn` loop over
    `num_steps` steps after `warmup`, run as the training runs them
    (replayed on the card). The steps train on: the optimizer's
    parameters and counts advance by warmup + num_steps, as the
    reference's state does."""
    def steps(n):
        while n > 0:
            k = min(n, multi_step.num_inner)
            out = multi_step(*data, steps=k)
            n -= k
        return out

    _wait(steps(warmup))
    t0 = time.perf_counter()
    _wait(steps(num_steps))
    return (time.perf_counter() - t0) / num_steps


def make_streaming_scan_fn(step_fn, eager: bool = False, mesh=None):
    """`scan_chunk(state, idx, y) -> (state, losses)`: one host-fed chunk
    of streamed minibatch steps, idx (chunk, B) and y (chunk, B, D) as
    `data/stream.ChunkStream.next_chunk` gives them. `step_fn(t, (idx_b,
    y_b))` is a streamed step (`svi_gplvm.make_svi_natgrad_step(...,
    streaming=True)`), t the global step its rates read (the device
    counter of `MinibatchChunks`, which runs the chunk, replayed from a
    CUDA graph on the card unless `eager` or a `mesh`); `state` (a
    `TrainState`) advances by the chunk.
    The losses stay on the device as one (chunk,) tensor: nothing is read
    back here."""
    chunks = MinibatchChunks(step_fn, streaming=True, eager=eager,
                             mesh=mesh)

    def scan_chunk(state: TrainState, idx, y):
        losses = chunks(state.step, idx, y)
        state.step += idx.shape[0]
        return state, losses

    return scan_chunk


def fit(loss_fn: Callable, params, data: tuple, num_steps: int,
        lr: float = 1e-2, log_every: int = 0,
        callback: Callable | None = None):
    """Convenience trainer: plain Adam (optax's `adam`: eps 1e-8, bias
    correction, no clip) on every parameter of `params`, updated in place.
    Returns (params, {"elbo": [...]}), the ELBO (-loss before the step)
    read at steps 0, log_every, ... and the last, where `callback(i, elbo,
    metrics)` is called too."""
    opt = GPOptimizer(params, dict.fromkeys(params, "var"), {"var": lr},
                      clip=None, skip_nonfinite=0)
    step = make_step_fn(loss_fn, opt)
    elbos = []
    for i in range(num_steps):
        metrics = step(*data)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            e = float(metrics["elbo"])
            elbos.append(e)
            if callback is not None:
                callback(i, e, metrics)
    return params, {"elbo": elbos}


# ---------------------------------------------------------------------------
# L-BFGS: optax's `lbfgs` with its zoom line search
# ---------------------------------------------------------------------------

LBFGS_LINESEARCH_STEPS = 20     # optax.lbfgs's max_linesearch_steps
_SLOPE_RTOL, _CURV_RTOL = 1e-4, 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5      # scale_by_zoom_linesearch's stepsize_precision
_INCREASE_FACTOR = 2.0


def _tree_vdot(x: dict, y: dict) -> torch.Tensor:
    """optax.tree.vdot: per-leaf dot products summed in the leaves' order
    (a dict's sorted keys, as JAX flattens it)."""
    out = None
    for k in sorted(x):
        v = torch.sum(x[k] * y[k])
        out = v if out is None else out + v
    return out


def _tree_axpy(x: dict, a, y: dict) -> dict:
    """optax.tree.add_scale: x + a * y."""
    return {k: x[k] + a * y[k] for k in x}


def _value_and_grad(fun: Callable, params: dict):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        value = fun(leaves)
        grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


class _ZoomLinesearch:
    """optax's `zoom_linesearch` (Nocedal and Wright's algorithms 3.5 and
    3.6 with Hager and Zhang's approximate decrease), with the settings
    `optax.lbfgs` gives it: at most 20 evaluations, a first guess of 1,
    no largest step, tol 0. Its scalars are host numbers of the
    parameters' width (numpy float32 or float64: IEEE semantics, NaN
    included, as the reference's 0-d arrays); the gradients stay on the
    device. `run` returns (stepsize, value, grad, evaluations)."""

    def __init__(self, fun, params, updates, value, grad, dtype):
        self.fun, self.params, self.updates = fun, params, updates
        self.f = np.float32 if dtype == torch.float32 else np.float64
        f = self.f
        self.value_init = f(float(value))
        self.slope_init = f(float(_tree_vdot(updates, grad)))
        self.stepsize, self.value, self.grad = f(0.0), self.value_init, grad
        self.slope = self.slope_init
        self.low = self.high = self.cubic_ref = f(0.0)
        self.value_low = self.value_high = self.value_cubic_ref = \
            self.value_init
        self.slope_low = self.slope_high = self.slope_init
        self.safe_stepsize, self.safe_value, self.safe_grad = (
            f(0.0), self.value_init, grad)
        self.decrease_error = f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.count = 0

    def _on_line(self, stepsize):
        value, grad = _value_and_grad(
            self.fun, _tree_axpy(self.params, float(stepsize), self.updates))
        slope = _tree_vdot(grad, self.updates)
        value, slope = torch.stack([value, slope]).tolist()
        return self.f(value), grad, self.f(slope)

    def _decrease_error(self, stepsize, value, slope):
        armijo = (value - self.value_init
                  - _SLOPE_RTOL * stepsize * self.slope_init)
        approx = slope - (2 * _SLOPE_RTOL - 1.0) * self.slope_init
        delta = (value - self.value_init
                 - _APPROX_DEC_RTOL * np.abs(self.value_init))
        err = np.maximum(np.minimum(np.maximum(approx, delta), armijo), 0.0)
        return self.f(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope):
        err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(self.slope_init),
                         0.0)
        return self.f(np.inf) if np.isnan(err) else err

    def _search_interval(self):
        prev = (self.stepsize, self.value, self.slope)
        new = (self.f(1.0) if self.count == 0
               else self.f(_INCREASE_FACTOR) * self.stepsize)
        value, grad, slope = self._on_line(new)
        dec = self._decrease_error(new, value, slope)
        err = np.maximum(dec, self._curvature_error(slope))
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                new, value, grad)
        set_high = (dec > 0.0) or (value >= prev[1] and self.count > 0)
        set_low = slope >= 0.0 and not set_high
        if set_low:
            (self.low, self.value_low, self.slope_low), \
                (self.high, self.value_high, self.slope_high) = (
                    (new, value, slope), prev)
        else:
            (self.low, self.value_low, self.slope_low), \
                (self.high, self.value_high, self.slope_high) = (
                    prev, (new, value, slope))
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.interval_found = set_high or set_low or err <= 0.0
        self.done = bool(err <= 0.0)
        self.failed = (self.count + 1 >= LBFGS_LINESEARCH_STEPS
                       and not self.done)
        self.stepsize, self.value, self.grad, self.slope = (
            new, value, grad, slope)
        self.decrease_error = dec

    def _zoom(self):
        f = self.f
        low, high = self.low, self.high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic = _cubicmin(low, self.value_low, self.slope_low, high,
                          self.value_high, self.cubic_ref,
                          self.value_cubic_ref)
        quad = _quadmin(low, self.value_low, self.slope_low, high,
                        self.value_high)
        if left + f(0.2) * delta < cubic < right - f(0.2) * delta:
            middle = cubic
        elif left + f(0.1) * delta < quad < right - f(0.1) * delta:
            middle = quad
        else:
            middle = (low + high) / f(2.0)
        value, grad, slope = self._on_line(middle)
        dec = self._decrease_error(middle, value, slope)
        err = np.maximum(dec, self._curvature_error(slope))
        if dec <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                middle, value, grad)
        self.done = bool(err <= 0.0)
        set_high_to_middle = (dec > 0.0) or (value >= self.value_low)
        set_high_to_low = ((slope * (high - low) >= 0.0)
                           and not set_high_to_middle)
        old_low = (low, self.value_low, self.slope_low)
        old_high = (high, self.value_high)
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_to_low:
            self.high, self.value_high, self.slope_high = old_low
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        self.cubic_ref, self.value_cubic_ref = (
            old_high if set_high_to_middle or set_high_to_low
            else old_low[:2])
        too_small = delta <= _INTERVAL_THRESHOLD
        self.failed = ((self.count + 1 >= LBFGS_LINESEARCH_STEPS
                        or (too_small and self.safe_stepsize > 0.0))
                       and not self.done)
        self.stepsize, self.value, self.grad, self.slope = (
            middle, value, grad, slope)
        self.decrease_error = dec

    def run(self):
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom()
            else:
                self._search_interval()
            self.count += 1
            if self.failed and (self.safe_stepsize > 0.0
                                or np.isinf(self.decrease_error)):
                # the safeguard: the best step with sufficient decrease
                # (or none, outside the function's domain)
                self.stepsize, self.value, self.grad = (
                    self.safe_stepsize, self.safe_value, self.safe_grad)
        return self.stepsize, self.value, self.grad, self.count


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (scipy's, as optax takes it); NaN where it has
    none."""
    C = fpa
    db, dc = b - a, c - a
    dbc = db * dc
    denom = dbc * dbc * (db - dc)
    rb, rc = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * rb - db * db * rc) / denom
    B = (-(dc * dc * dc) * rb + db * db * db * rc) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def fit_lbfgs(loss_fn: Callable, params, data: tuple, num_steps: int = 100,
              memory_size: int = 15, info: dict | None = None):
    """L-BFGS training, the reference's `fit_lbfgs`: optax's `lbfgs`
    (`scale_by_lbfgs` with the scaled-identity initial preconditioner, a
    ring of `memory_size` (s, y) pairs and the two-loop recursion; then
    the zoom line search from a first step of 1), as a Python loop of
    autograd evaluations. As optax's `value_and_grad_from_state`, a step
    reuses the value and gradient the line search computed at the point
    it accepted, so the evaluations are the reference's. For smooth
    full-batch problems (GP regression, SGPR, the Bayesian GP-LVM bound).

    `params` is a dict of tensors (left as they are); returns (the trained
    params, detached, losses (num_steps,) on their device: the loss at
    the start of each step). With `info`, its "evaluations" is set to the
    loss evaluations made and "linesearch_steps" to each step's."""
    fun = lambda p: loss_fn(p, *data)
    p = {k: v.detach().clone() for k, v in params.items()}
    first = next(iter(p.values()))
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    mem_s = [zeros] * memory_size      # parameter differences, a ring
    mem_y = [zeros] * memory_size      # gradient differences
    rho = [torch.zeros((), dtype=first.dtype, device=first.device)
           ] * memory_size
    prev_p = prev_g = zeros
    value = grad = None
    losses, ls_steps, evals = [], [], 0
    for count in range(num_steps):
        # value_and_grad_from_state: the line search's, while finite
        if value is None or not np.isfinite(value):
            value_t, grad = _value_and_grad(fun, p)
            evals += 1
        else:
            value_t = torch.tensor(value, dtype=first.dtype,
                                   device=first.device)
        losses.append(value_t)
        # scale_by_lbfgs: the newest pair into the ring, then P g
        idx, prev_idx = count % memory_size, (count - 1) % memory_size
        if count > 0:
            ds = {k: p[k] - prev_p[k] for k in p}
            dy = {k: grad[k] - prev_g[k] for k in p}
            sy, yy = _tree_vdot(dy, ds), _tree_vdot(dy, dy)
            mem_s[prev_idx], mem_y[prev_idx] = ds, dy
            rho[prev_idx] = torch.where(sy == 0.0, torch.zeros_like(sy),
                                        1.0 / sy)
            gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(yy))
        else:
            gamma = torch.clamp(1.0 / torch.sqrt(_tree_vdot(grad, grad)),
                                max=1.0)
        order = [(idx + i) % memory_size for i in range(memory_size)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rho[i] * _tree_vdot(mem_s[i], vec)
            vec = _tree_axpy(vec, -alphas[i], mem_y[i])
        vec = {k: gamma * v for k, v in vec.items()}
        for i in order:
            beta = rho[i] * _tree_vdot(mem_y[i], vec)
            vec = _tree_axpy(vec, alphas[i] - beta, mem_s[i])
        prev_p, prev_g = p, grad
        # scale(-1), then the zoom line search along that direction
        direction = {k: -v for k, v in vec.items()}
        with np.errstate(all="ignore"):
            stepsize, value, grad, n = _ZoomLinesearch(
                fun, p, direction, value_t, grad, first.dtype).run()
        evals += n
        ls_steps.append(n)
        p = _tree_axpy(p, float(stepsize), direction)
    if info is not None:
        info.update(evaluations=evals, linesearch_steps=ls_steps)
    return p, torch.stack(losses)
