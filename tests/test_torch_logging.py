"""The port's TensorBoard logger and profiler scopes (`train/logging.py`):
the event files `TensorBoardLogger` writes read back, through
TensorBoard's own `EventAccumulator`, with the scalars logged; without
the `tensorboard` package the logger is inactive; and the DP loss's three
scopes (`psi_stats`, `kuu_gram`, `collapsed_bound`, where the reference
puts its `jax.named_scope`s) appear in a CPU `torch.profiler` trace of
one loss. No JAX is imported here."""
import sys

import pytest
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
from dp_gp_lvm_tpu_torch.models import dp_gp_lvm
from dp_gp_lvm_tpu_torch.train.logging import TensorBoardLogger, named_scope

SCOPES = ("psi_stats", "kuu_gram", "collapsed_bound")


def test_tensorboard_events_read_back(tmp_path):
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:
        pytest.skip("the tensorboard package is not installed")
    logger = TensorBoardLogger(str(tmp_path))
    assert logger.active
    logged = {0: (-10.5, 0.25), 50: (-3.0, 0.125), 99: (-1.75, 0.0625)}
    for step, (elbo, noise) in logged.items():
        logger.log(step, elbo=torch.tensor(elbo), noise=noise, tag="skipped")
    logger.close()
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["elbo", "noise"]
    for i, name in enumerate(("elbo", "noise")):
        events = acc.Scalars(name)
        assert [e.step for e in events] == list(logged)
        assert [e.value for e in events] == [v[i] for v in logged.values()]


def test_logger_is_inactive_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = TensorBoardLogger(str(tmp_path))
    assert not logger.active
    logger.log(0, elbo=1.0)
    logger.close()
    assert list(tmp_path.iterdir()) == []


def test_dp_loss_scopes_appear_in_a_profiler_trace():
    key = prng.PRNGKey(0)
    Y, _ = mocap_like(key, n=24, d=4, device="cpu")
    cfg = dp_gp_lvm.Config(num_latent=2, num_inducing=5, truncation=3)
    params = dp_gp_lvm.init_params(key, Y, cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with named_scope("one_loss"):
            dp_gp_lvm.loss(params, Y, cfg)
    counts = {}
    for event in prof.events():
        counts[event.name] = counts.get(event.name, 0) + 1
    # each scope once: around the batched call, not inside a loop of atoms
    assert {name: counts.get(name) for name in SCOPES + ("one_loss",)} == {
        name: 1 for name in SCOPES + ("one_loss",)}
