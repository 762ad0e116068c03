"""Checkpoint and resume of the port's SVI loop (`train/checkpoint.py`,
`experiments/run.py`) on the CPU, in process: a run interrupted at a
checkpoint and resumed ends bit for bit where the uninterrupted run ends
(the reference's `tests/test_resume_cli.py`, at its shape), a run whose
losses go non-finite aborts with exit 3, and the checkpointer and the
.npz export round-trip. No JAX is imported here."""
import json

import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.train.checkpoint import (
    Checkpointer,
    export_npz,
    load_npz,
)
from dp_gp_lvm_tpu_torch.train.loop import TrainState, gp_optimizer

SMALL = ["c6_svi_bigN", "--device", "cpu", "--n", "128", "--batch", "32",
         "--log-every", "2"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(out, *extra):
    assert runner.main(SMALL + ["--out", str(out), *extra]) == 0
    return json.loads((out / "result.json").read_text())


def test_svi_loop_resume_is_bit_identical(tmp_path, capsys):
    straight, stopped = tmp_path / "straight", tmp_path / "interrupted"
    res_a = _run(straight, "--steps", "8")
    # the same schedules (--steps 8), the loop stopped at step 4 with a
    # checkpoint there, then resumed to the end
    _run(stopped, "--steps", "8", "--stop-after", "4", "--ckpt-every", "2")
    assert sorted(p.name for p in (stopped / "ckpt").iterdir()) == [
        "ckpt_2.pt", "ckpt_4.pt"]
    capsys.readouterr()
    res_b = _run(stopped, "--steps", "8", "--resume", "--ckpt-every", "2")
    assert "resumed at step 4" in capsys.readouterr().out
    assert res_a["elbo"] == res_b["elbo"]
    assert res_a["imputation_mse"] == res_b["imputation_mse"]
    a, b = (load_npz(str(d / "params.npz")) for d in (straight, stopped))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    log = [json.loads(line)["step"] for line in
           (stopped / "train.jsonl").read_text().splitlines()]
    assert log == [1, 3, 5, 7]             # one line a chunk, both halves
    # at most `keep` = 3 checkpoints remain
    assert sorted(p.name for p in (stopped / "ckpt").iterdir()) == [
        "ckpt_4.pt", "ckpt_6.pt", "ckpt_8.pt"]


def test_divergent_run_aborts_with_exit_3(tmp_path, capsys):
    out = tmp_path / "diverged"
    with pytest.raises(SystemExit) as exc:
        runner.main(SMALL + ["--steps", "200", "--out", str(out),
                             "--inject-nonfinite-at", "6"])
    assert exc.value.code == 3
    assert "ABORT" in capsys.readouterr().out
    res = json.loads((out / "result.json").read_text())
    assert res["aborted_nonfinite"] is True
    assert res["first_nonfinite_step"] >= 6
    assert res["aborted_at_step"] <= 20    # well short of 200


def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    params = {"qx_mean": torch.randn(5, 2, generator=gen,
                                     dtype=torch.float64),
              "raw_noise": torch.randn((), generator=gen,
                                       dtype=torch.float64),
              "z": torch.randn(3, 2, generator=gen, dtype=torch.float64)}
    opt = gp_optimizer({k: torch.nn.Parameter(v) for k, v in params.items()},
                       lr=1e-2, decay_steps=10)
    return TrainState(opt)


def test_checkpointer_round_trips_the_whole_state(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    assert ck.latest_step() is None and ck.restore(_state(0)) is None
    state = _state(0)
    for t in range(3):
        grads = {k: torch.full_like(v, 0.5 + t) for k, v in
                 state.params.items()}
        state.optimizer.step(grads)
        state.step = t + 1
        ck.save(state)
    assert ck.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_2.pt", "ckpt_3.pt"]
    other = _state(1)
    assert ck.restore(other) is other and other.step == 3
    mine, theirs = state.optimizer.state_dict(), other.optimizer.state_dict()
    for name in ("params", "mu", "nu", "count"):
        for k in mine[name]:
            assert torch.equal(mine[name][k], theirs[name][k]), (name, k)
    assert torch.equal(mine["notfinite_count"], theirs["notfinite_count"])
    ck.close()


def test_export_npz_round_trips(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": np.float64(2.5),
            "nested": {"c": np.ones(4, np.float32), "d": [np.zeros(2)]}}
    path = str(tmp_path / "params.npz")
    export_npz(path, tree)
    got = load_npz(path)
    assert sorted(got) == ["a", "b", "nested/c", "nested/d/0"]
    np.testing.assert_array_equal(got["a"], tree["a"].numpy())
    assert got["b"] == 2.5 and got["nested/c"].dtype == np.float32
    np.testing.assert_array_equal(got["nested/d/0"], np.zeros(2))
