"""The runner's `--mesh` (`dp_gp_lvm_tpu_torch/experiments/run.py`) on the
CPU: c4 and c7 (the staged DP-SVI) on a 2 x 2 mesh of gloo ranks under
torchrun reproduce the single-device runs' final ELBOs, a one-rank mesh in
process reproduces c4's and every SVI config's (c6-c9), and the meshes the
runner cannot take are refused: a mesh whose size is not the world's, and
a mesh of more than one rank on the card. No JAX."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dp_gp_lvm_tpu_torch.core import config
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib

ROOT = pathlib.Path(__file__).resolve().parent.parent
C4_ARGS = ["c4_dp_mocap", "--device", "cpu", "--f64", "--n", "64",
           "--steps", "8"]
# the SVI configs at a reduced size: (n, the run's keywords); c7's 20
# steps are its staged recipe's (70 with the warmup's floor)
SVI_RUNS = {
    "c6_svi_bigN": (128, dict(batch=32, steps=8, log_every=2)),
    "c7_dp_svi": (64, dict(batch=16, steps=20, log_every=5)),
    "c8_amortized_svi": (128, dict(batch=32, steps=8, log_every=2)),
    "c9_mrd_svi_bigN": (64, dict(batch=16, steps=12, log_every=2)),
}
IMPUTE_STEPS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def single_device_c4(tmp_path_factory):
    """The single-device run's result."""
    out = tmp_path_factory.mktemp("single")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert runner.main(C4_ARGS + ["--out", str(out)]) == 0
    finally:
        torch.set_num_threads(prev)
    return json.loads((out / "result.json").read_text())


def test_mesh_2x2_under_torchrun_reproduces_the_single_device_c4(
        tmp_path, single_device_c4):
    """Four gloo ranks, rows over two, the 20 atoms over two: the final
    ELBO (after the 8 training and 12 timing steps, on the gathered
    parameters) is the single-device run's at 1e-8, and only rank 0
    prints its result and writes result.json."""
    out = tmp_path / "mesh"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "dp_gp_lvm_tpu_torch.experiments.run",
         *C4_ARGS, "--mesh", "2,2", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = [ln for ln in proc.stdout.splitlines()
               if ln.startswith('{"config"')]
    assert len(results) == 1, proc.stdout
    got = json.loads((out / "result.json").read_text())
    assert json.loads(results[0]) == got
    want = single_device_c4
    assert abs(got["elbo"] - want["elbo"]) <= 1e-8 * abs(want["elbo"])
    assert not config.evaluate_checks("", got)        # every leaf finite


def test_one_rank_mesh_in_process_reproduces_the_single_device_c4(
        tmp_path, monkeypatch, single_device_c4):
    """`--mesh 1,1` without torchrun: a gloo group of one rank opened in
    process (as the card's NCCL group of one is), the sharded loss with no
    collective, the same final ELBO."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    try:
        assert runner.main(C4_ARGS + ["--mesh", "1,1", "--out",
                                      str(tmp_path / "mesh")]) == 0
        assert not torch.distributed.is_initialized()
    finally:
        mesh_lib.close_distributed()
    got = json.loads((tmp_path / "mesh" / "result.json").read_text())
    want = single_device_c4
    assert abs(got["elbo"] - want["elbo"]) <= 1e-10 * abs(want["elbo"])


def _svi_run(name, out=None, mesh=None):
    """The SVI config `name` at its reduced size, in process, f64 (the
    minibatch MRD's cross-view metric at 5 inference steps)."""
    n, kw = SVI_RUNS[name]
    cfg = dataclasses.replace(config.get(name), n=n)
    prev = runner.MRD_SVI_PREDICT_STEPS
    runner.MRD_SVI_PREDICT_STEPS = 5
    try:
        return runner.run(cfg, device="cpu", dtype=torch.float64, out=out,
                          impute_steps=IMPUTE_STEPS, mesh=mesh, **kw)
    finally:
        runner.MRD_SVI_PREDICT_STEPS = prev
        mesh_lib.close_distributed()


@pytest.fixture(scope="module")
def single_device_c7():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _svi_run("c7_dp_svi")
    finally:
        torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["c6_svi_bigN", "c7_dp_svi",
                                  "c8_amortized_svi", "c9_mrd_svi_bigN"])
def test_one_rank_mesh_run_equals_the_single_device_run(name, tmp_path,
                                                        monkeypatch, request):
    """`--mesh 1` on each SVI config (c6 resident, c7 through its staged
    recipe, c8 with its encoder, c9 through its two-phase recipe) in
    process, a gloo group of one rank as the card's NCCL group of one:
    the final ELBO, every metric and the exported parameters equal the
    single-device run's at 1e-10."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    got = _svi_run(name, out=str(tmp_path / "mesh"), mesh="1")
    assert not torch.distributed.is_initialized()
    want = (request.getfixturevalue("single_device_c7")
            if name == "c7_dp_svi" else _svi_run(name))
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float) and k not in ("seconds", "ms_per_step",
                                              "imputation_seconds",
                                              "cross_view_seconds"):
            assert abs(got[k] - w) <= 1e-10 * max(abs(w), 1.0), k
    assert not config.evaluate_checks("", got)
    assert (tmp_path / "mesh" / "params.npz").exists()


def test_c7_on_a_2x2_mesh_under_torchrun_reproduces_the_single_device_run(
        tmp_path, single_device_c7):
    """c7's staged recipe on four gloo ranks: stage 1 and the split whole
    on every rank, stages 2a-2c with the batch rows over two ranks and the
    8 atoms over two. The final ELBO (over every training row, on the
    gathered parameters) is the single-device run's at 1e-10, the
    imputation's and the group metrics too, and the stage boundaries hold
    the full parameters."""
    out = tmp_path / "mesh"
    n, kw = SVI_RUNS["c7_dp_svi"]
    kw = dict(kw, impute_steps=IMPUTE_STEPS, mesh="2,2", out=str(out))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(ROOT / "tests" / "torch_mesh_run_rank.py"),
         "c7_dp_svi", str(n), json.dumps(kw)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads((out / "result.json").read_text())
    want = single_device_c7
    for k in ("elbo", "noise_min", "imputation_mse",
              "predictive_loglik_per_dim", "group_purity_min"):
        assert abs(got[k] - want[k]) <= 1e-10 * abs(want[k]), k
    assert got["group_purities"] == want["group_purities"]
    with np.load(out / "stages" / "stage2b_assign.npz") as f:
        assert f["u_h"].shape[0] == config.get("c7_dp_svi").t


def test_a_mesh_whose_size_is_not_the_worlds_is_refused(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        runner.run(config.get("c4_dp_mocap"), device="cpu",
                   dtype=torch.float64, mesh="2,2")
    assert not torch.distributed.is_initialized()


def test_more_than_one_rank_on_the_card_is_refused():
    with pytest.raises(ValueError, match="NCCL runs one rank per card"):
        runner.open_mesh("2,2", torch.device("cuda"))
    with pytest.raises(ValueError, match="NCCL runs one rank per card"):
        runner.open_mesh("2", torch.device("cuda"))


C6_RUN = dict(n=128, batch=32, steps=8, log_every=2, mesh="1",
              impute_steps=IMPUTE_STEPS)


@pytest.mark.parametrize("stream", [False, True])
def test_mesh_resume_of_c6_ends_on_the_straight_mesh_runs_bits(
        tmp_path, monkeypatch, stream):
    """c6 on a one-rank mesh, resident or streamed: a run stopped after 4
    of 8 steps with checkpoints every 2 (the full state, gathered), then
    resumed (the state cut by the table again), ends on the parameters of
    the straight mesh run to the bit."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    kw = dict(C6_RUN)
    cfg = dataclasses.replace(config.get("c6_svi_bigN"), n=kw.pop("n"))
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    for extra in ({"out": str(straight)},
                  {"out": str(resumed), "stop_after": 4, "ckpt_every": 2},
                  {"out": str(resumed), "resume": True, "ckpt_every": 2}):
        try:
            runner.run(cfg, device="cpu", dtype=torch.float64, stream=stream,
                       **kw, **extra)
        finally:
            mesh_lib.close_distributed()
    with np.load(straight / "params.npz") as a, \
            np.load(resumed / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
