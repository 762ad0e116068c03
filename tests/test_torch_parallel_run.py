"""The runner's `--mesh` (`dp_gp_lvm_tpu_torch/experiments/run.py`) on the
CPU: c4 on a 2 x 2 mesh of gloo ranks under torchrun reproduces the
single-device run's final ELBO, a one-rank mesh in process reproduces it
too, and the meshes the runner cannot take are refused: the SVI configs'
(not ported yet), a mesh whose size is not the world's, and a mesh of
more than one rank on the card. No JAX."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from dp_gp_lvm_tpu_torch.core import config
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib

ROOT = pathlib.Path(__file__).resolve().parent.parent
C4_ARGS = ["c4_dp_mocap", "--device", "cpu", "--f64", "--n", "64",
           "--steps", "8"]


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


@pytest.mark.parametrize("name", ["c6_svi_bigN", "c7_dp_svi",
                                  "c8_amortized_svi", "c9_mrd_svi_bigN"])
def test_mesh_on_the_svi_configs_is_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        runner.main([name, "--device", "cpu", "--mesh", "1"])


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
