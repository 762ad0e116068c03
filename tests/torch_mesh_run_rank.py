"""One rank of the runner on a mesh, under torchrun, for
`tests/test_torch_parallel_run.py`:

    torchrun --nproc-per-node R tests/torch_mesh_run_rank.py CONFIG N KWARGS

trains CONFIG at `n=N` in f64 on the CPU through `run(config, **KWARGS)`
(KWARGS a JSON object of `run`'s keywords, `mesh` among them); rank 0
writes the result to the `out` keyword's directory. No JAX."""
import dataclasses
import json
import sys

import torch

from dp_gp_lvm_tpu_torch.core import config
from dp_gp_lvm_tpu_torch.experiments import run as runner
from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib


def main(name, n, kwargs):
    cfg = dataclasses.replace(config.get(name), n=int(n))
    try:
        runner.run(cfg, device="cpu", dtype=torch.float64,
                   **json.loads(kwargs))
    finally:
        mesh_lib.close_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:])
