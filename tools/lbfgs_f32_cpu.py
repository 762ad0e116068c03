#!/usr/bin/env python3
"""The reference's and the port's `fit_lbfgs` on c2's bound in float32, on
the CPU.

    JAX_PLATFORMS=cpu python3 tools/lbfgs_f32_cpu.py [--steps 20]

Both start from the JAX package's float32 draw of `oil_flow_like`
(PRNGKey(0), 1000 x 12) and its `bgplvm.init_params` (Q=10, M=50), and
minimise minus the bound at the float32 jitter 1e-4 for `--steps` L-BFGS
steps: the reference through its own `fit_lbfgs` (optax in one jitted
scan, its loss evaluations counted by a debug callback), the port through
`train/loop.py::fit_lbfgs` on the plain path. One JSON line each: the
per-step losses and the evaluations (the port's per step too). Float32
breaks the two trajectories apart after a few steps; the line searches'
evaluations say how hard float32 makes the search for each. Needs JAX:
run it on the CPU host, not on the card's machine.
"""
import argparse
import json
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from dp_gp_lvm_tpu.core.types import JitterPolicy as JJitterPolicy  # noqa
from dp_gp_lvm_tpu.data import synthetic as jsyn  # noqa: E402
from dp_gp_lvm_tpu.models import bgplvm as jbgplvm  # noqa: E402
from dp_gp_lvm_tpu.train.loop import fit_lbfgs as jfit_lbfgs  # noqa: E402
from dp_gp_lvm_tpu_torch.core.types import JitterPolicy  # noqa: E402
from dp_gp_lvm_tpu_torch.models import bgplvm  # noqa: E402
from dp_gp_lvm_tpu_torch.train.loop import fit_lbfgs  # noqa: E402

JITTER = 1e-4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    key = jax.random.PRNGKey(0)
    Y, _, _ = jsyn.oil_flow_like(key, n=1000, d=12, dtype=jnp.float32)
    cfg = jbgplvm.Config(num_latent=10, num_inducing=50)
    p0 = jbgplvm.init_params(key, Y, cfg)
    evaluations = [0]

    def ref_loss(p, y):
        jax.debug.callback(lambda: evaluations.__setitem__(
            0, evaluations[0] + 1))
        return -jbgplvm.elbo(p, y, cfg, JJitterPolicy(initial=JITTER))

    t0 = time.perf_counter()
    _, losses = jfit_lbfgs(ref_loss, p0, (Y,), args.steps)
    losses = np.asarray(jax.block_until_ready(losses))
    print(json.dumps(dict(impl="reference", losses=losses.tolist(),
                          evaluations=evaluations[0],
                          host_seconds=time.perf_counter() - t0)),
          flush=True)

    tcfg = bgplvm.Config(num_latent=10, num_inducing=50, use_fused=False)
    params = {k: torch.tensor(np.asarray(v)) for k, v in p0.items()}
    info = {}
    t0 = time.perf_counter()
    _, losses = fit_lbfgs(
        lambda p, y: -bgplvm.elbo(p, y, tcfg, JitterPolicy(initial=JITTER)),
        params, (torch.tensor(np.asarray(Y)),), args.steps, info=info)
    print(json.dumps(dict(impl="port", losses=losses.tolist(),
                          evaluations=info["evaluations"],
                          evaluations_per_step=info["linesearch_steps"],
                          host_seconds=time.perf_counter() - t0)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
