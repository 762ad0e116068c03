#!/usr/bin/env python3
"""Time and peak host memory of the host float64 ELBO
(`dp_gp_lvm_tpu_torch/models/eval_f64.py::elbo_f64`) at c6_svi_bigN's
widths, the evaluation the SVI runs' `elbo` gate reads.

    python3 tools/eval_f64_cost.py [--root DIR] [--n N] [--threads T]

`--root` takes `eval_f64.py` from another checkout of the repository (to
hold two versions against each other on one machine); the data, the
config and the parameters (c6's init on a standard normal Y drawn from
seed 0) come from this one. Prints one JSON line: the value, the seconds
of one call, and the peak resident set before and after it (MiB; the
growth is the evaluator's buffers). Runs on the CPU."""
import argparse
import dataclasses
import importlib.util
import json
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import svi_gplvm

    torch.set_num_threads(args.threads)
    path = pathlib.Path(args.root) / "dp_gp_lvm_tpu_torch/models/eval_f64.py"
    spec = importlib.util.spec_from_file_location("eval_f64_under_test", path)
    eval_f64 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_f64)

    cfg = config.get("c6_svi_bigN")
    cfg = dataclasses.replace(cfg, n=args.n or cfg.n)
    Y = torch.tensor(np.random.default_rng(0).standard_normal((cfg.n, cfg.d)))
    mcfg = runner._model_config(cfg, None)
    params = svi_gplvm.init_params(prng.PRNGKey(0), Y, mcfg)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    t0 = time.perf_counter()
    value = eval_f64.elbo_f64(params, Y, mcfg)
    seconds = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps(dict(eval_f64=str(path), n=cfg.n, threads=args.threads,
                          elbo=value, seconds=seconds,
                          peak_rss_mib_before=before,
                          peak_rss_mib_after=after)))


if __name__ == "__main__":
    main()
