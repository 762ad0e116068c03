#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Needs one CUDA card and nvcc. Drives the port (`dp_gp_lvm_tpu_torch`,
never JAX) through its main path, the full-batch DP-GP-LVM training step
at the c4_dp_mocap widths (N=1024, D=59, Q=10, M=64, T=20), in phases
that each print one JSON line:

  build  nvcc-builds the CUDA kernels K1 and K2 from csrc/ (in parallel)
  k1     K1 (fused Psi2 + Psi1^T Y) against its plain version in f64
  k2     K2 (fused Psi2 pullback) against its plain version in f64
  train  mocap_like -> init_params -> gp_optimizer; fused-path ELBO at
         init against the plain path in f64; 10 optimizer steps whose
         losses must be finite and which must launch K1 and K2 once each
  scale  one forward and backward of SuffstatsBatchedFused at N=8192,
         M=128 (timing only)

then the card's name and power limit again, a `kernels` JSON line, and as
its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero. Kernel times are medians of CUDA
event timings after warm-up; `bound_ms` is the least time the card could
take for the same work (see `_bound_ms`).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 rate,
# FP32 outside the tensor cores, and the special-function units
# (16 per SM x 132 SMs x 1.98 GHz boost) that evaluate exp.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OP_PER_S = 16 * 132 * 1.98e9

C4 = dict(T=20, N=1024, M=64, Q=10, D=59)
SCALE = dict(T=20, N=8192, M=128, Q=10, D=60)
TOL_K1 = 1e-4   # scaled by max|ref| per output: f32 sums over 1024 rows
TOL_K2 = 5e-4   # of exp of a quadratic form; the pullback adds cancellation
TOL_ELBO = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _timed(fn, torch, reps=20, warmup=3) -> float:
    """Median ms of `fn` over `reps` CUDA-event-timed calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(bytes_moved, flops, exps):
    """Least time for the work: max(bytes / HBM rate, FP32 flops / FP32
    peak, exponentials / SFU rate), and which of bytes or operations
    bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOP_PER_S, exps / SFU_OP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def k1_work(T, N, M, Q, D):
    """K1: each input read once, outputs written once; Psi2 is symmetric
    (M(M+1)/2 pair exponents of 2Q+6 flops), Psi1 rows (M exps, 4Q+4
    flops) and the Psi1^T Y contraction (2MD flops per row)."""
    pairs = M * (M + 1) // 2
    bytes_moved = 4 * (T + T * Q + 2 * N * Q + N + T * M * Q + N * D
                       + T * M * M + T * M * D)
    flops = T * N * (pairs * (2 * Q + 6) + M * (4 * Q + 4) + 2 * M * D)
    exps = T * N * (pairs + M)
    return bytes_moved, flops, exps


def k2_work(T, N, M, Q):
    """K2: the symmetric pair exponent (as K1), then per full pair the
    masked W element and its W_sym Z contraction (2Q+8 flops)."""
    pairs = M * (M + 1) // 2
    bytes_moved = 4 * (T + T * Q + 2 * N * Q + N + T * M * Q + T * M * M
                       + T * M + T * Q + T * M * Q + T * M * M
                       + 2 * N * Q + N)
    flops = T * N * (pairs * (2 * Q + 6) + M * M * (2 * Q + 8) + 8 * M * Q)
    exps = T * N * pairs
    return bytes_moved, flops, exps


def _inputs(torch, gen, T, N, M, Q, D):
    """The same random inputs in f64 (for the plain version) and f32."""
    kw = dict(generator=gen, device="cuda", dtype=torch.float64)
    f64 = dict(
        vs=0.5 + torch.rand(T, **kw), ards=0.3 + 1.7 * torch.rand(T, Q, **kw),
        mu=torch.randn(N, Q, **kw), s=0.05 + 0.55 * torch.rand(N, Q, **kw),
        Zs=torch.randn(T, M, Q, **kw), Y=torch.randn(N, D, **kw),
    )
    return f64, {k: v.float().contiguous() for k, v in f64.items()}


def _errors(got, want):
    """(max abs error, max error scaled by max|ref|) over the outputs."""
    abs_err = max(float((g.double() - w).abs().max())
                  for g, w in zip(got, want))
    scaled = max(float((g.double() - w).abs().max() / w.abs().max())
                 for g, w in zip(got, want))
    return abs_err, scaled


def phase_k1(torch, psi, gen):
    f64, f32 = _inputs(torch, gen, **C4)
    args32 = (f32["vs"], f32["ards"], f32["mu"], f32["s"], f32["Zs"],
              f32["Y"])
    got = psi.suffstats_batched(*args32)
    want = psi.suffstats_batched_reference(
        f64["vs"], f64["ards"], f64["mu"], f64["s"], f64["Zs"], f64["Y"])
    abs_err, scaled = _errors(got, want)
    per_out = [float((g.double() - w).abs().max() / w.abs().max())
               for g, w in zip(got, want)]
    ms = _timed(lambda: psi.suffstats_batched(*args32), torch)
    plain_ms = _timed(lambda: psi.suffstats_batched_reference(*args32), torch,
                      reps=5, warmup=1)
    bound_ms, bound_by = _bound_ms(*k1_work(**C4))
    row = dict(phase="k1", shape=C4, max_abs_err=abs_err,
               launches_in_phase=psi.LAUNCHES["suffstats_batched"],
               scaled_err_psi2=per_out[0], scaled_err_p1y=per_out[1],
               tol=TOL_K1, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None,
               library_note="no single PyTorch call computes Psi2/Psi1^T Y")
    emit(row)
    if not scaled <= TOL_K1:
        raise AssertionError(f"K1 disagrees with its plain version: {scaled}")
    return row


def phase_k2(torch, psi, gen):
    f64, f32 = _inputs(torch, gen, **C4)
    T, M = C4["T"], C4["M"]
    G64 = torch.randn(T, M, M, generator=gen, device="cuda",
                      dtype=torch.float64)
    G32 = G64.float()
    args32 = (f32["vs"], f32["ards"], f32["mu"], f32["s"], f32["Zs"], G32)
    got = psi.psi2_bwd_batched(*args32)
    want = psi.psi2_bwd_batched_reference(
        f64["vs"], f64["ards"], f64["mu"], f64["s"], f64["Zs"], G64)
    abs_err, scaled = _errors(got, want)
    names = ("gvar_m", "gard", "gz", "V", "gmu", "gs", "gw")
    per_out = {n: float((g.double() - w).abs().max() / w.abs().max())
               for n, g, w in zip(names, got, want)}
    ms = _timed(lambda: psi.psi2_bwd_batched(*args32), torch)
    plain_ms = _timed(lambda: psi.psi2_bwd_batched_reference(*args32), torch,
                      reps=5, warmup=1)
    bound_ms, bound_by = _bound_ms(*k2_work(T, C4["N"], M, C4["Q"]))
    row = dict(phase="k2", shape=C4, max_abs_err=abs_err,
               launches_in_phase=psi.LAUNCHES["psi2_bwd_batched"],
               scaled_err=per_out, tol=TOL_K2, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_note="no single PyTorch call computes the Psi2 "
                            "pullback")
    emit(row)
    if not scaled <= TOL_K2:
        raise AssertionError(f"K2 disagrees with its plain version: {per_out}")
    return row


def phase_train(torch, seed):
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    c4 = CONFIGS["c4_dp_mocap"]
    if (c4.t, c4.n, c4.m, c4.q, c4.d) != tuple(C4[k] for k in "TNMQD"):
        raise AssertionError("C4 no longer matches core/config.py")
    gen = torch.Generator().manual_seed(seed)
    Y, _ = mocap_like(gen, n=c4.n, d=c4.d, dtype=torch.float32)
    cfg = dp_gp_lvm.Config(num_latent=c4.q, num_inducing=c4.m,
                           truncation=c4.t, alpha=c4.alpha)
    params = dp_gp_lvm.init_params(gen, Y, cfg)

    # the f32 fused path against the plain path in f64, at the same jitter
    policy32 = JitterPolicy()
    same_jitter = JitterPolicy(initial=policy32.initial_for(torch.float32))
    with torch.no_grad():
        elbo_fused = float(dp_gp_lvm.elbo(params, Y, cfg))
        p64 = {k: v.double() for k, v in params.items()}
        cfg_plain = cfg._replace(use_fused=False)
        elbo_plain = float(dp_gp_lvm.elbo(p64, Y.double(), cfg_plain,
                                          same_jitter))
    rel = abs(elbo_fused - elbo_plain) / abs(elbo_plain)

    opt = gp_optimizer(params, lr=c4.lr, ngd_lr=c4.ngd_lr)
    keys = list(params)
    losses, step_ms = [], []
    psi.reset_launch_counts()
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = dp_gp_lvm.loss(params, Y, cfg)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        opt.step(dict(zip(keys, grads)))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss.detach()))
    launches = dict(psi.LAUNCHES)
    row = dict(phase="train", config="c4_dp_mocap", shape=C4,
               elbo_init_fused_f32=elbo_fused, elbo_init_plain_f64=elbo_plain,
               elbo_rel_err=rel, tol=TOL_ELBO, losses=losses,
               ms_per_step_median=statistics.median(step_ms),
               ms_per_step=step_ms, launches=launches)
    emit(row)
    if not rel <= TOL_ELBO:
        raise AssertionError(f"fused ELBO {elbo_fused} vs plain {elbo_plain}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if launches != {"suffstats_batched": 10, "psi2_bwd_batched": 10}:
        raise AssertionError(f"main path launched {launches}, expected 10 each")
    return row


def phase_scale(torch, psi, gen):
    _, f32 = _inputs(torch, gen, **SCALE)
    T, M, D = SCALE["T"], SCALE["M"], SCALE["D"]
    leaves = [f32[k].requires_grad_() for k in
              ("vs", "ards", "mu", "s", "Zs", "Y")]
    G2 = torch.randn(T, M, M, generator=gen, device="cuda")
    G1Y = torch.randn(T, M, D, generator=gen, device="cuda")
    out = {}

    def fwd():
        out["v"] = psi.suffstats_batched_fused(*leaves)

    def fwd_bwd():
        p2, p1y = psi.suffstats_batched_fused(*leaves)
        torch.autograd.grad((p2, p1y), leaves, (G2, G1Y))

    row = dict(phase="scale", shape=SCALE,
               fwd_ms=_timed(fwd, torch, reps=10),
               fwd_bwd_ms=_timed(fwd_bwd, torch, reps=10))
    with torch.no_grad():
        p2, p1y = out["v"]
    if not (torch.isfinite(p2).all() and torch.isfinite(p1y).all()):
        raise AssertionError("non-finite output at the scale shape")
    emit(row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "dp_gp_lvm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the dp_gp_lvm_tpu_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dp_gp_lvm_tpu_torch.core.types import pin_full_f32
    from dp_gp_lvm_tpu_torch.ops import build, psi

    pin_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), card=card))

    t0 = time.perf_counter()
    build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in build.ptxas_log.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    k1 = phase_k1(torch, psi, gen)
    k2 = phase_k2(torch, psi, gen)
    train = phase_train(torch, args.seed)
    phase_scale(torch, psi, gen)

    csrc = "dp_gp_lvm_tpu_torch/csrc"
    kernels = [
        dict(name="suffstats_batched", route="cuda",
             source=f"{csrc}/psi_suffstats.cu",
             replaces="dp_gp_lvm_tpu/ops/pallas/psi.py:610",
             launches=train["launches"]["suffstats_batched"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="psi2_bwd_batched", route="cuda",
             source=f"{csrc}/psi2_bwd.cu",
             replaces="dp_gp_lvm_tpu/ops/pallas/psi.py:359",
             launches=train["launches"]["psi2_bwd_batched"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
    ]
    print(card.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
