#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--parent DIR]

Needs one CUDA card and nvcc. Drives the port (`dp_gp_lvm_tpu_torch`,
never JAX) through its main paths at full width: the DP-GP-LVM training
step (c4_dp_mocap: N=1024, D=59, Q=10, M=64, T=20), the Bayesian GP-LVM
training step (c2_sparse_oil: N=1000, D=12, Q=10, M=50) and the two
imputation servers built on them. Phases, each printing one JSON line:

  build  nvcc-builds the CUDA kernels from csrc/ (in parallel)
  steps  the step of every chunked loop of the runner (c4 full batch, c6
         resident and streamed, c7 stage 2c, c8, c9 phase B) at its
         config's widths on a 4096-row draw (c4: its 1024 rows): the
         host syncs of an eager step (PyTorch's sync debug mode; held at
         0), ms a step and rows/s eager and replayed from a CUDA graph
         (a chunk of 100 after one that captures; held: 100 replays,
         finite losses) and, with `--parent DIR`, DIR's eager numbers
         measured first in a child process in the same call; the svi,
         stream, dp_svi, amortized, mrd_svi, runs and trace phases
         print them (`step_*`) beside the graphs their runs captured and
         replayed (held: every runner phase replayed its chunks)
  k1     K1 (fused Psi2 + Psi1^T Y) against its plain version in f64, at
         the c4 shape and at the N=8192, M=128 scale shape, with the launch
         geometry; two launches on the same inputs must give the same bits
  k2     K2 (fused Psi2 pullback) against its plain version in f64, at the
         c4 shape, at the T=1 c2 shape the Bayesian GP-LVM step gives it
         and at the N=8192, M=128 scale shape; two launches on the same
         inputs must give the same bits
  k6     K6 (Psi1) and
  k5     K5 (single-kernel Psi2) at the c2 widths, weighted and not,
         against their plain versions in f64; also timed at N=8192, M=128;
         two launches on the same inputs must give the same bits; each with
         its launch geometry (K5: K1's at D = 0); K6 also held against f64,
         weighted, at N=8192 with M=128 and with M=256 (two column tiles)
  k4     K4 (Psi2 stack) at the c4 shape, the same way, and against f64
         and timed at the T=20, N=8192, M=128 scale shape
  gate   value and gradient of sum Psi2^2 through Psi2BatchedFused (K4
         forward, K2 backward, weighted) against the plain path in f64
  train  mocap_like -> init_params -> gp_optimizer; fused-path ELBO and
         its gradient at init against the plain path in f64; 10 optimizer
         steps whose losses must be finite and which must launch K1 and K2
         once each
  scale  one forward and backward of SuffstatsBatchedFused at N=8192,
         M=128 (timing only)
  m256   the models at M = 256, where K1's body and K2 run their tiled
         forms under the default use_fused="auto": mocap_like (N=8192,
         D=60) -> dp_gp_lvm.init_params (Q=10, M=256, T=20) ->
         gp_optimizer and oil_flow_like (N=8192) -> bgplvm (Q=10, M=256);
         each model's fused f32 ELBO and gradient at init against the
         plain path in f32 on the card and in f64 at the same jitter (the
         train phase's tolerances, both gaps printed); 10 steps each with
         finite losses, launching K1 and K2 (DP) or K6, K5 and K2 once a
         step, beside 3 steps of the plain f32 path (ms a step);
         make_dp_imputer on the DP parameters (the build launches K1 once)
         answers batches 1 and 32; sum Psi2^2 through Psi2BatchedFused (K4
         and K2) against f64 on the DP path's first 2048 rows; every
         kernel held against f64 on the first inputs the paths gave it and
         on synthetic inputs at M = 129, 192, 256, weighted and not, each
         repeated to the bit, K2 also on the paths' mu, S and Z with a
         random G (within 2e-6 scaled); K1, K2 (T = 20 and 1), K4 and K5
         timed at M = 256 on the paths' inputs (device ms, bound, plain
         ms), with their launch geometry (for K2: range rows, panel width,
         blocks per SM, waves; for K1, K4, K5: blocks a chunk and atom,
         their pair balance, waves) and the registers and local memory
         (spills) of the tiled kernels; K1, K4 and K5 also with their
         FP32-issue floor and, with `--parent DIR` (an older checkout of
         this repository), the device ms of DIR's kernels on the same
         inputs, timed alike in a child process of this script that
         imports DIR's package
  train_bgplvm  oil_flow_like -> bgplvm.init_params -> gp_optimizer; the
         same checks; each step must launch K6, K5 and K2 once
  serve_bgplvm  make_bgplvm_imputer on those parameters answers requests
         of batch 1, 8, 32 with the second half of the dims masked; the
         posterior build must launch K6 and K5 once
  serve_dp  make_dp_imputer on the c4 parameters (the c5_dp_missing
         widths), batches 1, 8, 32, 128; the build must launch K1 once
  cavi   one full-batch CAVI step of (phi, gamma) on those c4 parameters:
         exactly one K1 launch (T = 20), held against its plain version on
         the step's input; the ELBO must not fall (beyond the f32
         tolerance), phi's rows sum to 1, and phi and gamma agree with the
         f64 plain step
  linear 20 Bayesian GP-LVM steps with the linear kernel at c2's N, D and
         Q with M = Q: no kernel may launch, the f32 ELBO at init agrees
         with f64 relative to the bound's largest term (at M = Q two terms
         of ~9e5 cancel exactly) and the ELBO rises; the gap at c2's
         M = 50 (a rank-Q K_uu) is reported
  runs   the by-name runner (`dp_gp_lvm_tpu_torch.experiments.run.run`)
         trains each gated config (c1_bgplvm_toy, c2_sparse_oil,
         c3_mrd_twoview, c4_dp_mocap, c5_dp_missing, c5_pose_missing) at
         full width for 100 steps a restart, its rates decayed over those
         100; every numeric leaf of the result must be finite and every
         gated key present (the gates themselves are reported, not held, at
         100 steps); every step must launch K6, K5 and K2 (c1, c2), K1 and
         K2 per view (c3, plus K6 and K5 per view for the cross-view
         posterior) or K1 and K2 (c4, c5, c5_pose); the
         first inputs each kernel got at each of its shapes in the run are
         kept, and the kernel is held on them against its plain version
         in f64 (at its phase's tolerance) and repeated to the bit; at
         c3's widths each is also timed there (device ms, bound)
  mesh   the device mesh (`dp_gp_lvm_tpu_torch/parallel/`) at world size
         1: an NCCL process group of one rank and a 1 x 1 mesh (one
         all-reduce on it must carry its data); for c4_dp_mocap, c2_sparse_oil
         and c3_mrd_twoview at full width, drawn and initialized as the
         runner does, the sharded loss and gradient at init (through
         `parallel.recipe.sharded_setup`) against the single-device fused
         path in f32 and the plain path in f64 at the f32 jitter, at the
         train phase's tolerances; 10 `gp_optimizer` steps on the mesh,
         finite, launching K1 and K2 once a step and view (the sharded
         Bayesian GP-LVM takes K1 at T = 1, as the reference's does), the
         kernels held on the steps' first inputs; 10 unsharded steps from
         the same init; then the runner trains c4 with `--mesh 1,1` for
         100 steps, launches held as the runs phase's c4, every numeric
         leaf finite; ms a step sharded and unsharded (20 steps of each,
         timed in turns) on one line with the card's name and power limit
  files  writes an oil-flow DataTrn.txt / DataTrnLbls.txt (1000 x 12,
         oil_flow_like) and a 1024-frame AMC file (mocap_like's 59
         channels and a constant one) under build/smoke_files; the native
         AMC parser (g++-built from csrc/amc_parser.cpp) must equal the
         Python parser and the written values to the bit; the runner
         trains c2_sparse_oil and c4_dp_mocap from those files
         (`--data-dir`) for 100 steps: the loaded Y must be the written
         data standardized (the constant channel dropped), the launches
         those the runs phase holds, and each kernel is held on the run's
         first inputs
  lbfgs  fit_lbfgs (optax's L-BFGS with its zoom line search) takes 20
         steps of c2's bound from one init, in f32 through the kernels and
         in f64 through the plain path, on the card: both losses must
         fall; K6, K5 and K2 must launch once a loss evaluation (line-
         search trials included), and are held on the run's first
         inputs; evaluations a step and each step's f32 and f64 loss are
         printed
  mfu    the c4 step's mfu_pct and roofline_pct (perf.mfu, the H100's
         peaks) at the train phase's ms a step; printed, not held
  serve_mrd  make_mrd_cross_view_predictor on that c3 run's parameters
         observes view 0 of held-out rows and predicts view 1, batches 1,
         4, 8, 32; the build must launch K6 and K5 once per view, and
         "auto" must take the kernels at c3's widths; the predictive at a
         fixed q(x*) and the caches' weights are held against f64, a whole
         request's f32-against-f64 gap is reported
  svi    the runner trains c6_svi_bigN (the minibatch SVI-GPLVM) at full
         width, N=131072 and 1024 rows a step, for 200 steps with a
         checkpoint every 100; a second run resumes from the step-100
         checkpoint and must end on the same bits; every step must launch
         K1 twice and K2 once (the gradient pass and the blend at the
         updated parameters); K1 is held against f64 on the first
         minibatch the run gives it, K2 on the first with a nonzero
         cotangent (the second: at the first q(u) is the prior, where
         the bound does not depend on Psi2), and both are timed there
         (device ms, bound);
         the float64 host ELBO and an imputation of the 256 held-out rows
         (50 inference steps) must be finite; also the host's draw of the
         minibatch indices and the host syncs a step makes (PyTorch's
         sync debug mode, at c6's widths on 4096 rows)
  stream the same c6 run with the host-streamed feed (`--stream`: the
         rows written to a file, gathered by the native loader built by
         g++ from csrc/stream_loader.cpp into pinned buffers, copied to
         the card chunk by chunk): the loader must be the native one;
         launches, the resume from step 100 and K1/K2 on the run's inputs
         are held as in svi; three streamed steps must equal three
         resident steps on the same rows to the bit; it prints ms a step
         streamed beside the svi phase's resident one, how long
         next_chunk() waited for the gather a chunk against the chunk's
         time, the copy of a chunk to the card, and host syncs a step
  dp_svi the runner trains c7_dp_svi (the minibatch DP-GP-LVM) at full
         width, N=131072 in four planted groups and 2048 rows a step,
         through its staged recipe for 250 steps (chunks of 125: stage 1
         at T = 1, the 50-step warmup, stage 2b, stage 2c at T = 8; 425
         steps in all): every step must launch K1 and K2 once (the blend
         reuses the gradient pass's statistics), checked stage by stage,
         plus K1 once over every row at T = 1 (the residual ladder) and
         once at T = 8 (the ELBO); each kernel is held against f64 on the
         first inputs the run gave it at each shape (K2 on the first with
         a nonzero cotangent) and timed there (device ms, bound, plain
         ms); the six c7 metrics are printed (gates not held at this
         depth) and must be finite; host syncs and ms of a T = 8 step
         (sync debug mode, 8192 rows); make_dp_svi_imputer on the run's
         parameters (its build launches nothing: the prediction's psi
         statistics are plain) answers batches 1, 32, 512, and its f32
         predictive at a fixed q(x*) is held against f64
  amortized  the runner trains c8_amortized_svi (the SVI-GPLVM with the
         amortized q(X): a recognition network encodes each minibatch
         row) at full width, N=131072 and 1024 rows a step, for 200 steps
         with a checkpoint every 100, resident, and again streamed
         (`--stream`, the native loader); a resumed run must end on the
         resident run's bits and three streamed steps must equal three
         resident ones; every step must launch K1 twice and K2 once, and
         both are held against f64 on the run's first inputs (K2 on the
         first nonzero cotangent), repeated to the bit and timed there
         (device ms, ms, plain ms, bound); the f64 ELBO and every gated
         metric must be present and finite (gates reported, not held);
         host syncs of a step (sync debug mode, 4096 rows); encode(Y) at
         init against the PCA latents; make_encoder_imputer on the run's
         parameters answers batches 1, 32, 256 with half the dims masked,
         one encoder pass or 150 refining steps (build ms, ms and
         launches a request), and its f32 predictive at a fixed q(x*) is
         held against f64
  mrd_svi the runner trains c9_mrd_svi_bigN (the minibatch MRD: two
         views of 32 dims sharing one q(X) table, N=131072, 1024 aligned
         rows a step) at full width through its two-phase recipe for 500
         steps (250 hot, 250 recalibrating): every step must launch K1
         and K2 once a view, checked phase by phase, plus K1 once a view
         over every row (the ELBO); each kernel is held against f64 on
         the first inputs the run gave it (K2 on the first nonzero
         cotangent) and timed there (device ms, ms, plain ms, bound); a
         second run resumes phase B from stages/phaseA.npz and must end
         on the same bits; the c9 metrics are printed (gates not held at
         this depth) and must be finite; host syncs and ms of a phase-B
         step (sync debug mode, 8192 rows); make_mrd_svi_predictor (view
         0 -> 1) on the run's parameters answers held-out rows at batches
         1, 32, 512 (no launch), its f32 predictive at a fixed q(x*) held
         against f64; cross_view_sample draws 64 joint samples of view 1
         at 8 held-out rows, whose mean and variance plus noise are held
         against cross_view_predict's
  mesh_svi the minibatch families on the device mesh at world size 1 (an
         NCCL group of one rank, a 1 x 1 mesh): c6, c8, c9 and c7's
         stage-2c step (T = 8) on reduced draws (4096 rows; 8192 for c7
         and c9) from q(u) at its optimum over the draw: the sharded loss,
         every gradient and the stepped leaves against the unsharded
         fused path to the bit; the loss, the gradients of the leaves the
         optimizer steps and the step's blended q(u) against the plain
         f64 path; 20 sharded and 20 unsharded steps in turns (ms a
         step, the launches of a step held exactly: K1 2 and K2 1 for c6
         and c8, K1 1 and K2 1 for c7, K1 2 and K2 2 for c9; K1 and K2
         held against f64 on the sharded steps' first inputs); then the
         runner with `--mesh 1`: c6 as the svi phase runs it, resumed from
         its step-100 checkpoint to the straight mesh run's bits, and c7
         as the dp_svi phase runs it, each with those phases' launches;
         the final ELBOs against theirs
  sgpr   SGPR's bound and predictive and the exact GP's marginal and
         predictive at toy widths (N=200, M=10), f32 on the card against
         f64 on the CPU at the same jitter; also reported, not held, at
         N=500, M=30, where K_uu's condition number is near 4e4
  trace  torch.profiler traces: one eager c4_dp_mocap training step, a
         chunk of 100 of them replayed from a CUDA graph and one
         streamed c6 chunk of 100 replayed steps; CUDA and
         CPU time of the DP loss's scopes (psi_stats, kuu_gram,
         collapsed_bound), device time by kernel, wall time and the
         card's idle share (numbers only, nothing held)

then a `total` line (the script's wall seconds, the build included), the
card's name and power limit again, a `kernels` JSON line, and as its last
line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero. A kernel's `ms` is the median of
CUDA-event timings around one call of its wrapper after warm-up, so it
holds the wrapper's host work (argument checks, allocations, the ctypes
call) wherever that outlasts the kernel. `device_ms` is the kernel's time
on the card alone: 20 launches captured in one CUDA graph and replayed
(see `_device_ms`). `bound_ms` is the least time the card could take for
the same work (see `_bound_ms`).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# the H100 SXM's peaks: HBM3 rate, FP32 outside the tensor cores, exp on
# the special-function units; `main` takes them from the port's cost
# model (`dp_gp_lvm_tpu_torch/perf/flops.py::H100_PEAKS`), one place
PEAKS = {}

C4 = dict(T=20, N=1024, M=64, Q=10, D=59)
C2 = dict(N=1000, M=50, Q=10, D=12)
SCALE = dict(T=20, N=8192, M=128, Q=10, D=60)
TOL_K1 = 1e-4   # scaled by max|ref| per output: f32 sums over 1024 rows
TOL_K2 = 5e-4   # of exp of a quadratic form; the pullback adds cancellation
TOL_K4 = TOL_K5 = TOL_K1   # the same f32 sums as K1's Psi2 half
TOL_K6 = 1e-4   # one f32 exp of a Q-term sum per element, no sum over rows
TOL_GATE = TOL_K2
TOL_ELBO = 1e-4
# gradient of the loss at init, f32 fused against f64 plain, each leaf
# scaled by its max|ref|: the pullback runs through two Cholesky factors
# at a 1e-4 relative jitter, which amplifies f32 rounding (worst leaf on
# an H100: z of c2_sparse_oil at 6.7e-4, of c4_dp_mocap phi_logits at 3e-5)
TOL_GRAD = 5e-3
# predictive mean/var in f32 against f64, scaled by max|ref|, and the
# cached weights w = K_uu^{-1} m_u the same way: both go through those
# two Cholesky factors (on an H100 at most 3.3e-5 and 1.9e-4)
TOL_PRED = 1e-3
TOL_CACHE_W = 2e-3
SERVE_STEPS = 150


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _timed(fn, torch, reps=20, warmup=3) -> float:
    """Median ms of `fn` over `reps` CUDA-event-timed calls after warm-up
    (no launch counted on the card)."""
    with _uncounted():
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


def _device_ms(fn, torch, launches=20, replays=5) -> float:
    """ms of one call of `fn` on the card with the host's share taken out:
    `launches` calls captured in one CUDA graph, the graph replayed, the
    median replay divided by `launches` (no launch counted on the
    card)."""
    with _uncounted():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        return _timed(graph.replay, torch, reps=replays,
                      warmup=2) / launches


def _bound_ms(bytes_moved, flops, exps):
    """Least time for the work: max(bytes / HBM rate, FP32 flops / FP32
    peak, exponentials / SFU rate), and which of bytes or operations
    bounds it."""
    t_bytes = bytes_moved / PEAKS["hbm_bytes_per_s"]
    t_ops = max(flops / PEAKS["f32_flops"], exps / PEAKS["exp_per_s"])
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


def k1_fp32_issue_ms(T, N, M, Q, D):
    """Least time the FP32 pipes take for the instructions K1's direct form
    issues, at one instruction per lane and clock (half the FMA flop rate
    `k1_work` counts against): per pair 2Q (an FADD and an FFMA per q)
    and 4 (le + quad, the exponent's FFMA, the clamp, the sum's FFMA); per
    Psi1 element 4Q + 4 (c and Psi1 share the difference mu - z); per
    Psi1^T Y element one FFMA."""
    pairs = M * (M + 1) // 2
    instr = T * N * (pairs * (2 * Q + 4) + M * (4 * Q + 4) + M * D)
    return 1e3 * instr / (PEAKS["f32_flops"] / 2)


def psi2_fp32_issue_ms(T, N, M, Q):
    """`k1_fp32_issue_ms` for K4 and K5 (K1's body without the Psi1 rows
    and Psi1^T Y): 2Q + 4 instructions a pair."""
    pairs = M * (M + 1) // 2
    return 1e3 * T * N * pairs * (2 * Q + 4) / (PEAKS["f32_flops"] / 2)


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


def k4_work(T, N, M, Q):
    """K4: K1's work without the Psi1 rows, the Y read and the Psi1^T Y
    contraction and write."""
    pairs = M * (M + 1) // 2
    bytes_moved = 4 * (T + T * Q + 2 * N * Q + N + T * M * Q + T * M * M)
    return bytes_moved, T * N * pairs * (2 * Q + 6), T * N * pairs


def k5_work(N, M, Q):
    """K5: one kernel's Psi2, the T = 1 case of K4."""
    return k4_work(1, N, M, Q)


def k6_work(N, M, Q):
    """K6: per row M exponentials of a Q-term exponent (3Q+2 flops); every
    input read once and the (N, M) output written once."""
    bytes_moved = 4 * (1 + Q + 2 * N * Q + N + M * Q + N * M)
    return bytes_moved, N * M * (3 * Q + 2), N * M


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
    repeat = psi.suffstats_batched(*args32)
    bitwise = all(bool(torch.equal(x, y)) for x, y in zip(got, repeat))
    want = psi.suffstats_batched_reference(
        f64["vs"], f64["ards"], f64["mu"], f64["s"], f64["Zs"], f64["Y"])
    abs_err, scaled = _errors(got, want)
    per_out = [float((g.double() - w).abs().max() / w.abs().max())
               for g, w in zip(got, want)]
    ms = _timed(lambda: psi.suffstats_batched(*args32), torch)
    device_ms = _device_ms(lambda: psi.suffstats_batched(*args32), torch)
    scale = _k1_at_scale(torch, psi, gen)
    plain_ms = _timed(lambda: psi.suffstats_batched_reference(*args32), torch,
                      reps=5, warmup=1)
    bound_ms, bound_by = _bound_ms(*k1_work(**C4))
    row = dict(phase="k1", shape=C4, max_abs_err=abs_err,
               launches_in_phase=psi.LAUNCHES["suffstats_batched"],
               geometry=_k1_geometry(psi, C4),
               scaled_err_psi2=per_out[0], scaled_err_p1y=per_out[1],
               tol=TOL_K1, repeat_bitwise_equal=bitwise, ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, fp32_issue_ms=k1_fp32_issue_ms(**C4),
               scale=scale, library_ms=None,
               library_note="no single PyTorch call computes Psi2/Psi1^T Y")
    emit(row)
    if not scaled <= TOL_K1:
        raise AssertionError(f"K1 disagrees with its plain version: {scaled}")
    if not bitwise:
        raise AssertionError("two K1 launches on the same inputs differ")
    if not max(scale["scaled_err"]) <= TOL_K1:
        raise AssertionError(f"K1 disagrees at the scale shape: {scale}")
    return row


def _k1_geometry(psi, shape):
    """How the K1 wrapper launches at `shape` on this card."""
    geo = psi.k1_launch_geometry("cuda", *(shape[k] for k in "TNMQD"))
    if isinstance(geo, psi.K1TiledGeometry):
        return geo._asdict()
    return dict(geo._asdict(), lane_use=geo.lane_use)


def _k1_at_scale(torch, psi, gen):
    """K1 at N=8192, M=128, T=20, D=60 against its plain version in f64."""
    f64, f32 = _inputs(torch, gen, **SCALE)
    names = ("vs", "ards", "mu", "s", "Zs", "Y")
    args32 = tuple(f32[k] for k in names)
    got = psi.suffstats_batched(*args32)
    want = psi.suffstats_batched_reference(*(f64[k] for k in names))
    abs_err = _errors(got, want)[0]
    scaled = [float((g.double() - w).abs().max() / w.abs().max())
              for g, w in zip(got, want)]
    del want
    bound_ms, bound_by = _bound_ms(*k1_work(**SCALE))
    return dict(shape=SCALE, max_abs_err=abs_err, scaled_err=scaled,
                geometry=_k1_geometry(psi, SCALE),
                ms=_timed(lambda: psi.suffstats_batched(*args32), torch,
                          reps=5, warmup=1),
                device_ms=_device_ms(lambda: psi.suffstats_batched(*args32),
                                     torch, launches=5, replays=3),
                plain_ms=_timed(
                    lambda: psi.suffstats_batched_reference(*args32), torch,
                    reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                fp32_issue_ms=k1_fp32_issue_ms(**SCALE))


def phase_k2(torch, psi, gen):
    f64, f32 = _inputs(torch, gen, **C4)
    T, M = C4["T"], C4["M"]
    G64 = torch.randn(T, M, M, generator=gen, device="cuda",
                      dtype=torch.float64)
    G32 = G64.float()
    args32 = (f32["vs"], f32["ards"], f32["mu"], f32["s"], f32["Zs"], G32)
    got = psi.psi2_bwd_batched(*args32)
    repeat = psi.psi2_bwd_batched(*args32)
    bitwise = all(bool(torch.equal(x, y)) for x, y in zip(got, repeat))
    want = psi.psi2_bwd_batched_reference(
        f64["vs"], f64["ards"], f64["mu"], f64["s"], f64["Zs"], G64)
    abs_err, scaled = _errors(got, want)
    names = ("gvar_m", "gard", "gz", "V", "gmu", "gs", "gw")
    per_out = {n: float((g.double() - w).abs().max() / w.abs().max())
               for n, g, w in zip(names, got, want)}
    ms = _timed(lambda: psi.psi2_bwd_batched(*args32), torch)
    device_ms = _device_ms(lambda: psi.psi2_bwd_batched(*args32), torch)
    c2 = _k2_at_c2(torch, psi, gen)
    scale = _k2_at_scale(torch, psi, gen)
    plain_ms = _timed(lambda: psi.psi2_bwd_batched_reference(*args32), torch,
                      reps=5, warmup=1)
    bound_ms, bound_by = _bound_ms(*k2_work(T, C4["N"], M, C4["Q"]))
    row = dict(phase="k2", shape=C4, max_abs_err=abs_err,
               launches_in_phase=psi.LAUNCHES["psi2_bwd_batched"],
               geometry=_k2_geometry(psi, C4),
               scaled_err=per_out, tol=TOL_K2, repeat_bitwise_equal=bitwise,
               ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, c2=c2, scale=scale,
               library_ms=None,
               library_note="no single PyTorch call computes the Psi2 "
                            "pullback")
    emit(row)
    if not scaled <= TOL_K2:
        raise AssertionError(f"K2 disagrees with its plain version: {per_out}")
    if not bitwise:
        raise AssertionError("two K2 launches on the same inputs differ")
    if not max(c2["scaled_err"].values()) <= TOL_K2:
        raise AssertionError(f"K2 disagrees at the c2 shape: {c2}")
    if not scale["scaled_err"] <= TOL_K2:
        raise AssertionError(f"K2 disagrees at the scale shape: {scale}")
    return row


def _k2_geometry(psi, shape):
    """How the K2 wrapper launches at `shape` on this card."""
    geo = psi.k2_launch_geometry("cuda", *(shape[k] for k in "TNMQ"))
    return geo._asdict()


def _k2_at_scale(torch, psi, gen):
    """K2 at N=8192, M=128, T=20 against its plain version in f64."""
    T, N, M, Q = (SCALE[k] for k in "TNMQ")
    f64, f32 = _inputs(torch, gen, **SCALE)
    G64 = torch.randn(T, M, M, generator=gen, device="cuda",
                      dtype=torch.float64)
    names = ("vs", "ards", "mu", "s", "Zs")
    args32 = tuple(f32[k] for k in names) + (G64.float(),)
    got = psi.psi2_bwd_batched(*args32)
    want = psi.psi2_bwd_batched_reference(*(f64[k] for k in names), G64)
    abs_err, scaled = _errors(got, want)
    del want
    bound_ms, bound_by = _bound_ms(*k2_work(T, N, M, Q))
    return dict(shape=dict(T=T, N=N, M=M, Q=Q), max_abs_err=abs_err,
                scaled_err=scaled, geometry=_k2_geometry(psi, SCALE),
                ms=_timed(lambda: psi.psi2_bwd_batched(*args32), torch,
                          reps=5, warmup=1),
                device_ms=_device_ms(lambda: psi.psi2_bwd_batched(*args32),
                                     torch, launches=5, replays=3),
                plain_ms=_timed(
                    lambda: psi.psi2_bwd_batched_reference(*args32), torch,
                    reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by)


def _k2_at_c2(torch, psi, gen):
    """K2 as the backward of K5: one atom at the c2 widths (M not a
    multiple of the 4x4 tile, N of no block size), weighted and not."""
    N, M, Q = C2["N"], C2["M"], C2["Q"]
    f64, f32 = _inputs(torch, gen, T=1, **C2)
    G64 = torch.randn(1, M, M, generator=gen, device="cuda",
                      dtype=torch.float64)
    w64 = _weights(torch, gen, N)
    names = ("vs", "ards", "mu", "s", "Zs")
    args32 = tuple(f32[k] for k in names) + (G64.float(),)
    errs = {}
    for label, w in (("unweighted", None), ("weighted", w64)):
        got = psi.psi2_bwd_batched(*args32, None if w is None else w.float())
        want = psi.psi2_bwd_batched_reference(*(f64[k] for k in names), G64,
                                              w)
        errs[label] = _errors(got, want)
    bound_ms, bound_by = _bound_ms(*k2_work(1, N, M, Q))
    return dict(shape=dict(T=1, N=N, M=M, Q=Q),
                geometry=_k2_geometry(psi, dict(T=1, **C2)),
                max_abs_err=max(e[0] for e in errs.values()),
                scaled_err={k: e[1] for k, e in errs.items()},
                ms=_timed(lambda: psi.psi2_bwd_batched(*args32), torch),
                device_ms=_device_ms(lambda: psi.psi2_bwd_batched(*args32),
                                     torch),
                plain_ms=_timed(
                    lambda: psi.psi2_bwd_batched_reference(*args32), torch,
                    reps=5, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by)


def _weights(torch, gen, n):
    """Mask-style row weights (zeros included), f64 on the card."""
    kw = dict(generator=gen, device="cuda", dtype=torch.float64)
    return ((torch.rand(n, **kw) > 0.3).double()
            * (0.5 + torch.rand(n, **kw)))


def _single(tensors):
    """The T = 1 inputs of `_inputs` without their atom dim."""
    return dict(v=tensors["vs"][0], ard=tensors["ards"][0].contiguous(),
                mu=tensors["mu"], s=tensors["s"],
                Z=tensors["Zs"][0].contiguous())


def _phase_single(torch, gen, name, fn, ref, launches_key, psi, work, tol,
                  geometry, held_at=()):
    """A single-kernel forward (K5 or K6) at the c2 widths against its
    plain version in f64, weighted and not, and repeated to the bit; timed
    there and at N=8192, M=128, with `geometry(shape)`, its launch geometry,
    at both; and held against f64, weighted, and timed at each (N, M, Q) of
    `held_at`."""
    N, M, Q = C2["N"], C2["M"], C2["Q"]
    f64, f32 = _inputs(torch, gen, T=1, **C2)
    a64, a32 = _single(f64), _single(f32)
    w64 = _weights(torch, gen, N)
    errs = {}
    for label, w in (("unweighted", None), ("weighted", w64)):
        w32 = None if w is None else w.float()
        got = fn(a32["v"], a32["ard"], a32["mu"], a32["s"], a32["Z"], w32)
        want = ref(a64["v"], a64["ard"], a64["mu"], a64["s"], a64["Z"], w)
        torch.cuda.synchronize()
        errs[label] = _errors([got], [want])
    args32 = (a32["v"], a32["ard"], a32["mu"], a32["s"], a32["Z"])
    bitwise = bool(torch.equal(fn(*args32), fn(*args32)))
    ms = _timed(lambda: fn(*args32), torch)
    device_ms = _device_ms(lambda: fn(*args32), torch)
    plain_ms = _timed(lambda: ref(*args32), torch, reps=5, warmup=1)
    big = dict(N=SCALE["N"], M=SCALE["M"], Q=SCALE["Q"])
    _, b32 = _inputs(torch, gen, T=1, D=1, **big)
    b32 = _single(b32)
    big_args = (b32["v"], b32["ard"], b32["mu"], b32["s"], b32["Z"])
    big_ms = _timed(lambda: fn(*big_args), torch)
    big_device_ms = _device_ms(lambda: fn(*big_args), torch)
    big_plain_ms = _timed(lambda: ref(*big_args), torch, reps=3, warmup=1)
    bound_ms, bound_by = _bound_ms(*work(N, M, Q))
    big_bound_ms, big_bound_by = _bound_ms(*work(**big))
    held = [_held_at(torch, gen, fn, ref, work, **sh) for sh in held_at]
    row = dict(phase=name, shape=dict(N=N, M=M, Q=Q),
               max_abs_err=max(e[0] for e in errs.values()),
               scaled_err={k: e[1] for k, e in errs.items()}, tol=tol,
               repeat_bitwise_equal=bitwise,
               launches_in_phase=psi.LAUNCHES[launches_key], ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, geometry=geometry(dict(N=N, M=M, Q=Q)),
               scale_shape=big, scale_ms=big_ms,
               scale_device_ms=big_device_ms, scale_plain_ms=big_plain_ms,
               scale_bound_ms=big_bound_ms,
               scale_bound_by=big_bound_by, scale_geometry=geometry(big),
               held_at=held, library_ms=None,
               library_note="no single PyTorch call computes Psi1 or Psi2")
    emit(row)
    if not max(e[1] for e in errs.values()) <= tol:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errs}")
    if not bitwise:
        raise AssertionError(f"two {name} launches on the same inputs differ")
    for h in held:
        if not h["scaled_err"] <= tol:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {h['shape']}: {h}")
    return row


def _held_at(torch, gen, fn, ref, work, N, M, Q):
    """A single-kernel forward at (N, M, Q), weighted, against its plain
    version in f64, and its device ms there."""
    f64, f32 = _inputs(torch, gen, T=1, D=1, N=N, M=M, Q=Q)
    a64, a32 = _single(f64), _single(f32)
    w64 = _weights(torch, gen, N)
    args32 = (a32["v"], a32["ard"], a32["mu"], a32["s"], a32["Z"],
              w64.float())
    abs_err, scaled = _errors(
        [fn(*args32)],
        [ref(a64["v"], a64["ard"], a64["mu"], a64["s"], a64["Z"], w64)])
    bound_ms, bound_by = _bound_ms(*work(N, M, Q))
    return dict(shape=dict(N=N, M=M, Q=Q), max_abs_err=abs_err,
                scaled_err=scaled, ms=_timed(lambda: fn(*args32), torch),
                device_ms=_device_ms(lambda: fn(*args32), torch),
                plain_ms=_timed(lambda: ref(*args32), torch, reps=3,
                                warmup=1),
                bound_ms=bound_ms, bound_by=bound_by)


def _k6_geometry(psi, shape):
    """How the K6 wrapper launches at `shape` on this card."""
    return psi.k6_launch_geometry("cuda", shape["N"], shape["M"],
                                  shape["Q"])._asdict()


def phase_k6(torch, psi, gen):
    big = dict(N=SCALE["N"], Q=SCALE["Q"])
    return _phase_single(torch, gen, "k6", psi.psi1, psi.psi1_reference,
                         "psi1", psi, k6_work, TOL_K6,
                         lambda sh: _k6_geometry(psi, sh),
                         held_at=(dict(big, M=128), dict(big, M=256)))


def phase_k5(torch, psi, gen):
    return _phase_single(torch, gen, "k5", psi.psi2_single,
                         psi.psi2_single_reference, "psi2_single", psi,
                         k5_work, TOL_K5,
                         lambda sh: _k1_geometry(psi, dict(T=1, D=0, **sh)))


def phase_k4(torch, psi, gen):
    f64, f32 = _inputs(torch, gen, **C4)
    names = ("vs", "ards", "mu", "s", "Zs")
    w64 = _weights(torch, gen, C4["N"])
    errs = {}
    for label, w in (("unweighted", None), ("weighted", w64)):
        got = psi.psi2_batched(*(f32[k] for k in names),
                               None if w is None else w.float())
        want = psi.psi2_batched_reference(*(f64[k] for k in names), w)
        torch.cuda.synchronize()
        errs[label] = _errors([got], [want])
    args32 = tuple(f32[k] for k in names)
    bitwise = bool(torch.equal(psi.psi2_batched(*args32),
                               psi.psi2_batched(*args32)))
    ms = _timed(lambda: psi.psi2_batched(*args32), torch)
    device_ms = _device_ms(lambda: psi.psi2_batched(*args32), torch)
    plain_ms = _timed(lambda: psi.psi2_batched_reference(*args32), torch,
                      reps=5, warmup=1)
    shape = {k: C4[k] for k in "TNMQ"}
    bound_ms, bound_by = _bound_ms(*k4_work(**shape))
    scale = _k4_at_scale(torch, psi, gen)
    row = dict(phase="k4", shape=shape,
               max_abs_err=max(e[0] for e in errs.values()),
               scaled_err={k: e[1] for k, e in errs.items()}, tol=TOL_K4,
               repeat_bitwise_equal=bitwise,
               geometry=_k1_geometry(psi, dict(shape, D=0)),
               launches_in_phase=psi.LAUNCHES["psi2_batched"], ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, scale=scale, library_ms=None,
               library_note="no single PyTorch call computes Psi2")
    emit(row)
    if not max(e[1] for e in errs.values()) <= TOL_K4:
        raise AssertionError(f"K4 disagrees with its plain version: {errs}")
    if not bitwise:
        raise AssertionError("two K4 launches on the same inputs differ")
    if not scale["scaled_err"] <= TOL_K4:
        raise AssertionError(f"K4 disagrees at the scale shape: {scale}")
    return row


def _k4_at_scale(torch, psi, gen):
    """K4 at N=8192, M=128, T=20 against its plain version in f64."""
    shape = {k: SCALE[k] for k in "TNMQ"}
    f64, f32 = _inputs(torch, gen, **SCALE)
    names = ("vs", "ards", "mu", "s", "Zs")
    args32 = tuple(f32[k] for k in names)
    want = psi.psi2_batched_reference(*(f64[k] for k in names))
    abs_err, scaled = _errors([psi.psi2_batched(*args32)], [want])
    del want
    bound_ms, bound_by = _bound_ms(*k4_work(**shape))
    return dict(shape=shape, max_abs_err=abs_err, scaled_err=scaled,
                geometry=_k1_geometry(psi, dict(shape, D=0)),
                ms=_timed(lambda: psi.psi2_batched(*args32), torch,
                          reps=5, warmup=1),
                device_ms=_device_ms(lambda: psi.psi2_batched(*args32),
                                     torch, launches=5, replays=3),
                plain_ms=_timed(lambda: psi.psi2_batched_reference(*args32),
                                torch, reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_gate(torch, psi, gen):
    """Value and gradient of sum Psi2^2 over the weighted atom stack:
    Psi2BatchedFused (K4 forward, K2 backward) in f32 against the plain
    non-fused path in f64."""
    from dp_gp_lvm_tpu_torch.ops import dispatch

    f64, f32 = _inputs(torch, gen, **C4)
    names = ("vs", "ards", "mu", "s", "Zs")
    w64 = _weights(torch, gen, C4["N"])

    def run(tensors, w, use_fused):
        leaves = [tensors[k].detach().clone().requires_grad_()
                  for k in names] + [w.detach().clone().requires_grad_()]
        p2 = dispatch.psi2_batched(*leaves, use_fused=use_fused)
        val = torch.sum(p2 * p2)
        return val.detach(), torch.autograd.grad(val, leaves)

    psi.reset_launch_counts()
    val32, g32 = run(f32, w64.float(), True)
    torch.cuda.synchronize()
    launches = dict(psi.LAUNCHES)
    val64, g64 = run(f64, w64, False)
    rel_val = float((val32.double() - val64).abs() / val64.abs())
    scaled = {n: float((g.double() - w).abs().max() / w.abs().max())
              for n, g, w in zip(names + ("w",), g32, g64)}
    row = dict(phase="gate", shape={k: C4[k] for k in "TNMQ"},
               value_f32=float(val32), value_f64=float(val64),
               value_rel_err=rel_val, grad_scaled_err=scaled, tol=TOL_GATE,
               launches=launches)
    emit(row)
    if not (rel_val <= TOL_GATE and max(scaled.values()) <= TOL_GATE):
        raise AssertionError(f"gate: fused disagrees with plain: {row}")
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(psi2_batched=1, psi2_bwd_batched=1)
    if launches != expected:
        raise AssertionError(f"gate launched {launches}")
    return row


def _ten_steps(torch, psi, loss_fn, params, opt, steps=10):
    """Ten (`steps`) training steps with the launch counts set to 0 just
    before: (losses, CUDA-event ms per step, launch counts just after)."""
    keys = list(params)
    losses, step_ms = [], []
    psi.reset_launch_counts()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = loss_fn()
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        opt.step(opt.reduce(dict(zip(keys, grads))))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss.detach()))
    return losses, step_ms, dict(psi.LAUNCHES)


def _init_grad_err(torch, loss32, loss64, params, p64):
    """The loss gradient at init: fused f32 (`loss32` on `params`) against
    the plain path in f64 (`loss64` on `p64`), per leaf scaled by
    max|ref|."""
    keys = list(params)
    g32 = torch.autograd.grad(loss32(), [params[k] for k in keys])
    leaves64 = [p64[k].requires_grad_() for k in keys]
    g64 = torch.autograd.grad(loss64(), leaves64)
    return {k: float((a.double() - b).abs().max() / b.abs().max())
            for k, a, b in zip(keys, g32, g64)}


def phase_train(torch, seed):
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    c4 = CONFIGS["c4_dp_mocap"]
    if (c4.t, c4.n, c4.m, c4.q, c4.d) != tuple(C4[k] for k in "TNMQD"):
        raise AssertionError("C4 no longer matches core/config.py")
    key = prng.PRNGKey(seed)    # the reference's draw of this seed
    Y, _ = mocap_like(key, n=c4.n, d=c4.d, dtype=torch.float32)
    cfg = dp_gp_lvm.Config(num_latent=c4.q, num_inducing=c4.m,
                           truncation=c4.t, alpha=c4.alpha)
    params = dp_gp_lvm.init_params(key, Y, cfg)

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
    grad_err = _init_grad_err(
        torch, lambda: dp_gp_lvm.loss(params, Y, cfg),
        lambda: -dp_gp_lvm.elbo(p64, Y.double(), cfg_plain, same_jitter),
        params, p64)

    opt = gp_optimizer(params, lr=c4.lr, ngd_lr=c4.ngd_lr)
    losses, step_ms, launches = _ten_steps(
        torch, psi, lambda: dp_gp_lvm.loss(params, Y, cfg), params, opt)
    row = dict(phase="train", config="c4_dp_mocap", shape=C4,
               elbo_init_fused_f32=elbo_fused, elbo_init_plain_f64=elbo_plain,
               elbo_rel_err=rel, tol=TOL_ELBO, grad_scaled_err=grad_err,
               tol_grad=TOL_GRAD, losses=losses,
               ms_per_step_median=statistics.median(step_ms),
               ms_per_step=step_ms, launches=launches)
    emit(row)
    if not rel <= TOL_ELBO:
        raise AssertionError(f"fused ELBO {elbo_fused} vs plain {elbo_plain}")
    if not max(grad_err.values()) <= TOL_GRAD:
        raise AssertionError(f"fused gradient off the plain one: {grad_err}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=10, psi2_bwd_batched=10)
    if launches != expected:
        raise AssertionError(f"main path launched {launches}, expected K1 "
                             "and K2 10 times each")
    return row, params, Y, cfg


def phase_train_bgplvm(torch, seed):
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data.synthetic import oil_flow_like
    from dp_gp_lvm_tpu_torch.models import bgplvm
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    c2 = CONFIGS["c2_sparse_oil"]
    if (c2.n, c2.m, c2.q, c2.d) != tuple(C2[k] for k in "NMQD"):
        raise AssertionError("C2 no longer matches core/config.py")
    key = prng.PRNGKey(seed)    # the reference's draw of this seed
    Y, _, _ = oil_flow_like(key, n=c2.n, d=c2.d, dtype=torch.float32)
    cfg = bgplvm.Config(num_latent=c2.q, num_inducing=c2.m)
    params = bgplvm.init_params(key, Y, cfg)

    policy32 = JitterPolicy()
    same_jitter = JitterPolicy(initial=policy32.initial_for(torch.float32))
    with torch.no_grad():
        elbo_fused = float(bgplvm.elbo(params, Y, cfg))
        p64 = {k: v.double() for k, v in params.items()}
        cfg_plain = cfg._replace(use_fused=False)
        elbo_plain = float(bgplvm.elbo(p64, Y.double(), cfg_plain,
                                       same_jitter))
    rel = abs(elbo_fused - elbo_plain) / abs(elbo_plain)
    grad_err = _init_grad_err(
        torch, lambda: bgplvm.loss(params, Y, cfg),
        lambda: -bgplvm.elbo(p64, Y.double(), cfg_plain, same_jitter),
        params, p64)

    opt = gp_optimizer(params, lr=c2.lr, ngd_lr=c2.ngd_lr)
    losses, step_ms, launches = _ten_steps(
        torch, psi, lambda: bgplvm.loss(params, Y, cfg), params, opt)
    row = dict(phase="train_bgplvm", config="c2_sparse_oil", shape=C2,
               elbo_init_fused_f32=elbo_fused, elbo_init_plain_f64=elbo_plain,
               elbo_rel_err=rel, tol=TOL_ELBO, grad_scaled_err=grad_err,
               tol_grad=TOL_GRAD, losses=losses,
               ms_per_step_median=statistics.median(step_ms),
               ms_per_step=step_ms, launches=launches)
    emit(row)
    if not rel <= TOL_ELBO:
        raise AssertionError(f"fused ELBO {elbo_fused} vs plain {elbo_plain}")
    if not max(grad_err.values()) <= TOL_GRAD:
        raise AssertionError(f"fused gradient off the plain one: {grad_err}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(psi1=10, psi2_single=10, psi2_bwd_batched=10)
    if launches != expected:
        raise AssertionError(f"c2 path launched {launches}, expected K6, K5 "
                             "and K2 10 times each")
    return row, params, Y, cfg


def _steps_from_trace(trace):
    """Steps the latent inference took: the trace repeats its last value
    once early stopping has converged."""
    changed = (trace[1:] != trace[:-1]).nonzero()
    return int(changed[-1]) + 2 if changed.numel() else 1


def _serve(torch, seed, name, impute, infer, predict64, predict32, w64, w32,
           d, batches):
    """Answer requests of each batch size through `impute`; check the
    outputs, the objective trace of the same inference, and the f32
    predictive against f64 at a fixed q(x*); compare the posterior
    cache's weights (`w32` through the kernels, `w64` plain)."""
    from dp_gp_lvm_tpu_torch.models import serving

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = []
    for b in batches:
        def request():
            y = torch.randn(b, d, generator=gen, device="cuda")
            mask = torch.ones(b, d, device="cuda")
            mask[:, d // 2:] = 0.0
            return y, mask

        times = []
        for i in range(4):                       # one warm call, then 3
            y, mask = request()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = impute(y, mask)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            if not (mean.shape == var.shape == (b, d)
                    and bool(torch.isfinite(mean).all())
                    and bool(torch.isfinite(var).all())
                    and bool((var > 0).all())):
                raise AssertionError(f"{name}: bad answer at batch {b}")
        tol, steps = serving._resolve("auto", SERVE_STEPS, b)
        trace = infer(y, mask, steps, tol)
        if not float(trace[-1]) > float(trace[0]):
            raise AssertionError(f"{name}: objective fell at batch {b}: "
                                 f"{float(trace[0])} -> {float(trace[-1])}")
        rows.append(dict(batch=b, mode="tol" if tol else "unroll",
                         step_cap=steps,
                         steps_taken=_steps_from_trace(trace),
                         ms_per_request=statistics.median(times),
                         objective_first=float(trace[0]),
                         objective_last=float(trace[-1])))
    (m64, v64), (m32, v32) = predict64(), predict32()
    pred_err = dict(
        mean=float((m32.double() - m64).abs().max() / m64.abs().max()),
        var=float((v32.double() - v64).abs().max() / v64.abs().max()),
        cache_w=float((w32.double() - w64).abs().max() / w64.abs().max()))
    return rows, pred_err


def _check_serve(name, pred_err):
    if not max(pred_err["mean"], pred_err["var"]) <= TOL_PRED:
        raise AssertionError(f"{name}: f32 predictive off: {pred_err}")
    if not pred_err["cache_w"] <= TOL_CACHE_W:
        raise AssertionError(f"{name}: f32 posterior cache off: {pred_err}")


def phase_serve_bgplvm(torch, seed, params, Y, cfg):
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import prediction, serving
    from dp_gp_lvm_tpu_torch.ops import psi

    psi.reset_launch_counts()
    impute = serving.make_bgplvm_imputer(params, Y, cfg,
                                         num_steps=SERVE_STEPS)
    launches = dict(psi.LAUNCHES)
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(psi1=1, psi2_single=1)
    if launches != expected:
        raise AssertionError(f"bgplvm_posterior launched {launches}, "
                             "expected K6 and K5 once each")
    cache32 = prediction.bgplvm_posterior(params, Y, cfg)
    same_jitter = JitterPolicy(
        initial=JitterPolicy().initial_for(torch.float32))
    cache64 = prediction.bgplvm_posterior(
        {k: v.detach().double() for k, v in params.items()}, Y.double(),
        cfg._replace(use_fused=False), same_jitter)
    qx = params["qx_mean"].detach()
    m_fix, s_fix = qx[:32], torch.full_like(qx[:32], 0.1)

    def infer(y, mask, steps, tol):
        m0 = prediction.init_latent_from_nearest(qx, Y, y, mask)
        return prediction.infer_latent(cache32, y, mask, m0, steps,
                                       tol=tol)[2]

    with torch.no_grad():
        rows, pred_err = _serve(
            torch, seed, "serve_bgplvm", impute, infer,
            lambda: prediction.predict_from_latent(
                cache64, m_fix.double(), s_fix.double()),
            lambda: prediction.predict_from_latent(cache32, m_fix, s_fix),
            cache64.w, cache32.w, Y.shape[1], (1, 8, 32))
    row = dict(phase="serve_bgplvm", config="c2_sparse_oil", shape=C2,
               num_steps=SERVE_STEPS, build_launches=launches,
               requests=rows, predict_f32_vs_f64_scaled_err=pred_err,
               tol=TOL_PRED, tol_cache_w=TOL_CACHE_W)
    emit(row)
    _check_serve("serve_bgplvm", pred_err)
    return row


def phase_serve_dp(torch, seed, params, Y, cfg):
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import prediction, serving
    from dp_gp_lvm_tpu_torch.ops import psi

    c5 = CONFIGS["c5_dp_missing"]
    if (c5.t, c5.n, c5.m, c5.q, c5.d) != tuple(C4[k] for k in "TNMQD"):
        raise AssertionError("c5_dp_missing no longer has the c4 widths")
    psi.reset_launch_counts()
    impute = serving.make_dp_imputer(params, Y, cfg, num_steps=SERVE_STEPS)
    launches = dict(psi.LAUNCHES)
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=1)
    if launches != expected:
        raise AssertionError(f"dp_posterior launched {launches}, expected "
                             "K1 once")
    caches32, phi32 = prediction.dp_posterior(params, Y, cfg)
    same_jitter = JitterPolicy(
        initial=JitterPolicy().initial_for(torch.float32))
    caches64, phi64 = prediction.dp_posterior(
        {k: v.detach().double() for k, v in params.items()}, Y.double(),
        cfg._replace(use_fused=False), same_jitter)
    qx = params["qx_mean"].detach()
    m_fix, s_fix = qx[:32], torch.full_like(qx[:32], 0.1)

    def infer(y, mask, steps, tol):
        m0 = prediction.init_latent_from_nearest(qx, Y, y, mask)
        return prediction.dp_infer_latent(caches32, phi32, y, mask, m0,
                                          steps, tol=tol)[2]

    with torch.no_grad():
        rows, pred_err = _serve(
            torch, seed, "serve_dp", impute, infer,
            lambda: prediction.dp_predict_from_latent(
                caches64, phi64, m_fix.double(), s_fix.double()),
            lambda: prediction.dp_predict_from_latent(caches32, phi32,
                                                      m_fix, s_fix),
            caches64.w, caches32.w, Y.shape[1], (1, 8, 32, 128))
    row = dict(phase="serve_dp", config="c5_dp_missing", shape=C4,
               num_steps=SERVE_STEPS, build_launches=launches,
               requests=rows, predict_f32_vs_f64_scaled_err=pred_err,
               tol=TOL_PRED, tol_cache_w=TOL_CACHE_W)
    emit(row)
    _check_serve("serve_dp", pred_err)
    return row


def _nested(flat):
    """A runner's params.npz (MRD's views under `views/<i>/<key>`) as the
    model's parameter dict, on the card."""
    import torch

    params, views = {}, {}
    for k, v in flat.items():
        t = torch.as_tensor(v, device="cuda")
        if k.startswith("views/"):
            _, i, leaf = k.split("/")
            views.setdefault(int(i), {})[leaf] = t
        else:
            params[k] = t
    params["views"] = [views[i] for i in sorted(views)]
    return params


MRD_BATCHES = (1, 4, 8, 32)


def phase_serve_mrd(torch, seed):
    """MRD's cross-view server on the c3 parameters the runs phase trained:
    observe view 0 of held-out rows, predict view 1."""
    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import prediction, serving
    from dp_gp_lvm_tpu_torch.ops import dispatch, psi
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz

    cfg = dataclasses.replace(config.get("c3_mrd_twoview"), seed=seed)
    mcfg = runner._model_config(cfg, None)
    views, _ = runner.load_data(cfg, torch.float32, "cuda")
    keep = torch.as_tensor(runner._holdout_rows(cfg.n), device="cuda")
    Ys = [y[keep] for y in views]
    y_test = views[0][~keep]
    params = _nested(load_npz(str(RUN_OUT / cfg.name / "params.npz")))
    N, M, Q, D = Ys[0].shape[0], cfg.m, cfg.q, cfg.views[0]
    fits = dict(suff_stats=dispatch.resolve_fused("auto", "ard_rbf", "cuda",
                                                  M, Q, D),
                psi2_only=dispatch.resolve_fused("auto", "ard_rbf", "cuda",
                                                 M, Q, 0))

    psi.reset_launch_counts()
    predict = serving.make_mrd_cross_view_predictor(
        params, Ys, mcfg, observed_view=0, target_view=1,
        num_steps=SERVE_STEPS)
    launches = dict(psi.LAUNCHES)
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(psi1=2, psi2_single=2)

    caches32 = prediction.mrd_posterior(params, Ys, mcfg)
    p64 = {k: v.double() for k, v in params.items() if k != "views"}
    p64["views"] = [{k: v.double() for k, v in view.items()}
                    for view in params["views"]]
    Ys64 = [y.double() for y in Ys]
    plain64 = mcfg._replace(use_fused=False)
    same_jitter = JitterPolicy(
        initial=JitterPolicy().initial_for(torch.float32))
    caches64 = prediction.mrd_posterior(p64, Ys64, plain64, same_jitter)
    rows = []
    for b in MRD_BATCHES:
        y = y_test[:b]
        times = []
        for i in range(4):                       # one warm call, then 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = predict(y)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
        if not (mean.shape == var.shape == (b, cfg.views[1])
                and bool(torch.isfinite(mean).all())
                and bool(torch.isfinite(var).all())
                and bool((var > 0).all())):
            raise AssertionError(f"serve_mrd: bad answer at batch {b}")
        tol, steps = serving._resolve("auto", SERVE_STEPS, b)
        m0 = prediction.init_latent_from_nearest(
            params["qx_mean"], Ys[0], y, torch.ones_like(y))
        trace = prediction.mrd_infer_latent(caches32, {0: y}, m0, steps,
                                            tol=tol)[2]
        if not float(trace[-1]) > float(trace[0]):
            raise AssertionError(f"serve_mrd: objective fell at batch {b}: "
                                 f"{float(trace[0])} -> {float(trace[-1])}")
        rows.append(dict(batch=b, mode="tol" if tol else "unroll",
                         step_cap=steps,
                         steps_taken=_steps_from_trace(trace),
                         ms_per_request=statistics.median(times),
                         objective_first=float(trace[0]),
                         objective_last=float(trace[-1])))
    # held: the predictive at a fixed q(x*) and the caches' weights, f32
    # through the kernels against f64 plain; reported: the whole request
    # (inference included) in f32 against f64 plain on the same rows
    qx = params["qx_mean"]
    m_fix, s_fix = qx[:32], torch.full_like(qx[:32], 0.1)
    with torch.no_grad():
        m64, v64 = prediction.predict_from_latent(caches64[1],
                                                  m_fix.double(),
                                                  s_fix.double())
        m32, v32 = prediction.predict_from_latent(caches32[1], m_fix, s_fix)
    pred_err = dict(
        mean=float((m32.double() - m64).abs().max() / m64.abs().max()),
        var=float((v32.double() - v64).abs().max() / v64.abs().max()),
        cache_w=max(float((c32.w.double() - c64.w).abs().max()
                          / c64.w.abs().max())
                    for c32, c64 in zip(caches32, caches64)))
    predict64 = serving.make_mrd_cross_view_predictor(
        p64, Ys64, plain64, observed_view=0, target_view=1,
        num_steps=SERVE_STEPS, device="cuda")
    full32, full64 = predict(y_test), predict64(y_test.double())
    request_gap = {k: float((a.double() - w).abs().max() / w.abs().max())
                   for k, a, w in zip(("mean", "var"), full32, full64)}
    row = dict(phase="serve_mrd", config=cfg.name,
               shape=dict(N=N, M=M, Q=Q, D=list(cfg.views)),
               resolve_fused_auto=fits, num_steps=SERVE_STEPS,
               build_launches=launches, requests=rows,
               predict_f32_vs_f64_scaled_err=pred_err, tol=TOL_PRED,
               tol_cache_w=TOL_CACHE_W,
               request_f32_vs_f64_scaled_gap_batch_32=request_gap,
               trained_restart=int(np.argmax(json.loads(
                   (RUN_OUT / cfg.name / "result.json").read_text())[
                       "restart_elbos"])))
    emit(row)
    if not all(fits.values()):
        raise AssertionError(f"serve_mrd: auto refuses the kernels at c3's "
                             f"widths: {fits}")
    if launches != expected:
        raise AssertionError(f"mrd_posterior launched {launches}, expected "
                             "K6 and K5 once per view")
    _check_serve("serve_mrd", pred_err)
    return row


# the CAVI step in f32 against f64: phi moves by at most
# phi (exp(2 delta) - 1) for a logit error delta, and c4's per-dim atom
# bounds (~1e4) carry f32 errors near 2e-3 (an f32 run of the step on the
# CPU), so 1e-2 covers delta up to 5e-3; gamma sums phi over dims
TOL_CAVI = 1e-2


def phase_cavi(torch, params, Y, cfg):
    """One full-batch CAVI step of (phi, gamma) on the train phase's c4
    parameters: one K1 launch at T = 20 and no K2."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm
    from dp_gp_lvm_tpu_torch.ops import psi

    with torch.no_grad():
        elbo_before = float(dp_gp_lvm.elbo(params, Y, cfg))
    psi.reset_launch_counts()
    with _first_inputs(torch, psi) as seen:
        new = dp_gp_lvm.cavi_step(params, Y, cfg)
    launches = dict(psi.LAUNCHES)
    held = _hold_first_inputs(torch, psi, seen)
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=1)
    same_jitter = JitterPolicy(
        initial=JitterPolicy().initial_for(torch.float32))
    plain = cfg._replace(use_fused=False)
    p64 = {k: v.detach().double() for k, v in params.items()}
    with torch.no_grad():
        elbo_after = float(dp_gp_lvm.elbo(new, Y, cfg))
        new64 = dp_gp_lvm.cavi_step(p64, Y.double(), plain, same_jitter)
        f32 = dp_gp_lvm.per_dim_atom_bound(dp_gp_lvm.constrain(params), Y,
                                           cfg)
        f64 = dp_gp_lvm.per_dim_atom_bound(dp_gp_lvm.constrain(p64),
                                           Y.double(), plain, same_jitter)
    phi, phi64 = (dp_gp_lvm.expected_assignments(p) for p in (new, new64))
    errs = dict(
        phi_abs=float((phi.double() - phi64).abs().max()),
        **{k: float((new[k].double() - new64[k]).abs().max()
                    / new64[k].abs().max())
           for k in ("raw_gamma1", "raw_gamma2")})
    row_sums = float((phi.sum(-1) - 1.0).abs().max())
    row = dict(phase="cavi", config="c4_dp_mocap", shape=C4,
               launches=launches, held_on_the_steps_inputs=held,
               elbo_before=elbo_before, elbo_after=elbo_after,
               tol_elbo=TOL_ELBO, f32_vs_f64=errs, tol=TOL_CAVI,
               per_dim_bound_max_abs_err=float((f32.double() - f64).abs()
                                               .max()),
               phi_row_sum_max_err=row_sums,
               atoms_used=int((phi.sum(0) > 0.5).sum()))
    emit(row)
    if launches != expected:
        raise AssertionError(f"cavi launched {launches}, expected K1 once")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"cavi: K1 disagrees with its plain version "
                                 f"on the step's inputs: {h}")
    if not elbo_after >= elbo_before - TOL_ELBO * abs(elbo_before):
        raise AssertionError(f"cavi lowered the ELBO: {elbo_before} -> "
                             f"{elbo_after}")
    if not row_sums <= 1e-5:
        raise AssertionError(f"cavi: phi rows do not sum to 1: {row_sums}")
    if not max(errs.values()) <= TOL_CAVI:
        raise AssertionError(f"cavi: f32 step off the f64 one: {errs}")
    return row


LINEAR_STEPS = 20


def phase_linear(torch, seed):
    """The Bayesian GP-LVM with the linear kernel at c2's N, D and Q: its
    psi statistics are plain matrix products, so nothing may launch. M is
    Q: at c2's M = 50 > Q the linear K_uu has rank Q, and f32 solves
    against it lose the ELBO (reported at init, not held).

    With M = Q the inducing points span the kernel's whole feature space,
    so psi0 = tr(K_uu^-1 Psi2) exactly and the bound's terms
    -beta psi0 / 2 and +beta tr(K_uu^-1 Psi2) / 2, each D beta psi0 / 2
    (~9e5 here) over the D dims, cancel: the f32 ELBO is held against f64
    relative to that term, the largest of the bound, not to the ELBO."""
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data.synthetic import oil_flow_like
    from dp_gp_lvm_tpu_torch.models import bgplvm
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    c2 = CONFIGS["c2_sparse_oil"]
    key = prng.PRNGKey(seed)
    Y, _, _ = oil_flow_like(key, n=c2.n, d=c2.d, dtype=torch.float32)
    same_jitter = JitterPolicy(
        initial=JitterPolicy().initial_for(torch.float32))

    def at_init(m):
        cfg = bgplvm.Config(num_latent=c2.q, num_inducing=m,
                            kernel="linear")
        params = bgplvm.init_params(key, Y, cfg)
        with torch.no_grad():
            e32 = float(bgplvm.elbo(params, Y, cfg))
            t64 = bgplvm.elbo_terms({k: v.double() for k, v in
                                     params.items()}, Y.double(), cfg,
                                    same_jitter)
        # the bound's largest term: D tr(beta K_uu^-1 Psi2) / 2
        largest = 0.5 * c2.d * abs(float(t64["trace_a"]))
        return params, cfg, e32, float(t64["elbo"]), largest

    params, cfg, e32, e64, largest = at_init(c2.q)
    _, _, e32_m, e64_m, _ = at_init(c2.m)
    rel = abs(e32 - e64) / abs(e64)
    rel_largest = abs(e32 - e64) / max(abs(e64), largest)
    opt = gp_optimizer(params, lr=c2.lr, ngd_lr=c2.ngd_lr)
    psi.reset_launch_counts()
    losses, step_ms = [], []
    keys = list(params)
    for _ in range(LINEAR_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = bgplvm.loss(params, Y, cfg)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        opt.step(opt.reduce(dict(zip(keys, grads))))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss.detach()))
    launches = dict(psi.LAUNCHES)
    row = dict(phase="linear", config="c2_sparse_oil", kernel="linear",
               shape=dict(N=c2.n, M=c2.q, Q=c2.q, D=c2.d),
               elbo_init_f32=e32, elbo_init_f64=e64, elbo_rel_err=rel,
               largest_term=largest, err_over_largest_term=rel_largest,
               tol=TOL_ELBO,
               at_c2_m=dict(M=c2.m, elbo_init_f32=e32_m, elbo_init_f64=e64_m,
                            elbo_rel_err=abs(e32_m - e64_m) / abs(e64_m)),
               losses=losses, ms_per_step_median=statistics.median(step_ms),
               launches=launches)
    emit(row)
    if any(launches.values()):
        raise AssertionError(f"linear: a psi kernel launched: {launches}")
    if not rel_largest <= TOL_ELBO:
        raise AssertionError(f"linear: f32 ELBO {e32} vs f64 {e64} "
                             f"(largest term {largest})")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"linear: the ELBO did not rise: {losses}")
    return row


RUN_CONFIGS = ("c1_bgplvm_toy", "c2_sparse_oil", "c3_mrd_twoview",
               "c4_dp_mocap", "c5_dp_missing", "c5_pose_missing")
RUN_STEPS = 100       # two chunks of the runner's 50 (a restart each)
RUN_OUT = ROOT / "build" / "smoke_runs"   # each run's result and params
# each kernel wrapper: its plain version (which takes the same
# arguments), the tolerance it is held to, and where its row weights sit
# among its positional arguments
RUN_KERNELS = dict(
    suffstats_batched=("suffstats_batched_reference", TOL_K1, 6),
    psi2_bwd_batched=("psi2_bwd_batched_reference", TOL_K2, 6),
    psi2_batched=("psi2_batched_reference", TOL_K4, 5),
    psi2_single=("psi2_single_reference", TOL_K5, 5),
    psi1=("psi1_reference", TOL_K6, 5))


@contextlib.contextmanager
def _first_inputs(torch, psi, worth=lambda name, args: True):
    """While the block runs, keep a copy of the arguments of the first
    call of each kernel wrapper at each signature (its name, the shapes of
    its tensors, None where an optional one is not given) that `worth`
    accepts. The wrappers are module attributes looked up at call time,
    so the fused autograd ops and every model reach the recording
    copies."""
    seen, pending = {}, {}
    originals = {name: getattr(psi, name) for name in RUN_KERNELS}

    def recording(name, fn):
        def wrapper(*args):
            key = (name,) + tuple(tuple(a.shape) if torch.is_tensor(a) else a
                                  for a in args)
            if key in seen or key in pending:
                pass
            elif torch.cuda.is_current_stream_capturing():
                # a captured step: the copies fill at each replay and
                # `worth` reads them after the block, off the graph
                pending[key] = _copied(torch, args)
            elif worth(name, args):
                seen[key] = _copied(torch, args)
            return fn(*args)
        return wrapper

    for name, fn in originals.items():
        setattr(psi, name, recording(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(psi, name, fn)
        torch.cuda.synchronize()
        for key, args in pending.items():
            if key not in seen and worth(key[0], args):
                seen[key] = args


def _copied(torch, args):
    return [a.detach().clone() if torch.is_tensor(a) else a for a in args]


def _hold_first_inputs(torch, psi, seen):
    """Each kernel on the inputs a run gave it, against its plain version
    in f64 on the same inputs, and repeated to the bit."""
    held = []
    for key, args in seen.items():
        name = key[0]
        ref_name, tol, w_at = RUN_KERNELS[name]
        got = getattr(psi, name)(*args)
        again = getattr(psi, name)(*args)
        want = getattr(psi, ref_name)(*(a.double() if torch.is_tensor(a)
                                        else a for a in args))
        got, again, want = (x if isinstance(x, tuple) else (x,)
                            for x in (got, again, want))
        abs_err, scaled = _errors(got, want)
        held.append(dict(
            kernel=name, shapes=[list(k) for k in key[1:]
                                 if isinstance(k, tuple)],
            weighted=len(args) > w_at and args[w_at] is not None,
            max_abs_err=abs_err,
            scaled_err=scaled, tol=tol,
            repeat_bitwise_equal=all(bool(torch.equal(x, y))
                                     for x, y in zip(got, again))))
    return held


def _work_of(name, args):
    """(shape, bound_ms, bound_by) of one kernel call on `args`."""
    if name in ("psi2_single", "psi1"):
        (M, Q), N = args[4].shape, args[2].shape[0]
        shape = dict(N=N, M=M, Q=Q)
        work = (k5_work if name == "psi2_single" else k6_work)(**shape)
    else:
        T, M, Q = args[4].shape
        shape = dict(T=T, N=args[2].shape[0], M=M, Q=Q)
        if name == "suffstats_batched":
            shape["D"] = args[5].shape[1]
        work = dict(suffstats_batched=k1_work, psi2_bwd_batched=k2_work,
                    psi2_batched=k4_work)[name](**shape)
    return (shape, *_bound_ms(*work))


def _timed_on_inputs(torch, psi, seen, plain=False):
    """Each kernel on the first inputs a run gave it (`_first_inputs`):
    its device ms against its bound, and with `plain` the wrapper's ms
    and its plain version's on the same inputs."""
    timing = {}
    for key, args in seen.items():
        name = key[0]
        shape, bound, by = _work_of(name, args)
        dev = _device_ms(lambda: getattr(psi, name)(*args), torch)
        timing[name] = dict(shape=shape, device_ms=dev, bound_ms=bound,
                            bound_by=by, device_over_bound=dev / bound)
        if plain:
            ref = getattr(psi, RUN_KERNELS[name][0])
            timing[name].update(
                ms=_timed(lambda: getattr(psi, name)(*args), torch),
                plain_ms=_timed(lambda: ref(*args), torch, reps=5,
                                warmup=1))
    return timing


def _expected_run_launches(psi, cfg, steps):
    """The kernel launches of the runner's run of `cfg` that took `steps`
    optimizer steps (training and timing)."""
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    if cfg.model == "bgplvm":
        # per step K6 and K5 forward, K2 backward; K6 and K5 once more
        # for the result's ELBO terms
        expected.update(psi1=steps + 1, psi2_single=steps + 1,
                        psi2_bwd_batched=steps)
    elif cfg.model == "mrd":
        # per view and step K1 forward, K2 backward; K1 once more per view
        # for the ELBO terms, and per view K6 and K5 once for the
        # cross-view prediction's posterior build
        V = len(cfg.views)
        expected.update(suffstats_batched=V * (steps + 1),
                        psi2_bwd_batched=V * steps, psi1=V, psi2_single=V)
    else:
        # per step K1 forward, K2 backward; K1 once more for the ELBO
        # terms, and once for the imputation's posterior build
        expected.update(
            suffstats_batched=steps + 1 + (cfg.missing_fraction > 0),
            psi2_bwd_batched=steps)
    return expected


def phase_runs(torch, seed):
    import dataclasses

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop

    rows = {}
    for name in RUN_CONFIGS:
        cfg = dataclasses.replace(config.get(name), seed=seed)
        psi.reset_launch_counts()
        loop.reset_step_count()
        graphs0 = dict(loop.GRAPHS)
        with _first_inputs(torch, psi) as seen:
            result = runner.run(cfg, steps=RUN_STEPS, device="cuda",
                                out=str(RUN_OUT / name))
        launches = dict(psi.LAUNCHES)
        steps = loop.STEPS["taken"]      # training and timing
        expected = _expected_run_launches(psi, cfg, steps)
        held = _hold_first_inputs(torch, psi, seen)
        finiteness = config.evaluate_checks("", result)   # no gates
        failures = config.evaluate_checks(name, result)
        row = dict(phase="runs", config=name, steps=RUN_STEPS,
                   **_graphs_since(loop, graphs0),
                   **(_step_fields("c4") if name == "c4_dp_mocap" else {}),
                   decay_steps=RUN_STEPS, steps_taken=steps,
                   ms_per_step=result["ms_per_step"],
                   seconds=result["seconds"], elbo=result["elbo"],
                   nonfinite=finiteness,
                   missing=[f for f in failures if "MISSING" in f],
                   gates_not_held_at_these_steps=[
                       f for f in failures if f not in finiteness],
                   launches=launches, expected_launches=expected,
                   held_on_the_runs_inputs=held,
                   **{k: result[k] for k in ("imputation_mse",
                                             "predictive_loglik_per_dim",
                                             "imputation_seconds",
                                             "ard_recall_top2",
                                             "ard_separation_ratio",
                                             "restart_elbos",
                                             "cross_view_mse_ratio",
                                             "cross_view_pll_per_dim",
                                             "ard_cross_private_ratio",
                                             "calibration_ratio",
                                             "cross_view_seconds")
                      if k in result})
        if cfg.model == "mrd":
            # c3's kernels on the run's own first inputs: the widths no
            # other phase times
            row["kernels_at_c3"] = _timed_on_inputs(torch, psi, seen,
                                                    plain=True)
        emit(row)
        _held_replayed(row)
        if row["nonfinite"] or row["missing"]:
            raise AssertionError(f"runs: {name} gave a broken result: {row}")
        if launches != expected:
            raise AssertionError(f"runs: {name} launched {launches}, "
                                 f"expected {expected}")
        if {h["kernel"] for h in held} != {k for k, n in launches.items()
                                          if n}:
            raise AssertionError(f"runs: {name} held {held} against the "
                                 f"kernels it launched, {launches}")
        for h in held:
            if not (h["scaled_err"] <= h["tol"]
                    and h["repeat_bitwise_equal"]):
                raise AssertionError(f"runs: {name}: {h['kernel']} disagrees "
                                     f"with its plain version on the run's "
                                     f"inputs: {h}")
        rows[name] = row
    return rows


MESH_CONFIGS = ("c4_dp_mocap", "c2_sparse_oil", "c3_mrd_twoview")


def _mesh_setup(torch, seed, name):
    """(model name, module, f32 params at init, data tuple, model config,
    run config) of a full-batch config at full width, drawn and
    initialized as the runner does (MRD's held-out rows removed)."""
    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.experiments import run as runner

    cfg = dataclasses.replace(config.get(name), seed=seed)
    Y, _ = runner.load_data(cfg, torch.float32, "cuda")
    if cfg.model == "mrd":
        keep = torch.as_tensor(runner._holdout_rows(cfg.n), device="cuda")
        data = tuple(y[keep] for y in Y)
    else:
        data = (Y,)
    model = runner.MODELS[cfg.model]
    mcfg = runner._model_config(cfg, None)
    params = model.init_params(prng.PRNGKey(cfg.seed),
                               list(data) if cfg.model == "mrd" else Y, mcfg)
    return cfg.model, model, params, data, mcfg, cfg


def _f64_tree(params):
    def leaf(v):
        return v.detach().double().requires_grad_()

    return {k: ([{kk: leaf(vv) for kk, vv in view.items()} for view in v]
                if k == "views" else leaf(v)) for k, v in params.items()}


def _mesh_model(torch, psi, mesh, seed, name):
    """One config on the 1 x 1 mesh: the sharded loss and gradient at init
    against the single-device fused path (f32) and the plain path in f64
    at the f32 jitter; 10 optimizer steps through sharded_setup (launches
    held, kernels held on the steps' first inputs), and as many unsharded
    steps from the same init; then 10 more of each, in the other order,
    for the ms comparison."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.parallel import recipe
    from dp_gp_lvm_tpu_torch.train import loop

    family, model, params, data, mcfg, cfg = _mesh_setup(torch, seed, name)
    views = family == "mrd"

    def given(ys):
        return list(ys) if views else ys[0]

    leaves = loop.flat_leaves(params)
    loss32 = model.loss(params, given(data), mcfg)
    g32 = torch.autograd.grad(loss32, list(leaves.values()))
    p64 = _f64_tree(params)
    same_jitter = JitterPolicy(initial=JitterPolicy().initial_for(
        torch.float32))
    loss64 = -model.elbo(p64, given([y.double() for y in data]),
                         mcfg._replace(use_fused=False), same_jitter)
    g64 = torch.autograd.grad(loss64, list(loop.flat_leaves(p64).values()))

    setup = recipe.sharded_setup(family, params, data, mcfg, mesh)
    opt = loop.gp_optimizer(setup.params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                            mesh=mesh, placement=setup.placement)
    local = list(opt.params.values())
    loss_sh = setup.loss_fn(setup.params, *setup.data)
    g_sh = opt.reduce(dict(zip(opt.params, torch.autograd.grad(loss_sh,
                                                               local))))
    g_sh = list(g_sh.values())

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    def scaled(got, want):
        return max(float((a.double() - b.double()).abs().max()
                         / b.double().abs().max())
                   for a, b in zip(got, want))

    def sharded_steps():
        return _ten_steps(torch, psi,
                          lambda: setup.loss_fn(setup.params, *setup.data),
                          opt.params, opt)

    opt_u = loop.gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr)

    def unsharded_steps():
        return _ten_steps(torch, psi,
                          lambda: model.loss(params, given(data), mcfg),
                          leaves, opt_u)

    with _first_inputs(torch, psi) as seen:
        losses, ms, launches = sharded_steps()
    held = _hold_first_inputs(torch, psi, seen)
    losses_u, ms_u, _ = unsharded_steps()
    # the host clock moves between rounds: time in turns, sharded,
    # unsharded, unsharded, sharded, and compare the medians of both
    ms_u += unsharded_steps()[1]
    ms += sharded_steps()[1]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=10 * len(data),
                    psi2_bwd_batched=10 * len(data))
    loss_sh, loss32, loss64 = (x.detach() for x in (loss_sh, loss32,
                                                     loss64))
    row = dict(phase="mesh", config=name, model=family,
               loss_sharded_f32=float(loss_sh), loss_fused_f32=float(loss32),
               loss_plain_f64=float(loss64),
               loss_rel_err_vs_fused=rel(loss_sh, loss32),
               loss_rel_err_vs_f64=rel(loss_sh, loss64), tol=TOL_ELBO,
               grad_scaled_err_vs_fused=scaled(g_sh, g32),
               grad_scaled_err_vs_f64=scaled(g_sh, g64), tol_grad=TOL_GRAD,
               losses=losses, losses_unsharded=losses_u,
               ms_per_step_median=statistics.median(ms),
               ms_per_step_unsharded_median=statistics.median(ms_u),
               launches=launches, expected_launches=expected,
               held_on_the_steps_inputs=held)
    emit(row)
    if not (row["loss_rel_err_vs_fused"] <= TOL_ELBO
            and row["loss_rel_err_vs_f64"] <= TOL_ELBO):
        raise AssertionError(f"mesh: {name}: sharded loss off: {row}")
    if not (row["grad_scaled_err_vs_fused"] <= TOL_GRAD
            and row["grad_scaled_err_vs_f64"] <= TOL_GRAD):
        raise AssertionError(f"mesh: {name}: sharded gradient off: {row}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh: {name}: non-finite loss in {losses}")
    if launches != expected:
        raise AssertionError(f"mesh: {name} launched {launches}, expected "
                             f"{expected}")
    if {h["kernel"] for h in held} != {"suffstats_batched",
                                       "psi2_bwd_batched"}:
        raise AssertionError(f"mesh: {name} held {held}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"mesh: {name}: {h['kernel']} disagrees "
                                 f"with its plain version: {h}")
    return row


def phase_mesh(torch, seed, card, runs):
    """The device mesh at world size 1: an NCCL process group of one rank,
    a 1 x 1 mesh; c4, c2 and c3 through `_mesh_model`; the runner trains
    c4 with `--mesh 1,1` for RUN_STEPS steps (launches as the runs
    phase's c4); ms a step sharded and unsharded on one line with the
    card."""
    import torch.distributed as dist

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
    from dp_gp_lvm_tpu_torch.train import loop

    mesh = mesh_lib.make_mesh(1, 1, "cuda")
    try:
        probe = torch.arange(4.0, device="cuda")
        dist.all_reduce(probe, group=mesh.group("data"))
        if dist.get_backend() != "nccl" or not torch.equal(
                probe, torch.arange(4.0, device="cuda")):
            raise AssertionError(f"mesh: the group is {dist.get_backend()}, "
                                 f"its all-reduce gave {probe}")
        rows = {name: _mesh_model(torch, psi, mesh, seed, name)
                for name in MESH_CONFIGS}

        cfg = dataclasses.replace(config.get("c4_dp_mocap"), seed=seed)
        psi.reset_launch_counts()
        loop.reset_step_count()
        with _first_inputs(torch, psi) as seen:
            result = runner.run(cfg, steps=RUN_STEPS, device="cuda",
                                out=str(RUN_OUT / "mesh_c4_dp_mocap"),
                                mesh="1,1")
        launches = dict(psi.LAUNCHES)
        steps = loop.STEPS["taken"]
        expected = _expected_run_launches(psi, cfg, steps)
        held = _hold_first_inputs(torch, psi, seen)
        unsharded = runs["c4_dp_mocap"]
        run_row = dict(phase="mesh_run", config=cfg.name, mesh="1,1",
                       steps=RUN_STEPS, steps_taken=steps,
                       ms_per_step=result["ms_per_step"],
                       seconds=result["seconds"], elbo=result["elbo"],
                       elbo_unsharded_run=unsharded["elbo"],
                       ms_per_step_unsharded_run=unsharded["ms_per_step"],
                       nonfinite=config.evaluate_checks("", result),
                       launches=launches, expected_launches=expected,
                       held_on_the_runs_inputs=held)
        emit(run_row)
    finally:
        mesh_lib.close_distributed()
    if run_row["nonfinite"]:
        raise AssertionError(f"mesh: the --mesh 1,1 run gave a broken "
                             f"result: {run_row}")
    if launches != expected:
        raise AssertionError(f"mesh: the --mesh 1,1 run launched {launches},"
                             f" expected {expected}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"mesh: the --mesh 1,1 run: {h['kernel']} "
                                 f"disagrees with its plain version: {h}")
    emit(dict(phase="mesh_ms", card=card,
              ms_per_step={name: {"sharded": r["ms_per_step_median"],
                                  "unsharded": r["ms_per_step_unsharded_median"]}
                           for name, r in rows.items()},
              runner_c4_ms_per_step={
                  "sharded": run_row["ms_per_step"],
                  "unsharded": run_row["ms_per_step_unsharded_run"]}))
    return rows, run_row


FILES_DIR = ROOT / "build" / "smoke_files"   # the files phase's datasets
FILES_CONFIGS = ("c2_sparse_oil", "c4_dp_mocap")
# the AMC file's bones: 59 varying channels and, last, one constant one
AMC_BONES = [(f"bone{i}", 3) for i in range(19)] + [("lhand", 2),
                                                    ("rhand", 1)]
TOL_FILE_Y = 1e-6    # f32 rounding of standardized data, |Y| up to ~4


def _write_files(torch, seed):
    """The files phase's two datasets in the formats the loaders read: an
    oil-flow DataTrn.txt / DataTrnLbls.txt (1000 x 12, the port's
    oil_flow_like of the seed) and a 1024-frame AMC file of mocap_like's
    59 channels plus a constant one. Returns the written arrays."""
    import numpy as np

    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.data import mocap, synthetic

    FILES_DIR.mkdir(parents=True, exist_ok=True)
    key = prng.PRNGKey(seed)
    oil, labels, _ = synthetic.oil_flow_like(key, n=1000, d=12,
                                             device="cpu")
    oil = oil.numpy()
    np.savetxt(FILES_DIR / "DataTrn.txt", oil, fmt="%.17g")
    np.savetxt(FILES_DIR / "DataTrnLbls.txt",
               np.eye(3)[labels.numpy()], fmt="%d")
    Y, _ = synthetic.mocap_like(key, n=1024, d=59, device="cpu")
    frames = np.c_[Y.numpy(), np.full(1024, 12.5)]
    amc = mocap.write_amc(str(FILES_DIR / "walk.amc"), frames, AMC_BONES)
    return oil, labels.numpy(), frames, amc


def phase_files(torch, seed):
    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.data import mocap, native_io
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop

    oil, labels, frames, amc = _write_files(torch, seed)
    if not native_io.available():
        raise AssertionError("files: the native AMC parser did not build")
    t0 = time.perf_counter()
    native = native_io.parse_amc_native(amc)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python, _ = mocap.parse_amc(amc)
    t_python = time.perf_counter() - t0
    parsers = dict(native_equals_python_bitwise=bool(
        np.array_equal(native, python)), equals_written=bool(
        np.array_equal(native, frames)), shape=list(native.shape),
        native_ms=1e3 * t_native, python_ms=1e3 * t_python)
    emit(dict(phase="files", parsers=parsers, dir=str(FILES_DIR)))
    if not (parsers["native_equals_python_bitwise"]
            and parsers["equals_written"]):
        raise AssertionError(f"files: the AMC parsers disagree: {parsers}")

    # the written data as the loaders standardize them (the mocap
    # preprocessing drops the constant channel; oil flow has none)
    written = {"c2_sparse_oil": (mocap.preprocess(oil), "file:oil_flow"),
               "c4_dp_mocap": (mocap.preprocess(frames), "amc:walk.amc")}
    rows = {}
    for name in FILES_CONFIGS:
        cfg = dataclasses.replace(config.get(name), seed=seed)
        want, tag = written[name]
        Y, got_tag = runner.load_data(cfg, torch.float32, "cuda",
                                      str(FILES_DIR))
        y_err = float(np.abs(Y.cpu().double().numpy() - want).max())
        psi.reset_launch_counts()
        loop.reset_step_count()
        with _first_inputs(torch, psi) as seen:
            result = runner.run(cfg, steps=RUN_STEPS, device="cuda",
                                out=str(RUN_OUT / f"files_{name}"),
                                data_dir=str(FILES_DIR))
        launches = dict(psi.LAUNCHES)
        steps = loop.STEPS["taken"]
        expected = _expected_run_launches(psi, cfg, steps)
        held = _hold_first_inputs(torch, psi, seen)
        row = dict(phase="files", config=name, data=result["data"],
                   shape=list(Y.shape), loaded_vs_written_max_abs=y_err,
                   tol=TOL_FILE_Y, steps=RUN_STEPS, steps_taken=steps,
                   ms_per_step=result["ms_per_step"],
                   seconds=result["seconds"], elbo=result["elbo"],
                   nonfinite=config.evaluate_checks("", result),
                   launches=launches, expected_launches=expected,
                   held_on_the_runs_inputs=held)
        emit(row)
        if result["data"] != tag or got_tag != tag:
            raise AssertionError(f"files: {name} read {result['data']}, "
                                 f"expected {tag}")
        if Y.shape != want.shape or not y_err <= TOL_FILE_Y:
            raise AssertionError(f"files: {name} loaded {tuple(Y.shape)}, "
                                 f"{y_err} off the written data")
        if row["nonfinite"]:
            raise AssertionError(f"files: {name} gave a broken result")
        if launches != expected:
            raise AssertionError(f"files: {name} launched {launches}, "
                                 f"expected {expected}")
        if {h["kernel"] for h in held} != {k for k, n in launches.items()
                                          if n}:
            raise AssertionError(f"files: {name} held {held} against the "
                                 f"kernels it launched, {launches}")
        for h in held:
            if not (h["scaled_err"] <= h["tol"]
                    and h["repeat_bitwise_equal"]):
                raise AssertionError(f"files: {name}: {h['kernel']} "
                                     f"disagrees with its plain version on "
                                     f"the run's inputs: {h}")
        rows[name] = row
    return rows


LBFGS_STEPS = 20


def phase_lbfgs(torch, seed):
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data.synthetic import oil_flow_like
    from dp_gp_lvm_tpu_torch.models import bgplvm
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train.loop import fit_lbfgs

    c2 = CONFIGS["c2_sparse_oil"]
    key = prng.PRNGKey(seed)
    Y, _, _ = oil_flow_like(key, n=c2.n, d=c2.d, dtype=torch.float32)
    cfg = bgplvm.Config(num_latent=c2.q, num_inducing=c2.m)
    params = bgplvm.init_params(key, Y, cfg)
    # both widths at the f32 jitter; f64 through the plain path
    jitter = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    runs = {}
    for width, cfg_w, dtype in (("f32", cfg, torch.float32),
                                ("f64", cfg._replace(use_fused=False),
                                 torch.float64)):
        p0 = {k: v.detach().to(dtype) for k, v in params.items()}
        info = {}
        psi.reset_launch_counts()
        with _first_inputs(torch, psi) as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, losses = fit_lbfgs(
                lambda p, y: -bgplvm.elbo(p, y, cfg_w, jitter), p0,
                (Y.to(dtype),), LBFGS_STEPS, info=info)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        runs[width] = dict(losses=losses.tolist(), seconds=seconds,
                           evaluations=info["evaluations"],
                           evaluations_per_step=info["linesearch_steps"],
                           launches=dict(psi.LAUNCHES),
                           held=_hold_first_inputs(torch, psi, seen))
    f32, f64 = runs["f32"], runs["f64"]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(psi1=f32["evaluations"], psi2_single=f32["evaluations"],
                    psi2_bwd_batched=f32["evaluations"])
    gap = [abs(a - b) / abs(b) for a, b in zip(f32["losses"],
                                                f64["losses"])]
    row = dict(phase="lbfgs", config="c2_sparse_oil", shape=C2,
               steps=LBFGS_STEPS, f32=f32, f64=f64,
               f32_vs_f64_loss_rel_gap=gap, expected_launches=expected)
    emit(row)
    for width, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"lbfgs: non-finite {width} loss")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"lbfgs: the {width} loss did not fall: "
                                 f"{r['losses']}")
    if f32["launches"] != expected:
        raise AssertionError(f"lbfgs: f32 launched {f32['launches']}, "
                             f"expected {expected}: K6, K5 and K2 once an "
                             f"evaluation")
    if any(f64["launches"].values()):
        raise AssertionError(f"lbfgs: the plain f64 path launched "
                             f"{f64['launches']}")
    for h in f32["held"]:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"lbfgs: {h['kernel']} disagrees with its "
                                 f"plain version on the run's inputs: {h}")
    return row


def phase_mfu(torch, train):
    """The c4 step's model-flops utilization and roofline share at the
    train phase's ms a step (eager) and at the steps phase's replayed ms
    a step (`replayed`); printed, not held."""
    from dp_gp_lvm_tpu_torch.perf import H100_PEAKS, dp_step_costs, mfu

    costs = dp_step_costs(n=C4["N"], d=C4["D"], q=C4["Q"], m=C4["M"],
                          t=C4["T"])
    ms = train["ms_per_step_median"]
    replayed = STEP_TIMES.get("c4", {}).get("ms_replayed")
    row = dict(phase="mfu", config="c4_dp_mocap", shape=C4, ms_per_step=ms,
               costs=costs._asdict(), peaks=H100_PEAKS,
               **mfu(ms / 1e3, costs),
               replayed=None if replayed is None else dict(
                   ms_per_step=replayed, **mfu(replayed / 1e3, costs)))
    emit(row)
    if not all(math.isfinite(v) for v in row.values()
               if isinstance(v, float)):
        raise AssertionError(f"mfu: non-finite reading {row}")
    return row


C6_STEPS = 200       # two chunks of the runner's 100 at this step count
C6_CKPT_EVERY = 100
C6_IMPUTE_STEPS = 50


def phase_svi(torch, seed):
    import shutil

    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz

    graphs0 = dict(loop.GRAPHS)
    cfg = dataclasses.replace(config.get("c6_svi_bigN"), seed=seed)
    out = ROOT / "build" / "smoke_svi"
    shutil.rmtree(out, ignore_errors=True)
    kw = dict(steps=C6_STEPS, device="cuda", ckpt_every=C6_CKPT_EVERY,
              impute_steps=C6_IMPUTE_STEPS)
    psi.reset_launch_counts()
    loop.reset_step_count()
    # K2's cotangent is exactly zero at the first step (q(u) starts at the
    # prior, where the bound does not depend on Psi2), so K2 is held on
    # the first call with a nonzero one: the second step's (one host read)
    with _first_inputs(torch, psi, lambda name, args: (
            name != "psi2_bwd_batched" or bool(args[5].any()))) as seen:
        straight = runner.run(cfg, out=str(out / "straight"), **kw)
    launches = dict(psi.LAUNCHES)
    steps = loop.STEPS["taken"]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=2 * steps, psi2_bwd_batched=steps)
    held = _hold_first_inputs(torch, psi, seen)

    # resume from the uninterrupted run's step-100 checkpoint
    resumed_dir = out / "resumed"
    (resumed_dir / "ckpt").mkdir(parents=True)
    shutil.copy(out / "straight" / "ckpt" / f"ckpt_{C6_CKPT_EVERY}.pt",
                resumed_dir / "ckpt")
    loop.reset_step_count()
    resumed = runner.run(cfg, out=str(resumed_dir), resume=True, **kw)
    resumed_steps = loop.STEPS["taken"]
    a, b = (load_npz(str(d / "params.npz"))
            for d in (out / "straight", resumed_dir))
    bitwise = sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)

    # K1 and K2 on the run's first minibatch: device time and bound
    timing = _timed_on_inputs(torch, psi, seen)
    # the host's draw of one chunk of minibatch indices
    _, r1 = prng.split(prng.PRNGKey(cfg.seed + 100))
    t0 = time.perf_counter()
    prng.randint(prng.fold_in(r1, torch.arange(C6_CKPT_EVERY)),
                 (runner.SVI_BATCH,), 0, _train_rows(cfg))
    draw_ms = 1e3 * (time.perf_counter() - t0) / C6_CKPT_EVERY
    syncs, sync_sites = _host_syncs_per_step(torch, cfg)

    finiteness = config.evaluate_checks("", straight)
    failures = config.evaluate_checks(cfg.name, straight)
    row = dict(phase="svi", **_graphs_since(loop, graphs0),
               **_step_fields("c6"), config=cfg.name, n=cfg.n, batch=straight["batch"],
               steps=C6_STEPS, steps_taken=steps,
               ms_per_step=straight["ms_per_step"],
               rows_per_sec=straight["rows_per_sec"],
               seconds=straight["seconds"], elbo_f64=straight["elbo"],
               noise=straight["noise"],
               **{k: straight[k] for k in (
                   "imputation_mse", "predictive_loglik_per_dim",
                   "calibration_ratio", "imputation_seconds",
                   "imputation_rows")},
               index_draw_ms_per_step=draw_ms,
               host_syncs_per_step=syncs, host_sync_sites=sync_sites,
               launches=launches, expected_launches=expected,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               held_on_the_runs_inputs=held, kernels_at_c6=timing,
               resumed_from=C6_CKPT_EVERY, resumed_steps=resumed_steps,
               resumed_elbo_f64=resumed["elbo"],
               resume_bitwise_equal=bitwise and (
                   resumed["elbo"] == straight["elbo"]),
               nonfinite=finiteness,
               missing=[f for f in failures if "MISSING" in f],
               gates_not_held_at_these_steps=[
                   f for f in failures if f not in finiteness])
    emit(row)
    _held_replayed(row)
    if row["nonfinite"] or row["missing"]:
        raise AssertionError(f"svi: broken result: {row}")
    if launches != expected or steps != C6_STEPS:
        raise AssertionError(f"svi: launched {launches} in {steps} steps, "
                             f"expected {expected}")
    if {h["kernel"] for h in held} != {"suffstats_batched",
                                       "psi2_bwd_batched"}:
        raise AssertionError(f"svi: held {held}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"svi: {h['kernel']} disagrees with its "
                                 f"plain version on the run's inputs: {h}")
    if resumed_steps != C6_STEPS - C6_CKPT_EVERY or not row[
            "resume_bitwise_equal"]:
        raise AssertionError("svi: the resumed run did not end on the "
                             "uninterrupted run's bits")
    return row


def _train_rows(cfg):
    """Rows of c6's training split: the strided holdout keeps 7 of 8."""
    return cfg.n - len(range(7, cfg.n, 8))


def _c6_step(torch, cfg, streaming, n=4096, batch=1024):
    """(Y, natural-gradient step, parameters) at the widths of `cfg` (c6,
    or c8 with its encoder) on an n-row draw, fresh parameters, the step
    and optimizer the runner builds for it (c8: Z at the hyper rate, the
    q(u) trust region); the step resident or streamed."""
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import svi_gplvm
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    Y, _ = mocap_like(prng.PRNGKey(cfg.seed), n=n, d=cfg.d,
                      dtype=torch.float32)
    mcfg = runner._model_config(cfg, batch)
    params = svi_gplvm.init_params(prng.PRNGKey(cfg.seed), Y, mcfg)
    opt = gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                       decay_steps=cfg.steps,
                       slow=frozenset({"z"}) if cfg.amortized
                       else frozenset())
    return Y, runner._svi_step(cfg, mcfg, n, opt, streaming), params


def _c6_indices(torch, n, count, batch=1024):
    from dp_gp_lvm_tpu_torch.core import prng

    return prng.randint(prng.fold_in(prng.PRNGKey(1), torch.arange(count)),
                        (batch,), 0, n).long().cuda()


STEP_CASES = ("c4", "c6", "c6_stream", "c7", "c8", "c9", "m256_dp",
              "m256_bgplvm")
STEP_CONFIGS = dict(c4="c4_dp_mocap", c6="c6_svi_bigN",
                    c6_stream="c6_svi_bigN", c7="c7_dp_svi",
                    c8="c8_amortized_svi", c9="c9_mrd_svi_bigN")
STEP_ROWS = 4096     # the draw the minibatch steps are timed on
STEP_WARM = 3        # eager warm-up steps
STEP_SYNC = 5        # eager steps whose host syncs are read
STEP_EAGER = 20      # eager steps timed
STEP_CHUNK = 100     # replayed steps timed, after a chunk that captures
STEP_CHUNKS = dict(m256_dp=20, m256_bgplvm=20)   # cases with fewer
STEP_TIMES = {}      # phase_steps' rows by case, which later phases print


def _step_case(torch, name, seed, n=STEP_ROWS):
    """(step(t) -> loss, chunk(t0, steps) -> losses or None, rows a step)
    of the step the runner takes for `name` at the config's widths (c7:
    stage 2c at T = 8; c9: phase B; c4: the full-batch DP-GP-LVM on its
    1024 rows; m256_dp and m256_bgplvm: the m256 phase's full-batch
    models, `_m256_step_case`), on an n-row draw with random minibatches.
    `step` is one eager step (t a host int); `chunk` runs that many steps
    as the runner does, replayed from a CUDA graph (None where the
    imported package has no graphs: an older checkout). Only parts of the
    package that older checkouts have too are used, so `--time-steps`
    runs this on a parent's package."""
    from dp_gp_lvm_tpu_torch.core import config as config_lib
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm, dp_svi, mrd_svi
    from dp_gp_lvm_tpu_torch.models import svi_gplvm
    from dp_gp_lvm_tpu_torch.train import loop, mrd_recipe

    if name.startswith("m256"):
        return _m256_step_case(torch, name, seed)
    cfg = dataclasses.replace(config_lib.get(STEP_CONFIGS[name]), seed=seed)
    key = prng.PRNGKey(cfg.seed)
    f32 = dict(dtype=torch.float32, device="cuda")
    mcfg = runner._model_config(cfg, None)
    graphs = hasattr(loop, "MinibatchChunks")
    if name == "c4":
        Y, _ = synthetic.mocap_like(key, n=cfg.n, d=cfg.d, **f32)
        params = dp_gp_lvm.init_params(key, Y, mcfg)
        opt = loop.gp_optimizer(params, lr=cfg.lr, ard_lr=cfg.ard_lr,
                                decay_steps=cfg.steps, ngd_lr=cfg.ngd_lr)
        return _full_batch_case(
            loop, lambda y: dp_gp_lvm.loss(params, y, mcfg), opt, Y,
            STEP_CHUNK)
    if name == "c7":
        Y, _, _ = synthetic.grouped_dims_big(
            key, n=n, dims_per_group=runner.grouped_dims_per_group(cfg.d),
            q=cfg.q, **f32)
        params = dp_svi.init_params(key, Y, mcfg)
        opt = loop.gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                                decay_steps=cfg.steps)
        step = dp_svi.make_dp_svi_step(mcfg, n, opt, rho=0.3,
                                       phi_update="frozen")
    elif name == "c9":
        Y = synthetic.two_view_big(key, n=n, d1=cfg.views[0],
                                   d2=cfg.views[1], **f32)[:2]
        params = mrd_recipe._as_parameters(mrd_recipe.recalibrated(
            mrd_svi.init_params(key, Y, mcfg), 0.4, 0.25))
        opt = loop.gp_optimizer(params, lr=cfg.lr, decay_steps=cfg.steps,
                                freeze=mrd_recipe.FROZEN_STRUCTURE)
        step = runner._svi_step(cfg, mcfg, n, opt, False)
    else:
        Y, _ = synthetic.mocap_like(key, n=n, d=cfg.d, **f32)
        params = svi_gplvm.init_params(key, Y, mcfg)
        opt = loop.gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                                decay_steps=cfg.steps,
                                slow=frozenset({"z"}) if cfg.amortized
                                else frozenset())
        step = runner._svi_step(cfg, mcfg, n, opt, name == "c6_stream")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total = STEP_WARM + STEP_SYNC + STEP_EAGER + 2 * STEP_CHUNK
    idx = torch.randint(0, n, (total, mcfg.batch), generator=gen,
                        device="cuda")
    streamed = name == "c6_stream"
    rows = Y[idx] if streamed else None

    def eager(t):
        if streamed:
            return step(t, (idx[t], rows[t]))
        return step(t, idx[t], Y)

    if not graphs:
        return eager, None, mcfg.batch
    chunks = loop.MinibatchChunks(step, None if streamed else Y,
                                  streaming=streamed)

    def chunk(t0, k):
        return chunks(t0, idx[t0:t0 + k], rows[t0:t0 + k] if streamed
                      else None)

    return eager, chunk, mcfg.batch


def _full_batch_case(loop, loss, opt, Y, chunk):
    """`_step_case`'s triple for a full-batch step of `loss(Y)`: one eager
    step, and `chunk` steps through `make_multi_step_fn` replayed from a
    CUDA graph (None where the package has no graphs)."""
    import inspect

    def multi(steps, eager):
        kw = ({"eager": eager} if "eager" in inspect.signature(
            loop.make_multi_step_fn).parameters else {})
        fn = loop.make_multi_step_fn(lambda _, y: loss(y), opt, steps, **kw)
        return lambda: fn(Y)

    one = multi(1, True)
    replay = multi(chunk, False) if hasattr(loop, "StepGraph") else None
    return ((lambda t: one()),
            None if replay is None else (lambda t0, k: replay()),
            Y.shape[0])


def _m256_step_case(torch, name, seed):
    """`_step_case` for the m256 phase's models at M = 256 (the tiled
    kernels): the DP-GP-LVM on mocap_like at M256, the Bayesian GP-LVM on
    oil_flow_like at M256_BG, from the seed's init, at c4's and c2's
    rates; full batch, as `_step_case`'s c4."""
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like, oil_flow_like
    from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm
    from dp_gp_lvm_tpu_torch.train import loop

    key = prng.PRNGKey(seed)
    if name == "m256_dp":
        rates = CONFIGS["c4_dp_mocap"]
        Y, _ = mocap_like(key, n=M256["N"], d=M256["D"], dtype=torch.float32)
        cfg = dp_gp_lvm.Config(num_latent=M256["Q"],
                               num_inducing=M256["M"],
                               truncation=M256["T"], alpha=rates.alpha)
        model = dp_gp_lvm
    else:
        rates = CONFIGS["c2_sparse_oil"]
        Y, _, _ = oil_flow_like(key, n=M256_BG["N"], d=M256_BG["D"],
                                dtype=torch.float32)
        cfg = bgplvm.Config(num_latent=M256_BG["Q"],
                            num_inducing=M256_BG["M"])
        model = bgplvm
    params = model.init_params(key, Y, cfg)
    opt = loop.gp_optimizer(params, lr=rates.lr, ngd_lr=rates.ngd_lr)
    return _full_batch_case(loop, lambda y: model.loss(params, y, cfg), opt,
                            Y, STEP_CHUNKS[name])


def _steps_of_package(torch, seed):
    """phase_steps' numbers for the package on sys.path: for each case the
    host syncs of an eager step (sync debug mode), the ms of an eager
    step and, where the package has them, of a replayed step (after a
    chunk that captures), and rows/s of each."""
    rows = {}
    for name in STEP_CASES:
        eager, chunk, batch = _step_case(torch, name, seed)
        t = 0
        for t in range(STEP_WARM):
            eager(t)
        syncs, sites = _syncs_per_step(torch, lambda t: eager(t), [
            (t,) for t in range(STEP_WARM, STEP_WARM + STEP_SYNC)])
        t = STEP_WARM + STEP_SYNC
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEP_EAGER):
            eager(t + i)
        torch.cuda.synchronize()
        ms_eager = 1e3 * (time.perf_counter() - t0) / STEP_EAGER
        row = dict(rows_a_step=batch, host_syncs_per_step=syncs,
                   host_sync_sites=sites, ms_eager=ms_eager,
                   rows_per_sec_eager=batch / ms_eager * 1e3)
        if chunk is not None:
            from dp_gp_lvm_tpu_torch.train import loop

            t += STEP_EAGER
            k = STEP_CHUNKS.get(name, STEP_CHUNK)
            chunk(t, k).cpu()                   # captures
            before = dict(loop.GRAPHS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = chunk(t + k, k).cpu()
            ms = 1e3 * (time.perf_counter() - t0) / k
            row.update(ms_replayed=ms, rows_per_sec_replayed=batch / ms * 1e3,
                       graph_replays=loop.GRAPHS["replays"]
                       - before["replays"],
                       graph_captures=loop.GRAPHS["captures"]
                       - before["captures"],
                       replayed_losses_finite=bool(
                           torch.isfinite(losses).all()))
        rows[name] = row
    return rows


def _ladder_cost(torch):
    """Device ms (`_device_ms`) of the safe Cholesky with the jitter
    ladder on the device against one `cholesky_ex`, f32: on K_uu stacks
    at c6's M = 64 (T = 1) and c7's (T = 8) per member
    (`safe_cholesky_members`), and at the m256 DP-GP-LVM's M = 256,
    T = 20 with one jitter for the stack (`safe_cholesky_spec`, which
    its collapsed bound calls twice a step)."""
    from dp_gp_lvm_tpu_torch.linalg import chol

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for T, M, fn in ((1, 64, chol.safe_cholesky_members),
                     (8, 64, chol.safe_cholesky_members),
                     (20, 256, chol.safe_cholesky_spec)):
        x = torch.randn(T, M, M + 16, generator=gen, device="cuda")
        kuu = x @ x.mT / (M + 16.0)
        rows[f"T{T}" if M == 64 else f"T{T}_M{M}"] = dict(
            ladder_ms=_device_ms(lambda: fn(kuu), torch),
            one_factorization_ms=_device_ms(
                lambda: torch.linalg.cholesky_ex(kuu), torch))
    return rows


def _time_steps_child(torch, parent, seed) -> int:
    """`--time-steps`: `_steps_of_package` on the package in `parent`,
    printed as the last line."""
    sys.path.insert(0, str(parent.resolve()))
    from dp_gp_lvm_tpu_torch.core.types import pin_full_f32

    pin_full_f32()
    emit(_steps_of_package(torch, seed))
    return 0


def phase_steps(torch, seed, parent, card):
    """ms a step and rows/s of every chunked loop's step (c4 full batch,
    c6 resident and streamed, c7 stage 2c, c8, c9 phase B, and the m256
    phase's DP-GP-LVM and Bayesian GP-LVM full batch at M = 256), eager
    and replayed from a CUDA graph, with the host syncs of an eager step;
    with `--parent DIR` the same eager numbers of DIR's package, measured
    first in a child process of this script in the same call. Held: no
    host sync in a step, one capture and STEP_CHUNK (STEP_CHUNKS) replays
    a timed chunk, finite losses. `cholesky_ladder_device_ms` is the
    safe Cholesky's cost (`_ladder_cost`)."""
    parent_rows = {}
    if parent is not None:
        out = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--parent",
             str(parent), "--time-steps", "--seed", str(seed)],
            capture_output=True, text=True, check=True, timeout=900).stdout
        parent_rows = json.loads(out.splitlines()[-1])
    mine = _steps_of_package(torch, seed)
    for name, row in mine.items():
        theirs = parent_rows.get(name, {})
        row.update(parent_ms_eager=theirs.get("ms_eager"),
                   parent_rows_per_sec=theirs.get("rows_per_sec_eager"),
                   parent_host_syncs_per_step=theirs.get(
                       "host_syncs_per_step"),
                   parent_host_sync_sites=theirs.get("host_sync_sites"))
        STEP_TIMES[name] = row
    emit(dict(phase="steps", card=card, rows=STEP_ROWS,
              chunk=STEP_CHUNK, chunks=STEP_CHUNKS, cases=mine,
              cholesky_ladder_device_ms=_ladder_cost(torch)))
    for name, row in mine.items():
        if row["host_syncs_per_step"] != 0:
            raise AssertionError(f"steps: {name} syncs with the host: "
                                 f"{row['host_sync_sites']}")
        k = STEP_CHUNKS.get(name, STEP_CHUNK)
        if (row["graph_captures"], row["graph_replays"]) != (0, k) \
                or not row["replayed_losses_finite"]:
            raise AssertionError(f"steps: {name}'s chunk did not replay "
                                 f"{k} finite steps: {row}")
    return mine


def _graphs_since(loop, before):
    """Graphs captured and steps replayed since `before` (a copy of
    `train.loop.GRAPHS`), and the kernel launches since the last reset as
    the host counts them (`launches_counted`: each eager launch, and the
    capture's launches once per replay, which `StepGraph` adds) and as
    the card counted them (`launches_on_card`: `ops.psi.count_on_card`'s
    counters, which each replay bumps itself; the smoke starts both at 0
    and `_uncounted` keeps its timings' launches in step)."""
    from dp_gp_lvm_tpu_torch.ops import psi

    return dict(graph_captures=loop.GRAPHS["captures"] - before["captures"],
                graph_replays=loop.GRAPHS["replays"] - before["replays"],
                launches_counted=dict(psi.LAUNCHES),
                launches_on_card=psi.card_counts(),
                launch_count_checks=COUNT_CHECKS["checks"])


# the smoke's comparisons of the host's launch counts with the card's
# (`_checked_resets`), and those that disagreed
COUNT_CHECKS = {"checks": 0, "mismatches": []}


def _checked_resets(psi):
    """From here each `psi.reset_launch_counts()` first holds the host's
    counts against the card's, so every launch between two resets is
    compared, whatever a phase reads before its next reset."""
    reset = psi.reset_launch_counts

    def checked():
        host, card = dict(psi.LAUNCHES), psi.card_counts()
        COUNT_CHECKS["checks"] += 1
        if host != card:
            COUNT_CHECKS["mismatches"].append(dict(host=host, card=card))
        reset()

    psi.reset_launch_counts = checked


def _held_replayed(row):
    """A phase whose runner ran chunks on the card must have replayed
    them from a CUDA graph, the launches the card counted must be those
    the host counts (so every replay launched what its capture did), and
    its eager step must not sync."""
    if row["graph_replays"] <= 0:
        raise AssertionError(f"{row['phase']}: no step was replayed from a "
                             f"CUDA graph: {row}")
    if row["launches_on_card"] != row["launches_counted"] or \
            COUNT_CHECKS["mismatches"]:
        raise AssertionError(f"{row['phase']}: the card counted "
                             f"{row['launches_on_card']} launches, the host "
                             f"{row['launches_counted']}; earlier: "
                             f"{COUNT_CHECKS['mismatches']}")
    if row.get("host_syncs_per_step", 0) != 0:
        raise AssertionError(f"{row['phase']}: the step syncs with the "
                             f"host: {row.get('host_sync_sites')}")


@contextlib.contextmanager
def _uncounted():
    """No launch counted on the card inside the block (the timings: a
    counter's add would be timed with the kernel); at its end the card's
    counters take the launches the host counted in it, so that host and
    card disagree only where the host infers (`StepGraph`'s replays). A
    package without card counters (an older checkout) is left alone."""
    from dp_gp_lvm_tpu_torch.ops import psi

    counters = getattr(psi, "CARD_COUNTS", None)
    if counters is None:
        yield
        return
    saved, before = dict(counters), dict(psi.LAUNCHES)
    counters.clear()
    try:
        yield
    finally:
        counters.clear()
        counters.update(saved)
        for k, counter in saved.items():
            if psi.LAUNCHES[k] != before[k]:
                counter.add_(psi.LAUNCHES[k] - before[k])


def _step_fields(name):
    """phase_steps' numbers of one case, for a phase's row."""
    return {"step_" + k: v for k, v in STEP_TIMES.get(name, {}).items()
            if k != "host_sync_sites"}


def _syncs_per_step(torch, step, args):
    """Host syncs a step as PyTorch's sync debug mode reports them (the
    synchronizing calls PyTorch makes; a library's own synchronization
    inside a call is not seen) over the calls `step(*a)` for a in `args`,
    with the source lines that made them. The mode's one-time notice that
    it is a prototype is not a sync and is not counted."""
    import os
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for a in args:
                step(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    n = len(args)
    return len(sites) / n, {s: sites.count(s) / n for s in sorted(set(sites))}


def _host_syncs_per_step(torch, cfg, steps=5, streaming=False):
    """Host syncs of a c6 natural-gradient step (`_syncs_per_step`) over
    `steps` steps after two warm-up steps, at c6's widths on a 4096-row
    draw, resident or streamed (the rows gathered before the window)."""
    Y, step, _ = _c6_step(torch, cfg, streaming)
    idx = _c6_indices(torch, Y.shape[0], 2 + steps)
    if streaming:
        rows = [Y[i] for i in idx]
        args = [(t, (idx[t], rows[t])) for t in range(2 + steps)]
    else:
        args = [(t, idx[t], Y) for t in range(2 + steps)]
    for a in args[:2]:
        step(*a)
    return _syncs_per_step(torch, step, args[2:])


def _streamed_equals_resident(torch, cfg, steps=3):
    """Three steps from the same parameters on the same indices, the rows
    gathered on the card (resident) or copied from pinned host memory
    (streamed): whether every loss and parameter is the same to the bit."""
    Y, res, p_res = _c6_step(torch, cfg, streaming=False)
    _, st, p_str = _c6_step(torch, cfg, streaming=True)
    idx = _c6_indices(torch, Y.shape[0], steps)
    same = True
    for t in range(steps):
        rows = Y[idx[t]].cpu().pin_memory().cuda(non_blocking=True)
        same &= bool(torch.equal(res(t, idx[t], Y), st(t, (idx[t], rows))))
    return same and all(bool(torch.equal(p_res[k], p_str[k]))
                        for k in p_res)


def phase_stream(torch, seed, svi):
    """c6_svi_bigN through the runner with the host-streamed feed, as the
    svi phase runs it resident."""
    import shutil

    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.data import stream
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz

    if not stream.native_available():
        raise AssertionError("stream: the native loader did not build from "
                             f"{stream.SOURCE}")
    graphs0 = dict(loop.GRAPHS)
    cfg = dataclasses.replace(config.get("c6_svi_bigN"), seed=seed)
    out = ROOT / "build" / "smoke_stream"
    shutil.rmtree(out, ignore_errors=True)
    kw = dict(steps=C6_STEPS, device="cuda", ckpt_every=C6_CKPT_EVERY,
              impute_steps=C6_IMPUTE_STEPS, stream=True)
    psi.reset_launch_counts()
    loop.reset_step_count()
    with _first_inputs(torch, psi, lambda name, args: (
            name != "psi2_bwd_batched" or bool(args[5].any()))) as seen:
        straight = runner.run(cfg, out=str(out / "straight"), **kw)
    launches = dict(psi.LAUNCHES)
    steps = loop.STEPS["taken"]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=2 * steps, psi2_bwd_batched=steps)
    held = _hold_first_inputs(torch, psi, seen)

    resumed_dir = out / "resumed"
    (resumed_dir / "ckpt").mkdir(parents=True)
    shutil.copy(out / "straight" / "ckpt" / f"ckpt_{C6_CKPT_EVERY}.pt",
                resumed_dir / "ckpt")
    loop.reset_step_count()
    resumed = runner.run(cfg, out=str(resumed_dir), resume=True, **kw)
    resumed_steps = loop.STEPS["taken"]
    a, b = (load_npz(str(d / "params.npz"))
            for d in (out / "straight", resumed_dir))
    bitwise = sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)

    # the copy of one chunk's rows and indices from pinned memory
    chunk = runner._svi_chunk(torch.device("cuda"), 50, C6_STEPS, None)
    rows = torch.empty(chunk, runner.SVI_BATCH, cfg.d, pin_memory=True)
    idx = torch.empty(chunk, runner.SVI_BATCH, dtype=torch.int32,
                      pin_memory=True)
    h2d_ms = _timed(lambda: (rows.cuda(non_blocking=True),
                             idx.cuda(non_blocking=True)), torch, reps=10)
    syncs, sync_sites = _host_syncs_per_step(torch, cfg, streaming=True)
    chunk_ms = straight["ms_per_step"] * chunk
    finiteness = config.evaluate_checks("", straight)
    failures = config.evaluate_checks(cfg.name, straight)
    row = dict(phase="stream", **_graphs_since(loop, graphs0),
               **_step_fields("c6_stream"), config=cfg.name, n=cfg.n,
               batch=straight["batch"], chunk=chunk, steps=C6_STEPS,
               steps_taken=steps, native_loader=straight["native_loader"],
               loader_source=str(stream.SOURCE.relative_to(ROOT)),
               loader_library=stream.library_path().name,
               ms_per_step_streamed=straight["ms_per_step"],
               ms_per_step_resident=svi["ms_per_step"],
               rows_per_sec=straight["rows_per_sec"],
               feed_wait_ms_per_chunk=straight["feed_wait_ms_per_chunk"],
               chunk_ms=chunk_ms,
               feed_wait_share=straight["feed_wait_ms_per_chunk"] / chunk_ms,
               h2d_copy_ms_per_chunk=h2d_ms,
               h2d_bytes_per_chunk=rows.numel() * 4 + idx.numel() * 4,
               host_syncs_per_step=syncs, host_sync_sites=sync_sites,
               seconds=straight["seconds"], elbo_f64=straight["elbo"],
               **{k: straight[k] for k in (
                   "imputation_mse", "predictive_loglik_per_dim",
                   "calibration_ratio")},
               launches=launches, expected_launches=expected,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               held_on_the_runs_inputs=held,
               resumed_from=C6_CKPT_EVERY, resumed_steps=resumed_steps,
               resume_bitwise_equal=bitwise and (
                   resumed["elbo"] == straight["elbo"]),
               streamed_equals_resident_bitwise=_streamed_equals_resident(
                   torch, cfg),
               nonfinite=finiteness,
               missing=[f for f in failures if "MISSING" in f],
               gates_not_held_at_these_steps=[
                   f for f in failures if f not in finiteness])
    emit(row)
    _held_replayed(row)
    if row["nonfinite"] or row["missing"] or not straight["streamed"]:
        raise AssertionError(f"stream: broken result: {row}")
    if not (row["native_loader"] and stream.library_path().exists()
            and stream.SOURCE == ROOT / "dp_gp_lvm_tpu_torch" / "csrc"
            / "stream_loader.cpp"):
        raise AssertionError("stream: the run did not use the native loader "
                             "built from the repository's source")
    if launches != expected or steps != C6_STEPS:
        raise AssertionError(f"stream: launched {launches} in {steps} steps, "
                             f"expected {expected}")
    if {h["kernel"] for h in held} != {"suffstats_batched",
                                       "psi2_bwd_batched"}:
        raise AssertionError(f"stream: held {held}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"stream: {h['kernel']} disagrees with its "
                                 f"plain version on the run's inputs: {h}")
    if resumed_steps != C6_STEPS - C6_CKPT_EVERY or not row[
            "resume_bitwise_equal"]:
        raise AssertionError("stream: the resumed run did not end on the "
                             "uninterrupted run's bits")
    if not row["streamed_equals_resident_bitwise"]:
        raise AssertionError("stream: a streamed step differs from the "
                             "resident step on the same rows")
    return row


C7_STEPS = 250       # chunks of 125: stage 1, the 50-step warmup, 2b, 2c
# c7's f32 mixture predictive against f64 at the same jitter, scaled by
# max|ref|: its trained K_uu have condition numbers near 1e4 (the 1e-4
# jitter's cap), and sigma^2 - tr(K_uu^-1 Psi2_n) + tr(S A2_n) cancels at
# that scale, so f32 keeps ~1e-3 of the variance (an H100: 1.06e-3;
# on the CPU 9.0e-4 in the port's form, 1.3e-3 in the reference's per-row
# solves); the mean keeps ~1e-5
TOL_PRED_C7 = 5e-3
C7_IMPUTE_STEPS = 50
C7_BATCHES = (1, 32, 512)


@contextlib.contextmanager
def _stage_launches(torch, psi, loop, recipe=None, name="staged_dp_svi"):
    """While the block runs, the launches and steps of each stage the
    runner's recipe `recipe.name` drives (default the DP-SVI's: stage 1,
    2b, 2c): a list filled as they end."""
    if recipe is None:
        from dp_gp_lvm_tpu_torch.train import dp_recipe as recipe

    original = getattr(recipe, name)
    stages = []

    def counted(*args, drive, **kw):
        def counting(step_fn, state, n_steps, key, Y, label=""):
            launches, steps = dict(psi.LAUNCHES), loop.STEPS["taken"]
            out = drive(step_fn, state, n_steps, key, Y, label=label)
            taken = loop.STEPS["taken"] - steps
            stages.append(dict(
                stage=label.strip(" []"), steps=taken,
                launches_per_step={k: (psi.LAUNCHES[k] - n) / taken
                                   for k, n in launches.items()
                                   if psi.LAUNCHES[k] > n}))
            return out
        return original(*args, drive=counting, **kw)

    setattr(recipe, name, counted)
    try:
        yield stages
    finally:
        setattr(recipe, name, original)


def _c7_step_syncs(torch, cfg, n=8192, steps=5):
    """Host syncs (`_syncs_per_step`) and ms of a c7 stage-2c step (T = 8,
    phi locked) at c7's widths on an n-row draw, over `steps` steps after
    two warm-up steps."""
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.data.synthetic import grouped_dims_big
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import dp_svi
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    Y, _, _ = grouped_dims_big(
        prng.PRNGKey(cfg.seed), n=n,
        dims_per_group=runner.grouped_dims_per_group(cfg.d), q=cfg.q,
        dtype=torch.float32)
    mcfg = runner._model_config(cfg, None)
    params = dp_svi.init_params(prng.PRNGKey(cfg.seed), Y, mcfg)
    opt = gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                       decay_steps=cfg.steps)
    step = dp_svi.make_dp_svi_step(mcfg, n, opt, rho=0.3,
                                   phi_update="frozen")
    idx = step.indices(prng.fold_in(prng.PRNGKey(1),
                                    torch.arange(2 + steps)))
    for t in range(2):
        step(t, idx[t], Y)
    syncs, sites = _syncs_per_step(torch, step, [
        (t, idx[t], Y) for t in range(2, 2 + steps)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + steps):
        step(t, idx[t], Y)
    torch.cuda.synchronize()
    return syncs, sites, 1e3 * (time.perf_counter() - t0) / steps


def _shape_key(key):
    """"name T=.. N=..": a kernel signature of `_first_inputs`."""
    name, T, N = key[0], key[5][0], key[3][0]
    return f"{name} T={T} N={N}"


def phase_dp_svi(torch, seed):
    """c7_dp_svi through the runner at full width for a short staged
    budget; the imputer built on its parameters."""
    import shutil

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import dp_svi, serving
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz

    graphs0 = dict(loop.GRAPHS)
    cfg = dataclasses.replace(config.get("c7_dp_svi"), seed=seed)
    out = ROOT / "build" / "smoke_dp_svi"
    shutil.rmtree(out, ignore_errors=True)
    psi.reset_launch_counts()
    loop.reset_step_count()
    # K2's cotangent is zero at a step whose q(u | t) is the prior (stage
    # 1's first): K2 is held on its first call with a nonzero one
    with _first_inputs(torch, psi, lambda name, args: (
            name != "psi2_bwd_batched" or bool(args[5].any()))) as seen, \
            _stage_launches(torch, psi, loop) as stages:
        result = runner.run(cfg, steps=C7_STEPS, device="cuda", out=str(out),
                            impute_steps=C7_IMPUTE_STEPS)
    launches = dict(psi.LAUNCHES)
    steps = loop.STEPS["taken"]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    # a K1 and a K2 a step (blend_at="grad": the blend reuses the gradient
    # pass's statistics); K1 once more over every row for the residual
    # ladder (T = 1) and once for the final ELBO (T = 8)
    expected.update(suffstats_batched=steps + 2, psi2_bwd_batched=steps)
    held = _hold_first_inputs(torch, psi, seen)
    timing = {}
    for key, args in seen.items():
        shape, bound, by = _work_of(key[0], args)
        ref = getattr(psi, RUN_KERNELS[key[0]][0])
        timing[_shape_key(key)] = dict(
            shape=shape, bound_ms=bound, bound_by=by,
            device_ms=_device_ms(lambda: getattr(psi, key[0])(*args), torch),
            ms=_timed(lambda: getattr(psi, key[0])(*args), torch),
            plain_ms=_timed(lambda: ref(*args), torch, reps=3, warmup=1))
    syncs, sync_sites, step_ms = _c7_step_syncs(torch, cfg)

    # the server on the run's parameters: requests of each batch, and its
    # f32 predictive against f64 at a fixed q(x*) (the first 64 training
    # latents) at the same jitter
    mcfg = runner._model_config(cfg, None)
    raw = {k: torch.as_tensor(v) for k, v in
           load_npz(str(out / "params.npz")).items()}
    psi.reset_launch_counts()
    t0 = time.perf_counter()
    impute = serving.make_dp_svi_imputer(raw, mcfg)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    build_launches = dict(psi.LAUNCHES)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    requests = []
    for b in C7_BATCHES:
        times = []
        for i in range(3):                      # one warm call, then 2
            y = torch.randn(b, cfg.d, generator=gen, device="cuda")
            mask = torch.zeros(b, cfg.d, device="cuda")
            mask[:, ::2] = 1.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = impute(y, mask)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            if not (mean.shape == var.shape == (b, cfg.d)
                    and bool(torch.isfinite(mean).all())
                    and bool((var > 0).all())):
                raise AssertionError(f"dp_svi: bad answer at batch {b}")
        tol, cap = serving._resolve("auto", 150, b)
        requests.append(dict(batch=b, mode="tol" if tol else "unroll",
                             step_cap=cap,
                             ms_per_request=statistics.median(times)))
    p32 = {k: v.cuda() for k, v in raw.items()}
    p64 = {k: v.double() for k, v in p32.items()}
    c32 = dp_svi.constrain(p32, mcfg)
    same = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    x_m, x_v = c32["qx_mean"][:64], c32["qx_var"][:64]
    m32, v32 = dp_svi.predict_from_latent(p32, x_m, x_v, mcfg)
    m64, v64 = dp_svi.predict_from_latent(p64, x_m.double(), x_v.double(),
                                          mcfg, same)
    pred_err = dict(
        mean=float((m32.double() - m64).abs().max() / m64.abs().max()),
        var=float((v32.double() - v64).abs().max() / v64.abs().max()))

    finiteness = config.evaluate_checks("", result)
    failures = config.evaluate_checks(cfg.name, result)
    row = dict(phase="dp_svi", **_graphs_since(loop, graphs0),
               **_step_fields("c7"), config=cfg.name, n=cfg.n,
               batch=result["batch"], steps=C7_STEPS, steps_taken=steps,
               stage_steps=dict(stage1=result["stage1_steps"],
                                stage2=result["stage2_steps"]),
               stages=stages, seconds=result["seconds"],
               ms_per_step_stage2c=result["ms_per_step"],
               rows_per_sec=result["rows_per_sec"],
               ms_per_step_t8=step_ms, host_syncs_per_step=syncs,
               host_sync_sites=sync_sites,
               **{k: result[k] for k in (
                   "elbo", "noise_min", "group_purity_min", "group_purities",
                   "distinct_atoms_for_groups", "predictive_loglik_per_dim",
                   "calibration_ratio", "imputation_mse",
                   "imputation_mse_baseline", "imputation_seconds")},
               launches=launches, expected_launches=expected,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               held_on_the_runs_inputs=held, kernels_at_c7=timing,
               imputer_build_ms=build_ms,
               imputer_build_launches=build_launches,
               imputer_requests=requests, predictive_f32_vs_f64=pred_err,
               tol_pred=TOL_PRED_C7, nonfinite=finiteness,
               missing=[f for f in failures if "MISSING" in f],
               gates_not_held_at_these_steps=[
                   f for f in failures if f not in finiteness])
    emit(row)
    _held_replayed(row)
    if row["nonfinite"] or row["missing"]:
        raise AssertionError(f"dp_svi: broken result: {row}")
    if launches != expected:
        raise AssertionError(f"dp_svi: launched {launches} in {steps} steps, "
                             f"expected {expected}")
    if [s["stage"] for s in stages] != [
            "stage1 T=1", f"stage2b assign T={cfg.t}",
            f"stage2c joint T={cfg.t}"] or any(
            s["launches_per_step"] != {"suffstats_batched": 1.0,
                                       "psi2_bwd_batched": 1.0}
            for s in stages):
        raise AssertionError(f"dp_svi: per-stage launches {stages}")
    want_keys = {f"suffstats_batched T={t} N={n}"
                 for t, n in ((1, 2048), (cfg.t, 2048), (1, cfg.n),
                              (cfg.t, cfg.n))} | {
        f"psi2_bwd_batched T={t} N=2048" for t in (1, cfg.t)}
    if set(timing) != want_keys:
        raise AssertionError(f"dp_svi: kernels seen {sorted(timing)}, "
                             f"expected {sorted(want_keys)}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"dp_svi: {h['kernel']} disagrees with its "
                                 f"plain version on the run's inputs: {h}")
    if any(build_launches.values()):
        raise AssertionError(f"dp_svi: the imputer's build launched "
                             f"{build_launches}; its psi statistics are plain")
    if not max(pred_err.values()) <= TOL_PRED_C7:
        raise AssertionError(f"dp_svi: f32 predictive off: {pred_err}")
    return row


C8_BATCHES = (1, 32, 256)
# c8's f32 predictive against f64 at the same jitter, scaled by max|ref|,
# at the encoder's q(x*) of held-out rows after the phase's 200 steps (an
# H100: mean 5.1e-7, variance 5.9e-6): the generic serving tolerance
TOL_PRED_C8 = TOL_PRED
C8_REFINE = (0, 150)
C8_REQUESTS = 3      # per batch and refinement: one warm call, then timed
# encode(Y) at init against the PCA latents it reproduces, scaled by
# max|pca|: the readout is fit in f64 to the f32 PCA scores, so f32 keeps
# about their own rounding (a CPU in f32: 2.5e-5 at 4096 rows, 1.0e-4 at
# c8's 114688)
TOL_ENCODE_INIT = 5e-4


def _c8_run(torch, runner, psi, loop, cfg, out, **kw):
    """The runner's c8 run at full width, its launches (held exactly: two
    K1 and one K2 a step) and its kernels on the run's first inputs (K2 on
    the first nonzero cotangent: at the first step q(u) is the prior)."""
    psi.reset_launch_counts()
    loop.reset_step_count()
    with _first_inputs(torch, psi, lambda name, args: (
            name != "psi2_bwd_batched" or bool(args[5].any()))) as seen:
        result = runner.run(cfg, out=str(out), steps=C6_STEPS, device="cuda",
                            impute_steps=C6_IMPUTE_STEPS, **kw)
    launches, steps = dict(psi.LAUNCHES), loop.STEPS["taken"]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=2 * steps, psi2_bwd_batched=steps)
    if launches != expected or steps != C6_STEPS:
        raise AssertionError(f"amortized: launched {launches} in {steps} "
                             f"steps, expected {expected}")
    return result, launches, steps, seen


def _c8_imputer(torch, psi, seed, raw, mcfg, Y_test):
    """make_encoder_imputer on the run's raw parameters: its build, and
    requests of each batch with half the dims masked, one encoder pass or
    refined; launches counted over the build and over the requests."""
    from dp_gp_lvm_tpu_torch.models import serving

    rows = []
    builds = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    for refine in C8_REFINE:
        psi.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        impute = serving.make_encoder_imputer(raw, mcfg, refine_steps=refine)
        torch.cuda.synchronize()
        builds.append(dict(refine_steps=refine,
                           build_ms=1e3 * (time.perf_counter() - t0),
                           build_launches={k: v for k, v in
                                           psi.LAUNCHES.items() if v}))
        for b in C8_BATCHES:
            times = []
            psi.reset_launch_counts()
            for i in range(C8_REQUESTS):
                pick = torch.randint(0, Y_test.shape[0], (b,), generator=gen,
                                     device="cuda")
                y = Y_test[pick]
                mask = torch.ones_like(y)
                mask[:, y.shape[1] // 2:] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean, var = impute(y, mask)
                torch.cuda.synchronize()
                if i:
                    times.append(1e3 * (time.perf_counter() - t0))
                if not (mean.shape == var.shape == y.shape
                        and bool(torch.isfinite(mean).all())
                        and bool((var > 0).all())):
                    raise AssertionError(f"amortized: bad answer at batch "
                                         f"{b}, refine {refine}")
            rows.append(dict(batch=b, refine_steps=refine,
                             ms_per_request=statistics.median(times),
                             launches_per_request=sum(psi.LAUNCHES.values())
                             / C8_REQUESTS))
    return builds, rows


def phase_amortized(torch, seed):
    """c8_amortized_svi through the runner at full width, resident (with
    the resume) and streamed; the one-pass encoder imputer on its
    parameters."""
    import shutil

    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.data import stream
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import amortized, svi_gplvm
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz
    from dp_gp_lvm_tpu_torch.train.init import pca_latents

    if not stream.native_available():
        raise AssertionError("amortized: the native loader did not build "
                             f"from {stream.SOURCE}")
    graphs0 = dict(loop.GRAPHS)
    cfg = dataclasses.replace(config.get("c8_amortized_svi"), seed=seed)
    mcfg = runner._model_config(cfg, None)
    out = ROOT / "build" / "smoke_amortized"
    shutil.rmtree(out, ignore_errors=True)
    straight, launches, steps, seen = _c8_run(
        torch, runner, psi, loop, cfg, out / "straight",
        ckpt_every=C6_CKPT_EVERY)
    held = _hold_first_inputs(torch, psi, seen)
    timing = _timed_on_inputs(torch, psi, seen, plain=True)

    resumed_dir = out / "resumed"
    (resumed_dir / "ckpt").mkdir(parents=True)
    shutil.copy(out / "straight" / "ckpt" / f"ckpt_{C6_CKPT_EVERY}.pt",
                resumed_dir / "ckpt")
    loop.reset_step_count()
    resumed = runner.run(cfg, out=str(resumed_dir), resume=True,
                         steps=C6_STEPS, device="cuda",
                         ckpt_every=C6_CKPT_EVERY,
                         impute_steps=C6_IMPUTE_STEPS)
    resumed_steps = loop.STEPS["taken"]
    a, b = (load_npz(str(d / "params.npz"))
            for d in (out / "straight", resumed_dir))
    bitwise = sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)

    streamed, s_launches, s_steps, s_seen = _c8_run(
        torch, runner, psi, loop, cfg, out / "streamed", stream=True)
    s_held = _hold_first_inputs(torch, psi, s_seen)
    syncs, sync_sites = _host_syncs_per_step(torch, cfg)

    # encode(Y) at init against the PCA latents on the training rows
    Y, _ = runner.load_data(cfg, torch.float32, "cuda")
    Y_train, Y_test = (torch.as_tensor(y, device="cuda")
                       for y in runner.holdout_split(Y.cpu().numpy()))
    p0 = svi_gplvm.init_params(prng.PRNGKey(cfg.seed), Y_train, mcfg)
    with torch.no_grad():
        mu0, s0 = amortized.encode(p0, Y_train)
    x0 = pca_latents(Y_train, cfg.q)
    encode_init_err = float((mu0 - x0).abs().max() / x0.abs().max())
    del p0, mu0, s0, x0

    # the imputer on the run's parameters, and its predictive in f32
    # against f64 at a fixed q(x*) (the encoder's, without the floor, on
    # the first 64 held-out rows) at the same jitter
    raw = {k: torch.as_tensor(v, device="cuda")
           for k, v in load_npz(str(out / "straight" / "params.npz")).items()}
    builds, requests = _c8_imputer(torch, psi, seed, raw, mcfg, Y_test)
    p64 = {k: v.double() for k, v in raw.items()}
    same = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    with torch.no_grad():
        x_m, x_v = amortized.encode(raw, Y_test[:64])
        m32, v32 = svi_gplvm.predict_from_latent(raw, x_m, x_v, mcfg)
        m64, v64 = svi_gplvm.predict_from_latent(p64, x_m.double(),
                                                 x_v.double(), mcfg, same)
    pred_err = dict(
        mean=float((m32.double() - m64).abs().max() / m64.abs().max()),
        var=float((v32.double() - v64).abs().max() / v64.abs().max()))

    finiteness = config.evaluate_checks("", straight)
    failures = config.evaluate_checks(cfg.name, straight)
    row = dict(phase="amortized", **_graphs_since(loop, graphs0),
               **_step_fields("c8"), config=cfg.name, n=cfg.n,
               batch=straight["batch"], steps=C6_STEPS, steps_taken=steps,
               ms_per_step=straight["ms_per_step"],
               ms_per_step_streamed=streamed["ms_per_step"],
               rows_per_sec=straight["rows_per_sec"],
               rows_per_sec_streamed=streamed["rows_per_sec"],
               seconds=straight["seconds"], elbo_f64=straight["elbo"],
               elbo_f64_streamed=streamed["elbo"], noise=straight["noise"],
               **{k: straight[k] for k in (
                   "imputation_mse", "predictive_loglik_per_dim",
                   "calibration_ratio", "imputation_seconds",
                   "imputation_rows")},
               gates=config.CHECKS[cfg.name],
               host_syncs_per_step=syncs, host_sync_sites=sync_sites,
               launches=launches, streamed_launches=s_launches,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               streamed_launches_per_step={k: v / s_steps
                                           for k, v in s_launches.items()
                                           if v},
               held_on_the_runs_inputs=held,
               held_on_the_streamed_runs_inputs=s_held,
               kernels_at_c8=timing,
               resumed_from=C6_CKPT_EVERY, resumed_steps=resumed_steps,
               resume_bitwise_equal=bitwise and (
                   resumed["elbo"] == straight["elbo"]),
               native_loader=streamed["native_loader"],
               feed_wait_ms_per_chunk=streamed["feed_wait_ms_per_chunk"],
               streamed_equals_resident_bitwise=_streamed_equals_resident(
                   torch, cfg),
               encode_init_vs_pca=encode_init_err,
               tol_encode_init=TOL_ENCODE_INIT,
               imputer_builds=builds, imputer_requests=requests,
               predictive_f32_vs_f64=pred_err, tol_pred=TOL_PRED_C8,
               nonfinite=finiteness + config.evaluate_checks("", streamed),
               missing=[f for f in failures if "MISSING" in f],
               gates_not_held_at_these_steps=[
                   f for f in failures if f not in finiteness])
    emit(row)
    _held_replayed(row)
    if row["nonfinite"] or row["missing"] or not streamed["streamed"]:
        raise AssertionError(f"amortized: broken result: {row}")
    if not row["native_loader"]:
        raise AssertionError("amortized: the streamed run did not use the "
                             "native loader")
    for h in held + s_held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"amortized: {h['kernel']} disagrees with "
                                 f"its plain version on the run's inputs: "
                                 f"{h}")
    for hs in (held, s_held):
        if {h["kernel"] for h in hs} != {"suffstats_batched",
                                         "psi2_bwd_batched"}:
            raise AssertionError(f"amortized: held {hs}")
    if resumed_steps != C6_STEPS - C6_CKPT_EVERY or not row[
            "resume_bitwise_equal"]:
        raise AssertionError("amortized: the resumed run did not end on "
                             "the uninterrupted run's bits")
    if not row["streamed_equals_resident_bitwise"]:
        raise AssertionError("amortized: a streamed step differs from the "
                             "resident step on the same rows")
    if not encode_init_err <= TOL_ENCODE_INIT:
        raise AssertionError(f"amortized: encode(Y) at init is "
                             f"{encode_init_err} off the PCA latents")
    if not max(pred_err.values()) <= TOL_PRED_C8:
        raise AssertionError(f"amortized: f32 predictive off: {pred_err}")
    return row


C9_STEPS = 500       # plan(500, 250): 250 steps hot, 250 recalibrating
C9_BATCHES = (1, 32, 512)
C9_REQUESTS = 3      # per batch: one warm call, then timed
C9_SYNC_ROWS = 8192  # the draw the phase-B step's host syncs are read on
C9_SAMPLES = 64      # cross_view_sample's draws
C9_SAMPLE_ROWS = 8
# the sampler's moments against cross_view_predict's: the largest error of
# the 64-draw mean over the root of the mean predictive variance (Monte
# Carlo alone: ~3.5 sd / 8 over 256 entries, ~0.44), and the mean of the
# draws' variance plus the noise over the mean predictive variance (64
# draws: ~1 +- 0.03 pooled; the 2048 random features add their own)
TOL_SAMPLE_MEAN = 0.5
SAMPLE_VAR_RATIO = (0.8, 1.25)
# c9's f32 predictive against f64 at the same jitter, scaled by max|ref|
TOL_PRED_C9 = TOL_PRED


def _c9_step_syncs(torch, cfg, n=C9_SYNC_ROWS, steps=5):
    """Host syncs (`_syncs_per_step`) and ms of a c9 phase-B step (the
    recalibrated parameters, raw_ard and raw_variance frozen, the calm
    rate) at c9's widths on an n-row draw, over `steps` steps after two
    warm-up steps."""
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.data.synthetic import two_view_big
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import mrd_svi
    from dp_gp_lvm_tpu_torch.train import mrd_recipe
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    Y1, Y2, _ = two_view_big(prng.PRNGKey(cfg.seed), n=n, d1=cfg.views[0],
                             d2=cfg.views[1], dtype=torch.float32)
    mcfg = runner._model_config(cfg, None)
    params = mrd_recipe._as_parameters(mrd_recipe.recalibrated(
        mrd_svi.init_params(prng.PRNGKey(cfg.seed), (Y1, Y2), mcfg), 0.4,
        0.25))
    opt = gp_optimizer(params, lr=cfg.lr, decay_steps=cfg.steps,
                       freeze=mrd_recipe.FROZEN_STRUCTURE)
    step = mrd_svi.make_svi_natgrad_step(mcfg, n, opt, rho=0.2)
    idx = step.indices(prng.fold_in(prng.PRNGKey(1), torch.arange(2 + steps)))
    for t in range(2):
        step(t, idx[t], (Y1, Y2))
    syncs, sites = _syncs_per_step(torch, step, [
        (t, idx[t], (Y1, Y2)) for t in range(2, 2 + steps)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + steps):
        step(t, idx[t], (Y1, Y2))
    torch.cuda.synchronize()
    return syncs, sites, 1e3 * (time.perf_counter() - t0) / steps


def _c9_predictor(torch, raw, mcfg, Y_obs):
    """make_mrd_svi_predictor (view 0 -> view 1) on the run's parameters:
    its build (ms, launches) and requests of each batch from the held-out
    rows (ms a request, launches)."""
    from dp_gp_lvm_tpu_torch.models import serving
    from dp_gp_lvm_tpu_torch.ops import psi

    psi.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict = serving.make_mrd_svi_predictor(raw, mcfg, 0, 1)
    torch.cuda.synchronize()
    build = dict(build_ms=1e3 * (time.perf_counter() - t0),
                 build_launches={k: v for k, v in psi.LAUNCHES.items() if v})
    rows = []
    for b in C9_BATCHES:
        times = []
        psi.reset_launch_counts()
        for i in range(C9_REQUESTS):
            y = Y_obs[i * b:(i + 1) * b] if (i + 1) * b <= Y_obs.shape[0] \
                else Y_obs[:b]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = predict(y)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            if not (mean.shape == var.shape == (b, mcfg.view_dims[1])
                    and bool(torch.isfinite(mean).all())
                    and bool((var > 0).all())):
                raise AssertionError(f"mrd_svi: bad answer at batch {b}")
        tol, cap = serving._resolve("auto", 150, b)
        rows.append(dict(batch=b, mode="tol" if tol else "unroll",
                         step_cap=cap,
                         ms_per_request=statistics.median(times),
                         launches_per_request=sum(psi.LAUNCHES.values())
                         / C9_REQUESTS))
    return build, rows


def phase_mrd_svi(torch, seed):
    """c9_mrd_svi_bigN through the runner at full width for a short
    two-phase budget, the resume from its phase-A boundary, the q(u)-only
    predictor and the cross-view sampler on its parameters."""
    import shutil

    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.core.transforms import positive
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import mrd_svi
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.train import loop, mrd_recipe
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz

    graphs0 = dict(loop.GRAPHS)
    cfg = dataclasses.replace(config.get("c9_mrd_svi_bigN"), seed=seed)
    mcfg = runner._model_config(cfg, None)
    out = ROOT / "build" / "smoke_mrd_svi"
    shutil.rmtree(out, ignore_errors=True)
    psi.reset_launch_counts()
    loop.reset_step_count()
    # K2's cotangent is zero at a step whose q(u^v) is the prior (the
    # first): K2 is held on its first call with a nonzero one
    with _first_inputs(torch, psi, lambda name, args: (
            name != "psi2_bwd_batched" or bool(args[5].any()))) as seen, \
            _stage_launches(torch, psi, loop, mrd_recipe,
                            "staged_mrd_svi") as stages:
        straight = runner.run(cfg, steps=C9_STEPS, device="cuda",
                              out=str(out / "straight"))
    launches = dict(psi.LAUNCHES)
    steps = loop.STEPS["taken"]
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    # a K1 and a K2 a view and step; K1 once more a view over every row
    # for the ELBO; the cross-view evaluation's psi statistics are plain
    expected.update(suffstats_batched=2 * steps + 2,
                    psi2_bwd_batched=2 * steps)
    held = _hold_first_inputs(torch, psi, seen)
    timing = {}
    for key, args in seen.items():
        shape, bound, by = _work_of(key[0], args)
        ref = getattr(psi, RUN_KERNELS[key[0]][0])
        timing[_shape_key(key)] = dict(
            shape=shape, bound_ms=bound, bound_by=by,
            device_ms=_device_ms(lambda: getattr(psi, key[0])(*args), torch),
            ms=_timed(lambda: getattr(psi, key[0])(*args), torch),
            plain_ms=_timed(lambda: ref(*args), torch, reps=3, warmup=1))
    with np.load(out / "straight" / "stages" / "phaseA.npz") as f:
        boundary = [[round(float(a), 6) for a in
                     positive(torch.as_tensor(f[f"views/{v}/raw_ard"]))]
                    for v in range(2)]

    resumed_dir = out / "resumed"
    (resumed_dir / "stages").mkdir(parents=True)
    shutil.copy(out / "straight" / "stages" / "phaseA.npz",
                resumed_dir / "stages")
    loop.reset_step_count()
    resumed = runner.run(cfg, steps=C9_STEPS, device="cuda",
                         out=str(resumed_dir), resume=True)
    resumed_steps = loop.STEPS["taken"]
    a, b = (load_npz(str(d / "params.npz"))
            for d in (out / "straight", resumed_dir))
    bitwise = sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)
    syncs, sync_sites, step_ms = _c9_step_syncs(torch, cfg)

    # the server and the sampler on the run's parameters, requests from
    # the held-out rows
    Ys, _ = runner.load_data(cfg, torch.float32, "cuda")
    Y_obs, Y_tgt = (y[cfg.n:] for y in Ys)
    del Ys
    raw = _nested(a)
    build, requests = _c9_predictor(torch, raw, mcfg, Y_obs)
    p64 = {k: ([{kk: vv.double() for kk, vv in view.items()}
                for view in v] if k == "views" else v.double())
           for k, v in raw.items()}
    same = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    with torch.no_grad():
        c32 = mrd_svi.constrain_views(raw, mcfg)[0]
        x_m, x_v = c32["qx_mean"][:64], c32["qx_var"][:64]
        m32, v32 = mrd_svi.predict_view(raw, x_m, x_v, 1, mcfg)
        m64, v64 = mrd_svi.predict_view(p64, x_m.double(), x_v.double(), 1,
                                        mcfg, same)
    pred_err = dict(
        mean=float((m32.double() - m64).abs().max() / m64.abs().max()),
        var=float((v32.double() - v64).abs().max() / v64.abs().max()))
    rows = {0: Y_obs[:C9_SAMPLE_ROWS]}
    psi.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = mrd_svi.cross_view_sample(prng.PRNGKey(seed), raw, rows, 1,
                                      mcfg, C9_SAMPLES)
    torch.cuda.synchronize()
    sample_ms = 1e3 * (time.perf_counter() - t0)
    sample_launches = dict(psi.LAUNCHES)
    mean, var, *_ = mrd_svi.cross_view_predict(raw, rows, 1, mcfg)
    with torch.no_grad():
        noise = float(mrd_svi.constrain_views(raw, mcfg)[1]["noise"])
        sample = dict(
            shape=list(draws.shape),
            mean_err=float((draws.mean(0) - mean).abs().max()
                           / var.mean().sqrt()),
            var_ratio=float((draws.var(0).mean() + noise) / var.mean()),
            ms=sample_ms, launches={k: v for k, v in
                                    sample_launches.items() if v})

    finiteness = config.evaluate_checks("", straight)
    failures = config.evaluate_checks(cfg.name, straight)
    row = dict(phase="mrd_svi", **_graphs_since(loop, graphs0),
               **_step_fields("c9"), config=cfg.name, n=cfg.n,
               batch=straight["batch"], steps=C9_STEPS, steps_taken=steps,
               phase_steps=dict(a=straight["phase_a_steps"],
                                b=straight["phase_b_steps"]),
               stages=stages, seconds=straight["seconds"],
               ms_per_step_phase_b=straight["ms_per_step"],
               rows_per_sec=straight["rows_per_sec"],
               ms_per_step_phase_b_8192=step_ms, host_syncs_per_step=syncs,
               host_sync_sites=sync_sites, boundary_relevance=boundary,
               **{k: straight[k] for k in (
                   "elbo", "noise_min", "cross_view_mse_ratio",
                   "cross_view_pll_per_dim", "calibration_ratio",
                   "ard_cross_private_ratio", "ard_relevance",
                   "cross_view_seconds")},
               gates=config.CHECKS[cfg.name],
               launches=launches, expected_launches=expected,
               launches_per_step={k: v / steps for k, v in launches.items()
                                  if v},
               held_on_the_runs_inputs=held, kernels_at_c9=timing,
               resumed_steps=resumed_steps,
               resume_bitwise_equal=bitwise and (
                   resumed["elbo"] == straight["elbo"]),
               predictor_build=build, predictor_requests=requests,
               predictive_f32_vs_f64=pred_err, tol_pred=TOL_PRED_C9,
               sample=sample, tol_sample_mean=TOL_SAMPLE_MEAN,
               sample_var_ratio_range=SAMPLE_VAR_RATIO,
               nonfinite=finiteness, missing=[f for f in failures
                                              if "MISSING" in f],
               gates_not_held_at_these_steps=[
                   f for f in failures if f not in finiteness])
    emit(row)
    _held_replayed(row)
    if row["nonfinite"] or row["missing"]:
        raise AssertionError(f"mrd_svi: broken result: {row}")
    if launches != expected or steps != C9_STEPS:
        raise AssertionError(f"mrd_svi: launched {launches} in {steps} "
                             f"steps, expected {expected}")
    if [s["stage"] for s in stages] != ["phaseA hot", "phaseB recal"] or any(
            s["launches_per_step"] != {"suffstats_batched": 2.0,
                                       "psi2_bwd_batched": 2.0}
            for s in stages):
        raise AssertionError(f"mrd_svi: per-phase launches {stages}")
    want_keys = {"suffstats_batched T=1 N=1024",
                 f"suffstats_batched T=1 N={cfg.n}",
                 "psi2_bwd_batched T=1 N=1024"}
    if set(timing) != want_keys:
        raise AssertionError(f"mrd_svi: kernels seen {sorted(timing)}, "
                             f"expected {sorted(want_keys)}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"mrd_svi: {h['kernel']} disagrees with its "
                                 f"plain version on the run's inputs: {h}")
    if resumed_steps != straight["phase_b_steps"] or not row[
            "resume_bitwise_equal"]:
        raise AssertionError("mrd_svi: the resumed run did not end on the "
                             "uninterrupted run's bits")
    if build["build_launches"] or any(r["launches_per_request"]
                                      for r in requests) or sample[
            "launches"]:
        raise AssertionError("mrd_svi: serving launched a kernel; its psi "
                             "statistics are plain")
    if not max(pred_err.values()) <= TOL_PRED_C9:
        raise AssertionError(f"mrd_svi: f32 predictive off: {pred_err}")
    if not (sample["shape"] == [C9_SAMPLES, C9_SAMPLE_ROWS, cfg.views[1]]
            and sample["mean_err"] <= TOL_SAMPLE_MEAN
            and SAMPLE_VAR_RATIO[0] <= sample["var_ratio"]
            <= SAMPLE_VAR_RATIO[1]):
        raise AssertionError(f"mrd_svi: the sampler's moments are off the "
                             f"predictive's: {sample}")
    return row


# the minibatch families on the 1 x 1 mesh: (draw rows, K1 and K2
# launches a step); c7's is its stage-2c step (T = 8, phi locked)
MESH_SVI = {"c6_svi_bigN": (4096, 2, 1), "c8_amortized_svi": (4096, 2, 1),
            "c9_mrd_svi_bigN": (8192, 2, 2), "c7_dp_svi": (8192, 1, 1)}
# f32 against f64: each view's or atom's blended q(u) after one step, as
# tests/test_torch_cuda.py holds the unsharded steps
TOL_BLEND = 1e-3
# the DP-SVI's Z gradient (c7) against f64, scaled by max|ref|: at q(u | t)'s
# optimum it is the collapsed bound's, small beside the per-row terms it
# sums, and f32 keeps ~2e-2 of it (an H100: 2.01e-2); at the prior it is
# exactly 0 in both precisions, so neither state escapes the cancellation
TOL_GRAD_DP_Z = 5e-2


def _mesh_svi_setup(torch, seed, name):
    """(data: Y or the views, model module, model config, draw rows, init
    -> params, step factory (opt, mesh) -> step, gp_optimizer keywords) of
    an SVI config at full width on a reduced draw, its step as the runner
    (c6, c8, c9) or the staged recipe's stage 2c (c7) builds it."""
    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.data import synthetic
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.models import dp_svi, mrd_svi, svi_gplvm

    cfg = dataclasses.replace(config.get(name), seed=seed)
    mcfg = runner._model_config(cfg, None)
    n, key = MESH_SVI[name][0], prng.PRNGKey(cfg.seed)
    opt_kw = dict(lr=cfg.lr, ngd_lr=cfg.ngd_lr, decay_steps=cfg.steps,
                  slow=frozenset({"z"}) if cfg.amortized else frozenset())
    if cfg.model == "dp_svi":
        Y, _, _ = synthetic.grouped_dims_big(
            key, n=n, dims_per_group=runner.grouped_dims_per_group(cfg.d),
            q=cfg.q, dtype=torch.float32)
        return (Y, dp_svi, mcfg, n,
                lambda: dp_svi.init_params(key, Y, mcfg),
                lambda opt, mesh: dp_svi.make_dp_svi_step(
                    mcfg, n, opt, rho=0.3, phi_update="frozen", mesh=mesh),
                opt_kw)
    if cfg.model == "mrd_svi":
        Y1, Y2, _ = synthetic.two_view_big(key, n=n, d1=cfg.views[0],
                                           d2=cfg.views[1],
                                           dtype=torch.float32)
        return ((Y1, Y2), mrd_svi, mcfg, n,
                lambda: mrd_svi.init_params(key, (Y1, Y2), mcfg),
                lambda opt, mesh: runner._svi_step(cfg, mcfg, n, opt, False,
                                                   mesh), opt_kw)
    Y, _ = synthetic.mocap_like(key, n=n, d=cfg.d, dtype=torch.float32)
    return (Y, svi_gplvm, mcfg, n,
            lambda: svi_gplvm.init_params(key, Y, mcfg),
            lambda opt, mesh: runner._svi_step(cfg, mcfg, n, opt, False,
                                               mesh), opt_kw)


def _at_optimal_qu(torch, model, params, data, mcfg):
    """params with q(u) (each view's, each atom's) at its optimum over
    every row of the draw, in place: off the prior, where the bound does
    not read Psi2 and the hypers' and Z's gradients vanish."""
    from dp_gp_lvm_tpu_torch.train.loop import flat_leaves

    with torch.no_grad():
        best = flat_leaves(model.set_optimal_qu(
            params, list(data) if isinstance(data, tuple) else data, mcfg))
        for k, v in flat_leaves(params).items():
            v.copy_(best[k])
    return params


def _mesh_svi_model(torch, psi, mesh, seed, name):
    """One SVI config on the 1 x 1 mesh (see the module docstring)."""
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import dp_svi
    from dp_gp_lvm_tpu_torch.parallel import recipe
    from dp_gp_lvm_tpu_torch.parallel import sharded_elbo as se
    from dp_gp_lvm_tpu_torch.train import loop

    t_start = time.perf_counter()
    data, model, mcfg, n, init, make_step, opt_kw = _mesh_svi_setup(
        torch, seed, name)
    family = model.__name__.rsplit(".", 1)[-1]
    views = isinstance(data, tuple)
    _, k1, k2 = MESH_SVI[name]
    same = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))

    base = _at_optimal_qu(torch, model, init(), data, mcfg)

    def fresh():
        """A copy of the checked state, new leaves."""
        return {k: ([{kk: torch.nn.Parameter(vv.detach().clone())
                      for kk, vv in view.items()} for view in v]
                    if k == "views" else torch.nn.Parameter(
                        v.detach().clone())) for k, v in base.items()}

    idx_all = dp_svi.minibatch_indices(
        prng.fold_in(prng.PRNGKey(1), torch.arange(21)), mcfg.batch,
        n).cuda()
    idx = idx_all[0]
    rows = [y[idx] for y in data] if views else data[idx]

    # the loss and every gradient: unsharded f32, sharded f32, plain f64
    params = fresh()
    leaves = loop.flat_leaves(params)
    loss_u = model.loss_minibatch(params, rows, idx, n, mcfg)
    g_u = torch.autograd.grad(loss_u, list(leaves.values()))
    local, _, table = recipe.place_svi(family, fresh(), (), mesh)
    sharded = {"svi_gplvm": se.svi_loss_sharded,
               "dp_svi": se.dp_svi_loss_sharded,
               "mrd_svi": se.mrd_svi_loss_sharded}[family]
    loss_s = sharded(local, rows, idx, n, mcfg, mesh)
    g_s = torch.autograd.grad(loss_s, list(loop.flat_leaves(local).values()))
    p64 = _f64_tree(params)
    rows64 = [y.double() for y in rows] if views else rows.double()
    loss64 = -model.elbo_minibatch(p64, rows64, idx, n,
                                   mcfg._replace(use_fused=False), same)
    g64 = torch.autograd.grad(loss64, list(loop.flat_leaves(p64).values()))

    def scaled(got, want, names=tuple(leaves)):
        """Per leaf |got - want| / max|want|; leaves whose reference is
        exactly 0 are left out."""
        return {k: float((a.double() - b.double()).abs().max()
                         / b.double().abs().max())
                for k, a, b in zip(names, got, want)
                if float(b.abs().max()) > 0}

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    # one step from the same state: unsharded f32, sharded f32, plain f64
    step_u = make_step(loop.gp_optimizer(params, **opt_kw), None)
    step_u(0, idx, data)
    opt_s = loop.gp_optimizer(local, mesh=mesh, placement=table, **opt_kw)
    step_s = make_step(opt_s, mesh)
    step_s(0, idx, data)
    p64_step = _f64_tree(fresh())
    cfg64 = mcfg._replace(use_fused=False)
    opt64 = loop.gp_optimizer(p64_step, **opt_kw)
    data64 = (tuple(y.double() for y in data) if views else data.double())
    if family == "svi_gplvm":
        step64 = model.make_svi_natgrad_step(
            cfg64, n, opt64, rho=0.2, policy=same,
            qu_trust=100.0 if mcfg.amortized else None)
    elif family == "mrd_svi":
        step64 = model.make_svi_natgrad_step(cfg64, n, opt64, rho=0.2,
                                             policy=same)
    else:
        step64 = model.make_dp_svi_step(cfg64, n, opt64, rho=0.3,
                                        phi_update="frozen", policy=same)
    step64(0, idx, data64)
    after_u, after_s, after64 = ({k: v.detach().clone() for k, v in
                                  loop.flat_leaves(p).items()}
                                 for p in (params, local, p64_step))
    blend = [k for k in after_u if k.rsplit(".", 1)[-1] in (
        "u_mean", "raw_u_scale", "u_h", "u_lam")]
    step_bits = all(bool(torch.equal(after_s[k], after_u[k]))
                    for k in after_u)
    blend_vs_u = max(scaled([after_s[k] for k in blend],
                            [after_u[k] for k in blend], blend).values())
    blend_vs_f64 = scaled([after_s[k] for k in blend],
                          [after64[k] for k in blend], blend)

    # 20 sharded and 20 unsharded steps, in turns (10, 10, 10, 10), each
    # side on the minibatches 1-20 (both continue from the step above)
    t = [1]

    def ten(step):
        out = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(t[0], idx_all[t[0]], data)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
            t[0] += 1
        return out

    psi.reset_launch_counts()
    loop.reset_step_count()
    with _first_inputs(torch, psi, lambda name, args: (
            name != "psi2_bwd_batched" or bool(args[5].any()))) as seen:
        ms = ten(step_s)
    launches, steps = dict(psi.LAUNCHES), loop.STEPS["taken"]
    held = _hold_first_inputs(torch, psi, seen)
    t[0] = 1
    ms_u = ten(step_u)
    ms_u += ten(step_u)
    t[0] = 11
    ms += ten(step_s)
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=k1 * steps, psi2_bwd_batched=k2 * steps)
    grad_vs_u = scaled(g_s, g_u)
    grad_vs_f64 = scaled(g_s, g64)
    # the leaves the optimizer steps by their gradient; the blend sets
    # q(u) (held above), and the DP-SVI's blend or CAVI its other leaves
    set_by_blend = ("u_mean", "raw_u_scale") + dp_svi._BLEND_LEAVES
    stepped_vs_f64 = {k: v for k, v in grad_vs_f64.items()
                      if k.rsplit(".", 1)[-1] not in set_by_blend}
    tol_stepped = {k: TOL_GRAD_DP_Z if (family, k) == ("dp_svi", "z")
                   else TOL_GRAD for k in stepped_vs_f64}
    row = dict(
        phase="mesh_svi", config=name, model=family, rows=n,
        batch=mcfg.batch,
        loss_sharded_f32=float(loss_s), loss_unsharded_f32=float(loss_u),
        loss_plain_f64=float(loss64),
        loss_bitwise_equal=bool(torch.equal(loss_s.detach(),
                                            loss_u.detach())),
        grads_bitwise_equal=all(bool(torch.equal(a, b))
                                for a, b in zip(g_s, g_u)),
        step_bitwise_equal=step_bits,
        loss_rel_err_vs_unsharded=rel(loss_s, loss_u),
        loss_rel_err_vs_f64=rel(loss_s, loss64), tol=TOL_ELBO,
        grad_scaled_err_vs_unsharded=max(grad_vs_u.values()),
        grad_scaled_err_vs_f64=grad_vs_f64,
        stepped_grad_scaled_err_vs_f64=stepped_vs_f64,
        tol_stepped_grad=tol_stepped,
        grads_zero_at_this_state=sorted(set(leaves) - set(grad_vs_f64)),
        blend_scaled_err_vs_unsharded=blend_vs_u,
        blend_scaled_err_vs_f64=blend_vs_f64,
        tol_blend=TOL_BLEND,
        ms_per_step_median=statistics.median(ms),
        ms_per_step_unsharded_median=statistics.median(ms_u),
        launches=launches, expected_launches=expected,
        launches_per_step={k: v / steps for k, v in launches.items() if v},
        held_on_the_steps_inputs=held,
        seconds=time.perf_counter() - t_start)
    emit(row)
    # one rank runs the unsharded path's kernels in its order: the same bits
    if not (row["loss_bitwise_equal"] and row["grads_bitwise_equal"]
            and row["step_bitwise_equal"]):
        raise AssertionError(f"mesh_svi: {name}: the sharded loss, gradient "
                             f"or step is not the unsharded one's bits: "
                             f"{row}")
    if not row["loss_rel_err_vs_f64"] <= TOL_ELBO:
        raise AssertionError(f"mesh_svi: {name}: sharded loss off: {row}")
    if any(v > tol_stepped[k] for k, v in stepped_vs_f64.items()):
        raise AssertionError(f"mesh_svi: {name}: sharded gradient off: "
                             f"{row}")
    if not max(row["blend_scaled_err_vs_f64"].values()) <= TOL_BLEND:
        raise AssertionError(f"mesh_svi: {name}: blended q(u) off: {row}")
    if launches != expected or steps != 10:
        raise AssertionError(f"mesh_svi: {name} launched {launches} in "
                             f"{steps} steps, expected {expected}")
    if {h["kernel"] for h in held} != {"suffstats_batched",
                                       "psi2_bwd_batched"}:
        raise AssertionError(f"mesh_svi: {name} held {held}")
    for h in held:
        if not (h["scaled_err"] <= h["tol"] and h["repeat_bitwise_equal"]):
            raise AssertionError(f"mesh_svi: {name}: {h['kernel']} "
                                 f"disagrees with its plain version: {h}")
    return row


def phase_mesh_svi(torch, seed, card, svi, dp):
    """The minibatch families at world size 1 (module docstring): the
    per-step checks of each config, then the runner's `--mesh 1` runs of
    c6 (with the resume) and c7 against the svi and dp_svi phases'
    unsharded runs of the same configs."""
    import shutil

    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config
    from dp_gp_lvm_tpu_torch.experiments import run as runner
    from dp_gp_lvm_tpu_torch.ops import psi
    from dp_gp_lvm_tpu_torch.parallel import mesh as mesh_lib
    from dp_gp_lvm_tpu_torch.train import loop
    from dp_gp_lvm_tpu_torch.train.checkpoint import load_npz

    t_phase = time.perf_counter()
    out = ROOT / "build" / "smoke_mesh_svi"
    shutil.rmtree(out, ignore_errors=True)
    mesh = mesh_lib.make_mesh(1, 1, "cuda")
    try:
        rows = {name: _mesh_svi_model(torch, psi, mesh, seed, name)
                for name in MESH_SVI}
        runs = {}
        c6 = dataclasses.replace(config.get("c6_svi_bigN"), seed=seed)
        kw = dict(steps=C6_STEPS, device="cuda", ckpt_every=C6_CKPT_EVERY,
                  impute_steps=C6_IMPUTE_STEPS, mesh="1")
        psi.reset_launch_counts()
        loop.reset_step_count()
        t0 = time.perf_counter()
        straight = runner.run(c6, out=str(out / "c6"), **kw)
        c6_launches = dict(psi.LAUNCHES)
        wall = [time.perf_counter() - t0]
        resumed_dir = out / "c6_resumed"
        (resumed_dir / "ckpt").mkdir(parents=True)
        shutil.copy(out / "c6" / "ckpt" / f"ckpt_{C6_CKPT_EVERY}.pt",
                    resumed_dir / "ckpt")
        loop.reset_step_count()
        t0 = time.perf_counter()
        resumed = runner.run(c6, out=str(resumed_dir), resume=True, **kw)
        wall.append(time.perf_counter() - t0)
        resumed_steps = loop.STEPS["taken"]
        a, b = (load_npz(str(d / "params.npz"))
                for d in (out / "c6", resumed_dir))
        runs["c6_svi_bigN"] = dict(
            phase="mesh_svi_run", config=c6.name, mesh="1", steps=C6_STEPS,
            ms_per_step=straight["ms_per_step"],
            ms_per_step_unsharded_run=svi["ms_per_step"],
            seconds=straight["seconds"], elbo_f64=straight["elbo"],
            elbo_f64_unsharded_run=svi["elbo_f64"],
            elbo_diff_vs_unsharded_run=straight["elbo"] - svi["elbo_f64"],
            launches=c6_launches, launches_unsharded_run=svi["launches"],
            resumed_from=C6_CKPT_EVERY, resumed_steps=resumed_steps,
            resume_bitwise_equal=sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in a)
            and resumed["elbo"] == straight["elbo"],
            nonfinite=config.evaluate_checks("", straight),
            wall_seconds_straight_and_resumed=wall)
        emit(runs["c6_svi_bigN"])

        c7 = dataclasses.replace(config.get("c7_dp_svi"), seed=seed)
        psi.reset_launch_counts()
        loop.reset_step_count()
        t0 = time.perf_counter()
        result = runner.run(c7, steps=C7_STEPS, device="cuda",
                            out=str(out / "c7"), mesh="1",
                            impute_steps=C7_IMPUTE_STEPS)
        wall = time.perf_counter() - t0
        runs["c7_dp_svi"] = dict(
            phase="mesh_svi_run", config=c7.name, mesh="1", steps=C7_STEPS,
            steps_taken=loop.STEPS["taken"],
            ms_per_step_stage2c=result["ms_per_step"],
            ms_per_step_stage2c_unsharded_run=dp["ms_per_step_stage2c"],
            seconds=result["seconds"], elbo=result["elbo"],
            elbo_unsharded_run=dp["elbo"],
            elbo_diff_vs_unsharded_run=result["elbo"] - dp["elbo"],
            group_purities=result["group_purities"],
            group_purities_unsharded_run=dp["group_purities"],
            launches=dict(psi.LAUNCHES), launches_unsharded_run=dp["launches"],
            nonfinite=config.evaluate_checks("", result), wall_seconds=wall)
        emit(runs["c7_dp_svi"])
    finally:
        mesh_lib.close_distributed()
    for name, r in runs.items():
        if r["nonfinite"]:
            raise AssertionError(f"mesh_svi: the --mesh 1 run of {name} gave "
                                 f"a broken result: {r}")
        if r["launches"] != r["launches_unsharded_run"]:
            raise AssertionError(f"mesh_svi: the --mesh 1 run of {name} "
                                 f"launched {r['launches']}, the unsharded "
                                 f"run {r['launches_unsharded_run']}")
    r6 = runs["c6_svi_bigN"]
    if r6["resumed_steps"] != C6_STEPS - C6_CKPT_EVERY or not r6[
            "resume_bitwise_equal"]:
        raise AssertionError("mesh_svi: the resumed --mesh 1 c6 run did not "
                             "end on the straight mesh run's bits")
    emit(dict(phase="mesh_svi_ms", card=card,
              phase_seconds=time.perf_counter() - t_phase,
              ms_per_step={name: {"sharded": r["ms_per_step_median"],
                                  "unsharded": r[
                                      "ms_per_step_unsharded_median"]}
                           for name, r in rows.items()},
              runner_ms_per_step={
                  "c6_svi_bigN": {"sharded": r6["ms_per_step"],
                                  "unsharded": r6[
                                      "ms_per_step_unsharded_run"]},
                  "c7_dp_svi stage 2c": {
                      "sharded": runs["c7_dp_svi"]["ms_per_step_stage2c"],
                      "unsharded": runs["c7_dp_svi"][
                          "ms_per_step_stage2c_unsharded_run"]}}))
    return rows, runs


TOL_SGPR = 1e-4   # relative, of the bound and the exact marginal
# (N, M) of the sgpr phase: held at the first; the second, whose K_uu has
# a condition number near 4e4, is reported only (f32 solves lose about
# cond(K_uu) x 2^-24 there, in the reference's f32 as in the port's)
SGPR_SHAPES = ((200, 10, True), (500, 30, False))


def _sgpr_at(torch, seed, n, m):
    import numpy as np

    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.kernels import ard_rbf
    from dp_gp_lvm_tpu_torch.models import gp_regression, sparse_gp

    r = np.random.default_rng(seed)
    X, Y, Xs = (r.normal(size=s) for s in ((n, 3), (n, 4), (50, 3)))
    policy = JitterPolicy(initial=JitterPolicy().initial_for(torch.float32))
    got, want = {}, {}
    for out, dev, dtype in ((got, "cuda", torch.float32),
                            (want, "cpu", torch.float64)):
        x, y, xs = (torch.tensor(a, dtype=dtype, device=dev)
                    for a in (X, Y, Xs))
        ps = sparse_gp.init_params(prng.PRNGKey(seed), x, m)
        pg = gp_regression.init_params(3, dtype=dtype, device=dev)
        with torch.no_grad():
            out["elbo"] = float(sparse_gp.elbo(ps, x, y, policy))
            out["log_marginal"] = float(gp_regression.log_marginal(
                pg, x, y, policy))
            out["mean"], out["var"] = (t.double().cpu() for t in
                                       sparse_gp.predict(ps, x, y, xs,
                                                         policy))
            out["gpr_mean"], out["gpr_var"] = (
                t.double().cpu() for t in gp_regression.predict(
                    pg, x, y, xs, policy))
            kuu = ard_rbf.gram(torch.ones((), dtype=dtype, device=dev),
                               torch.ones(3, dtype=dtype, device=dev),
                               ps["z"])
    rel = {k: abs(got[k] - want[k]) / abs(want[k])
           for k in ("elbo", "log_marginal")}
    scaled = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
              for k in ("mean", "var", "gpr_mean", "gpr_var")}
    return dict(N=n, M=m, Q=3, D=4, N_star=50,
                cond_kuu=float(torch.linalg.cond(kuu.double().cpu())),
                elbo_f32=got["elbo"], elbo_f64=want["elbo"],
                log_marginal_f32=got["log_marginal"],
                log_marginal_f64=want["log_marginal"], rel_err=rel,
                predictive_scaled_err=scaled,
                bound_below_exact=want["elbo"] <= want["log_marginal"])


def phase_sgpr(torch, seed):
    """SGPR and exact GP regression at toy widths: f32 on the card against
    f64 on the CPU at the same jitter (no kernel: Gram matrices)."""
    shapes = []
    for n, m, held in SGPR_SHAPES:
        at = _sgpr_at(torch, seed, n, m)
        at["held"] = held
        at["ok"] = (max(at["rel_err"].values()) <= TOL_SGPR
                    and max(at["predictive_scaled_err"].values()) <= TOL_PRED
                    and at["bound_below_exact"])
        shapes.append(at)
    row = dict(phase="sgpr", tol=TOL_SGPR, tol_pred=TOL_PRED, shapes=shapes)
    emit(row)
    if not all(at["ok"] for at in shapes if at["held"]):
        raise AssertionError(f"sgpr: f32 on the card off f64: {row}")
    return row


def _profiled(torch, fn):
    """`fn` under torch.profiler (CPU and CUDA): its wall ms, each of the
    DP loss's scopes (CUDA and CPU ms the profiler attributes to the
    range, and how often it ran), the card's busy ms (every kernel's own
    time), the count of kernel launches and the twelve kernels with the
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    def ms(event, attr):
        value = getattr(event, attr, None)
        if value is None:
            value = getattr(event, attr.replace("device", "cuda"), math.nan)
        return float(value) / 1e3

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    scopes = {}
    for event in prof.events():
        if event.name in SCOPES and "CPU" in str(event.device_type):
            s = scopes.setdefault(event.name, dict(cuda_ms=0.0, cpu_ms=0.0,
                                                   count=0))
            s["cuda_ms"] += ms(event, "device_time_total")
            s["cpu_ms"] += ms(event, "cpu_time_total")
            s["count"] += 1
    kernels = sorted(
        ((e.key, ms(e, "self_device_time_total"), e.count)
         for e in prof.key_averages()
         if "CUDA" in str(e.device_type) and e.key not in SCOPES),
        key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return dict(wall_ms=wall_ms, scopes=scopes, busy_ms=busy,
                idle_share=1.0 - busy / wall_ms,
                kernel_launches=sum(k[2] for k in kernels),
                kernels=[dict(name=n[:90], cuda_ms=t, count=c)
                         for n, t, c in kernels[:12]])


SCOPES = ("psi_stats", "kuu_gram", "collapsed_bound")
TRACE_CHUNK = 100


def phase_trace(torch, seed, dp_params, dp_Y, dp_cfg):
    """Profiler traces: one eager c4_dp_mocap training step, a chunk of
    TRACE_CHUNK of them replayed from a CUDA graph, and one streamed
    c6_svi_bigN chunk replayed (the stream phase's rows file). Numbers
    only; nothing is held."""
    import numpy as np

    from dp_gp_lvm_tpu_torch.core import config, prng
    from dp_gp_lvm_tpu_torch.data import stream
    from dp_gp_lvm_tpu_torch.models import dp_gp_lvm, svi_gplvm
    from dp_gp_lvm_tpu_torch.train.loop import (
        TrainState,
        gp_optimizer,
        make_multi_step_fn,
        make_step_fn,
        make_streaming_scan_fn,
    )

    c4 = config.get("c4_dp_mocap")
    opt = gp_optimizer(dp_params, lr=c4.lr, ngd_lr=c4.ngd_lr)
    step = make_step_fn(lambda p, y: dp_gp_lvm.loss(p, y, dp_cfg), opt)
    for _ in range(3):
        step(dp_Y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(dp_Y)
    torch.cuda.synchronize()
    c4_row = dict(unprofiled_wall_ms=1e3 * (time.perf_counter() - t0),
                  **_profiled(torch, lambda: step(dp_Y)))
    multi = make_multi_step_fn(lambda p, y: dp_gp_lvm.loss(p, y, dp_cfg),
                               opt, TRACE_CHUNK)
    multi(dp_Y).cpu()                     # the chunk that captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi(dp_Y).cpu()
    c4_chunk = dict(steps=TRACE_CHUNK, unprofiled_wall_ms_per_step=1e3 * (
        time.perf_counter() - t0) / TRACE_CHUNK,
        **_profiled(torch, lambda: multi(dp_Y).cpu()))
    c4_chunk["wall_ms_per_step"] = c4_chunk["wall_ms"] / TRACE_CHUNK

    cfg = dataclasses.replace(config.get("c6_svi_bigN"), seed=seed)
    path = ROOT / "build" / "smoke_stream" / "straight" / "y_stream.f32"
    Y = torch.from_numpy(np.fromfile(path, np.float32).reshape(
        -1, cfg.d)).cuda()
    mcfg = svi_gplvm.Config(num_latent=cfg.q, num_inducing=cfg.m,
                            batch=1024, psi2_block=cfg.psi2_block)
    params = svi_gplvm.init_params(prng.PRNGKey(seed), Y, mcfg)
    opt = gp_optimizer(params, lr=cfg.lr, ngd_lr=cfg.ngd_lr,
                       decay_steps=cfg.steps)
    scan_chunk = make_streaming_scan_fn(svi_gplvm.make_svi_natgrad_step(
        mcfg, Y.shape[0], opt, rho=0.2, streaming=True))
    state = TrainState(opt)
    with stream.ChunkStream(stream.StreamLoader(str(path), *Y.shape),
                            batch=1024, chunk=TRACE_CHUNK, seed=cfg.seed + 7,
                            device="cuda") as cs:
        def one_chunk():
            idx, y = cs.next_chunk()
            return scan_chunk(state, idx, y)[1].cpu()

        one_chunk()                       # warm-up chunk
        c6_row = _profiled(torch, one_chunk)
    c6_row["wall_ms_per_step"] = c6_row["wall_ms"] / TRACE_CHUNK
    row = dict(phase="trace", c4_step=c4_row, c4_replayed_chunk=c4_chunk,
               **_step_fields("c4"),
               c6_streamed_chunk=dict(steps=TRACE_CHUNK, **c6_row))
    emit(row)
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


# the m256 phase: each model at M = 256 (K1's body and K2 tiled), the
# reference's scaling widths (experiments/scaling.py) at Q = 10
M256 = dict(T=20, N=8192, M=256, Q=10, D=60)       # the DP-GP-LVM
M256_BG = dict(N=8192, M=256, Q=10, D=12)           # the Bayesian GP-LVM
M256_HELD = dict(T=4, N=2048, Q=10, D=60)           # synthetic holds
M256_HELD_M = (129, 192, 256)
M256_PLAIN_BLOCK = 512    # rows a block of the plain path's Psi2
M256_PLAIN_STEPS = 3
# K2 on the paths' own mu, S and Z with a standard normal G: f32 resolves
# it whatever K_uu's conditioning, and the tiled form has held there at
# 6.8e-07 to 1.36e-06 scaled (NVIDIA H100 80GB HBM3, 700 W)
TOL_K2_RANDOM_G = 2e-6
# The Bayesian GP-LVM on oil_flow_like at M = 256 is f32-limited: its 256
# inducing points lie in a 2-dim latent, K_uu's condition number is ~1e10
# (1.5e10 at N = 1024 on a CPU), and the plain f32 path itself misses f64
# by more than TOL_ELBO/TOL_GRAD. Its gaps are printed, not held; the same
# model is held on the DP path's mocap_like data (K_uu's condition ~9 at
# N = 1024), and K2 on its first inputs with a random G.


def _grads(torch, loss, params):
    keys = list(params)
    return dict(zip(keys, torch.autograd.grad(loss, [params[k]
                                                     for k in keys])))


def _scaled_gaps(got, want):
    return {k: float((got[k].double() - want[k].double()).abs().max()
                     / want[k].double().abs().max()) for k in want}


def _m256_init(torch, psi, model, params, Y, cfg, step,
               f32_limited_ok=False):
    """A model's fused f32 ELBO and gradient at `params` against the plain
    path in f32 (same card) and in f64 (same jitter). Each gap is held at
    TOL_ELBO or TOL_GRAD, except, with `f32_limited_ok`, where the plain
    f32 path itself misses f64 by more: those are listed in `f32_limited`,
    printed and not held. The fused ELBO and loss-and-gradient must launch
    the forward kernels of `step` (a step's launches) twice and K2 once.
    Returns the row, the failures and the plain f32 params (a copy)."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy

    same_jitter = JitterPolicy(initial=JitterPolicy().initial_for(
        torch.float32))
    plain = cfg._replace(use_fused=False, psi2_block=M256_PLAIN_BLOCK)
    p32 = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    p64 = {k: v.detach().double().requires_grad_()
           for k, v in params.items()}
    psi.reset_launch_counts()
    with torch.no_grad():
        fused_elbo = float(model.elbo(params, Y, cfg))
    g_fused = _grads(torch, model.loss(params, Y, cfg), params)
    torch.cuda.synchronize()
    launches = dict(psi.LAUNCHES)
    with torch.no_grad():
        elbo = dict(fused_f32=fused_elbo,
                    plain_f32=float(model.elbo(p32, Y, plain)),
                    plain_f64=float(model.elbo(p64, Y.double(), plain,
                                               same_jitter)))
    g32 = _grads(torch, model.loss(p32, Y, plain), p32)
    g64 = _grads(torch, -model.elbo(p64, Y.double(), plain, same_jitter),
                 p64)
    row = dict(
        elbo_init=elbo,
        elbo_rel_err_vs_plain_f32=abs(elbo["fused_f32"] - elbo["plain_f32"])
        / abs(elbo["plain_f32"]),
        elbo_rel_err_vs_plain_f64=abs(elbo["fused_f32"] - elbo["plain_f64"])
        / abs(elbo["plain_f64"]),
        plain_f32_elbo_rel_err_vs_f64=abs(elbo["plain_f32"]
                                          - elbo["plain_f64"])
        / abs(elbo["plain_f64"]),
        grad_scaled_err_vs_plain_f32=_scaled_gaps(g_fused, g32),
        grad_scaled_err_vs_plain_f64=_scaled_gaps(g_fused, g64),
        plain_f32_grad_scaled_err_vs_f64=_scaled_gaps(g32, g64),
        tol=TOL_ELBO, tol_grad=TOL_GRAD, init_launches=launches,
        f32_limited=[])
    failures = []
    gaps = [("elbo", row["elbo_rel_err_vs_plain_f32"],
             row["elbo_rel_err_vs_plain_f64"],
             row["plain_f32_elbo_rel_err_vs_f64"], TOL_ELBO)]
    gaps += [(f"grad {k}", row["grad_scaled_err_vs_plain_f32"][k],
              row["grad_scaled_err_vs_plain_f64"][k],
              row["plain_f32_grad_scaled_err_vs_f64"][k], TOL_GRAD)
             for k in g64]
    for what, vs32, vs64, plain_gap, tol in gaps:
        if f32_limited_ok and plain_gap > tol:
            row["f32_limited"].append(what)
        elif not (vs32 <= tol and vs64 <= tol):
            failures.append(f"{what}: fused {vs32} off plain f32, {vs64} "
                            f"off f64 (tolerance {tol})")
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update({k: n * (1 if k == "psi2_bwd_batched" else 2)
                     for k, n in step.items()})
    if launches != expected:
        failures.append(f"the fused ELBO and gradient launched {launches}, "
                        f"expected {expected}")
    return row, failures, p32


def _m256_model(torch, psi, model, params, Y, cfg, lr, ngd_lr, step,
                f32_limited_ok=False):
    """A model at M = 256: `_m256_init` at init; 10 fused steps (each
    launching `step`) and M256_PLAIN_STEPS plain f32 steps from the same
    init."""
    from dp_gp_lvm_tpu_torch.train.loop import gp_optimizer

    row, failures, p32 = _m256_init(torch, psi, model, params, Y, cfg, step,
                                    f32_limited_ok)
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update({k: 10 * n for k, n in step.items()})
    plain = cfg._replace(use_fused=False, psi2_block=M256_PLAIN_BLOCK)
    opt = gp_optimizer(params, lr=lr, ngd_lr=ngd_lr)
    losses, step_ms, launches = _ten_steps(
        torch, psi, lambda: model.loss(params, Y, cfg), params, opt)
    opt32 = gp_optimizer(p32, lr=lr, ngd_lr=ngd_lr)
    plain_losses, plain_ms, plain_launches = _ten_steps(
        torch, psi, lambda: model.loss(p32, Y, plain), p32, opt32,
        steps=M256_PLAIN_STEPS)
    row.update(losses=losses, ms_per_step_median=statistics.median(step_ms),
               ms_per_step=step_ms, launches=launches,
               expected_launches=expected, plain_losses=plain_losses,
               plain_ms_per_step_median=statistics.median(plain_ms),
               plain_launches=plain_launches)
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"non-finite loss in {losses}")
    if launches != expected:
        failures.append(f"launched {launches}, expected {expected}")
    if any(plain_launches.values()):
        failures.append(f"the plain path launched {plain_launches}")
    return row, failures


def _m256_serve(torch, seed, params, Y, cfg):
    """make_dp_imputer at M = 256: the build's launches, batches 1 and 32
    (ms a request, finite answers), and the f32 predictive at a fixed
    q(x*) against the plain f32 and f64 caches (printed)."""
    from dp_gp_lvm_tpu_torch.core.types import JitterPolicy
    from dp_gp_lvm_tpu_torch.models import prediction, serving
    from dp_gp_lvm_tpu_torch.ops import psi

    psi.reset_launch_counts()
    t0 = time.perf_counter()
    impute = serving.make_dp_imputer(params, Y, cfg, num_steps=SERVE_STEPS)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(psi.LAUNCHES)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    d = Y.shape[1]
    requests, failures = [], []
    for b in (1, 32):
        times = []
        for i in range(4):                       # one warm call, then 3
            y = torch.randn(b, d, generator=gen, device="cuda")
            mask = torch.ones(b, d, device="cuda")
            mask[:, d // 2:] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = impute(y, mask)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
        ok = (mean.shape == var.shape == (b, d)
              and bool(torch.isfinite(mean).all())
              and bool((var > 0).all()))
        if not ok:
            failures.append(f"bad answer at batch {b}")
        requests.append(dict(batch=b, ms_per_request=statistics.median(times)))
    plain = cfg._replace(use_fused=False, psi2_block=M256_PLAIN_BLOCK)
    same_jitter = JitterPolicy(initial=JitterPolicy().initial_for(
        torch.float32))
    qx = params["qx_mean"].detach()
    m_fix, s_fix = qx[:32], torch.full_like(qx[:32], 0.1)
    with torch.no_grad():
        fused = prediction.dp_predict_from_latent(
            *prediction.dp_posterior(params, Y, cfg), m_fix, s_fix)
        p32 = prediction.dp_predict_from_latent(
            *prediction.dp_posterior(params, Y, plain), m_fix, s_fix)
        c64, phi64 = prediction.dp_posterior(
            {k: v.detach().double() for k, v in params.items()}, Y.double(),
            plain, same_jitter)
        p64 = prediction.dp_predict_from_latent(c64, phi64, m_fix.double(),
                                                s_fix.double())
    gaps = {ref: {k: float((g.double() - w.double()).abs().max()
                           / w.double().abs().max())
                  for k, g, w in zip(("mean", "var"), fused, want)}
            for ref, want in (("plain_f32", p32), ("plain_f64", p64))}
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(suffstats_batched=1)
    if launches != expected:
        failures.append(f"dp_posterior launched {launches}, expected K1 "
                        "once")
    return dict(build_ms=build_ms, build_launches=launches,
                requests=requests, predict_scaled_err=gaps), failures


def _m256_gate(torch, psi, args32):
    """sum Psi2^2 through Psi2BatchedFused (K4 forward, K2 backward) on
    `args32` (vs, ards, mu, s, Zs; f32), value and gradient against the
    plain path in f64, and its launches."""
    from dp_gp_lvm_tpu_torch.ops import dispatch

    def run(tensors, use_fused):
        leaves = [x.detach().clone().requires_grad_() for x in tensors]
        p2 = dispatch.psi2_batched(*leaves, use_fused=use_fused)
        val = torch.sum(p2 * p2)
        return val.detach(), torch.autograd.grad(val, leaves)

    psi.reset_launch_counts()
    val32, g32 = run(args32, "auto")
    torch.cuda.synchronize()
    launches = dict(psi.LAUNCHES)
    val64, g64 = run([x.double() for x in args32], False)
    names = ("vs", "ards", "mu", "s", "Zs")
    return dict(shape=dict(zip("TNMQ", (*args32[4].shape[:1],
                                        args32[2].shape[0],
                                        *args32[4].shape[1:]))),
                value_rel_err=float((val32.double() - val64).abs()
                                    / val64.abs()),
                grad_scaled_err={n: float((g.double() - w).abs().max()
                                          / w.abs().max())
                                 for n, g, w in zip(names, g32, g64)},
                tol=TOL_GATE, launches=launches)


def _m256_synthetic(torch, psi, gen):
    """K1, K2, K4 and K5 on random inputs at M = 129, 192, 256, weighted
    and not, against their plain versions in f64, each repeated to the
    bit: the tiled forms at ragged and whole ranges."""
    held = []
    for M in M256_HELD_M:
        shape = dict(M256_HELD, M=M)
        f64, f32 = _inputs(torch, gen, **shape)
        G64 = torch.randn(shape["T"], M, M, generator=gen, device="cuda",
                          dtype=torch.float64)
        w64 = _weights(torch, gen, shape["N"])
        for w in (None, w64):
            w32 = None if w is None else w.float()
            calls = (
                ("suffstats_batched", tuple(f32[k] for k in
                                            ("vs", "ards", "mu", "s", "Zs",
                                             "Y")) + (w32,),
                 tuple(f64[k] for k in ("vs", "ards", "mu", "s", "Zs", "Y"))
                 + (w,)),
                ("psi2_bwd_batched", tuple(f32[k] for k in
                                           ("vs", "ards", "mu", "s", "Zs"))
                 + (G64.float(), w32),
                 tuple(f64[k] for k in ("vs", "ards", "mu", "s", "Zs"))
                 + (G64, w)),
                ("psi2_batched", tuple(f32[k] for k in
                                       ("vs", "ards", "mu", "s", "Zs"))
                 + (w32,), tuple(f64[k] for k in
                                 ("vs", "ards", "mu", "s", "Zs")) + (w,)),
                ("psi2_single", tuple(_single(f32).values()) + (w32,),
                 tuple(_single(f64).values()) + (w,)))
            for name, a32, a64 in calls:
                fn = getattr(psi, name)
                ref = getattr(psi, RUN_KERNELS[name][0])
                got, again, want = fn(*a32), fn(*a32), ref(*a64)
                got, again, want = (x if isinstance(x, tuple) else (x,)
                                    for x in (got, again, want))
                abs_err, scaled = _errors(got, want)
                held.append(dict(
                    kernel=name, M=M, weighted=w is not None,
                    max_abs_err=abs_err, scaled_err=scaled,
                    tol=RUN_KERNELS[name][1],
                    repeat_bitwise_equal=all(bool(torch.equal(x, y))
                                             for x, y in zip(got, again))))
    return held


def _k2_tiled_attributes():
    """Registers and local memory bytes a thread (the stack frame, spills
    included) of each tiled K2 instantiation, as the loaded module reports
    them (cudaFuncGetAttributes, so whether or not this run built it): the
    one-pass kernel (Q <= 10) and the one of passes of 8 columns."""
    from dp_gp_lvm_tpu_torch.ops import build

    query = build.function("psi2_bwd", "psi2_bwd_tiled_attributes")
    out = {}
    for Q in (10, 64):
        got = (ctypes.c_int * 4)()
        err = query(Q, ctypes.addressof(got))
        if err:
            raise RuntimeError(f"psi2_bwd_tiled_attributes failed at Q={Q} "
                               f"(CUDA error {err})")
        qt, ch, registers, local = got
        out[f"psi2_bwd_tiled_kernel<{qt}, {ch}>"] = dict(
            registers=registers, local_bytes=local)
    return out


def _k1_tiled_attributes():
    """Registers and local memory bytes a thread (the stack frame, spills
    included) of the tiled K1 body's Q = 10 instantiations, the pair body
    (K1, K4, K5) and K1's Psi1^T Y kernel, as the loaded module reports
    them (cudaFuncGetAttributes, so whether or not this run built it)."""
    from dp_gp_lvm_tpu_torch.ops import build

    query = build.function("psi_suffstats", "psi_suffstats_tiled_attributes")
    got = (ctypes.c_int * 5)()
    err = query(10, ctypes.addressof(got))
    if err:
        raise RuntimeError(f"psi_suffstats_tiled_attributes failed (CUDA "
                           f"error {err})")
    qc, body_regs, body_local, p1y_regs, p1y_local = got
    return {f"suffstats_tiled_kernel<{qc}>": dict(registers=body_regs,
                                                 local_bytes=body_local),
            f"p1y_tiled_kernel<{qc}>": dict(registers=p1y_regs,
                                           local_bytes=p1y_local)}


M256_LAUNCHES, M256_REPLAYS = 5, 3   # the m256 timings' CUDA graphs


def _parent_device_ms(torch, parent, calls):
    """Device ms of the parent checkout `parent`'s wrappers on the same
    inputs, timed as `_m256_timing` times this checkout's, in a child
    process of this script that imports the parent's package
    (`--time-inputs`): {name: ms}."""
    path = ROOT / "build" / "m256_inputs.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, path)
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--parent",
         str(parent), "--time-inputs", str(path)],
        capture_output=True, text=True, check=True, timeout=900).stdout
    return json.loads(out.splitlines()[-1])


def _time_inputs(torch, parent, path) -> int:
    """`--time-inputs`: time the wrappers of the package in `parent` on the
    arguments saved at `path` ({wrapper name: arguments}) and print
    {name: device ms} as the last line."""
    sys.path.insert(0, str(parent.resolve()))
    from dp_gp_lvm_tpu_torch.core.types import pin_full_f32
    from dp_gp_lvm_tpu_torch.ops import psi

    pin_full_f32()
    calls = torch.load(path)
    emit({name: _device_ms(lambda fn=getattr(psi, name), a=args: fn(*a),
                           torch, launches=M256_LAUNCHES,
                           replays=M256_REPLAYS)
          for name, args in calls.items()})
    return 0


def _m256_timing(torch, psi, args, name):
    """One kernel at M = 256 on `args`: device ms (5 launches in one CUDA
    graph), the wrapper's ms, its plain version's ms, the bound, and the
    launch geometry and the tiled kernels' registers and local memory;
    for K1, K4 and K5 also the FP32-issue floor."""
    shape, bound, by = _work_of(name, args)
    fn = getattr(psi, name)
    ref = getattr(psi, RUN_KERNELS[name][0])
    dev = _device_ms(lambda: fn(*args), torch, launches=M256_LAUNCHES,
                     replays=M256_REPLAYS)
    extra = {}
    if name == "psi2_bwd_batched":
        geometry = _k2_geometry(psi, shape)
        extra["attributes"] = _k2_tiled_attributes()
    else:
        geometry = _k1_geometry(psi, dict(dict(T=1, D=0), **shape))
        extra["attributes"] = _k1_tiled_attributes()
        extra["fp32_issue_ms"] = (
            k1_fp32_issue_ms(**shape) if "D" in shape
            else psi2_fp32_issue_ms(**dict(dict(T=1), **shape)))
    return dict(shape=shape, device_ms=dev, bound_ms=bound, bound_by=by,
                device_over_bound=dev / bound,
                ms=_timed(lambda: fn(*args), torch, reps=5, warmup=1),
                plain_ms=_timed(lambda: ref(*args), torch, reps=3, warmup=1),
                geometry=geometry, **extra)


# a step's launches on each family's fused path at M = 256
M256_STEP = dict(dp=dict(suffstats_batched=1, psi2_bwd_batched=1),
                 bgplvm=dict(psi1=1, psi2_single=1, psi2_bwd_batched=1))


def _random_cotangent(torch, seen, gen):
    """K2's first inputs on the paths with G replaced by a standard normal
    draw: the shapes and the mu, S and Z the paths gave K2, with a
    cotangent f32 resolves whatever K_uu's conditioning."""
    return {key: args[:5] + [torch.randn(args[5].shape, generator=gen,
                                         device="cuda")] + args[6:]
            for key, args in seen.items() if key[0] == "psi2_bwd_batched"}


def phase_m256(torch, seed, parent=None):
    from dp_gp_lvm_tpu_torch.core import prng
    from dp_gp_lvm_tpu_torch.core.config import CONFIGS
    from dp_gp_lvm_tpu_torch.data.synthetic import mocap_like, oil_flow_like
    from dp_gp_lvm_tpu_torch.models import bgplvm, dp_gp_lvm
    from dp_gp_lvm_tpu_torch.ops import psi

    t0 = time.perf_counter()
    key = prng.PRNGKey(seed)
    c4, c2 = CONFIGS["c4_dp_mocap"], CONFIGS["c2_sparse_oil"]
    failures = {}
    with _first_inputs(torch, psi) as seen:
        Y, _ = mocap_like(key, n=M256["N"], d=M256["D"], dtype=torch.float32)
        cfg = dp_gp_lvm.Config(num_latent=M256["Q"],
                               num_inducing=M256["M"],
                               truncation=M256["T"], alpha=c4.alpha)
        params = dp_gp_lvm.init_params(key, Y, cfg)
        dp, failures["dp"] = _m256_model(torch, psi, dp_gp_lvm, params, Y,
                                         cfg, c4.lr, c4.ngd_lr,
                                         M256_STEP["dp"])
        serve, failures["serve_dp"] = _m256_serve(torch, seed, params, Y,
                                                  cfg)
        Yb, _, _ = oil_flow_like(key, n=M256_BG["N"], d=M256_BG["D"],
                                 dtype=torch.float32)
        cfg_b = bgplvm.Config(num_latent=M256_BG["Q"],
                              num_inducing=M256_BG["M"])
        params_b = bgplvm.init_params(key, Yb, cfg_b)
        bg, failures["bgplvm"] = _m256_model(
            torch, psi, bgplvm, params_b, Yb, cfg_b, c2.lr, c2.ngd_lr,
            M256_STEP["bgplvm"], f32_limited_ok=True)
        # the gate on the DP step's first K1 inputs, cut to 2048 rows
        dp_args = next(a for k, a in seen.items()
                       if k[0] == "suffstats_batched")
        gate = _m256_gate(torch, psi, [x[:2048] if x.shape[0] == M256["N"]
                                       else x for x in dp_args[:5]])
    # the Bayesian GP-LVM where f32 resolves it: on the DP path's data
    bg_held, failures["bgplvm_mocap"], _ = _m256_init(
        torch, psi, bgplvm, bgplvm.init_params(key, Y, cfg_b), Y, cfg_b,
        M256_STEP["bgplvm"])
    # the first inputs of each kernel on the paths: the DP step's K1 and
    # K2, the Bayesian step's K6, K5 and K2 (T = 1), the gate's K4
    first = {}
    for key, args in seen.items():
        first.setdefault(key[0] + ("_t1" if key[0] == "psi2_bwd_batched"
                                   and args[4].shape[0] == 1 else ""), args)
    held = _hold_first_inputs(torch, psi, seen)
    for h, (key, args) in zip(held, seen.items()):
        # the plain version's own f32 error on the same inputs: how far f32
        # can resolve these outputs at all
        ref = getattr(psi, RUN_KERNELS[key[0]][0])
        got = ref(*args)
        want = ref(*(a.double() if torch.is_tensor(a) else a for a in args))
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        h["plain_f32_scaled_err"] = _errors(got, want)[1]
        h["plain_f32_scaled_err_by_output"] = [
            float((g.double() - w).abs().max() / w.abs().max().clamp_min(
                1e-30)) for g, w in zip(got, want)]
        # K2's G carries K_uu's conditioning (the Bayesian GP-LVM's on
        # oil_flow_like): where the plain f32 version misses too, printed
        h["f32_limited"] = (key[0] == "psi2_bwd_batched"
                            and h["plain_f32_scaled_err"] > h["tol"])
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    held_random_g = _hold_first_inputs(torch, psi,
                                       _random_cotangent(torch, seen, gen))
    synthetic = _m256_synthetic(torch, psi, gen)
    timing = dict(
        suffstats_batched=_m256_timing(torch, psi, dp_args,
                                       "suffstats_batched"),
        psi2_bwd_batched=_m256_timing(torch, psi, first["psi2_bwd_batched"],
                                      "psi2_bwd_batched"),
        psi2_bwd_batched_t1=_m256_timing(torch, psi,
                                         first["psi2_bwd_batched_t1"],
                                         "psi2_bwd_batched"),
        psi2_batched=_m256_timing(torch, psi, tuple(dp_args[:5]) + (None,),
                                  "psi2_batched"),
        psi2_single=_m256_timing(torch, psi, first["psi2_single"],
                                 "psi2_single"))
    # K1's body on the same inputs in the parent checkout, when given
    calls = dict(suffstats_batched=list(dp_args),
                 psi2_batched=list(dp_args[:5]) + [None],
                 psi2_single=list(first["psi2_single"]))
    parent_ms = (_parent_device_ms(torch, parent, calls) if parent
                 else dict.fromkeys(calls))
    for name, ms in parent_ms.items():
        timing[name].update(parent=None if parent is None else str(parent),
                            parent_device_ms=ms)
    row = dict(phase="m256", dp=dict(config=M256, **dp),
               bgplvm=dict(config=M256_BG, **bg),
               bgplvm_on_dp_data=dict(config=dict(M256_BG, D=M256["D"]),
                                      **bg_held),
               serve_dp=serve, gate=gate, held_on_path_inputs=held,
               held_on_path_inputs_random_g=held_random_g,
               held_synthetic=synthetic, timing=timing,
               seconds=time.perf_counter() - t0)
    emit(row)
    failures = [f"{k}: {v}" for k, vs in failures.items() for v in vs]
    if not (gate["value_rel_err"] <= TOL_GATE
            and max(gate["grad_scaled_err"].values()) <= TOL_GATE):
        failures.append(f"gate: fused disagrees with plain: {gate}")
    expected = dict.fromkeys(psi.LAUNCHES, 0)
    expected.update(psi2_batched=1, psi2_bwd_batched=1)
    if gate["launches"] != expected:
        failures.append(f"gate launched {gate['launches']}")
    if len(held_random_g) != 3:
        failures.append(f"K2 held with a random G at {len(held_random_g)} "
                        "shapes, expected 3 (DP step, Bayesian step, gate)")
    for h in held_random_g:
        if not h["scaled_err"] <= TOL_K2_RANDOM_G:
            failures.append(f"K2 with a random G past {TOL_K2_RANDOM_G}: "
                            f"{h}")
    for h in held + held_random_g + synthetic:
        if not ((h.get("f32_limited") or h["scaled_err"] <= h["tol"])
                and h["repeat_bitwise_equal"]):
            failures.append(f"kernel off its plain version or not "
                            f"repeatable: {h}")
    for name, t in timing.items():
        form = t["geometry"].get("super_tiles", t["geometry"].get("ranges"))
        if form is None:
            failures.append(f"{name} did not run its tiled form at M = 256")
    for kernel, a in timing["psi2_bwd_batched"]["attributes"].items():
        if not 0 < a["registers"] <= 128:
            failures.append(f"{kernel} takes {a['registers']} registers a "
                            "thread, past two 256-thread blocks an SM")
    # the pair body at two 256-thread blocks an SM, the Psi1^T Y kernel at
    # four: registers within that cap, and no local memory (no spill)
    caps = dict(suffstats=128, p1y=64)
    for kernel, a in timing["suffstats_batched"]["attributes"].items():
        cap = caps[kernel.split("_")[0]]
        if not (0 < a["registers"] <= cap and a["local_bytes"] == 0):
            failures.append(f"{kernel} takes {a['registers']} registers "
                            f"and {a['local_bytes']} bytes of local memory "
                            f"a thread: past its cap of {cap}, or a spill")
    if failures:
        raise AssertionError("m256: " + "; ".join(failures))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="an older checkout whose K1, K4 and K5 the m256 "
                         "phase also times on its inputs")
    ap.add_argument("--time-inputs", type=pathlib.Path, default=None,
                    help=argparse.SUPPRESS)   # the --parent child's mode
    ap.add_argument("--time-steps", action="store_true",
                    help=argparse.SUPPRESS)   # the --parent child's mode
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.time_inputs:
        return _time_inputs(torch, args.parent, args.time_inputs)
    if args.time_steps:
        return _time_steps_child(torch, args.parent, args.seed)
    if not (ROOT / "dp_gp_lvm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the dp_gp_lvm_tpu_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dp_gp_lvm_tpu_torch.core.types import pin_full_f32
    from dp_gp_lvm_tpu_torch.ops import build, psi
    from dp_gp_lvm_tpu_torch.perf import H100_PEAKS

    PEAKS.update(H100_PEAKS)
    pin_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              nvcc=[ln for ln in nvcc.splitlines() if "release" in ln],
              capability=torch.cuda.get_device_capability(0),
              device=torch.cuda.get_device_name(0), card=card))

    t0 = time.perf_counter()
    build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln]
             for n, log in build.ptxas_log.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas))

    phase_steps(torch, args.seed, args.parent, card.splitlines()[0])
    # from here every launch is counted on the card as well, so that the
    # replayed steps' host counts are held against the card's
    psi.count_on_card("cuda")
    psi.reset_launch_counts()
    _checked_resets(psi)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    k1 = phase_k1(torch, psi, gen)
    k2 = phase_k2(torch, psi, gen)
    k6 = phase_k6(torch, psi, gen)
    k5 = phase_k5(torch, psi, gen)
    k4 = phase_k4(torch, psi, gen)
    gate = phase_gate(torch, psi, gen)
    train, dp_params, dp_Y, dp_cfg = phase_train(torch, args.seed)
    phase_scale(torch, psi, gen)
    m256 = phase_m256(torch, args.seed, args.parent)
    train2, bg_params, bg_Y, bg_cfg = phase_train_bgplvm(torch, args.seed)
    serve2 = phase_serve_bgplvm(torch, args.seed, bg_params, bg_Y, bg_cfg)
    serve5 = phase_serve_dp(torch, args.seed, dp_params, dp_Y, dp_cfg)
    cavi = phase_cavi(torch, dp_params, dp_Y, dp_cfg)
    linear = phase_linear(torch, args.seed)
    runs = phase_runs(torch, args.seed)
    mesh_rows, mesh_run = phase_mesh(torch, args.seed, card.splitlines()[0],
                                     runs)
    files = phase_files(torch, args.seed)
    lbfgs = phase_lbfgs(torch, args.seed)
    phase_mfu(torch, train)
    serve3 = phase_serve_mrd(torch, args.seed)
    svi = phase_svi(torch, args.seed)
    streamed = phase_stream(torch, args.seed, svi)
    dp = phase_dp_svi(torch, args.seed)
    amort = phase_amortized(torch, args.seed)
    c9 = phase_mrd_svi(torch, args.seed)
    mesh_svi, mesh_svi_runs = phase_mesh_svi(torch, args.seed,
                                             card.splitlines()[0], svi, dp)
    phase_sgpr(torch, args.seed)
    phase_trace(torch, args.seed, dp_params, dp_Y, dp_cfg)

    # `launches` of a kernel is its count over the path named in
    # `launches_of`; `launches_by_phase` lists every driven path, the
    # server builds (one posterior each), the CAVI step, the linear
    # kernel's training (none) and the runner's run of each gated config
    paths = dict(train="10 training steps of c4_dp_mocap",
                 train_bgplvm="10 training steps of c2_sparse_oil",
                 gate="one value and gradient of sum Psi2^2")
    phases = dict(train=train["launches"], train_bgplvm=train2["launches"],
                  gate=gate["launches"],
                  m256_dp=m256["dp"]["launches"],
                  m256_bgplvm=m256["bgplvm"]["launches"],
                  m256_serve_dp_build=m256["serve_dp"]["build_launches"],
                  m256_gate=m256["gate"]["launches"],
                  serve_bgplvm_build=serve2["build_launches"],
                  serve_dp_build=serve5["build_launches"],
                  cavi=cavi["launches"], linear=linear["launches"],
                  serve_mrd_build=serve3["build_launches"],
                  **{f"runs_{name}": row["launches"]
                     for name, row in runs.items()},
                  **{f"mesh_{name}": row["launches"]
                     for name, row in mesh_rows.items()},
                  mesh_run_c4_dp_mocap=mesh_run["launches"],
                  **{f"files_{name}": row["launches"]
                     for name, row in files.items()},
                  lbfgs_f32=lbfgs["f32"]["launches"],
                  svi_c6_svi_bigN=svi["launches"],
                  stream_c6_svi_bigN=streamed["launches"],
                  dp_svi_c7_dp_svi=dp["launches"],
                  amortized_c8_amortized_svi=amort["launches"],
                  amortized_stream_c8_amortized_svi=amort[
                      "streamed_launches"],
                  mrd_svi_c9_mrd_svi_bigN=c9["launches"],
                  **{f"mesh_svi_{name}": row["launches"]
                     for name, row in mesh_svi.items()},
                  **{f"mesh_svi_run_{name}": row["launches"]
                     for name, row in mesh_svi_runs.items()})
    csrc = "dp_gp_lvm_tpu_torch/csrc"
    pallas = "dp_gp_lvm_tpu/ops/pallas/psi.py"

    def kernel_row(name, source, line, main, res):
        return dict(name=name, route="cuda", source=f"{csrc}/{source}",
                    replaces=f"{pallas}:{line}",
                    launches=phases[main][name], launches_of=paths[main],
                    launches_by_phase={ph: c[name]
                                       for ph, c in phases.items()},
                    max_abs_err=res["max_abs_err"], ms=res["ms"],
                    device_ms=res["device_ms"],
                    device_over_bound=res["device_ms"] / res["bound_ms"],
                    plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                    bound_by=res["bound_by"], library_ms=None)

    c3 = runs["c3_mrd_twoview"]

    def at_c3(name, build=False):
        """A kernel's device ms and bound at c3's widths, on the first
        inputs the runs phase's c3 run gave it, and its launches in that
        run (c3_run_steps optimizer steps, training and timing) or in the
        serve_mrd phase's posterior build."""
        t = c3["kernels_at_c3"][name]
        launches = ({"c3_build_launches": serve3["build_launches"][name]}
                    if build else
                    {"c3_run_launches": c3["launches"][name],
                     "c3_run_steps": c3["steps_taken"]})
        return {"c3_shape": t["shape"], "c3_device_ms": t["device_ms"],
                "c3_ms": t["ms"], "c3_plain_ms": t["plain_ms"],
                "c3_bound_ms": t["bound_ms"], "c3_bound_by": t["bound_by"],
                **launches}

    def at_c7(name):
        """A kernel at c7's minibatch (T = 8, N = 2048) on the first inputs
        the dp_svi phase's run gave it, and its launches a step there."""
        t = dp["kernels_at_c7"][f"{name} T=8 N=2048"]
        return {"c7_shape": t["shape"], "c7_device_ms": t["device_ms"],
                "c7_ms": t["ms"], "c7_plain_ms": t["plain_ms"],
                "c7_bound_ms": t["bound_ms"], "c7_bound_by": t["bound_by"],
                "c7_launches_per_step": {
                    s["stage"]: s["launches_per_step"][name]
                    for s in dp["stages"]}}

    def at_c8(name):
        """A kernel at c8's minibatch (T = 1, N = 1024) on the first inputs
        the amortized phase's run gave it, and its launches a step there,
        resident and streamed."""
        t = amort["kernels_at_c8"][name]
        return {"c8_shape": t["shape"], "c8_device_ms": t["device_ms"],
                "c8_ms": t["ms"], "c8_plain_ms": t["plain_ms"],
                "c8_bound_ms": t["bound_ms"], "c8_bound_by": t["bound_by"],
                "c8_launches_per_step": amort["launches_per_step"][name],
                "c8_streamed_launches_per_step": amort[
                    "streamed_launches_per_step"][name]}

    def at_c9(name):
        """A kernel at a c9 view's minibatch (T = 1, N = 1024, M = 32,
        Q = 4, D = 32) on the first inputs the mrd_svi phase's run gave
        it, and its launches a step there by phase (two views)."""
        t = c9["kernels_at_c9"][f"{name} T=1 N=1024"]
        return {"c9_shape": t["shape"], "c9_device_ms": t["device_ms"],
                "c9_ms": t["ms"], "c9_plain_ms": t["plain_ms"],
                "c9_bound_ms": t["bound_ms"], "c9_bound_by": t["bound_by"],
                "c9_launches_per_step": {
                    s["stage"]: s["launches_per_step"][name]
                    for s in c9["stages"]}}

    def on_mesh(name):
        """A kernel's launches a step on the 1 x 1 mesh (mesh_svi phase)."""
        return {c: r["launches_per_step"][name] for c, r in mesh_svi.items()}

    def at_m256(name, *timed):
        """A kernel at M = 256 (the m256 phase, its tiled form): device ms,
        ms, plain ms and bound on the paths' inputs, its launches on each
        m256 path and its largest error against f64 in the held holds
        (those not f32-limited). The geometry keeps its launch
        configuration (integers); the m256 phase's row has the rest (waves,
        fill, balance, FP32-issue floor), worked out from the shapes."""
        t = m256["timing"][timed[0] if timed else name]
        errs = [h["max_abs_err"] for h in m256["held_on_path_inputs"]
                + m256["held_on_path_inputs_random_g"]
                + m256["held_synthetic"]
                if h["kernel"] == name and not h.get("f32_limited")]
        out = {"m256_shape": t["shape"], "m256_device_ms": t["device_ms"],
               "m256_ms": t["ms"], "m256_plain_ms": t["plain_ms"],
               "m256_bound_ms": t["bound_ms"], "m256_bound_by": t["bound_by"],
               "m256_geometry": {k: v for k, v in t["geometry"].items()
                                 if isinstance(v, int)},
               "m256_attributes": t["attributes"],
               "m256_max_abs_err": max(errs),
               "m256_launches": {
                   "dp_10_steps": m256["dp"]["launches"][name],
                   "bgplvm_10_steps": m256["bgplvm"]["launches"][name],
                   "serve_dp_build": m256["serve_dp"]["build_launches"][name],
                   "gate": m256["gate"]["launches"][name]}}
        for extra in timed[1:]:
            e = m256["timing"][extra]
            out.update({f"m256_{extra}_shape": e["shape"],
                        f"m256_{extra}_device_ms": e["device_ms"],
                        f"m256_{extra}_plain_ms": e["plain_ms"],
                        f"m256_{extra}_bound_ms": e["bound_ms"]})
        if "parent_device_ms" in t:
            out.update(m256_parent_device_ms=t["parent_device_ms"],
                       m256_redesigned_in="twentieth slice of the port")
        return out

    c7_full = dp["kernels_at_c7"]["suffstats_batched T=8 N=131072"]
    c9_full = c9["kernels_at_c9"]["suffstats_batched T=1 N=131072"]
    kernels = [
        dict(kernel_row("suffstats_batched", "psi_suffstats.cu", 610,
                        "train", k1),
             redesigned_in="fifth slice of the port",
             scale_device_ms=k1["scale"]["device_ms"],
             scale_plain_ms=k1["scale"]["plain_ms"],
             scale_bound_ms=k1["scale"]["bound_ms"],
             c6_device_ms=svi["kernels_at_c6"]["suffstats_batched"][
                 "device_ms"],
             c6_bound_ms=svi["kernels_at_c6"]["suffstats_batched"][
                 "bound_ms"],
             c6_launches_per_step=svi["launches_per_step"][
                 "suffstats_batched"],
             c6_streamed_launches_per_step=streamed["launches_per_step"][
                 "suffstats_batched"],
             cavi_launches=cavi["launches"]["suffstats_batched"],
             **at_c3("suffstats_batched"), **at_c7("suffstats_batched"),
             **at_c8("suffstats_batched"),
             c7_full_n_device_ms=c7_full["device_ms"],
             c7_full_n_bound_ms=c7_full["bound_ms"],
             c7_full_n_ms=c7_full["ms"],
             c7_full_n_plain_ms=c7_full["plain_ms"],
             **at_c9("suffstats_batched"),
             c9_full_n_shape=c9_full["shape"],
             c9_full_n_device_ms=c9_full["device_ms"],
             c9_full_n_bound_ms=c9_full["bound_ms"],
             c9_full_n_ms=c9_full["ms"],
             c9_full_n_plain_ms=c9_full["plain_ms"],
             mesh_svi_launches_per_step=on_mesh("suffstats_batched"),
             **at_m256("suffstats_batched")),
        dict(kernel_row("psi2_bwd_batched", "psi2_bwd.cu", 359, "train", k2),
             redesigned_in="fourth slice of the port",
             c2_device_ms=k2["c2"]["device_ms"],
             c2_plain_ms=k2["c2"]["plain_ms"],
             scale_device_ms=k2["scale"]["device_ms"],
             scale_plain_ms=k2["scale"]["plain_ms"],
             scale_bound_ms=k2["scale"]["bound_ms"],
             c6_device_ms=svi["kernels_at_c6"]["psi2_bwd_batched"][
                 "device_ms"],
             c6_bound_ms=svi["kernels_at_c6"]["psi2_bwd_batched"][
                 "bound_ms"],
             c6_launches_per_step=svi["launches_per_step"][
                 "psi2_bwd_batched"],
             c6_streamed_launches_per_step=streamed["launches_per_step"][
                 "psi2_bwd_batched"],
             **at_c3("psi2_bwd_batched"), **at_c7("psi2_bwd_batched"),
             **at_c8("psi2_bwd_batched"), **at_c9("psi2_bwd_batched"),
             mesh_svi_launches_per_step=on_mesh("psi2_bwd_batched"),
             **at_m256("psi2_bwd_batched", "psi2_bwd_batched",
                       "psi2_bwd_batched_t1"),
             m256_redesigned_in="nineteenth slice of the port"),
        dict(kernel_row("psi2_batched", "psi_suffstats.cu", 244, "gate", k4),
             redesigned_in="sixth slice of the port",
             scale_device_ms=k4["scale"]["device_ms"],
             scale_plain_ms=k4["scale"]["plain_ms"],
             scale_bound_ms=k4["scale"]["bound_ms"],
             **at_m256("psi2_batched")),
        dict(kernel_row("psi2_single", "psi_suffstats.cu", 66,
                        "train_bgplvm", k5),
             redesigned_in="sixth slice of the port",
             scale_device_ms=k5["scale_device_ms"],
             scale_plain_ms=k5["scale_plain_ms"],
             scale_bound_ms=k5["scale_bound_ms"],
             **at_c3("psi2_single", build=True), **at_m256("psi2_single")),
        dict(kernel_row("psi1", "psi1.cu", 179, "train_bgplvm", k6),
             redesigned_in="seventh slice of the port",
             scale_device_ms=k6["scale_device_ms"],
             scale_plain_ms=k6["scale_plain_ms"],
             scale_bound_ms=k6["scale_bound_ms"],
             **at_c3("psi1", build=True)),
    ]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel was never launched: {kernels}")
    psi.reset_launch_counts()                   # the last comparison
    emit(dict(phase="total", seconds=time.perf_counter() - t_start,
              launch_count_checks=COUNT_CHECKS["checks"],
              launch_count_mismatches=COUNT_CHECKS["mismatches"]))
    if COUNT_CHECKS["mismatches"]:
        raise AssertionError(f"the card counted other launches than the "
                             f"host: {COUNT_CHECKS['mismatches']}")
    print(card.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
