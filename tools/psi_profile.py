#!/usr/bin/env python3
"""Time the Psi kernels on the card, CUDA kernel by CUDA kernel: K1 (fused
Psi2 + Psi1^T Y, `ops/psi.py::suffstats_batched`), K2 (the fused Psi2
pullback, `psi2_bwd_batched`), K4 (the Psi2 stack, `psi2_batched`), K5
(one kernel's Psi2, `psi2_single`) and K6 (Psi1, `psi1`).

    python3 tools/psi_profile.py [--root DIR] [--kernel k1|k2|k4|k5|k6]
                                 [--chunks C[,C...]] [--out FILE]

Imports `dp_gp_lvm_tpu_torch` from DIR (default: the checkout holding this
script), so that an older checkout unpacked beside this one is timed by
the same script, and builds that checkout's kernels. K1 at the c4 (T=20,
N=1024, M=64, D=59), scale (T=20, N=8192, M=128, D=60) and, in its tiled
form, m256 (M=256) shapes, K2 at c4, c2 (T=1, N=1000, M=50), scale and
m256 (T=20 and T=1, N=8192, M=256), K4 at c4, scale and m256, K5 and K6
at c2 and scale (N=8192, M=128), K5 also at m256 (N=8192, M=256), all
Q=10: one JSON line per kernel and shape
with the device ms per call of each CUDA kernel the wrapper launches (the
main kernel and any chunk reduction), from `torch.profiler`'s `key_averages()`
over 20 wrapper calls, and the wrapper's ms (one call between two CUDA
events, host work included, median of 20); then the card's name and power
limit as `nvidia-smi` gives them. With `--out` the lines are also written to FILE.
With `--chunks` it times only K1, K4 and K5 at m256, their tiled form,
through its C entries with each chunk count given in place of the one
the wrapper picks (the partials sized from DIR's `k1_launch_geometry`),
one line per kernel and count. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys

K1_SHAPES = dict(c4=dict(T=20, N=1024, M=64, Q=10, D=59),
                 scale=dict(T=20, N=8192, M=128, Q=10, D=60),
                 m256=dict(T=20, N=8192, M=256, Q=10, D=60))
K2_SHAPES = dict(c4=dict(T=20, N=1024, M=64, Q=10),
                 c2=dict(T=1, N=1000, M=50, Q=10),
                 scale=dict(T=20, N=8192, M=128, Q=10),
                 m256=dict(T=20, N=8192, M=256, Q=10),
                 m256_t1=dict(T=1, N=8192, M=256, Q=10))
K4_SHAPES = dict(c4=K2_SHAPES["c4"], scale=K2_SHAPES["scale"],
                 m256=K2_SHAPES["m256"])
K6_SHAPES = dict(c2=K2_SHAPES["c2"], scale=dict(T=1, N=8192, M=128, Q=10))
K5_SHAPES = dict(K6_SHAPES, m256=K2_SHAPES["m256_t1"])
CALLS = 20


def _kernel_ms(torch, fn):
    """{kernel name: device ms per wrapper call} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = (getattr(evt, "device_time_total", None)
              or getattr(evt, "cuda_time_total", 0) or 0)
        if us > 0 and not evt.key.startswith(("cuda", "aten::")):
            out[evt.key] = us / 1e3 / CALLS
    return out


def _wrapper_ms(torch, fn, calls=CALLS):
    """Median ms of one call of `fn` between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(torch, gen, kernel, T, N, M, Q, D=None):
    """The wrapper's arguments: K1 takes Y (N, D), K2 a cotangent (T, M, M),
    K5 and K6 the first atom only."""
    kw = dict(generator=gen, device="cuda")
    args = [0.5 + torch.rand(T, **kw), 0.3 + 1.7 * torch.rand(T, Q, **kw),
            torch.randn(N, Q, **kw), 0.05 + 0.55 * torch.rand(N, Q, **kw),
            torch.randn(T, M, Q, **kw)]
    if kernel == "k1":
        return args + [torch.randn(N, D, **kw)]
    if kernel == "k2":
        return args + [torch.randn(T, M, M, **kw)]
    if kernel in ("k5", "k6"):
        return [args[0][0], args[1][0], args[2], args[3], args[4][0]]
    return args


def _tiled_at_chunks(torch, psi, kernel, args32, T, N, M, Q, D=0,
                     chunks=1):
    """A call of the tiled K1 body's C entry (`psi_suffstats_tiled_f32`,
    at D = 0 `psi2_batched_tiled_f32`) on the wrapper's arguments `args32`
    with `chunks` chunks (as many as that count's rows a chunk need), its
    partials sized from the geometry the wrapper would take."""
    from dp_gp_lvm_tpu_torch.ops import build

    geo = psi.k1_launch_geometry("cuda", T, N, M, Q, D)
    rows = math.ceil(N / chunks)
    chunks = math.ceil(N / rows)
    part = torch.empty(chunks * (geo.part_floats // geo.chunks),
                       device="cuda")
    psi2 = torch.empty(T, M, M, device="cuda")
    var, ard, mu, s, z = args32[:5]
    head = (var.data_ptr(), ard.data_ptr(), mu.data_ptr(), s.data_ptr(),
            None, z.data_ptr())
    tail = (geo.stage_rows, rows, chunks,
            torch.cuda.current_stream().cuda_stream)
    if kernel == "k1":
        p1y = torch.empty(T, M, D, device="cuda")
        fn = build.function("psi_suffstats", "psi_suffstats_tiled_f32")
        call = head + (args32[5].data_ptr(), part.data_ptr(),
                       psi2.data_ptr(), p1y.data_ptr(), T, N, M, Q, D) + tail
    else:
        fn = build.function("psi_suffstats", "psi2_batched_tiled_f32")
        call = head + (part.data_ptr(), psi2.data_ptr(), T, N, M, Q) + tail

    def launch():
        if fn(*call) != 0:
            raise RuntimeError(f"{kernel} failed at {chunks} chunks")
    return chunks, launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--kernel", choices=("k1", "k2", "k4", "k5", "k6"),
                    default=None)
    ap.add_argument("--chunks", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("psi_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from dp_gp_lvm_tpu_torch.ops import psi

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lines = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, shapes, fn in (("k1", K1_SHAPES, psi.suffstats_batched),
                               ("k2", K2_SHAPES, psi.psi2_bwd_batched),
                               ("k4", K4_SHAPES, psi.psi2_batched),
                               ("k5", K5_SHAPES, psi.psi2_single),
                               ("k6", K6_SHAPES, psi.psi1)):
        if args.kernel not in (None, kernel):
            continue
        for name, sh in shapes.items():
            if args.chunks:
                if name != "m256" or kernel not in ("k1", "k4", "k5"):
                    continue
                args32 = _inputs(torch, gen, kernel, **sh)
                for c in map(int, args.chunks.split(",")):
                    c, launch = _tiled_at_chunks(
                        torch, psi, kernel, args32, **dict(dict(T=1), **sh),
                        chunks=c)
                    lines.append(dict(root=args.root, kernel=kernel,
                                      shape=name, **sh, chunks=c,
                                      kernels=_kernel_ms(torch, launch)))
                continue
            args32 = _inputs(torch, gen, kernel, **sh)
            lines.append(dict(root=args.root, kernel=kernel, shape=name,
                              **sh, kernels=_kernel_ms(
                                  torch, lambda: fn(*args32)),
                              wrapper_ms=_wrapper_ms(
                                  torch, lambda: fn(*args32))))
    lines.append(dict(card=card))
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
