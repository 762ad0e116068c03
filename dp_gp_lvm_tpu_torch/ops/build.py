"""Build the CUDA kernels under `csrc/` at first use and bind them with
ctypes through their plain C interface.

Each source is compiled by nvcc for `sm_90a` into a shared library under
`build/kernels/` at the repository root (git-ignored); the file name
carries a hash of the source, so an edited source is rebuilt. `build_all`
starts one nvcc per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C entry points of each source: {function name: argtypes}; every one
# returns the CUDA error of its launches as an int
SIGNATURES = {
    "psi_suffstats": {"psi_suffstats_f32": [P] * 10 + [I] * 9 + [P],
                      "psi2_batched_f32": [P] * 8 + [I] * 8 + [P],
                      "psi_suffstats_blocks_per_sm": [I] * 5,
                      "psi_suffstats_tiled_f32": [P] * 10 + [I] * 8 + [P],
                      "psi2_batched_tiled_f32": [P] * 8 + [I] * 7 + [P],
                      "psi_suffstats_tiled_blocks_per_sm": [I] * 3,
                      "psi_suffstats_tiled_attributes": [I, P]},
    "psi2_bwd": {"psi2_bwd_f32": [P] * 16 + [I] * 7 + [P],
                 "psi2_bwd_blocks_per_sm": [I] * 3,
                 "psi2_bwd_tiled_f32": [P] * 16 + [I] * 6 + [P],
                 "psi2_bwd_tiled_blocks_per_sm": [I],
                 "psi2_bwd_tiled_attributes": [I, P]},
    "psi1": {"psi1_f32": [P] * 7 + [I] * 5 + [P],
             "psi1_blocks_per_sm": [I] * 2},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _load(name: str, path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all(names=tuple(SIGNATURES)) -> None:
    """Compile every missing library in parallel, then load them all."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = [(n, *_start(n)) for n in todo if not _target(n).exists()]
        failures = []
        for name, proc, tmp, out in started:
            log, _ = proc.communicate()
            ptxas_log[name] = log
            if proc.returncode != 0:
                failures.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed\n" + "\n".join(failures))
        for name in todo:
            _libs[name] = _load(name, _target(name))


def function(name: str, entry: str | None = None):
    """C entry point `entry` (default `<name>_f32`) of `csrc/<name>.cu`,
    built on first use."""
    if name not in _libs:
        build_all((name,))
    return getattr(_libs[name], entry or f"{name}_f32")
