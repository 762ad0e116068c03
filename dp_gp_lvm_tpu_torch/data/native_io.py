"""ctypes bindings of the native AMC parser (counterpart of
`dp_gp_lvm_tpu/data/native_io.py`), and the g++ build the port's native
data code shares.

`csrc/amc_parser.cpp` (a plain C ABI, no pybind11) is built by g++ at
first use into `build/kernels/libamc_parser-<hash>.so`, the hash taken
over its source and flags, so an edited source is rebuilt; never at
import. Where no compiler builds it, `available()` is False and
`parse_amc_native` raises; it never answers with the Python parser's
result (`data/mocap.py::parse_amc`, which stays the plain version the
tests hold it against).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "amc_parser.cpp"
BUILD_DIR = _PKG.parent / "build" / "kernels"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
_BUILD_ERR: str | None = None


def library_path(source: pathlib.Path, stem: str,
                 flags: list[str]) -> pathlib.Path:
    """Where `source` is built: the name carries a hash of the source and
    the flags."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_library(source: pathlib.Path, stem: str,
                  flags: list[str]) -> pathlib.Path:
    """g++-build `source` into `library_path(...)` unless it is there
    (written to a temporary name first, so a concurrent build never loads
    half a file). Raises OSError or SubprocessError where it cannot."""
    so = library_path(source, stem, flags)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, so)
    return so


def _build_and_load():
    global _BUILD_ERR
    try:
        so = build_library(SOURCE, "amc_parser", GXX_FLAGS)
    except (OSError, subprocess.SubprocessError) as e:
        _BUILD_ERR = f"native build failed: {e}"
        return None
    lib = ctypes.CDLL(str(so))
    lib.amc_parse.restype = ctypes.c_int
    lib.amc_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.amc_free.restype = None
    lib.amc_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    return lib


def _get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None and _BUILD_ERR is None:
            _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    """Whether the native parser builds and loads (built here on the first
    call)."""
    return _get_lib() is not None


def parse_amc_native(path: str) -> np.ndarray:
    """Parse an AMC file with the C++ parser -> (N, D) float64 array. A
    frame whose bones differ from the first frame's (order, names or
    channel counts) raises; short trailing frames are dropped."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(_BUILD_ERR or "native parser unavailable")
    data = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    err = ctypes.create_string_buffer(512)
    rc = lib.amc_parse(
        os.fsencode(path), ctypes.byref(data), ctypes.byref(rows),
        ctypes.byref(cols), err, len(err),
    )
    if rc != 0:
        raise ValueError(
            f"amc_parse({path!r}) failed rc={rc}: {err.value.decode()}"
        )
    try:
        out = np.ctypeslib.as_array(data, shape=(rows.value,
                                                 cols.value)).copy()
    finally:
        lib.amc_free(data)
    return out
