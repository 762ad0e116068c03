"""Host-streamed minibatch feed over a host-resident dataset (counterpart of
`dp_gp_lvm_tpu/data/stream.py`).

The minibatch SVI step touches O(batch) rows a step, so Y only has to be
addressable from the host, not resident on the card. The native loader
(`csrc/stream_loader.cpp`, built by g++ at first use into `build/kernels/`
and bound with ctypes) mmaps a row-major float32 file and gathers the rows
of a minibatch on a C++ worker thread that runs without the GIL.
`ChunkStream` stacks `chunk` minibatches into one (chunk, batch, d) block,
the unit the training loop runs between host reads, and double-buffers:
while the card runs chunk k, the worker gathers chunk k+1.

The indices are the reference's draw bit for bit: `numpy.random.Generator(
numpy.random.Philox(seed)).integers(0, n, (chunk, batch), int32)`.
`NumpyLoader` is the plain version of the gather, with the same API.

For a CUDA device `ChunkStream` gathers into pinned host buffers and
copies each chunk to the card with `non_blocking`; the copy out of a
buffer is waited for (a CUDA event) before the worker refills it.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.data import native_io

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "stream_loader.cpp"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIB = None
_BUILD_ERR: str | None = None


def library_path() -> pathlib.Path:
    """Where the loader is built: the name carries a hash of the source
    and the flags, so an edited source is rebuilt."""
    return native_io.library_path(SOURCE, "stream_loader", GXX_FLAGS)


def _build_and_load():
    try:
        so = native_io.build_library(SOURCE, "stream_loader", GXX_FLAGS)
    except (OSError, subprocess.SubprocessError) as e:
        global _BUILD_ERR
        _BUILD_ERR = f"native build failed: {e}"
        return None
    lib = ctypes.CDLL(str(so))
    lib.sl_open.restype = ctypes.c_void_p
    lib.sl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.sl_request.restype = ctypes.c_int
    lib.sl_request.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_float)]
    lib.sl_wait.restype = ctypes.c_int
    lib.sl_wait.argtypes = [ctypes.c_void_p]
    lib.sl_rows.restype = ctypes.c_int64
    lib.sl_rows.argtypes = [ctypes.c_void_p]
    lib.sl_dims.restype = ctypes.c_int64
    lib.sl_dims.argtypes = [ctypes.c_void_p]
    lib.sl_close.restype = None
    lib.sl_close.argtypes = [ctypes.c_void_p]
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None and _BUILD_ERR is None:
            _LIB = _build_and_load()
    return _LIB


def native_available() -> bool:
    """Whether the native loader builds and loads (it is built here on the
    first call)."""
    return _lib() is not None


def write_rows(path: str, Y) -> str:
    """Write Y (n, d) in the loader's format: raw row-major float32, no
    header (the caller keeps the shape). Returns path."""
    arr = np.ascontiguousarray(np.asarray(Y, dtype=np.float32))
    if arr.ndim != 2:
        raise ValueError(f"expected an (n, d) matrix, got shape {arr.shape}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        arr.tofile(f)
    os.replace(tmp, path)
    return path


class NumpyLoader:
    """The plain gather, with the native loader's API (synchronous:
    `request` gathers, `wait` reports a bad index)."""

    def __init__(self, path: str, n: int, d: int):
        self.n, self.d = int(n), int(d)
        self._data = np.memmap(path, dtype=np.float32, mode="r",
                               shape=(self.n, self.d))
        self._err = 0

    def request(self, idx: np.ndarray, out: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int32)
        if idx.min(initial=0) < 0 or idx.max(initial=-1) >= self.n:
            self._err = -2
            return
        np.take(self._data, idx, axis=0, out=out.reshape(idx.size, self.d))
        self._err = 0

    def wait(self) -> None:
        if self._err:
            raise IndexError(f"row index out of range (status {self._err})")

    def close(self) -> None:
        del self._data


class StreamLoader:
    """The native mmap and asynchronous gather; one request in flight
    (`ChunkStream` double-buffers on top)."""

    def __init__(self, path: str, n: int, d: int):
        lib = _lib()
        if lib is None:
            raise RuntimeError(_BUILD_ERR or "native loader unavailable")
        self._lib = lib
        self.n, self.d = int(n), int(d)
        self._inflight = None
        self._h = lib.sl_open(path.encode(), self.n, self.d)
        if not self._h:
            raise OSError(f"sl_open failed for {path!r} (missing file or "
                          f"size < {self.n}x{self.d} float32)")

    def request(self, idx: np.ndarray, out: np.ndarray) -> None:
        """Start gathering rows idx into out ((count, d) or flat float32,
        C-contiguous) on the worker thread and return at once; out must
        stay alive until `wait`."""
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        if out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous float32")
        if out.size != idx.size * self.d:
            raise ValueError(f"out holds {out.size} floats, the request "
                             f"{idx.size} x {self.d}")
        rc = self._lib.sl_request(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            idx.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(f"sl_request failed (status {rc}; a previous "
                               "request still outstanding?)")
        self._inflight = (idx, out)    # alive until the gather ends

    def wait(self) -> None:
        rc = self._lib.sl_wait(self._h)
        self._inflight = None
        if rc != 0:
            raise IndexError(f"row index out of range (status {rc})")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def open_loader(path: str, n: int, d: int):
    """The native loader where g++ builds it, else `NumpyLoader` (the same
    API). A caller that must have the native one makes a `StreamLoader`."""
    if native_available():
        return StreamLoader(path, n, d)
    return NumpyLoader(path, n, d)


class ChunkStream:
    """Double-buffered stream of chunks: each `next_chunk()` is (idx, y),
    idx (chunk, batch) drawn uniformly from [0, n) with replacement and y
    (chunk, batch, d) float32 the rows at idx. `skip_chunks` fast-forwards
    the index stream past chunks a checkpointed run consumed (draws only,
    no gathers).

    With `device` None it gives numpy arrays, as the reference does: y
    aliases a buffer that the next call's prefetch overwrites, so consume
    it first. With a device it gives tensors there (idx as int64) that own
    their memory: for a CUDA device the buffers are pinned and the copy is
    asynchronous, waited for before the worker refills its buffer.
    `wait_s` counts the host seconds `next_chunk` spent waiting for the
    gather."""

    def __init__(self, loader, batch: int, chunk: int, seed: int = 0,
                 skip_chunks: int = 0, device=None):
        self.loader = loader
        self.batch = int(batch)
        self.chunk = int(chunk)
        self.device = None if device is None else torch.device(device)
        self._rng = np.random.Generator(np.random.Philox(seed))
        for _ in range(int(skip_chunks)):
            self._draw()
        shape = (self.chunk, self.batch, loader.d)
        self._cuda = self.device is not None and self.device.type == "cuda"
        if self._cuda:
            # the worker writes through numpy views of pinned tensors
            self._pinned = [torch.empty(shape, dtype=torch.float32,
                                        pin_memory=True) for _ in range(2)]
            self._pinned_idx = [torch.empty(shape[:2], dtype=torch.int32,
                                            pin_memory=True)
                                for _ in range(2)]
            self._buf = [t.numpy() for t in self._pinned]
        else:
            self._buf = [np.empty(shape, np.float32) for _ in range(2)]
        self._copied = [None, None]    # CUDA event after each slot's copy
        self._idx = [None, None]
        self._slot = 0
        self._primed = False
        self.wait_s = 0.0

    def _draw(self):
        return self._rng.integers(0, self.loader.n,
                                  size=(self.chunk, self.batch),
                                  dtype=np.int32)

    def _begin(self, slot: int) -> None:
        idx = self._draw()
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()   # the copy out of this buffer
            self._copied[slot] = None
        self._idx[slot] = idx
        self.loader.request(idx.reshape(-1), self._buf[slot].reshape(-1))

    def _to_device(self, slot: int, idx: np.ndarray, y: np.ndarray):
        if not self._cuda:
            return (torch.from_numpy(idx).to(self.device, torch.int64),
                    torch.from_numpy(y).to(self.device, copy=True))
        np.copyto(self._pinned_idx[slot].numpy(), idx)
        idx_d = self._pinned_idx[slot].to(self.device, non_blocking=True)
        y_d = self._pinned[slot].to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._copied[slot] = event
        return idx_d.long(), y_d

    def next_chunk(self):
        """(idx, y) of the next chunk; starts the gather of the one after."""
        if not self._primed:
            self._begin(self._slot)
            self._primed = True
        slot = self._slot
        t0 = time.perf_counter()
        self.loader.wait()
        self.wait_s += time.perf_counter() - t0
        idx, y = self._idx[slot], self._buf[slot]
        if self.device is not None:
            idx, y = self._to_device(slot, idx, y)
        self._slot = 1 - slot
        self._begin(self._slot)        # prefetch the next chunk
        return idx, y

    def close(self) -> None:
        try:
            self.loader.wait()         # drain the gather in flight
        except IndexError:
            pass
        for event in self._copied:
            if event is not None:
                event.synchronize()
        self.loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
