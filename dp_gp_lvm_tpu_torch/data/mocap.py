"""CMU mocap data IO (counterpart of `dp_gp_lvm_tpu/data/mocap.py`): the
AMC joint-angle parser, the channel preprocessing, and the loader with its
synthetic fallback.

The AMC motion-capture text format:

    :FULLY-SPECIFIED / :DEGREES header lines
    <frame number>
    bonename v1 v2 ...      (one line per bone, channels in ASF order)

`parse_amc` returns the per-frame concatenation of all bone channels, in
the first frame's bone order. It is the plain version of the native
parser (`data/native_io.py::parse_amc_native`). `write_amc` writes frames
in that format. Without a file
`load_mocap` draws the `synthetic.mocap_like` surrogate at the given
(N, D).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.types import resolve_device


def parse_amc(path: str):
    """Parse an AMC file -> (frames (N, D) float64, channel names list)."""
    frames: list[dict[str, list[float]]] = []
    current: dict[str, list[float]] | None = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith(":"):
                continue
            if line.isdigit():
                if current:
                    frames.append(current)
                current = {}
                continue
            if current is None:
                continue
            parts = line.split()
            current[parts[0]] = [float(v) for v in parts[1:]]
    if current:
        frames.append(current)
    if not frames:
        raise ValueError(f"no frames parsed from {path}")
    bones = list(frames[0].keys())
    names = [f"{b}:{i}" for b in bones for i in range(len(frames[0][b]))]
    data = np.asarray(
        [[v for b in bones for v in fr[b]] for fr in frames], dtype=np.float64
    )
    return data, names


def write_amc(path: str, Y, bones) -> str:
    """Write the frames Y (N, D) as an AMC file: `bones` is a list of
    (name, channels) whose channels sum to D, dealt the columns in order.
    Each value is written as its shortest round-trip decimal, so
    `parse_amc` reads Y back to the bit. Returns path."""
    Y = np.asarray(Y, dtype=np.float64)
    widths = [w for _, w in bones]
    if sum(widths) != Y.shape[1]:
        raise ValueError(f"bones take {sum(widths)} channels, Y has "
                         f"{Y.shape[1]}")
    edges = np.cumsum([0] + widths)
    with open(path, "w") as fh:
        fh.write(":FULLY-SPECIFIED\n:DEGREES\n")
        for i, row in enumerate(Y.tolist(), 1):
            fh.write(f"{i}\n")
            for (name, _), lo, hi in zip(bones, edges[:-1], edges[1:]):
                fh.write(" ".join([name, *map(repr, row[lo:hi])]) + "\n")
    return path


def preprocess(Y: np.ndarray, drop_constant: bool = True):
    """Standardize the channels (numpy, ddof 0), first dropping those whose
    std is at most 1e-8 (constant channels), as is conventional for GP-LVM
    mocap experiments."""
    std = Y.std(axis=0)
    if drop_constant:
        keep = std > 1e-8
        Y = Y[:, keep]
        std = std[keep]
    return (Y - Y.mean(axis=0)) / std


def load_mocap(path: str | None = None, n: int = 1024, d: int = 59,
               subsample: int = 1, dtype=torch.float64, device=None,
               rng=None):
    """Load an AMC file if it exists, else draw mocap-like data from `rng`
    (default the reference's `PRNGKey(0)`). From a file `n` and `d` are
    ignored: every frame is kept, then every `subsample`-th, and D is what
    `preprocess` keeps. Returns (Y (N, D), source tag) on `device` (the
    card unless the caller says "cpu")."""
    device = resolve_device(device)
    if path and os.path.exists(path):
        Y, _ = parse_amc(path)
        # row-major, as the kernels take Y: the channel mask leaves
        # numpy's result column-major
        Y = np.ascontiguousarray(preprocess(Y[::subsample]))
        return (torch.tensor(Y, dtype=dtype, device=device),
                f"amc:{os.path.basename(path)}")
    from dp_gp_lvm_tpu_torch.data import synthetic

    rng = rng if rng is not None else prng.PRNGKey(0)
    Y, _ = synthetic.mocap_like(rng, n=n, d=d, dtype=dtype, device=device)
    return Y, "synthetic:mocap_like"
