"""Oil-flow dataset IO (counterpart of `dp_gp_lvm_tpu/data/oil_flow.py`:
Bishop & James's three-phase flow, N=1000, D=12).

`load_oil_flow` reads `DataTrn.txt` (and `DataTrnLbls.txt`, one-hot rows)
from a directory when it holds them, else falls back to the
`synthetic.oil_flow_like` surrogate of the same shape, drawn from the
reference's `PRNGKey(0)`. The source tag says which was taken.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dp_gp_lvm_tpu_torch.core import prng
from dp_gp_lvm_tpu_torch.core.types import resolve_device


def load_oil_flow(directory: str | None = None, dtype=torch.float64,
                  device=None, rng=None):
    """Returns (Y (1000, 12), labels (1000,), source tag) on `device` (the
    card unless the caller says "cpu"). From files Y is standardized with
    numpy's population std (ddof 0) and the labels are the argmax of the
    label rows, or zeros without the label file."""
    device = resolve_device(device)
    if directory:
        data_p = os.path.join(directory, "DataTrn.txt")
        lbl_p = os.path.join(directory, "DataTrnLbls.txt")
        if os.path.exists(data_p):
            Y = np.loadtxt(data_p)
            Y = (Y - Y.mean(axis=0)) / Y.std(axis=0)
            if os.path.exists(lbl_p):
                lbls = np.argmax(np.loadtxt(lbl_p), axis=1)
            else:
                lbls = np.zeros(len(Y), dtype=int)
            return (torch.tensor(np.ascontiguousarray(Y), dtype=dtype,
                                 device=device),
                    torch.tensor(lbls, dtype=torch.int64, device=device),
                    "file:oil_flow")
    from dp_gp_lvm_tpu_torch.data import synthetic

    rng = rng if rng is not None else prng.PRNGKey(0)
    Y, labels, _ = synthetic.oil_flow_like(rng, n=1000, d=12, dtype=dtype,
                                           device=device)
    return Y, labels, "synthetic:oil_flow_like"
