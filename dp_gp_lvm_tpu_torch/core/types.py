"""Numerics policy (counterpart of `dp_gp_lvm_tpu/core/types.py`) and the
device rule of the port's entry points.

Every function computes in the dtype of its inputs: f64 on the CPU parity
path, f32 on the GPU. The jitter policy is scale-aware (relative to the
mean diagonal) and escalates on Cholesky failure (see linalg/chol.py).
"""
from __future__ import annotations

import dataclasses

import torch

DEFAULT_JITTER = 1e-6


@dataclasses.dataclass(frozen=True)
class JitterPolicy:
    """Scale-aware escalating jitter for Cholesky factorizations.

    ``initial`` is relative to the mean |diagonal|; on failure the jitter
    is multiplied by ``growth`` up to ``max_tries`` times. ``initial_f32``
    replaces ``initial`` for float32 matrices, where a 1e-6 jitter leaves
    chol(K_uu)^-1 amplifying rounding noise once ARD weights collapse.
    """

    initial: float = DEFAULT_JITTER
    growth: float = 10.0
    max_tries: int = 6
    initial_f32: float = 1e-4

    def initial_for(self, dtype) -> float:
        if dtype == torch.float64:
            return self.initial
        return max(self.initial, self.initial_f32)


def finfo_eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def pin_full_f32() -> None:
    """Keep float32 products on the GPU in full f32, never TF32.

    TF32 keeps ~3 decimal digits, which the exponentiated distances of
    the psi statistics cannot afford (the GPU's twin of the TPU's bf16
    matmul demotion)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Device of an entry point: CUDA unless the caller names another.

    With no card and no explicit device this raises instead of running
    on the CPU behind the caller's back.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
