"""Training records and profiler scopes (counterpart of
`dp_gp_lvm_tpu/train/logging.py`): `JsonlLogger`, one JSON line per chunk;
`TensorBoardLogger`, the same scalars as TensorBoard events; `named_scope`,
a region of a `torch.profiler` trace. The loggers are pure host-side: call
them with values already read from the device, at the logging cadence,
never inside the hot loop."""
from __future__ import annotations

import json
import time
from typing import IO, Any

import torch


class JsonlLogger:
    """One JSON line per `log` call: the step, the wall seconds since the
    previous call, and the scalars (as floats where they convert)."""

    def __init__(self, path: str | None = None, stream: IO | None = None):
        self._fh = open(path, "a") if path else stream
        self._t_last = time.perf_counter()

    def log(self, step: int, **scalars: Any):
        now = time.perf_counter()
        rec = {
            "step": int(step),
            "wall_dt_s": round(now - self._t_last, 6),
        }
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._t_last = now
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()


class TensorBoardLogger:
    """TensorBoard scalar writer through `torch.utils.tensorboard`. Where
    the `tensorboard` package does not import, the logger is inactive
    (`active` is False) and `log` does nothing, so the library never
    depends on it."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(log_dir=logdir)

    @property
    def active(self) -> bool:
        return self._writer is not None

    def log(self, step: int, **scalars: Any):
        if self._writer is None:
            return
        for k, v in scalars.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self._writer.add_scalar(k, value, global_step=int(step))
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


def named_scope(name: str):
    """A named region of a `torch.profiler` trace (the reference's
    `jax.named_scope`): `with named_scope("psi_stats"): ...`."""
    return torch.profiler.record_function(name)
