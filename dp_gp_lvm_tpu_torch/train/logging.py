"""Structured per-chunk training records (counterpart of
`dp_gp_lvm_tpu/train/logging.py::JsonlLogger`). Pure host-side: call it
with values already read from the device, at the logging cadence, never
inside the hot loop. `TensorBoardLogger` and `named_scope` wait for a later
slice."""
from __future__ import annotations

import json
import time
from typing import IO, Any


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
