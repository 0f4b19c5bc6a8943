"""Structured per-step metrics (port of ``pylamp_tpu/io/logging.py``): one
JSON line per step with the driver's quantities (v_rms, vmax, dt, Krylov
iterations, residuals, wall time per phase).

A 0-d tensor or numpy array becomes a Python float, as ``float()`` of a
0-d jnp array does in the reference, so a line holds the values the
reference writes; reading a 0-d tensor on the card syncs the host once.
A value with more than one element is an error."""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch


def _scalar(key, v):
    if torch.is_tensor(v) or isinstance(v, (np.ndarray, np.generic)):
        if v.ndim != 0:
            raise ValueError(f"metrics value {key!r} has shape "
                             f"{tuple(v.shape)}: only 0-d values are logged")
        return float(v)
    return v


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = False):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def log(self, record: dict):
        record = {k: _scalar(k, v) for k, v in record.items()}
        record.setdefault("wall_s", time.perf_counter() - self._t0)
        line = json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
