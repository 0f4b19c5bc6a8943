"""Tracing / profiling hooks (port of ``pylamp_tpu/utils/profiling.py``):
named phases for the PyTorch profiler and a lightweight per-phase
wall-clock accumulator for the driver.

Usage:
    with phase("stokes"):
        ...
    start_trace("/tmp/trace")  # Chrome trace via torch.profiler
    ...
    stop_trace()               # writes /tmp/trace/trace.json
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_timings: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_trace: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Named profiler range + wall-clock accumulation (host time: the
    caller synchronizes the device where it wants device time in it)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _timings[name] += time.perf_counter() - t0
    _counts[name] += 1


def phase_report() -> dict:
    return {
        name: {"total_s": round(t, 4), "count": _counts[name]}
        for name, t in sorted(_timings.items())
    }


def reset_phases():
    _timings.clear()
    _counts.clear()


def start_trace(logdir: str):
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device; ``stop_trace`` writes it to
    ``<logdir>/trace.json``."""
    if _trace:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace.update(prof=prof, logdir=logdir)


def stop_trace():
    prof, logdir = _trace.pop("prof"), _trace.pop("logdir")
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
