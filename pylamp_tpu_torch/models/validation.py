"""What the port's validation runs share (``validate_blankenbach``,
``validate_van_keken``, ``validate_blankenbach_2a``, ``validate_fk_lid``):
the command line, the device record and a step loop that stops on the
first step that does not converge or drops a marker (the run then writes
the summary of the steps before it and exits non-zero), and counts
seconds, Krylov iterations and kernel launches per step.

Each run takes its configuration from the JAX package's script of the same
name, switch for switch, builds it with ``models.setup.build`` on the card
(``--device cpu`` for the tests), prints the script's periodic progress
line and one JSON summary line, and writes the summary (with any series)
to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

from pylamp_tpu_torch.utils.artifacts import write_json_artifact

# the launch counters of every kernel wrapper (and of their periodic and
# rho0 * alpha forms)
COUNTERS = ("launches", "launches_periodic", "launches_ra")
# the JAX package's records of the same runs (TPU v5e), read for their
# step counts only: the length of a full run that a capped run projects
RECORDS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "validation")


class StepFailure(RuntimeError):
    """A step that did not converge or dropped a marker."""


def arguments(doc: str, nx: int, **extra) -> argparse.ArgumentParser:
    """The shared command line: ``--out`` (required), ``--nx``,
    ``--device`` (cuda unless the caller asks for cpu), ``--x64`` (an f64
    state; the scripts' is f32), ``--max-steps`` (cap the run).  ``extra``
    maps further ``--name`` options to (type, default)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="JSON file for the summary (a git-ignored path)")
    ap.add_argument("--nx", type=int, default=nx)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--x64", action="store_true",
                    help="f64 state (the scripts run f32)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after this many steps (0: the run's own "
                         "stop rule only)")
    ap.add_argument("--allow-drops", action="store_true",
                    help="count markers dropped by a full bucket instead of "
                         "stopping at the first (the JAX scripts neither "
                         "count nor stop)")
    for name, (typ, default) in extra.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=typ,
                        default=default)
    return ap


def device_record(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def check_device(device):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device (run with --device cpu for the CPU)")


def kernel_modules() -> dict:
    """Every kernel wrapper module by its kernel's name."""
    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.ops.kernels import (
        cheb,
        cheb_block,
        coarse_vcycle,
        momentum,
        saddle,
        saddle_block,
    )

    return dict(saddle=saddle, m2g=m2g, advect=advect, rebucket=rebucket,
                cheb=cheb, coarse_vcycle=coarse_vcycle, momentum=momentum,
                cheb_block=cheb_block, saddle_block=saddle_block,
                m2g_block=m2g_block, advect_block=advect_block,
                rebucket_block=rebucket_block)


def _counts(mods) -> dict:
    return {f"{k}.{f}": getattr(mod, f) for k, mod in mods.items()
            for f in COUNTERS if hasattr(mod, f)}


class Run:
    """A model built on ``device`` and stepped by ``make_step``: each
    ``step()`` synchronizes the device around the step, raises
    ``StepFailure`` on a Stokes solve that did not converge or (unless
    ``allow_drops``) a dropped marker, and adds to the seconds, Krylov,
    drop and launch tallies.  A run
    loop steps inside ``with run.stopping():``, which ends the loop at a
    failed step and keeps its message in ``failure``: the summary of the
    steps before it is still written."""

    def __init__(self, cfg, dtype, device, allow_drops: bool = False):
        from pylamp_tpu_torch.models.setup import build
        from pylamp_tpu_torch.models.step import make_step, sync_device

        self.device = torch.device(device)
        self.sync = sync_device
        self.grid, self.table, self.state = build(cfg, dtype=dtype,
                                                  device=self.device)
        self._step = make_step(self.grid, cfg, self.table)
        self.mods = kernel_modules()
        self.start = _counts(self.mods)
        self.n = 0
        self.failure = None
        self.converged = True
        self.allow_drops = allow_drops
        self.dropped = 0
        self.first_drop = None
        self.step_s = []
        self.krylov = []
        self.t0 = time.perf_counter()

    def step(self):
        self.sync(self.device)
        t0 = time.perf_counter()
        self.state, diag = self._step(self.state)
        self.sync(self.device)
        self.step_s.append(time.perf_counter() - t0)
        self.n += 1
        self.krylov.append(int(diag["stokes_iterations"]))
        dropped = int(diag.get("markers_dropped", 0))
        if dropped and self.first_drop is None:
            self.first_drop = self.n
        self.dropped += dropped
        if not bool(diag["stokes_converged"]):
            self.converged = False
            raise StepFailure(
                f"step {self.n}: the Stokes solve did not converge "
                f"(relative residual {float(diag['stokes_residual_rel']):.3e}"
                f" after {self.krylov[-1]} iterations)")
        if dropped and not self.allow_drops:
            raise StepFailure(f"step {self.n}: {dropped} markers dropped")
        return diag

    @contextlib.contextmanager
    def stopping(self):
        try:
            yield
        except StepFailure as e:
            self.failure = str(e)
            print(f"stopped: {e}", flush=True)

    @property
    def time(self) -> float:
        return float(self.state.time)

    def wall(self) -> float:
        return time.perf_counter() - self.t0

    def record(self) -> dict:
        """The port's own keys of a summary: device, seconds and Krylov
        iterations per step, kernel launches per step."""
        n = max(self.n, 1)
        now = _counts(self.mods)
        launches = {k: (now[k] - self.start[k]) / n for k in now
                    if now[k] != self.start[k]}
        return {
            "device": device_record(self.device),
            "dtype": str(self.state.vx.dtype).removeprefix("torch."),
            # the first step pays one-time set-up (kernel build, allocator)
            "seconds_per_step": (sum(self.step_s[1:]) / (n - 1) if n > 1
                                 else sum(self.step_s)),
            "seconds_first_step": self.step_s[0] if self.step_s else None,
            "krylov_per_step": sum(self.krylov) / n,
            "krylov_max": max(self.krylov, default=0),
            "kernel_launches_per_step": launches,
            # the failed step, if any (the run stops there)
            "failure": self.failure,
            "all_converged": self.converged,
            "markers_dropped": self.dropped,
            "first_drop_step": self.first_drop,
            "allow_drops": self.allow_drops,
        }


def record_steps(name: str):
    """Steps of the JAX package's record ``validation/<name>.json`` (None
    without one)."""
    path = os.path.join(RECORDS, f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("steps")


def finish(out: str, summary: dict, **series):
    """Print the summary as one JSON line and write it, with ``series``,
    to ``out``; exit non-zero if the run failed (its ``failure``)."""
    write_json_artifact(out, {"summary": summary, **series})
    print(json.dumps(summary), flush=True)
    if summary.get("failure"):
        sys.exit(f"validation run failed: {summary['failure']}")
