"""Sticky-air free-surface relaxation on one GPU (BASELINE config 5): the
port's counterpart of ``scripts/validate_sticky_air.py``.

    python -m pylamp_tpu_torch.models.validate_sticky_air --out PATH
        [--nx 1024] [--steps 80]

An initial 7 km cosine topography on a high-viscosity lithosphere relaxes
toward isostasy (Crameri et al. 2012, their case-1 geometry); the surface
is tracked through the air/rock marker interface every 5 steps, and the
relaxation time tau is fitted to the amplitude history.  The run takes
``sticky_air_bench_config(nx)`` (the tuned preset at nx x nx // 4, 1e-8
Stokes tolerance, the MG momentum kernel on) in f32 on the card, and checks
that every step converges and the decay is monotonic.  It prints one JSON summary line and writes it, with
the amplitude series, to ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pylamp_tpu_torch.markers.bucket import bucket_markers_to_grid
from pylamp_tpu_torch.models.benchmarks import KYR, sticky_air_bench_config


def surface_amplitude(state, grid):
    """Air/rock interface from the marker 'rockness' field: in each corner
    column, the depth where the rock fraction first crosses 0.5, linearly
    interpolated.  Returns (half the peak-to-peak amplitude, interface)."""
    m = state.markers
    rock = (m.mat > 0).to(m.x.dtype)
    frac, w = bucket_markers_to_grid(m, rock, grid, "corner")
    frac = torch.where(w > 0, frac, 0.0).double().cpu().numpy()
    ny1, nx1 = frac.shape
    ys = np.linspace(0.0, grid.ly, ny1)
    iface = np.zeros(nx1)
    for i in range(nx1):
        col = frac[:, i]
        idx = int(np.argmax(col >= 0.5))
        if idx == 0:
            continue
        f0, f1 = col[idx - 1], col[idx]
        t = (0.5 - f0) / max(f1 - f0, 1e-12)
        iface[i] = ys[idx - 1] + t * (ys[idx] - ys[idx - 1])
    dev = iface - iface.mean()
    return 0.5 * (dev.max() - dev.min()), iface


def fit_tau(ts, amps):
    """Relaxation time of amp(t) = amp0 exp(-t / tau), fitted over the
    samples above a fifth of the initial amplitude (nan with <= 3)."""
    ts, amps = np.asarray(ts), np.asarray(amps)
    sel = amps > 0.2 * amps[0]
    if sel.sum() <= 3:
        return float("nan")
    return float(-1.0 / np.polyfit(ts[sel], np.log(amps[sel] / amps[0]), 1)[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="JSON file for the summary and amplitude series")
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("validate_sticky_air: no CUDA device")

    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    cfg = sticky_air_bench_config(args.nx)
    grid, table, state = build(cfg, dtype=torch.float32, device="cuda")
    step = make_step(grid, cfg, table)
    amp0, _ = surface_amplitude(state, grid)
    print(f"t=0: amplitude={amp0 / 1e3:.3f} km", flush=True)
    hist = [(0.0, amp0)]
    series, iters, step_s = [], [], []
    all_converged = True
    for n in range(1, args.steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        iters.append(int(diag["stokes_iterations"]))
        all_converged &= bool(diag["stokes_converged"])
        if n % 5 == 0 or n == args.steps:
            amp, _ = surface_amplitude(state, grid)
            t_kyr = float(state.time) / KYR
            hist.append((t_kyr, amp))
            series.append({"step": n, "t_kyr": t_kyr, "amp_m": float(amp),
                           "iters": iters[-1],
                           "converged": bool(diag["stokes_converged"]),
                           "rel_residual": float(diag["stokes_residual_rel"])})
            print(f"step {n} t={t_kyr:.2f} kyr amp={amp / 1e3:.3f} km "
                  f"iters={iters[-1]} conv={bool(diag['stokes_converged'])} "
                  f"dt={float(diag['dt']) / KYR:.3f} kyr "
                  f"step={step_s[-1]:.3f} s", flush=True)

    ts = [h[0] for h in hist]
    amps = np.array([h[1] for h in hist])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    summary = {
        "benchmark": "crameri_2012_style_sticky_air",
        "nx": grid.nx, "ny": grid.ny, "steps": args.steps,
        "amp0_km": float(amps[0] / 1e3),
        "amp_final_km": float(amps[-1] / 1e3),
        "tau_kyr": fit_tau(ts, amps),
        "monotonic_decay": bool(np.all(np.diff(amps) < 0.05 * amps[0])),
        "all_converged": all_converged,
        "iters_min": min(iters), "iters_max": max(iters),
        "iters_mean": float(np.mean(iters)),
        # the first step pays one-time set-up (kernel build, allocator)
        "seconds_per_step": float(np.mean(step_s[1:] or step_s)),
        "seconds_first_step": step_s[0],
        "device": smi,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "series": series, "step_s": step_s,
                   "iters": iters}, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
