"""van Keken et al. (1997) isothermal Rayleigh-Taylor benchmark on one GPU:
the port's counterpart of ``scripts/validate_van_keken.py``.

    python -m pylamp_tpu_torch.models.validate_van_keken --out PATH
        [--nx 512] [--t-end 400] [--max-steps N] [--allow-drops]
        [--device cpu] [--x64]

The isoviscous case (BASELINE config 4) is tracked step by step; its v_rms
peaks at ~3.0916e-3 around t ~ 209 (published community values for case
1a). The run stops at ``t_end`` or once clearly past the peak (v_rms below
0.6 of it). The configuration is the script's (``config``: reseeding below
2 markers per cell, Courant 0.5, dt_max 2), in f32 on the card by default.
The run stops at the first step that does not converge or drops a marker
(``--allow-drops``: drops are counted instead) and exits non-zero after
writing its summary. Prints the script's progress line every 100 steps and
one JSON summary line, and writes the summary and the per-step v_rms
series to ``--out``.
"""
from __future__ import annotations

import dataclasses

import torch

from pylamp_tpu_torch.models import validation
from pylamp_tpu_torch.models.benchmarks import rt_van_keken, vrms_box
from pylamp_tpu_torch.models.config import SolverConfig

VAN_KEKEN_VRMS_PEAK = 3.0916e-3
VAN_KEKEN_T_PEAK = 208.99


def config(nx: int = 512):
    """The script's configuration (scripts/validate_van_keken.py:135-141)."""
    cfg = rt_van_keken(nx=nx, ny=nx, max_steps=10**9)
    return dataclasses.replace(
        cfg,
        physics=dataclasses.replace(cfg.physics, reseed_min_per_cell=2),
        solver=SolverConfig(stokes_tol=1e-8, stokes_restart=40,
                            stokes_maxiter=200),
        time=dataclasses.replace(cfg.time, courant=0.5, dt_max=2.0))


def run(nx=512, t_end=400.0, max_steps=0, device="cuda",
        dtype=torch.float32, allow_drops=False):
    """Steps the run; returns (summary, per-step series)."""
    r = validation.Run(config(nx), dtype, device, allow_drops)
    peak_v, peak_t = 0.0, 0.0
    series = []
    with r.stopping():
        while r.time < t_end and not (max_steps and r.n >= max_steps):
            diag = r.step()
            vr = float(vrms_box(r.state.vx, r.state.vy))
            tnow = r.time
            series.append({"step": r.n, "t": tnow, "vrms": vr,
                           "iters": int(diag["stokes_iterations"]),
                           "converged": bool(diag["stokes_converged"]),
                           "dropped": int(diag.get("markers_dropped", 0))})
            if vr > peak_v:
                peak_v, peak_t = vr, tnow
            if r.n % 100 == 0:
                print(f"step {r.n} t={tnow:.1f} vrms={vr:.5e} "
                      f"iters={int(diag['stokes_iterations'])} "
                      f"wall={r.wall():.0f}s", flush=True)
            # stop once clearly past the peak
            if peak_v > 1e-3 and vr < 0.6 * peak_v:
                break
    past_peak = (peak_v > 1e-3 and bool(series)
                 and series[-1]["vrms"] < 0.6 * peak_v)
    summary = {
        "benchmark": "van_keken_1997_case1a",
        "nx": nx,
        "vrms_peak": peak_v,
        "t_peak": peak_t,
        "ref_vrms_peak": VAN_KEKEN_VRMS_PEAK,
        "ref_t_peak": VAN_KEKEN_T_PEAK,
        "err_vrms_rel": abs(peak_v - VAN_KEKEN_VRMS_PEAK)
        / VAN_KEKEN_VRMS_PEAK,
        "err_t_rel": abs(peak_t - VAN_KEKEN_T_PEAK) / VAN_KEKEN_T_PEAK,
        "steps": r.n,
        "time_nondim": r.time,
        "past_peak": past_peak,
        "capped": bool(max_steps) and r.n >= max_steps and not past_peak
        and r.time < t_end,
        "iters_per_step": sum(s["iters"] for s in series) / max(r.n, 1),
        "wall_s": r.wall(),
        **r.record(),
    }
    return summary, series


def main(argv=None):
    args = validation.arguments(__doc__, 512, t_end=(float, 400.0)
                                ).parse_args(argv)
    validation.check_device(args.device)
    summary, series = run(
        args.nx, args.t_end, args.max_steps, args.device,
        torch.float64 if args.x64 else torch.float32,
        args.allow_drops)
    validation.finish(args.out, summary, series=series)


if __name__ == "__main__":
    main()
