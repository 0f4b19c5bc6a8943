"""Blankenbach et al. (1989) case 2a on one GPU: the port's counterpart of
``scripts/validate_blankenbach_2a.py``.

    python -m pylamp_tpu_torch.models.validate_blankenbach_2a --out PATH
        [--nx 64] [--max-time 0.2] [--max-wall-s 0] [--max-steps N]
        [--allow-drops] [--device cpu] [--x64]

Temperature-dependent viscosity convection, Ra0 = 1e4 (top-viscosity
Rayleigh number), viscosity ratio 1e3 (eta = exp(-ln(1e3) T)); published
steady-state values Nu = 10.066, v_rms = 480.43. The run stops at
``max_time``, at ``max_wall_s`` seconds of wall time (0: none), or at a
steady Nusselt number (checked every 500 steps after step 3000). The
configuration is the script's (``config``), in f32 on the card by default.
The run stops at the first step that does not converge or drops a marker
(``--allow-drops``: drops are counted instead) and exits non-zero after
writing its summary. A run capped by ``--max-steps`` also projects the
hours of the JAX package's full run (its record's step count at this nx
times the seconds per step). Prints the script's progress line every 500
steps and one JSON summary line, and writes the summary to ``--out``.
"""
from __future__ import annotations

import dataclasses

import torch

from pylamp_tpu_torch.models import validation
from pylamp_tpu_torch.models.benchmarks import (
    fk_stagnant_lid,
    nusselt_bottom,
    nusselt_top,
    vrms_box,
)
from pylamp_tpu_torch.models.config import SolverConfig

BB2A_NU = 10.066
BB2A_VRMS = 480.43


def config(nx: int = 64, max_time: float = 0.2):
    """The script's configuration
    (scripts/validate_blankenbach_2a.py:35-41)."""
    cfg = fk_stagnant_lid(nx=nx, ny=nx, Ra_top=1e4, visc_contrast=1e3,
                          max_steps=10**9, max_time=max_time)
    return dataclasses.replace(cfg, solver=SolverConfig(
        stokes_tol=1e-8, stokes_restart=40, stokes_maxiter=300,
        energy_tol=1e-10))


def run(nx=64, max_time=0.2, max_wall_s=0.0, max_steps=0, device="cuda",
        dtype=torch.float32, allow_drops=False):
    """Steps the run and returns its summary."""
    r = validation.Run(config(nx, max_time), dtype, device, allow_drops)
    grid = r.grid
    last_nu, steady, wall_capped = -1.0, False, False
    with r.stopping():
        while r.time < max_time and not (max_steps and r.n >= max_steps):
            diag = r.step()
            if max_wall_s and r.wall() > max_wall_s:
                print("wall cap reached", flush=True)
                wall_capped = True
                break
            if r.n % 500 == 0:
                nu = float(nusselt_top(r.state.T, grid))
                vr = float(vrms_box(r.state.vx, r.state.vy))
                print(f"step {r.n} t={r.time:.4f} Nu={nu:.4f} vrms={vr:.2f} "
                      f"iters={int(diag['stokes_iterations'])} "
                      f"wall={r.wall():.0f}s", flush=True)
                if abs(nu - last_nu) < 2e-4 and r.n > 3000:
                    print("steady state reached", flush=True)
                    steady = True
                    break
                last_nu = nu
    nu = float(nusselt_top(r.state.T, grid))
    nub = float(nusselt_bottom(r.state.T, grid))
    vr = float(vrms_box(r.state.vx, r.state.vy))
    print(f"FINAL nx={nx}: Nu_top={nu:.4f} Nu_bot={nub:.4f} (ref {BB2A_NU}, "
          f"err {abs(nu - BB2A_NU) / BB2A_NU:.2%}) vrms={vr:.2f} (ref "
          f"{BB2A_VRMS}, err {abs(vr - BB2A_VRMS) / BB2A_VRMS:.2%}) "
          f"steps={r.n} wall={r.wall():.0f}s", flush=True)
    rec = r.record()
    capped = (bool(max_steps) and r.n >= max_steps and r.time < max_time
              and not steady)
    full = validation.record_steps("blankenbach_2a") if nx == 64 else None
    return {
        "config": "Blankenbach 1989 case 2a (T-dep viscosity, Ra0=1e4, "
                  "contrast 1e3)",
        "nx": nx, "steps": r.n, "time_nondim": r.time,
        "steady_state": steady, "wall_capped": wall_capped,
        "capped": capped,
        "nu_top": nu, "nu_bottom": nub,
        "nu_ref": BB2A_NU, "nu_rel_err": abs(nu - BB2A_NU) / BB2A_NU,
        "nu_top_bottom_gap": abs(nu - nub) / BB2A_NU,
        "vrms": vr, "vrms_ref": BB2A_VRMS,
        "vrms_rel_err": abs(vr - BB2A_VRMS) / BB2A_VRMS,
        "wall_s": r.wall(),
        "record_steps": full,
        "projected_full_run_hours": (full * rec["seconds_per_step"] / 3600.0
                                     if capped and full else None),
        **rec,
    }


def main(argv=None):
    args = validation.arguments(__doc__, 64, max_time=(float, 0.2),
                                max_wall_s=(float, 0.0)).parse_args(argv)
    validation.check_device(args.device)
    summary = run(
        args.nx, args.max_time, args.max_wall_s, args.max_steps,
        args.device, torch.float64 if args.x64 else torch.float32,
        args.allow_drops)
    validation.finish(args.out, summary)


if __name__ == "__main__":
    main()
