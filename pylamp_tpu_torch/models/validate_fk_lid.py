"""Frank-Kamenetskii stagnant-lid validation on one GPU: the port's
counterpart of ``scripts/validate_fk_lid.py``.

    python -m pylamp_tpu_torch.models.validate_fk_lid --out PATH
        [--nx 64] [--max-time 2.0] [--max-steps N] [--allow-drops]
        [--device cpu] [--x64]

With gamma = ln(1e4) and Ra(top) = 100 (BASELINE config 3) the convection
must sit in the stagnant-lid regime, a nearly immobile cold lid over a
convecting interior: the surface mobility M = v_rms(surface) /
v_rms(volume) is << 1 (Solomatov 1995). The run stops at ``max_time`` or
at a steady Nusselt number (checked every 200 steps after step 2000). The
configuration is the script's (``config``), in f32 on the card by default.
The run stops at the first step that does not converge or drops a marker
(``--allow-drops``: drops are counted instead) and exits non-zero after
writing its summary. A run capped by ``--max-steps`` also projects the
hours of the JAX package's full run (its record's step count at this nx
times the seconds per step). Prints the script's progress line every 200
steps and one JSON summary line, and writes the summary to ``--out``.
"""
from __future__ import annotations

import dataclasses

import torch

from pylamp_tpu_torch.models import validation
from pylamp_tpu_torch.models.benchmarks import (
    fk_stagnant_lid,
    nusselt_top,
    vrms_box,
)
from pylamp_tpu_torch.models.config import SolverConfig


def config(nx: int = 64, max_time: float = 2.0):
    """The script's configuration (scripts/validate_fk_lid.py:132-136)."""
    cfg = fk_stagnant_lid(nx=nx, ny=nx, max_steps=10**9, max_time=max_time)
    return dataclasses.replace(cfg, solver=SolverConfig(
        stokes_tol=1e-8, stokes_restart=40, stokes_maxiter=200))


def _surface_rms(vx) -> float:
    return float(torch.sqrt(torch.mean(vx[0, :] ** 2)))


def run(nx=64, max_time=2.0, max_steps=0, device="cuda",
        dtype=torch.float32, allow_drops=False):
    """Steps the run and returns its summary."""
    r = validation.Run(config(nx, max_time), dtype, device, allow_drops)
    grid = r.grid
    last_nu, steady = -1.0, False
    with r.stopping():
        while r.time < max_time and not (max_steps and r.n >= max_steps):
            diag = r.step()
            if r.n % 200 == 0:
                nu = float(nusselt_top(r.state.T, grid))
                vr = float(vrms_box(r.state.vx, r.state.vy))
                print(f"step {r.n} t={r.time:.4f} Nu={nu:.4f} vrms={vr:.3f} "
                      f"v_surf={_surface_rms(r.state.vx):.4f} "
                      f"iters={int(diag['stokes_iterations'])} "
                      f"wall={r.wall():.0f}s", flush=True)
                if abs(nu - last_nu) < 5e-5 and r.n > 2000:
                    steady = True
                    break
                last_nu = nu
    nu = float(nusselt_top(r.state.T, grid))
    vr = float(vrms_box(r.state.vx, r.state.vy))
    v_surf = _surface_rms(r.state.vx)
    mobility = v_surf / vr
    print(f"FINAL nx={nx}: Nu={nu:.4f} vrms={vr:.3f} v_surf={v_surf:.5f} "
          f"mobility={mobility:.2e} (stagnant lid expects << 1) "
          f"steps={r.n} wall={r.wall():.0f}s", flush=True)
    rec = r.record()
    capped = (bool(max_steps) and r.n >= max_steps and r.time < max_time
              and not steady)
    full = validation.record_steps("fk_lid") if nx == 64 else None
    return {
        "config": "BASELINE config 3 (Frank-Kamenetskii stagnant lid, "
                  "1e4 viscosity contrast)",
        "nx": nx, "steps": r.n, "time_nondim": r.time,
        "steady_state": steady, "capped": capped,
        "nu_top": nu, "vrms": vr, "v_surf_rms": v_surf,
        "mobility": mobility,
        "stagnant_lid": bool(mobility < 0.05),
        "wall_s": r.wall(),
        "record_steps": full,
        "projected_full_run_hours": (full * rec["seconds_per_step"] / 3600.0
                                     if capped and full else None),
        **rec,
    }


def main(argv=None):
    args = validation.arguments(__doc__, 64, max_time=(float, 2.0)
                                ).parse_args(argv)
    validation.check_device(args.device)
    summary = run(
        args.nx, args.max_time, args.max_steps, args.device,
        torch.float64 if args.x64 else torch.float32,
        args.allow_drops)
    validation.finish(args.out, summary)


if __name__ == "__main__":
    main()
