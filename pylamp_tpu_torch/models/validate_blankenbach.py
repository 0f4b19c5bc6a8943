"""Blankenbach et al. (1989) case 1a on one GPU: the port's counterpart of
``scripts/validate_blankenbach.py``.

    python -m pylamp_tpu_torch.models.validate_blankenbach --out PATH
        [--nx 64] [--max-time 0.25] [--max-steps N] [--allow-drops]
        [--device cpu] [--x64]

Isoviscous convection at Ra = 1e4 (BASELINE config 2) is run to
``max_time`` or to a steady Nusselt number (checked every 100 steps after
step 500), and the Nusselt number and v_rms are compared with the
community benchmark values (Nu = 4.8844, v_rms = 42.865). The
configuration is the script's (``config``), in f32 on the card by default.
The run stops at the first step that does not converge or drops a marker
(``--allow-drops``: drops are counted instead) and exits non-zero after
writing its summary. Prints the script's progress line every 100 steps and
one JSON summary line, and writes the summary to ``--out``.
"""
from __future__ import annotations

import dataclasses

import torch

from pylamp_tpu_torch.models import validation
from pylamp_tpu_torch.models.benchmarks import (
    BLANKENBACH_1A_NU,
    BLANKENBACH_1A_VRMS,
    blankenbach_case1a,
    nusselt_top,
    vrms_box,
)
from pylamp_tpu_torch.models.config import SolverConfig


def config(nx: int = 64, max_time: float = 0.25):
    """The script's configuration (scripts/validate_blankenbach.py:37-42)."""
    cfg = blankenbach_case1a(nx=nx, ny=nx, max_steps=100000,
                             max_time=max_time)
    return dataclasses.replace(cfg, solver=SolverConfig(
        stokes_tol=1e-8, stokes_restart=30, stokes_maxiter=150,
        energy_tol=1e-10))


def run(nx=64, max_time=0.25, max_steps=0, device="cuda",
        dtype=torch.float32, allow_drops=False):
    """Steps the run and returns its summary (raises
    ``validation.StepFailure`` on a failed step)."""
    r = validation.Run(config(nx, max_time), dtype, device, allow_drops)
    grid = r.grid
    last_nu, steady = 0.0, False
    with r.stopping():
        while r.time < max_time and not (max_steps and r.n >= max_steps):
            diag = r.step()
            if r.n % 100 == 0:
                nu = float(nusselt_top(r.state.T, grid))
                vr = float(vrms_box(r.state.vx, r.state.vy))
                print(f"step {r.n} t={r.time:.4f} Nu={nu:.4f} vrms={vr:.3f} "
                      f"iters={int(diag['stokes_iterations'])} "
                      f"dt={float(diag['dt']):.2e} wall={r.wall():.0f}s",
                      flush=True)
                if abs(nu - last_nu) < 1e-5 and r.n > 500:
                    print("steady state reached", flush=True)
                    steady = True
                    break
                last_nu = nu
    nu = float(nusselt_top(r.state.T, grid))
    vr = float(vrms_box(r.state.vx, r.state.vy))
    err_nu = abs(nu - BLANKENBACH_1A_NU) / BLANKENBACH_1A_NU
    err_vr = abs(vr - BLANKENBACH_1A_VRMS) / BLANKENBACH_1A_VRMS
    print(f"FINAL nx={nx} Nu={nu:.4f} (ref {BLANKENBACH_1A_NU}, err "
          f"{err_nu:.2%}) vrms={vr:.3f} (ref {BLANKENBACH_1A_VRMS}, err "
          f"{err_vr:.2%}) steps={r.n} wall={r.wall():.0f}s", flush=True)
    return {
        "config": "BASELINE config 2 (Blankenbach 1989 case 1a, Ra=1e4)",
        "nx": nx, "steps": r.n, "time_nondim": r.time,
        "steady_state": steady,
        "capped": bool(max_steps) and r.n >= max_steps and r.time < max_time
        and not steady,
        "nu_top": nu, "nu_ref": BLANKENBACH_1A_NU, "nu_rel_err": err_nu,
        "vrms": vr, "vrms_ref": BLANKENBACH_1A_VRMS, "vrms_rel_err": err_vr,
        "wall_s": r.wall(),
        **r.record(),
    }


def main(argv=None):
    args = validation.arguments(__doc__, 64, max_time=(float, 0.25)
                                ).parse_args(argv)
    validation.check_device(args.device)
    summary = run(
        args.nx, args.max_time, args.max_steps, args.device,
        torch.float64 if args.x64 else torch.float32,
        args.allow_drops)
    validation.finish(args.out, summary)


if __name__ == "__main__":
    main()
