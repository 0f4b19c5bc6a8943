"""Where the time goes in the port's step, on one GPU.

    python -m pylamp_tpu_torch.models.profile
        [--config fk|fk_heated|fk_heated_mg|fk_stretched|fk_stretched_line|
                  sticky_air|falling_block_periodic|blankenbach|van_keken]
        [--nx 1024] [--steps 2] [--mesh 4x2]

Builds ``fk_bench_config(nx)`` (FK nx^2, the default),
``fk_heated_config(nx)`` (the same with the reference's four thermal
switches; ``fk_heated_mg``: with the energy multigrid and flexible CG),
``fk_stretched_bench_config(nx)`` (y-stretched 8x, ``bench.py --stretch-y
8``; ``fk_stretched_line``: with the line smoothers in both multigrids,
see ``fk_stretched_line_config``),
``sticky_air_bench_config(nx)`` (sticky air nx x nx // 4) or
``falling_block_periodic_config(nx)`` (periodic side walls, nx^2) or the
configuration of a validation run (``blankenbach``: Blankenbach 1a,
``van_keken``: the Rayleigh-Taylor benchmark, nx^2) on the card in f32
and takes 2 warm-up steps, then (with ``--mesh YxX``, as the
reference's CLI: the explicit-halo step on that in-process mesh)

1. runs ``--steps`` steps through ``models.step.run_step`` with a device
   synchronize around each phase (interp, stokes, timestep, energy,
   advect), for the mean seconds of each phase, the Krylov and energy
   iterations and the launches per step of every kernel (the wrappers'
   counters; of the periodic forms and of the rho0 * alpha stream too);
2. times one whole step without synchronizes inside it;
3. traces the next step with ``torch.profiler`` (device activity only):
   device busy time is the union of the kernel, memcpy and memset
   intervals of the trace (operator and runtime events are host-side
   records, not device work), with the number of those device operations
   and the kernels that take the most device time, and every launch of
   the hand-written kernels (``csrc/*.cu``) by name: count and device
   milliseconds in the traced step.  The idle share sets
   that busy time against the untraced step's wall time: tracing slows the
   host's launches, so the traced step's own wall time overstates it.

Prints one JSON object; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import replace

import torch

from pylamp_tpu_torch.models import validate_blankenbach, validate_van_keken
from pylamp_tpu_torch.models.benchmarks import (
    falling_block_periodic_config,
    fk_bench_config,
    fk_stretched_bench_config,
    sticky_air_bench_config,
)



def fk_heated_config(nx: int = 1024, energy_preconditioner: str = "jacobi"):
    """``fk_bench_config(nx)`` with the reference's thermal switches, set
    as tests/test_heating.py sets the heating terms: shear and adiabatic
    heating, subgrid diffusion with d = 1 (Gerya's standard value) and
    reseeding below 2 markers per cell (scripts/validate_van_keken.py).
    ``energy_preconditioner="mg"``: the energy multigrid with flexible CG.
    Not a preset of either package: the switches on the bench preset."""
    cfg = fk_bench_config(nx)
    return replace(
        cfg,
        physics=replace(cfg.physics, shear_heating=True,
                        adiabatic_heating=True, subgrid_diffusion_d=1.0,
                        reseed_min_per_cell=2),
        solver=replace(cfg.solver,
                       energy_preconditioner=energy_preconditioner))


def fk_stretched_line_config(nx: int = 1024):
    """``fk_stretched_bench_config(nx)`` with the line smoothers: y and x
    line relaxation in the Stokes MG (``mg_smoother="line"``) and the
    energy MG with line smoothing under flexible CG (the line-smoother
    partner of ``chip_smoke.py``'s stretched phase)."""
    cfg = fk_stretched_bench_config(nx)
    return replace(cfg, solver=replace(
        cfg.solver, mg_smoother="line", energy_preconditioner="mg",
        energy_mg_smoother="line"))


CONFIGS = {"fk": fk_bench_config, "fk_heated": fk_heated_config,
           "fk_heated_mg": lambda nx: fk_heated_config(nx, "mg"),
           "fk_stretched": fk_stretched_bench_config,
           "fk_stretched_line": fk_stretched_line_config,
           "sticky_air": sticky_air_bench_config,
           "falling_block_periodic": falling_block_periodic_config,
           # the validation runs' configurations (their early steps)
           "blankenbach": validate_blankenbach.config,
           "van_keken": validate_van_keken.config}
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the hand-written kernels' names: each csrc/*.cu defines its kernels in
# an anonymous namespace (PyTorch's own carry at::native before theirs;
# cuBLAS's have none)
OWN_KERNEL = "(anonymous namespace)::"
WARMUP_STEPS = 2


def device_activity(events):
    """Device work in a Chrome trace's ``traceEvents``: (busy seconds,
    number of device operations, {name: [count, seconds]}).  Only kernel,
    memcpy and memset events count, and busy time is the union of their
    intervals, so work on overlapping streams is not counted twice."""
    spans = []
    by_name = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((start, start + dur))
        entry = by_name.setdefault(e.get("name", "?"), [0, 0.0])
        entry[0] += 1
        entry[1] += dur * 1e-6
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us * 1e-6, len(spans), by_name


def synced_timer(seconds):
    """A ``run_step`` phase hook that adds each phase's wall time, with the
    device synchronized before and after it, to ``seconds[name]``."""
    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] += time.perf_counter() - t0
        return out
    return timed


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=tuple(CONFIGS), default="fk")
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--mesh", default=None, metavar="YxX",
                    help="run the explicit-halo step on a YxX in-process "
                         "mesh (or a shard count)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile: no CUDA device")

    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step_phases, run_step
    from pylamp_tpu_torch.ops.kernels import (
        cheb,
        cheb_block,
        coarse_vcycle,
        momentum,
        saddle,
        saddle_block,
    )
    from pylamp_tpu_torch.parallel.mesh import parse_mesh

    kernels = dict(saddle=saddle, m2g=m2g, advect=advect, rebucket=rebucket,
                   cheb=cheb, coarse_vcycle=coarse_vcycle, momentum=momentum,
                   cheb_block=cheb_block, saddle_block=saddle_block,
                   m2g_block=m2g_block, advect_block=advect_block,
                   rebucket_block=rebucket_block)
    cfg = CONFIGS[args.config](args.nx)
    mesh = None
    if args.mesh:
        mesh = parse_mesh(args.mesh)
        cfg = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
    grid, table, st = build(cfg, dtype=torch.float32, device="cuda")
    ph = make_step_phases(grid, cfg, table, mesh=mesh)
    for _ in range(WARMUP_STEPS):
        st, _ = run_step(ph, st)

    phases = defaultdict(float)
    iters = energy_iters = 0
    forms = {f: {k: mod for k, mod in kernels.items() if hasattr(mod, f)}
             for f in ("launches", "launches_periodic", "launches_ra")}
    for f, mods in forms.items():
        for mod in mods.values():
            setattr(mod, f, 0)
    for _ in range(args.steps):
        st, diag = run_step(ph, st, timed=synced_timer(phases))
        iters += diag["stokes_iterations"]
        energy_iters += diag.get("energy_iterations", 0)
    per_step = {f: {k: getattr(mod, f) / args.steps
                    for k, mod in mods.items()}
                for f, mods in forms.items()}

    (st, _), wall = _wall(lambda: run_step(ph, st))
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            (st, diag), traced_wall = _wall(lambda: run_step(ph, st))
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    busy, n_ops, by_name = device_activity(events)
    if n_ops == 0:
        sys.exit("profile: the trace holds no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "device": smi,
        "config": args.config,
        "mesh": [mesh.my, mesh.mx] if mesh else None,
        "grid": [grid.ny, grid.nx],
        "phase_seconds": {k: v / args.steps for k, v in phases.items()},
        "krylov_iterations_per_step": iters / args.steps,
        "energy_iterations_per_step": energy_iters / args.steps,
        "kernel_launches_per_step": per_step["launches"],
        "periodic_form_launches_per_step": per_step["launches_periodic"],
        "ra_stream_launches_per_step": per_step["launches_ra"],
        "step": {
            "wall_s": wall,
            "traced_wall_s": traced_wall,
            "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_idle_share_traced": 1.0 - busy / traced_wall,
            "device_ops": n_ops,
            "krylov_iterations": diag["stokes_iterations"],
            "top_kernels": [{"name": k[:90], "count": c, "ms": s * 1e3}
                            for k, (c, s) in top],
            "own_kernels": [
                {"name": k[:120], "count": c, "ms": s * 1e3}
                for k, (c, s) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])
                if OWN_KERNEL in k and "at::native" not in k],
        },
    }, indent=1))


if __name__ == "__main__":
    main()
