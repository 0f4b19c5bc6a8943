"""Chip smoke test of the PyTorch/CUDA port (pylamp_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the six hand-written CUDA kernels from ``pylamp_tpu_torch/csrc``
(nvcc, sm_90a, one process per source), checks each one against its plain
PyTorch version on the card at the shapes of the Frank-Kamenetskii
1024^2 x K18 benchmark step (the fused smoother on the solve's own levels
1024, 512 and 256, the coarse sub-V-cycle from 128^2), times both with
CUDA events, and then drives that step through the port's ``build`` +
``make_step`` on ``fk_bench_config`` -- the JAX bench preset -- (2 warm-up
+ 3 measured steps), failing unless every step converges to 1e-8, drops no
marker, keeps every field finite and launches all six kernels.  The same
call then takes the step with ``use_pallas_smoother=False`` (plain MG
smoother) from the same built state, for an A/B of the two paths, and
fails unless their Krylov counts agree within +-2 per step.  A 64^2 step
on the card (coarse kernel from 32^2) is also held against the plain f64
step on the CPU (the path the CPU tests hold against the JAX package).
The last line is the JSON device record; any failure raises, so the exit
code is non-zero.  It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FK_NX = 1024
WARMUP_STEPS = 2
MEASURED_STEPS = 3
PLAIN_MG_MEASURED_STEPS = 2  # the use_pallas_smoother=False path
KRYLOV_AB_TOL = 2  # Krylov iterations per step, fused vs plain MG smoother
SMALL_NX = 64
# tolerances of the kernels against their plain versions on the card
TOL = {
    "saddle": 1e-5,  # max |err| / max |ref| per output array
    "m2g": 1e-5,  # the bar of the TPU kernel's own equivalence test
    # max |displacement error| / max |displacement|, the error counted
    # beyond one f32 spacing of the position (see displacement_error)
    "advect": 1e-4,
    "rebucket": 0.0,  # bit-identical
    # max |err| / max |ref| per output: the bars of the TPU kernels' tests
    # (tests/test_cheb_kernel.py, tests/test_coarse_vcycle.py)
    "cheb": 2e-5,
    "coarse_vcycle": 2e-5,
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Median of per-launch CUDA-event times (after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def errors(pairs):
    """(max |got - ref|, max over arrays of max |got - ref| / max |ref|)."""
    abs_err, rel = 0.0, 0.0
    for got, ref in pairs:
        scale = float(torch.max(torch.abs(ref)))
        err = float(torch.max(torch.abs(got.double() - ref.double())))
        abs_err = max(abs_err, err)
        rel = max(rel, err / scale if scale > 0 else err)
    return abs_err, rel


def displacement_error(got, ref, start):
    """Advect: (max |got - ref| of the new positions, max over x and y of
    the displacement error over max |displacement|).  Both versions round
    start + displacement to f32 last, which alone may part them by one f32
    spacing of the position; the displacement error is what exceeds that.
    A whole-position bar would pass a kernel of the wrong order: at the
    FK step a marker moves ~5e-4 of the unit domain."""
    abs_err, excess, scale = 0.0, 0.0, 0.0
    for g, r, s in zip(got, ref, start):
        top = torch.maximum(torch.abs(g), torch.abs(r))
        spacing = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        diff = torch.abs(g.double() - r.double())
        abs_err = max(abs_err, float(torch.max(diff)))
        excess = max(excess, float(torch.max(
            torch.clamp(diff - spacing.double(), min=0.0))))
        scale = max(scale, float(torch.max(torch.abs(r.double() - s.double()))))
    return abs_err, excess / scale


def check_kernels(grid, table, cfg, state, ph):
    """Each kernel against its plain version on the card, on inputs taken
    from the built state after one interp and one Stokes solve."""
    from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
    from pylamp_tpu_torch.ops.kernels import saddle
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    phys, vbc = cfg.physics, cfg.physics.velocity_bcs
    io = ph.interp(state)
    vx, vy, p, sdiag = ph.stokes(state, io)
    dt = ph.timestep(vx, vy, io.k_m, io.rhocp_m)
    torch.cuda.synchronize()
    log(f"setup solve: {sdiag['stokes_iterations']} Krylov iterations, "
        f"rel residual {sdiag['stokes_residual_rel']:.3e}")
    m = state.markers
    rows = []

    # saddle apply: the solve's viscosities and scales; the vector is a
    # seeded random field at the solution's scale per component (at the
    # solution itself the momentum rows cancel to the buoyancy and f32
    # rounding of the individual terms dominates any comparison)
    kcont, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()),
                                grid)
    prep = saddle.prep_saddle(io.eta_s, io.eta_n, kcont.float(), kbnd.float())
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = [torch.randn(t.shape, generator=gen, device="cuda") * torch.max(torch.abs(t))
         for t in (vx, vy, p)]
    got = saddle.saddle_apply_cuda(*u, prep, grid, vbc)
    ref = saddle.saddle_apply_plain(*u, prep, grid, vbc)
    err = errors(zip(got, ref))
    rows.append(("saddle", "pylamp_tpu_torch/csrc/saddle.cu",
                 "pylamp_tpu/ops/pallas/stokes_kernel.py:407", err,
                 lambda: saddle.saddle_apply_cuda(*u, prep, grid, vbc),
                 lambda: saddle.saddle_apply_plain(*u, prep, grid, vbc), 50))

    # marker -> grid on the built state's markers
    got = m2g.m2g_fused_cuda(m, grid, table, phys, with_energy=True)
    ref = m2g.m2g_fused_plain(m, grid, table, phys, with_energy=True)
    if sorted(got) != sorted(ref):
        raise AssertionError(f"m2g streams differ: {sorted(got)} vs {sorted(ref)}")
    err = errors((got[k], ref[k]) for k in ref)
    rows.append(("m2g", "pylamp_tpu_torch/csrc/m2g.cu",
                 "pylamp_tpu/markers/pallas/m2g_kernel.py:407", err,
                 lambda: m2g.m2g_fused_cuda(m, grid, table, phys, with_energy=True),
                 lambda: m2g.m2g_fused_plain(m, grid, table, phys, with_energy=True),
                 5))

    # RK4 advection with the solve's velocities and the step's dt
    reach = 1
    got = advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, reach)
    ref = advect.advect_rk4_plain(m, vx, vy, dt, grid, vbc, reach)
    err = displacement_error((got.x, got.y), (ref.x, ref.y), (m.x, m.y))
    log(f"advect: new positions max |err| / max |ref| "
        f"{errors([(got.x, ref.x), (got.y, ref.y)])[1]:.3e}")
    rows.append(("advect", "pylamp_tpu_torch/csrc/advect.cu",
                 "pylamp_tpu/markers/pallas/advect_kernel.py:282", err,
                 lambda: advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, reach),
                 lambda: advect.advect_rk4_plain(m, vx, vy, dt, grid, vbc, reach),
                 5))

    # rebucket of the advected markers: bit-identical
    moved = got
    (gm, gd), (rm, rd) = (rebucket.rebucket_cuda(moved, grid),
                          rebucket.rebucket_plain(moved, grid))
    same = all(torch.equal(getattr(gm, f), getattr(rm, f))
               for f in ("x", "y", "mat", "T", "valid")) and int(gd) == int(rd)
    moved_cells = int(torch.sum(moved.valid & ~gm.valid))  # slots repacked
    log(f"rebucket: dropped {int(gd)} (plain {int(rd)}), "
        f"{moved_cells} slots emptied by the repack")
    rows.append(("rebucket", "pylamp_tpu_torch/csrc/rebucket.cu",
                 "pylamp_tpu/markers/pallas/rebucket_kernel.py:311",
                 (0.0, 0.0) if same else (math.inf, math.inf),
                 lambda: rebucket.rebucket_cuda(moved, grid),
                 lambda: rebucket.rebucket_plain(moved, grid), 3))

    rows += mg_kernel_rows(grid, cfg, io)

    results = {}
    for name, source, replaces, (abs_err, err), kfn, pfn, preps in rows:
        ok = err <= TOL[name]
        # plain, kernel, kernel, plain: the two versions alternate
        p1 = cuda_time_ms(pfn, preps)
        k1 = cuda_time_ms(kfn, 20)
        k2 = cuda_time_ms(kfn, 20)
        p2 = cuda_time_ms(pfn, preps)
        results[name] = dict(source=source, replaces=replaces,
                             max_abs_err=abs_err, ms=min(k1, k2),
                             plain_ms=min(p1, p2))
        log(f"kernel {name}: max abs err {abs_err:.3e}, rel err {err:.3e} "
            f"(tol {TOL[name]:g}) "
            f"{'OK' if ok else 'FAIL'}; kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms")
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {err:.3e} > {TOL[name]:g}")
    return results


def mg_kernel_rows(grid, cfg, io):
    """The fused smoother and the coarse sub-V-cycle against their plain
    versions on the solve's own MG levels: f32 viscosities, kbnd and the
    per-level Gershgorin lambdas as the step computes them, seeded random
    residuals and start iterates."""
    from pylamp_tpu_torch.ops.kernels import cheb
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
    from pylamp_tpu_torch.solvers import mg
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    solver, vbc = cfg.solver, cfg.physics.velocity_bcs
    deg = max(solver.mg_pre_smooth, solver.mg_post_smooth)
    es, en = io.eta_s.float(), io.eta_n.float()
    _, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()), grid)
    kbnd = kbnd.float()
    plan, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd,
                                             solver.mg_levels,
                                             solver.mg_semicoarsen)
    lam = mg.estimate_mg_lambdas(es, en, grid, vbc, kbnd,
                                 levels=solver.mg_levels,
                                 semicoarsen=solver.mg_semicoarsen,
                                 mode="gershgorin")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # kernel 5 on every level it takes: the pre-smooth form (zero start,
    # emitted residual) and the post-smooth form (non-zero start)
    cheb_levels = [l for l, g in enumerate(grids)
                   if cheb.smoother_eligible(g, torch.float32, deg, True)]
    if [grids[l].nx for l in cheb_levels] != [1024, 512, 256]:
        raise AssertionError(f"fused smoother levels {cheb_levels}")
    cheb_abs, cheb_rel, timed = 0.0, 0.0, None
    for l in cheb_levels:
        g, (les, len_) = grids[l], etas[l]
        prep = cheb.prep_smoother(les, len_, g, vbc, kbnds[l], lam[l], deg + 1)
        rx, ry = rand(g.shape_vx), rand(g.shape_vy)
        zx, zy = torch.zeros_like(rx), torch.zeros_like(ry)
        ex, ey = rand(g.shape_vx), rand(g.shape_vy)
        forms = (((zx, zy), True, True), ((ex, ey), False, False))
        for (sx, sy), zero_init, emit in forms:
            got = cheb.chebyshev_smooth_cuda(sx, sy, rx, ry, prep, g, vbc,
                                             deg, zero_init, emit)
            ref = cheb.chebyshev_smooth_plain(sx, sy, rx, ry, les, len_, g,
                                              vbc, kbnds[l], lam[l], deg,
                                              zero_init, emit)
            a, r = errors(zip(got, ref))
            log(f"cheb level {g.ny}x{g.nx} zero_init={zero_init} "
                f"emit={emit}: max abs err {a:.3e}, rel {r:.3e}")
            cheb_abs, cheb_rel = max(cheb_abs, a), max(cheb_rel, r)
        if timed is None:  # time the finest level's pre-smooth form
            timed = (
                partial(cheb.chebyshev_smooth_cuda, zx, zy, rx, ry, prep, g,
                        vbc, deg, True, True),
                partial(cheb.chebyshev_smooth_plain, zx, zy, rx, ry, les,
                        len_, g, vbc, kbnds[l], lam[l], deg, True, True))
    rows = [("cheb", "pylamp_tpu_torch/csrc/cheb.cu",
             "pylamp_tpu/ops/pallas/cheb_kernel.py:347",
             (cheb_abs, cheb_rel), *timed, 20)]

    # kernel 6 on the solve's coarse hierarchy from the fusion start
    fs = cvk.coarse_fuse_start(grids, plan, vbc, torch.float32, "chebyshev",
                               False, False)
    if fs is None or grids[fs].nx != 128:
        raise AssertionError(f"coarse fusion start {fs}")
    prep = cvk.CoarseVcyclePrep(grids[fs:], etas[fs:], kbnds[fs:], lam[fs:],
                                vbc, solver.mg_pre_smooth,
                                solver.mg_post_smooth, 32)
    rx, ry = rand(grids[fs].shape_vx), rand(grids[fs].shape_vy)
    got = cvk.coarse_vcycle_cuda(rx, ry, prep)
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    log(f"coarse V-cycle from {grids[fs].ny}x{grids[fs].nx} "
        f"({prep.nlev} levels)")
    rows.append(("coarse_vcycle", "pylamp_tpu_torch/csrc/coarse_vcycle.cu",
                 "pylamp_tpu/ops/pallas/coarse_vcycle_kernel.py:136",
                 errors(zip(got, ref)),
                 partial(cvk.coarse_vcycle_cuda, rx, ry, prep),
                 partial(cvk.coarse_vcycle_plain, rx, ry, prep), 10))
    return rows


def check_state(state, n_markers, diag, label):
    if not diag["stokes_converged"]:
        raise AssertionError(f"{label}: Stokes solve did not converge")
    if not diag["stokes_residual_rel"] <= 1e-8:
        raise AssertionError(f"{label}: rel residual "
                             f"{diag['stokes_residual_rel']:.3e} > 1e-8")
    if int(diag["markers_dropped"]) != 0:
        raise AssertionError(f"{label}: {int(diag['markers_dropped'])} "
                             "markers dropped")
    if int(diag["marker_count"]) != n_markers:
        raise AssertionError(f"{label}: marker count "
                             f"{int(diag['marker_count'])} != {n_markers}")
    fields = dict(vx=state.vx, vy=state.vy, p=state.p, T=state.T,
                  eta_s=state.eta_s, eta_n=state.eta_n, x=state.markers.x,
                  y=state.markers.y, mT=state.markers.T)
    for k, v in fields.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite values in {k}")


def mean(xs):
    return sum(xs) / len(xs)


def run_steps(step, state0, n_markers, modules, measured, label):
    """WARMUP_STEPS + ``measured`` steps from state0; every step must pass
    check_state and launch every kernel of ``modules``.  Returns the wall
    seconds and Krylov iterations of every step (warm-up first)."""
    state = state0
    times, iters = [], []
    for i in range(WARMUP_STEPS + measured):
        before = {k: mod.launches for k, mod in modules.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = step(state)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        tag = f"{label} step {i + 1}"
        check_state(state, n_markers, diag, tag)
        stalled = [k for k, mod in modules.items() if mod.launches <= before[k]]
        if stalled:
            raise AssertionError(f"{tag}: kernels not launched: {stalled}")
        kind = "warm-up" if i < WARMUP_STEPS else "measured"
        log(f"{tag} ({kind}): {dt_s:.3f} s, Krylov "
            f"{diag['stokes_iterations']}, energy CG "
            f"{diag['energy_iterations']}, rel residual "
            f"{diag['stokes_residual_rel']:.3e}, dt {float(diag['dt']):.4e}, "
            f"launches " + ", ".join(
                f"{k}+{mod.launches - before[k]}" for k, mod in modules.items()))
        times.append(dt_s)
        iters.append(int(diag["stokes_iterations"]))
    return times, iters


def small_reference_check():
    """One 64^2 step on the card (f32, kernels: the coarse V-cycle runs
    levels 32 to 4) against the plain f64 step on the CPU from the same
    seeded initial state: velocities within 1e-4 max|v| (f32 viscosity
    rounding), like the CPU tests' bar."""
    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk

    cfg = fk_bench_config(SMALL_NX)
    out = {}
    n0 = cvk.launches
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        grid, table, st = build(cfg, dtype=dtype, device=dev)
        st, d = make_step(grid, cfg, table)(st)
        out[dev] = (st, d)
    if cvk.launches <= n0:
        raise AssertionError(f"{SMALL_NX}^2 step: the coarse V-cycle kernel "
                             "was not launched")
    g, r = out["cuda"][0], out["cpu"][0]
    vmax = float(torch.max(torch.abs(r.vx)))
    err = max(float(torch.max(torch.abs(g.vx.cpu().double() - r.vx))),
              float(torch.max(torch.abs(g.vy.cpu().double() - r.vy))))
    log(f"{SMALL_NX}^2 step, card f32 vs CPU f64: max |dv| / max|v| = "
        f"{err / vmax:.3e}; Krylov {out['cuda'][1]['stokes_iterations']} vs "
        f"{out['cpu'][1]['stokes_iterations']}")
    if not err <= 1e-4 * vmax:
        raise AssertionError(f"{SMALL_NX}^2 step disagrees with the CPU "
                             f"reference: {err / vmax:.3e} > 1e-4")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    from pylamp_tpu_torch import cuda_build
    from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step, make_step_phases
    from pylamp_tpu_torch.ops.kernels import cheb, saddle
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    lib, secs = cuda_build.build()
    cuda_build.library()
    log(f"kernels built in {secs:.1f} s -> {lib}")

    cfg = fk_bench_config(FK_NX)
    t0 = time.perf_counter()
    grid, table, state0 = build(cfg, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_markers = int(state0.markers.total())
    log(f"built FK {FK_NX}^2: {tuple(state0.markers.x.shape)} marker slots, "
        f"{n_markers} markers, {time.perf_counter() - t0:.1f} s")

    results = check_kernels(grid, table, cfg, state0,
                            make_step_phases(grid, cfg, table))

    modules = {"saddle": saddle, "m2g": m2g, "advect": advect,
               "rebucket": rebucket, "cheb": cheb, "coarse_vcycle": cvk}
    # the main path: the JAX bench preset, all six kernels
    for mod in modules.values():
        mod.launches = 0
    times, iters = run_steps(make_step(grid, cfg, table), state0, n_markers,
                             modules, MEASURED_STEPS, "fused")
    launches = {k: mod.launches for k, mod in modules.items()}
    log(f"FK {FK_NX}^2 on {smi}, fused MG smoother (bench preset): median "
        f"{statistics.median(times[WARMUP_STEPS:]):.3f} s/step over "
        f"{MEASURED_STEPS} steps, {mean(iters[WARMUP_STEPS:]):.1f} Krylov "
        f"iterations/step; launches {launches}")

    # the plain-smoother path (use_pallas_smoother=False) from the same
    # built state: four kernels, the MG smoother as tensor code
    cfg1 = fk_bench_config(FK_NX, fused_smoother=False)
    four = {k: modules[k] for k in ("saddle", "m2g", "advect", "rebucket")}
    for mod in modules.values():
        mod.launches = 0
    times1, iters1 = run_steps(make_step(grid, cfg1, table), state0,
                               n_markers, four, PLAIN_MG_MEASURED_STEPS,
                               "plain MG")
    launches1 = {k: mod.launches for k, mod in modules.items()}
    if launches1["cheb"] or launches1["coarse_vcycle"]:
        raise AssertionError("the use_pallas_smoother=False path launched a "
                             f"fused MG kernel: {launches1}")
    log(f"FK {FK_NX}^2 on {smi}, plain MG smoother "
        f"(use_pallas_smoother=False): median "
        f"{statistics.median(times1[WARMUP_STEPS:]):.3f} s/step over "
        f"{PLAIN_MG_MEASURED_STEPS} steps, "
        f"{mean(iters1[WARMUP_STEPS:]):.1f} Krylov iterations/step; "
        f"launches {launches1}")
    log("A/B " + json.dumps({
        "device": smi,
        "fused": {"median_s_per_step": statistics.median(times[WARMUP_STEPS:]),
                  "step_s": times, "krylov": iters},
        "plain_mg": {
            "median_s_per_step": statistics.median(times1[WARMUP_STEPS:]),
            "step_s": times1, "krylov": iters1}}))
    for i, (a, b) in enumerate(zip(iters, iters1)):
        if abs(a - b) > KRYLOV_AB_TOL:
            raise AssertionError(
                f"step {i + 1}: {a} Krylov iterations with the fused MG "
                f"kernels, {b} without (bar +-{KRYLOV_AB_TOL})")

    small_reference_check()

    kernels = [dict(name=k, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[k],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"]) for k, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
