"""Times of kernels 1-5 and 7-12 of the PyTorch/CUDA port
(pylamp_tpu_torch) on one GPU, so that two trees of the repository can be
compared in one call.

    python3 kernel_ab.py [--tree DIR] [--out FILE]

Imports ``pylamp_tpu_torch`` from ``--tree`` (default: this file's
directory), builds its kernels, and times on the FK 1024^2 x K18 state
(``fk_bench_config``) the saddle apply, m2g (with the energy streams, and
as ``m2g_ra`` with the rho0 * alpha stream too, on the heated FK
physics), advect and rebucket, and on the periodic falling block 1024^2 x
K18 the periodic saddle apply, m2g (the step's streams), advect and
rebucket, on the inputs ``chip_smoke.py`` gives these rows (kernel 1 on
the solve's viscosities with seeded random vectors, kernels 2-4 on the
built markers advected with the solve's velocities); then kernel 7 (the
MG momentum apply) at 1024x256 (the sticky-air fine level's shape), as
``momentum_1024`` on the FK solve's viscosities and, as
``momentum_periodic``, on the periodic solve's viscosities at 1024^2,
and on the FK solve's hierarchy kernel 5 (``cheb``, level 1024^2) and
kernel 8 (``cheb_block``, the level's frames on the 4x2 mesh), both in
the pre-smooth form (degree 4 + the residual from a zero start) on
seeded random residuals; then the per-shard kernels at the 4x2 mesh's
256x512 blocks of FK 1024^2, on the inputs ``chip_smoke.py`` gives them:
kernel 9 (``saddle_block`` with p, ``saddle_block_mom`` momentum-only) on
the solve's viscosities' extended blocks with seeded random vectors,
kernel 10 on the built markers' blocks (``m2g_block``, the energy
streams, and as ``m2g_block_ra`` with the rho0 * alpha stream too, on
the heated FK physics), kernel 11 (``advect_block``, the solve's
velocities) on their own blocks, kernel 12 (``rebucket_block``) on the
blocks of kernel 11's output.  Kernel 7's
1024x256 viscosities are seeded log-normal fields (its time does not
depend on their values).  Each row: its agreement with the plain
version (kernels 4 and 12 bit-identical with the same drop count or
arrivals, kernels 1, 7 and 9 within 1e-5 of max |ref|, kernels 2 and 10
within 1e-5 per stream, kernels 3 and 11 within 1e-4 of the displacement,
kernels 5 and 8 within 2e-5), the CUDA-event ms (the better of two
medians of 20 calls), the device ms (one call captured in a CUDA graph
and replayed), the bound and, for kernels 1, 7 and 9, the wrapper's host
microseconds per call, with (kernel 1) two pieces of a launch path timed
in two forms each (the stream handle, the output allocations).  Also the
build's ``ptxas -v`` rows of ``saddle.cu``, ``rebucket.cu``, ``m2g.cu``,
``advect.cu``, ``cheb.cu``, ``cheb_block.cu``, ``momentum.cu`` and the
per-shard kernels' sources.  Prints one JSON object (and writes it to
``--out``); exits non-zero without a CUDA device or on a disagreement.

The timing helpers, bounds and tolerances are ``chip_smoke.py``'s (this
file's directory), so a tree without them can be timed the same way.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from functools import partial

import torch

import chip_smoke as cs


def _prepared(cfg):
    """(grid, table, physics, u, prep, vbc, bm, moved, (vx, vy, dt)) of
    one built state: the solve's saddle prep with seeded random vectors u
    at the solution's scale, the built markers bm, the markers advected
    with the solve's velocities and the step's dt."""
    from pylamp_tpu_torch.markers.kernels import advect
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step_phases
    from pylamp_tpu_torch.ops.kernels import saddle
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    grid, table, state = build(cfg, dtype=torch.float32, device="cuda")
    ph = make_step_phases(grid, cfg, table)
    io = ph.interp(state)
    vx, vy, p, _ = ph.stokes(state, io)
    dt = ph.timestep(vx, vy, io.k_m, io.rhocp_m)
    vbc = cfg.physics.velocity_bcs
    kcont, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()),
                                grid)
    prep = saddle.prep_saddle(io.eta_s, io.eta_n, kcont.float(),
                              kbnd.float())
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = [torch.randn(t.shape, generator=gen, device="cuda")
         * torch.max(torch.abs(t)) for t in (vx, vy, p)]
    if vbc.periodic_x:
        u[0][:, -1] = u[0][:, 0]
    moved = advect.advect_rk4_cuda(state.markers, vx, vy, dt, grid, vbc, 1)
    return (grid, table, cfg.physics, u, prep, vbc, state.markers, moved,
            (vx, vy, dt))


def _saddle_row(name, grid, u, prep, vbc):
    from pylamp_tpu_torch.ops.kernels import saddle

    got = saddle.saddle_apply_cuda(*u, prep, grid, vbc)
    ref = saddle.saddle_apply_plain(*u, prep, grid, vbc)
    ops = (cs.stencil_ops(grid) + cs.OPS["pressure"]
           * (u[0].numel() + u[1].numel()) + cs.OPS["continuity"]
           * u[2].numel())
    return (name, cs.errors(zip(got, ref)), cs.TOL["saddle"],
            partial(saddle.saddle_apply_cuda, *u, prep, grid, vbc),
            cs.bound_ms(cs.nbytes(*u, prep.eta_s, prep.eta_n, prep.kk,
                                  *got), ops))


def _rebucket_row(name, grid, moved, periodic):
    from pylamp_tpu_torch.markers.kernels import rebucket

    (gm, gd), (rm, rd) = (rebucket.rebucket_cuda(moved, grid, periodic),
                          rebucket.rebucket_plain(moved, grid, periodic))
    same = all(torch.equal(getattr(gm, f), getattr(rm, f))
               for f in ("x", "y", "mat", "T", "valid")) and int(gd) == int(rd)
    m = moved
    return (name, (0.0, 0.0) if same else (float("inf"),) * 2, 0.0,
            partial(rebucket.rebucket_cuda, moved, grid, periodic),
            cs.bound_ms(2 * cs.nbytes(m.x, m.y, m.T, m.mat, m.valid),
                        cs.OPS["rebucket"] * int(m.total())))


def _m2g_row(name, grid, table, phys, bm, **kw):
    from pylamp_tpu_torch.markers.kernels import m2g

    got = m2g.m2g_fused_cuda(bm, grid, table, phys, **kw)
    ref = m2g.m2g_fused_plain(bm, grid, table, phys, **kw)
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{name}: streams {sorted(got)} vs {sorted(ref)}")
    return (name, cs.errors((got[k], ref[k]) for k in ref), cs.TOL["m2g"],
            partial(m2g.m2g_fused_cuda, bm, grid, table, phys, **kw),
            cs.bound_ms(cs.nbytes(bm.x, bm.y, bm.T, bm.mat, bm.valid)
                        + cs.nbytes(*got.values()),
                        cs.OPS["m2g"] * int(bm.total())))


def _advect_row(name, grid, vbc, bm, moved, vel):
    from pylamp_tpu_torch.markers.kernels import advect

    vx, vy, dt = vel
    ref = advect.advect_rk4_plain(bm, vx, vy, dt, grid, vbc, 1)
    periods = (grid.lx if vbc.periodic_x else None, None)
    return (name, cs.displacement_error((moved.x, moved.y), (ref.x, ref.y),
                                        (bm.x, bm.y), periods),
            cs.TOL["advect"],
            partial(advect.advect_rk4_cuda, bm, vx, vy, dt, grid, vbc, 1),
            cs.bound_ms(cs.nbytes(bm.x, bm.y, bm.valid, vx, vy, moved.x,
                                  moved.y),
                        cs.OPS["advect"] * int(bm.total())))


def _momentum_row(name, grid, es, en, kbnd, vbc):
    from pylamp_tpu_torch.ops.kernels import momentum

    gen = torch.Generator(device="cuda").manual_seed(1)
    vx, vy = (torch.randn(s, generator=gen, device="cuda")
              for s in (grid.shape_vx, grid.shape_vy))
    if vbc.periodic_x:
        vx[:, -1] = vx[:, 0]
    prep = momentum.prep_momentum(es, en, kbnd)
    got = momentum.momentum_apply_cuda(vx, vy, prep, grid, vbc)
    ref = momentum.momentum_apply_plain(vx, vy, es, en, grid, vbc, kbnd)
    if vbc.periodic_x and not torch.equal(got[0][:, 0], got[0][:, -1]):
        raise AssertionError(f"{name}: the seam columns differ")
    return (name, cs.errors(zip(got, ref)), cs.TOL["momentum"],
            partial(momentum.momentum_apply_cuda, vx, vy, prep, grid, vbc),
            cs.bound_ms(cs.nbytes(vx, vy, prep.eta_s, prep.eta_n, prep.kb,
                                  *got), cs.stencil_ops(grid)))


def _sweep_rows(cfg, prep_s, grid):
    """Kernels 5 and 8 on the finest level of the FK solve's hierarchy:
    the pre-smooth form (zero start, degree + the residual)."""
    from pylamp_tpu_torch.ops.kernels import cheb, cheb_block
    from pylamp_tpu_torch.parallel import halo_smoother as hs
    from pylamp_tpu_torch.parallel.mesh import make_mesh
    from pylamp_tpu_torch.solvers import mg

    solver, vbc = cfg.solver, cfg.physics.velocity_bcs
    deg = max(solver.mg_pre_smooth, solver.mg_post_smooth)
    es, en, kbnd = prep_s.eta_s, prep_s.eta_n, prep_s.kk[0]
    lam = mg.gershgorin_lambda(es, en, grid, vbc, kbnd)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rx, ry = (torch.randn(s, generator=gen, device="cuda")
              for s in (grid.shape_vx, grid.shape_vy))
    zx, zy = torch.zeros_like(rx), torch.zeros_like(ry)
    prep = cheb.prep_smoother(es, en, grid, vbc, kbnd, lam, deg + 1)
    got = cheb.chebyshev_smooth_cuda(zx, zy, rx, ry, prep, grid, vbc, deg,
                                     True, True)
    ref = cheb.chebyshev_smooth_plain(zx, zy, rx, ry, es, en, grid, vbc,
                                      kbnd, lam, deg, True, True)
    rows = [("cheb", cs.errors(zip(got, ref)), cs.TOL["cheb"],
             partial(cheb.chebyshev_smooth_cuda, zx, zy, rx, ry, prep, grid,
                     vbc, deg, True, True),
             cs.bound_ms(2 * cs.nbytes(rx, ry) + cs.nbytes(
                 rx, ry, prep.eta_s, prep.eta_n, prep.coeffs, prep.kb),
                 cs.cheb_ops(grid, deg, True, True)))]
    mesh = make_mesh(cs.MESH_SHARDS)
    bprep = hs.prep_halo_smoother(es, en, grid, mesh, deg + 1, kbnd, lam)
    frames = hs.smoother_frames(zx, zy, rx, ry, vbc, mesh, bprep.h)
    got = cheb_block.cheb_block_cuda(*frames, bprep, grid, vbc, deg, True,
                                     True)
    ref = cheb_block.cheb_block_plain(*frames, bprep, grid, vbc, deg, True,
                                      True)
    S, by, bx = mesh.size, bprep.by, bprep.bx
    rows.append(("cheb_block", cs.errors(zip(got, ref)), cs.TOL["cheb_block"],
                 partial(cheb_block.cheb_block_cuda, *frames, bprep, grid,
                         vbc, deg, True, True),
                 cs.bound_ms(cs.nbytes(*frames[2:], bprep.es_v, bprep.en_v,
                                       bprep.flags, bprep.coeffs, bprep.kb,
                                       *got),
                             cs.block_ops(2 * S * by * bx, deg, True, True))))
    return rows


def _block_rows(grid, table, phys, u, prep, vbc, bm, vel, heated):
    """Kernels 9-12 at the 4x2 mesh's blocks of the FK state (the inputs of
    chip_smoke.py's mesh_kernel_rows): kernel 9 in both forms on the
    extended blocks of the solve's viscosities with vectors at u's scale,
    kernel 10 on the built markers' extended blocks (and with rho0 * alpha
    on the ``heated`` physics), kernel 11 on their own blocks with the
    solve's velocities, kernel 12 on the extended blocks of kernel 11's
    output."""
    from pylamp_tpu_torch.markers.kernels import (
        advect_block,
        m2g_block,
        rebucket_block,
    )
    from pylamp_tpu_torch.ops.kernels import saddle_block
    from pylamp_tpu_torch.parallel.halo_markers import BLK3, velocity_windows
    from pylamp_tpu_torch.parallel.mesh import P, make_mesh

    mesh = make_mesh(cs.MESH_SHARDS)
    S, by, bx = mesh.size, grid.ny // mesh.my, grid.nx // mesh.mx
    gen = torch.Generator(device="cuda").manual_seed(4)
    en_e = mesh.flat(mesh.ext1(mesh.split(prep.eta_n, P("y", "x"))))
    es_e = mesh.flat(mesh.ext1(mesh.split(prep.eta_s[:-1, :-1],
                                          P("y", "x")))[..., 1:, 1:])
    vx_e, vy_e, p_e = (torch.randn((S, by + 2, bx + 2), generator=gen,
                                   device="cuda") * torch.max(torch.abs(t))
                       for t in u)
    kcont = prep.kk[1]
    rows = []
    n = S * by * bx
    for name, p_or_none in (("saddle_block", p_e), ("saddle_block_mom", None)):
        args = (vx_e, vy_e, p_or_none, es_e, en_e, grid.dx, grid.dy, kcont)
        got = saddle_block.saddle_block_cuda(*args)
        ref = saddle_block.saddle_block_plain(*args)
        ins = (vx_e, vy_e, es_e, en_e) + ((p_e,) if p_or_none is not None
                                          else ())
        ops = n * 2 * cs.OPS["stencil"] + (
            n * (2 * cs.OPS["pressure"] + cs.OPS["continuity"])
            if p_or_none is not None else 0)
        rows.append((name, cs.errors(zip(got, ref)), cs.TOL["saddle_block"],
                     partial(saddle_block.saddle_block_cuda, *args),
                     cs.bound_ms(cs.nbytes(*ins, *got), ops)))

    bases = mesh.bases(by, bx, device="cuda")
    ext = [mesh.flat(mesh.ext1(mesh.split(a, BLK3), nd=3))
           for a in (bm.x, bm.y, bm.T, bm.mat, bm.valid)]
    for name, ph, ra in (("m2g_block", phys, False),
                         ("m2g_block_ra", heated, True)):
        kw = dict(with_energy=True, with_ra=ra)
        got = m2g_block.m2g_fused_block_cuda(*ext, grid, table, ph, bases,
                                             **kw)
        ref = m2g_block.m2g_fused_block_plain(*ext, grid, table, ph, bases,
                                              **kw)
        if sorted(got) != sorted(ref):
            raise AssertionError(f"{name}: streams {sorted(got)} vs "
                                 f"{sorted(ref)}")
        rows.append((name, cs.errors((got[k], ref[k]) for k in ref),
                     cs.TOL[name],
                     partial(m2g_block.m2g_fused_block_cuda, *ext, grid,
                             table, ph, bases, **kw),
                     cs.bound_ms(cs.nbytes(*ext, bases, *got.values()),
                                 cs.OPS["m2g"] * int(ext[4].sum()))))

    vx, vy, dt = vel
    wins = velocity_windows(vx.float(), vy.float(), grid, vbc, mesh, 1)
    own = [mesh.flat(mesh.split(a, BLK3)) for a in (bm.x, bm.y, bm.valid)]
    adv = (*own, *wins, dt, grid, bases, 1)
    got = advect_block.advect_block_cuda(*adv)
    ref = advect_block.advect_block_plain(*adv)
    rows.append(("advect_block", cs.displacement_error(got, ref, own[:2]),
                 cs.TOL["advect_block"],
                 partial(advect_block.advect_block_cuda, *adv),
                 cs.bound_ms(cs.nbytes(*own, *wins, bases, *got),
                             cs.OPS["advect"] * int(own[2].sum()))))

    moved = bm.replace(x=mesh.gather(mesh.unflat(got[0]), BLK3),
                       y=mesh.gather(mesh.unflat(got[1]), BLK3))
    ext = [mesh.flat(mesh.ext1(mesh.split(a, BLK3), nd=3))
           for a in (moved.x, moved.y, moved.T, moved.mat, moved.valid)]
    (gm, ga), (rm, ra) = (rebucket_block.rebucket_block_cuda(*ext, grid,
                                                              bases),
                          rebucket_block.rebucket_block_plain(*ext, grid,
                                                              bases))
    same = all(torch.equal(getattr(gm, f), getattr(rm, f))
               for f in ("x", "y", "mat", "T", "valid")) and torch.equal(
        ga, ra)
    rows.append(("rebucket_block", (0.0, 0.0) if same else (math.inf,) * 2,
                 cs.TOL["rebucket_block"],
                 partial(rebucket_block.rebucket_block_cuda, *ext, grid,
                         bases),
                 cs.bound_ms(cs.nbytes(*ext, bases, gm.x, gm.y, gm.T, gm.mat,
                                       gm.valid, ga),
                             cs.OPS["rebucket"] * int(ext[4].sum()))))
    return rows


def _host_parts(u):
    """Host microseconds per call of two pieces of a wrapper's launch
    path, each in two forms: the stream handle through a Stream object
    (``torch.cuda.current_stream(device).cuda_stream``) and through
    PyTorch's raw accessor; rx, ry and rc as three allocations and as one
    allocation cut into three views."""
    dev = u[0].device
    shapes = [t.shape for t in u]
    sizes = [t.numel() for t in u]

    def views():
        return [b.view(s) for b, s in zip(
            torch.empty(sum(sizes), device=dev).split(sizes), shapes)]

    return dict(
        stream_object=cs.host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        raw_stream=cs.host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        three_allocations=cs.host_us(
            lambda: [torch.empty(s, device=dev) for s in shapes]),
        one_allocation_three_views=cs.host_us(views))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree whose pylamp_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from pylamp_tpu_torch import cuda_build
    from pylamp_tpu_torch.core.grid import StaggeredGrid
    from pylamp_tpu_torch.models.benchmarks import (
        falling_block_periodic_config,
        fk_bench_config,
    )
    from pylamp_tpu_torch.models.profile import fk_heated_config

    lib, secs = cuda_build.build()
    cuda_build.library()
    smi = cs.nvidia_smi_line()
    cs.log(f"kernel_ab: {lib} (built in {secs:.1f} s) on {smi}")

    rows = []
    cfg = fk_bench_config(cs.FK_NX)
    grid, table, phys, u, prep, vbc, bm, moved, vel = _prepared(cfg)
    rows.append(_saddle_row("saddle", grid, u, prep, vbc))
    rows.append(_m2g_row("m2g", grid, table, phys, bm, with_energy=True))
    rows.append(_m2g_row("m2g_ra", grid, table,
                         fk_heated_config(cs.FK_NX).physics, bm,
                         with_energy=True, with_ra=True))
    rows.append(_advect_row("advect", grid, vbc, bm, moved, vel))
    rows.append(_rebucket_row("rebucket", grid, moved, False))
    rows += _sweep_rows(cfg, prep, grid)
    rows.append(_momentum_row("momentum_1024", grid, prep.eta_s, prep.eta_n,
                              prep.kk[0], vbc))
    rows += _block_rows(grid, table, phys, u, prep, vbc, bm, vel,
                        fk_heated_config(cs.FK_NX).physics)
    del bm, moved, vel
    g_m = StaggeredGrid(nx=cs.STICKY_NX, ny=cs.STICKY_NX // 4, lx=4.0,
                        ly=1.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    es_m, en_m = (torch.exp(2.0 * torch.randn(s, generator=gen,
                                              device="cuda"))
                  for s in (g_m.shape_corner, g_m.shape_center))
    rows.append(_momentum_row("momentum", g_m, es_m, en_m, prep.kk[0], vbc))
    grid, table, phys, u, prep, vbc, bm, moved, vel = _prepared(
        falling_block_periodic_config(cs.PERIODIC_NX))
    rows.append(_saddle_row("saddle_periodic", grid, u, prep, vbc))
    rows.append(_m2g_row("m2g_periodic", grid, table, phys, bm,
                         with_energy=phys.solve_energy, periodic_x=True))
    rows.append(_advect_row("advect_periodic", grid, vbc, bm, moved, vel))
    rows.append(_rebucket_row("rebucket_periodic", grid, moved, True))
    rows.append(_momentum_row("momentum_periodic", grid, prep.eta_s,
                              prep.eta_n, prep.kk[0], vbc))

    out = {}
    for name, (abs_err, rel), tol, fn, (b_ms, b_by) in rows:
        if not rel <= tol:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {rel:.3e} > {tol:g}")
        ms = min(cs.cuda_time_ms(fn, 20), cs.cuda_time_ms(fn, 20))
        r = dict(ms=ms, device_ms=cs.graph_ms(fn), bound_ms=b_ms,
                 bound_by=b_by, rel_err=rel)
        r["share_of_bound"] = b_ms / ms
        r["device_share_of_bound"] = b_ms / r["device_ms"]
        if name.startswith(("saddle", "momentum")):
            r["host_us"] = cs.host_us(fn)
        if name in ("saddle", "saddle_periodic"):
            r["host_parts_us"] = _host_parts(fn.args[:3])
        out[name] = r
        cs.log(f"{name}: {json.dumps(r)}")
    ptx = [r for r in cuda_build.ptxas_summary()
           if r["source"] in ("saddle.cu", "rebucket.cu", "m2g.cu",
                              "advect.cu", "cheb.cu", "cheb_block.cu",
                              "momentum.cu", "saddle_block.cu",
                              "m2g_block.cu", "advect_block.cu",
                              "rebucket_block.cu")]
    rec = {"tree": os.path.abspath(args.tree), "device": smi,
           "kernels": out, "ptxas": ptx}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
