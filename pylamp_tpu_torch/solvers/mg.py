"""Geometric multigrid preconditioner for the Stokes velocity block.

Port of the uniform-grid Chebyshev path of ``pylamp_tpu/solvers/mg.py``:
a block upper-triangular preconditioner

    z_p = -(eta_n / kcont) * r_p          (mass Schur surrogate)
    z_v = MG(r_v - G z_p)                 (V-cycles on the momentum block)

with rediscretized coarse operators (eta_n: 2x2 geometric mean, eta_s:
injection), Chebyshev smoothing of D^-1 A over [lmax/4, lmax] with
per-level Gershgorin bounds, and staggered-lattice bilinear transfers
(restriction = P^T / 4, Dirichlet entries zeroed on both) that match the
reference element for element.

With ``use_pallas_smoother`` (the reference's name and default) the
levels with nx >= 256 sweep through the fused Chebyshev smoother
(ops/kernels/cheb.py), and with ``use_pallas_coarse`` as well every level
below 256 cells runs as one fused sub-V-cycle (ops/kernels/coarse_vcycle.py).
Their wrappers launch CUDA kernels on CUDA tensors and run the plain
versions on CPU tensors, so the CPU result does not depend on the flags.
Still to port: the power-iteration lambda mode, scaled transfers, line
search damping, the eta cap, the velocity inner Krylov, BFBT, AL, the
``use_pallas`` momentum-apply kernel and the mesh options.
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import cheb
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.ops.kernels.cheb import momentum_apply
from pylamp_tpu_torch.solvers.stokes_solver import (
    project_vx_mean,
    velocity_diagonals,
    vx_nullspace,
)


def _later(what):
    return NotImplementedError(f"{what} waits for a later port PR")


# -- viscosity coarsening -------------------------------------------------------

def coarsen_eta(eta_s, eta_n, cx: bool = True, cy: bool = True):
    """eta_n by geometric mean over the merged cells, eta_s by injection at
    the coincident corner nodes."""
    if cx and cy:
        eta_n_c = torch.exp(
            0.25
            * (
                torch.log(eta_n[0::2, 0::2])
                + torch.log(eta_n[0::2, 1::2])
                + torch.log(eta_n[1::2, 0::2])
                + torch.log(eta_n[1::2, 1::2])
            )
        )
        eta_s_c = eta_s[0::2, 0::2]
    elif cx:
        eta_n_c = torch.exp(
            0.5 * (torch.log(eta_n[:, 0::2]) + torch.log(eta_n[:, 1::2])))
        eta_s_c = eta_s[:, 0::2]
    elif cy:
        eta_n_c = torch.exp(
            0.5 * (torch.log(eta_n[0::2, :]) + torch.log(eta_n[1::2, :])))
        eta_s_c = eta_s[0::2, :]
    else:
        raise ValueError("coarsen_eta needs at least one axis")
    return eta_s_c, eta_n_c


# -- interleave / masking helpers ------------------------------------------------

def _interleave_rows(a, b):
    """rows [a0, b0, a1, b1, ...]; (n, m) -> (2n, m)"""
    n, m = a.shape
    return torch.stack([a, b], dim=1).reshape(2 * n, m)


def _interleave_cols(a, b):
    n, m = a.shape
    return torch.stack([a, b], dim=2).reshape(n, 2 * m)


def _zero_cols(a):
    a = a.clone()
    a[:, 0] = 0.0
    a[:, -1] = 0.0
    return a


def _zero_rows(a):
    a = a.clone()
    a[0, :] = 0.0
    a[-1, :] = 0.0
    return a


def _no_periodic(bcs):
    if bcs.periodic_x:
        raise _later("periodic multigrid")


# -- vx-lattice transfers (shape (ny, nx+1)) ----------------------------------------

def prolong_vx(c, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    """Bilinear prolongation on the vx lattice (coarse (NY, NX+1) -> fine
    (2NY, 2NX+1)); ghost rows carry the wall behaviour."""
    _no_periodic(bcs)
    c = _zero_cols(c)
    if cy:
        cg = torch.cat([bcs.s_top * c[:1], c, bcs.s_bottom * c[-1:]], dim=0)
        a0 = 0.25 * cg[:-2] + 0.75 * cg[1:-1]
        a1 = 0.75 * cg[1:-1] + 0.25 * cg[2:]
        e = _interleave_rows(a0, a1)
    else:
        e = c
    if cx:
        odd = 0.5 * (e[:, :-1] + e[:, 1:])
        f = torch.cat([_interleave_cols(e[:, :-1], odd), e[:, -1:]], dim=1)
    else:
        f = e
    return _zero_cols(f)


def restrict_vx(f, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    """P^T / 4 on the vx lattice (fine (2NY, 2NX+1) -> coarse (NY, NX+1));
    P^T / 2 along the single coarsened axis under semi-coarsening."""
    _no_periodic(bcs)
    f = _zero_cols(f)
    if cy:
        fg = torch.cat([bcs.s_top * f[:1], f, bcs.s_bottom * f[-1:]], dim=0)
        g = (
            0.25 * fg[0:-3:2]
            + 0.75 * fg[1:-2:2]
            + 0.75 * fg[2:-1:2]
            + 0.25 * fg[3::2]
        ) / 2.0
    else:
        g = f
    if cx:
        gz = torch.nn.functional.pad(g, (1, 1))
        c = 0.5 * gz[:, 0:-2:2] + 1.0 * gz[:, 1:-1:2] + 0.5 * gz[:, 2::2]
        c = c / 2.0
    else:
        c = g
    return _zero_cols(c)


# -- vy-lattice transfers (shape (ny+1, nx)) ----------------------------------------

def prolong_vy(c, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    _no_periodic(bcs)
    c = _zero_rows(c)
    if cx:
        cg = torch.cat([bcs.s_left * c[:, :1], c, bcs.s_right * c[:, -1:]],
                       dim=1)
        a0 = 0.25 * cg[:, :-2] + 0.75 * cg[:, 1:-1]
        a1 = 0.75 * cg[:, 1:-1] + 0.25 * cg[:, 2:]
        e = _interleave_cols(a0, a1)
    else:
        e = c
    if cy:
        odd = 0.5 * (e[:-1, :] + e[1:, :])
        f = torch.cat([_interleave_rows(e[:-1, :], odd), e[-1:, :]], dim=0)
    else:
        f = e
    return _zero_rows(f)


def restrict_vy(f, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    _no_periodic(bcs)
    f = _zero_rows(f)
    if cx:
        fg = torch.cat([bcs.s_left * f[:, :1], f, bcs.s_right * f[:, -1:]],
                       dim=1)
        g = (
            0.25 * fg[:, 0:-3:2]
            + 0.75 * fg[:, 1:-2:2]
            + 0.75 * fg[:, 2:-1:2]
            + 0.25 * fg[:, 3::2]
        ) / 2.0
    else:
        g = f
    if cy:
        gz = torch.nn.functional.pad(g, (0, 0, 1, 1))
        c = 0.5 * gz[0:-2:2, :] + 1.0 * gz[1:-1:2, :] + 0.5 * gz[2::2, :]
        c = c / 2.0
    else:
        c = g
    return _zero_rows(c)


# -- level structure --------------------------------------------------------------

def _pressure_gradient(zp, grid, dtype):
    """G z_p: the +grad p part of the momentum rows (zero on the Dirichlet
    rows)."""
    gx_int = (zp[:, 1:] - zp[:, :-1]) / grid.dx
    zeros_x = torch.zeros((grid.ny, 1), dtype=dtype, device=zp.device)
    gx = torch.cat([zeros_x, gx_int, zeros_x], dim=1)
    gy_int = (zp[1:, :] - zp[:-1, :]) / grid.dy
    zeros_y = torch.zeros((1, grid.nx), dtype=dtype, device=zp.device)
    gy = torch.cat([zeros_y, gy_int, zeros_y], dim=0)
    return gx, gy


def coarsening_plan(grid: StaggeredGrid, requested: int = 0,
                    min_cells: int = 4, semi_threshold: float = 0.0) -> list:
    """Per-level coarsening directions ``(cx, cy)``; ``nlev = len(plan) +
    1``.  ``semi_threshold`` > 0 coarsens only the finer axis while one
    axis's spacing is that factor smaller than the other's."""
    plan = []
    g = grid
    while requested <= 0 or len(plan) < requested - 1:
        can_x = g.nx % 2 == 0 and g.nx > min_cells
        can_y = g.ny % 2 == 0 and g.ny > min_cells
        if semi_threshold <= 0:
            if not (can_x and can_y):
                break
            step = (True, True)
        elif g.dy_min >= semi_threshold * g.dx_min and can_x:
            step = (True, False)
        elif g.dx_min >= semi_threshold * g.dy_min and can_y:
            step = (False, True)
        elif can_x and can_y:
            step = (True, True)
        else:
            break
        plan.append(step)
        g = g.coarsen(*step)
    return plan


def gershgorin_lambda(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                      kbnd):
    """Rigorous Chebyshev upper bound on lambda_max(D^-1 A) for the coupled
    momentum operator from Gershgorin row sums (2 + cross/diag <= 3)."""
    dvx, dvy = velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs=bcs)
    dx, dy = grid.dx, grid.dy
    cross_vx = 2.0 * (eta_s[1:, 1:-1] + eta_s[:-1, 1:-1]) / (dx * dy)
    bx = torch.max(cross_vx / dvx[:, 1:-1])
    cross_vy = 2.0 * (eta_s[1:-1, 1:] + eta_s[1:-1, :-1]) / (dx * dy)
    by = torch.max(cross_vy / dvy[1:-1, :])
    return 2.0 + torch.maximum(bx, by)


def _hierarchy(eta_s, eta_n, grid, kbnd, levels, semicoarsen):
    plan = coarsening_plan(grid, levels, semi_threshold=semicoarsen)
    grids = [grid]
    etas = [(eta_s, eta_n)]
    for cx, cy in plan:
        grids.append(grids[-1].coarsen(cx, cy))
        etas.append(coarsen_eta(*etas[-1], cx=cx, cy=cy))
    # kbnd scales with 1/(dx*dy) like the stencil
    kbnds = [
        kbnd * (grids[0].dx_min * grids[0].dy_min) / (g.dx_min * g.dy_min)
        for g in grids
    ]
    return plan, grids, etas, kbnds


def estimate_mg_lambdas(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                        kbnd, levels: int = 0, semicoarsen: float = 0.0,
                        hint=None, mode: str = "power"):
    """Per-level Chebyshev lambda_max bounds, (nlev,) tensor.  Only the
    analytic ``mode="gershgorin"`` is ported."""
    if mode != "gershgorin":
        raise _later("power-iteration lambda estimation")
    _, grids, etas, kbnds = _hierarchy(eta_s, eta_n, grid, kbnd, levels,
                                       semicoarsen)
    return torch.stack([
        gershgorin_lambda(es, en, g, bcs, kb)
        for (es, en), g, kb in zip(etas, grids, kbnds)
    ])


def make_velocity_mg(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                     kbnd, levels: int = 0, pre_smooth: int = 2,
                     post_smooth: int = 2, coarse_iters: int = 32,
                     semicoarsen: float = 0.0, lam_max=None,
                     use_pallas_smoother: bool = True,
                     use_pallas_coarse: bool = True):
    """Returns mg(rx, ry, emit=False) -> (zx, zy) [+ the cycle's residual
    (rx - A zx, ry - A zy) with ``emit``].

    ``lam_max``: (nlev,) Chebyshev bounds (``estimate_mg_lambdas``); the
    reference's power-iteration default is not ported, so it is required.
    ``use_pallas_smoother``: eligible levels sweep through the fused
    smoother (ops/kernels/cheb.py); with ``use_pallas_coarse`` as well, the
    levels below 256 cells run as one fused sub-V-cycle
    (ops/kernels/coarse_vcycle.py)."""
    if lam_max is None:
        raise _later("power-iteration lambda estimation")
    _no_periodic(bcs)
    plan, grids, etas, kbnds = _hierarchy(eta_s, eta_n, grid, kbnd, levels,
                                          semicoarsen)
    nlev = len(grids)
    dtype = eta_n.dtype
    diags = [
        velocity_diagonals(es, en, g, kb, bcs=bcs)
        for (es, en), g, kb in zip(etas, grids, kbnds)
    ]
    # Chebyshev interval constants per level (frozen for the solve)
    intervals = [cheb.cheb_interval(lam_max[l]) for l in range(nlev)]

    # fused smoother: per-level eligibility + hoisted preps.  A level that
    # can fuse deg + 1 applications also emits the post-sweep residual from
    # the kernel, saving the V-cycle's separate momentum_apply per level.
    smoother_preps = [None] * nlev
    smoother_emit = [False] * nlev
    if use_pallas_smoother:
        deg = max(pre_smooth, post_smooth)
        for l, ((es, en), g) in enumerate(zip(etas, grids)):
            if cheb.smoother_eligible(g, dtype, deg, emit_residual=True):
                h, smoother_emit[l] = deg + 1, True
            elif cheb.smoother_eligible(g, dtype, deg):
                h = deg
            else:
                continue
            smoother_preps[l] = cheb.prep_smoother(
                es, en, g, bcs, kbnds[l], lam_max[l], h, diags=diags[l])

    def apply_A(l, ex, ey):
        es, en = etas[l]
        return momentum_apply(ex, ey, es, en, grids[l], bcs, kbnds[l])

    def smooth(l, ex, ey, rx, ry, iters, zero_init=False,
               emit_residual=False):
        """Chebyshev semi-iteration on D^-1 A; returns (ex, ey) or, with
        ``emit_residual``, (ex, ey, rx - A ex, ry - A ey) (from the fused
        sweep where the level supports it; one extra apply otherwise)."""
        prep = smoother_preps[l]
        fuse_emit = emit_residual and smoother_emit[l]
        if prep is not None and 1 <= iters <= prep.h - (1 if fuse_emit else 0):
            if fuse_emit:
                return cheb.chebyshev_smooth(ex, ey, rx, ry, prep, grids[l],
                                             bcs, iters, zero_init, True)
            ex, ey = cheb.chebyshev_smooth(ex, ey, rx, ry, prep, grids[l],
                                           bcs, iters, zero_init)
            if not emit_residual:
                return ex, ey
            ax, ay = apply_A(l, ex, ey)
            return ex, ey, rx - ax, ry - ay
        es, en = etas[l]
        return cheb.chebyshev_smooth_plain(
            ex, ey, rx, ry, es, en, grids[l], bcs, kbnds[l], lam_max[l], iters,
            zero_init=zero_init, emit_residual=emit_residual, diags=diags[l],
            interval=intervals[l])

    # fused coarse sub-V-cycle: every level below the cutoff in one launch
    fused_coarse = None
    if use_pallas_smoother and use_pallas_coarse and len(lam_max) == nlev:
        fs = cvk.coarse_fuse_start(grids, plan, bcs, dtype, "chebyshev",
                                   False, False)
        if fs is not None:
            fused_coarse = (fs, cvk.CoarseVcyclePrep(
                grids[fs:], etas[fs:], kbnds[fs:], lam_max[fs:], bcs,
                pre_smooth, post_smooth, coarse_iters, diags=diags[fs:]))

    def vcycle(l, rx, ry, emit=False):
        if fused_coarse is not None and l == fused_coarse[0] and not emit:
            return cvk.coarse_vcycle(rx, ry, fused_coarse[1])
        ex = torch.zeros_like(rx)
        ey = torch.zeros_like(ry)
        if l == nlev - 1:
            return smooth(l, ex, ey, rx, ry, coarse_iters, zero_init=True,
                          emit_residual=emit)
        ex, ey, rfx, rfy = smooth(l, ex, ey, rx, ry, pre_smooth,
                                  zero_init=True, emit_residual=True)
        pcx, pcy = plan[l]
        rcx = restrict_vx(rfx, bcs, cx=pcx, cy=pcy)
        rcy = restrict_vy(rfy, bcs, cx=pcx, cy=pcy)
        ecx, ecy = vcycle(l + 1, rcx, rcy)
        ex = ex + prolong_vx(ecx, bcs, cx=pcx, cy=pcy)
        ey = ey + prolong_vy(ecy, bcs, cx=pcx, cy=pcy)
        return smooth(l, ex, ey, rx, ry, post_smooth, emit_residual=emit)

    def mg(rx, ry, emit=False):
        return vcycle(0, rx, ry, emit=emit)

    return mg


def make_mg_preconditioner(eta_s, eta_n, grid: StaggeredGrid, kcont, kbnd,
                           bcs: VelocityBCs = None, levels: int = 0,
                           cycles: int = 1, pre_smooth: int = 2,
                           post_smooth: int = 2, smoother: str = "chebyshev",
                           semicoarsen: float = 0.0, lam_max=None,
                           schur: str = "mass",
                           use_pallas_smoother: bool = True,
                           use_pallas_coarse: bool = True):
    """Block upper-triangular preconditioner M(r) for the full Stokes
    system (mass Schur surrogate, ``cycles`` V-cycles on the velocity
    block); the ``use_pallas_*`` flags go to ``make_velocity_mg``."""
    if bcs is None:
        bcs = VelocityBCs()
    if smoother != "chebyshev":
        raise _later(f"the {smoother!r} MG smoother")
    if schur != "mass":
        raise _later(f"the {schur!r} Schur surrogate")
    mg = make_velocity_mg(eta_s, eta_n, grid, bcs, kbnd, levels=levels,
                          pre_smooth=pre_smooth, post_smooth=post_smooth,
                          semicoarsen=semicoarsen, lam_max=lam_max,
                          use_pallas_smoother=use_pallas_smoother,
                          use_pallas_coarse=use_pallas_coarse)
    dtype = eta_n.dtype
    project = vx_nullspace(bcs)

    def vel_solve(rvx, rvy):
        # the first cycle starts from zero; each non-final cycle emits the
        # running residual for the next
        if cycles == 1:
            return mg(rvx, rvy)
        zx, zy, rfx, rfy = mg(rvx, rvy, emit=True)
        for c in range(cycles - 1):
            if c == cycles - 2:
                dx_, dy_ = mg(rfx, rfy)
            else:
                dx_, dy_, rfx, rfy = mg(rfx, rfy, emit=True)
            zx = zx + dx_
            zy = zy + dy_
        return zx, zy

    def M(r):
        rx, ry, rc = r
        zp = -1.0 * (eta_n / kcont) * rc
        zp = zp - torch.mean(zp)
        gx, gy = _pressure_gradient(zp, grid, dtype)
        zx, zy = vel_solve(rx - gx, ry - gy)
        if project:
            zx = project_vx_mean(zx)
        return (zx, zy, zp)

    return M
