"""Geometric multigrid preconditioner for the Stokes velocity block.

Port of ``pylamp_tpu/solvers/mg.py``: a block upper-triangular
preconditioner

    z_p = -(eta_n / kcont) * r_p          (mass Schur surrogate)
    z_v = MG(r_v - G z_p)                 (V-cycles on the momentum block)

with rediscretized coarse operators (eta_n: 2x2 geometric mean, eta_s:
injection), staggered-lattice bilinear transfers (restriction = P^T / 4,
Dirichlet entries zeroed on both) that match the reference element for
element, and one of three smoothers: Chebyshev on D^-1 A over
[lmax/4, lmax] (the default), omega-damped point Jacobi (``"jacobi"``),
or omega-damped line Jacobi with tridiagonal line solves
(``"line"``, ``"line_y"``, ``"line_x"``: solvers/lines.py).

On a stretched grid every level applies the variable-spacing operator
(ops/stretched.py), and ``semicoarsen`` > 0 coarsens only the finer axis
while the cells are anisotropic (``coarsening_plan``); every kernel's gate
fails there, so the whole hierarchy is tensor code.

Chebyshev bounds come from Gershgorin row sums on uniform levels or from
power iteration (``estimate_mg_lambdas``); ``eta_cap`` clips each coarse
level's viscosity around its geometric mean; ``al_gamma`` and
``velocity_inner_iters`` give the augmented-Lagrangian Schur surrogate and
an inner velocity FGMRES (or flexible CG) on the augmented block
(solvers/al.py).

With ``use_pallas_smoother`` (the reference's name and default) the
levels with nx >= 256 sweep through the fused Chebyshev smoother
(ops/kernels/cheb.py), and with ``use_pallas_coarse`` as well every level
below 256 cells runs as one fused sub-V-cycle (ops/kernels/coarse_vcycle.py).
With ``use_pallas`` every other momentum apply on a level that passes
``_pallas_eligible`` takes the momentum kernel (ops/kernels/momentum.py).
Their wrappers launch CUDA kernels on CUDA tensors and run the plain
versions on CPU tensors, so the CPU result does not depend on the flags.

With ``halo_mesh`` (an in-process mesh, parallel/mesh.py) every momentum
apply of a level that decomposes over it runs through the explicit-halo
operator (parallel/halo_ops.py; with ``use_pallas`` each shard's stencil
takes the per-shard saddle kernel), levels at most ``coarse_replicate``
cells across stay on the global tensors (the reference's replicated
sub-hierarchy), and ``use_pallas_smoother`` sweeps each eligible level
through the per-shard fused smoother (parallel/halo_smoother.py); the
single-device smoother and the fused coarse sub-V-cycle are off, as in the
reference.

On the sharded layout (viscosities that are ``parallel/blocks.py
Blocks``) every level that decomposes over the mesh and lies above
``coarse_replicate`` stays sharded: its coarsening, diagonals, smoother,
applies and transfers run in block form (parallel/block_ops.py, one halo
round a transfer).  Below the last such level, the residual is gathered
once on the way down and restricted on the global tensors (one "coarse"
collective), the correction is prolonged on the global tensors and split
on the way up (no message), and every coarser level runs on the global
tensors on every shard, the reference's replicated sub-hierarchy.

``scaled_transfers`` (diagonally scaled transfers) and ``ls_damp`` (a
minimal-residual line search on each prolonged correction) are the
reference's extreme-contrast stabilizers; either turns the fused coarse
sub-V-cycle off, as in the reference.  ``schur="wbfbt"`` replaces the mass
Schur surrogate with the weighted BFBT of solvers/bfbt.py.
"""
from __future__ import annotations

from functools import partial

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels import cheb
from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
from pylamp_tpu_torch.ops.kernels import momentum
from pylamp_tpu_torch.ops.stretched import pressure_gradient_stretched
from pylamp_tpu_torch.parallel import block_ops
from pylamp_tpu_torch.parallel.blocks import Blocks, gather_all
from pylamp_tpu_torch.parallel.halo_ops import (
    halo_eligible,
    stokes_operator_halo,
)
from pylamp_tpu_torch.parallel.halo_smoother import (
    chebyshev_smooth_halo,
    halo_smoother_eligible,
    prep_halo_smoother,
)
from pylamp_tpu_torch.solvers.al import make_grad_div
from pylamp_tpu_torch.solvers.bfbt import make_bfbt_schur
from pylamp_tpu_torch.solvers.krylov import fcg, fgmres, tdot
from pylamp_tpu_torch.solvers.lines import (
    line_axes,
    momentum_line_coeffs,
    pcr_factor,
    pcr_solve,
)
from pylamp_tpu_torch.solvers.scaling import characteristic_viscosity
from pylamp_tpu_torch.solvers.stokes_solver import (
    project_vx_mean,
    velocity_diagonals,
    vx_nullspace,
)


# -- viscosity coarsening -------------------------------------------------------

def coarsen_eta(eta_s, eta_n, cx: bool = True, cy: bool = True):
    """eta_n by geometric mean over the merged cells, eta_s by injection at
    the coincident corner nodes."""
    if isinstance(eta_n, Blocks):
        if not (cx and cy):
            raise ValueError("semicoarsening on the sharded layout is "
                             "ROADMAP item 19c")
        return block_ops.coarsen_eta(eta_s, eta_n)
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


# -- vx-lattice transfers (shape (ny, nx+1)) ----------------------------------------

def prolong_vx(c, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    """Bilinear prolongation on the vx lattice (coarse (NY, NX+1) -> fine
    (2NY, 2NX+1)); ghost rows carry the wall behaviour.  Periodic sides:
    the seam columns are real unknowns (equal in columns 0 and NX) and are
    interpolated like interior columns."""
    periodic = bcs.periodic_x
    if not periodic:
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
    return f if periodic else _zero_cols(f)


def restrict_vx(f, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    """P^T / 4 on the vx lattice (fine (2NY, 2NX+1) -> coarse (NY, NX+1));
    P^T / 2 along the single coarsened axis under semi-coarsening.
    Periodic sides: each fine seam column carries half the physical
    residual; they fold into one unique column, restrict with x wrap-around,
    and the coarse seam is emitted as equal halves."""
    if bcs.periodic_x:
        return _restrict_vx_periodic(f, bcs, cx, cy)
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


def _restrict_vx_periodic(f, bcs: VelocityBCs, cx: bool, cy: bool):
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
    if not cx:
        return g
    gu = g[:, :-1].clone()
    gu[:, 0] += g[:, -1]  # unique columns, the physical seam
    gz = torch.cat([gu[:, -1:], gu], dim=1)  # left wrap ghost
    cu = (0.5 * gz[:, 0:-2:2] + 1.0 * gz[:, 1:-1:2] + 0.5 * gz[:, 2::2]) / 2.0
    seam = 0.5 * cu[:, :1]
    return torch.cat([seam, cu[:, 1:], seam], dim=1)


def _ghost_cols(c, bcs: VelocityBCs):
    """vy-lattice ghost columns: wrapped (periodic) or the wall signs."""
    if bcs.periodic_x:
        return torch.cat([c[:, -1:], c, c[:, :1]], dim=1)
    return torch.cat([bcs.s_left * c[:, :1], c, bcs.s_right * c[:, -1:]],
                     dim=1)


# -- vy-lattice transfers (shape (ny+1, nx)) ----------------------------------------

def prolong_vy(c, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    c = _zero_rows(c)
    if cx:
        cg = _ghost_cols(c, bcs)
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
    f = _zero_rows(f)
    if cx:
        fg = _ghost_cols(f, bcs)
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

def _pallas_eligible(grid: StaggeredGrid, dtype) -> bool:
    """The reference's gate for the momentum kernel (mg.py
    _pallas_eligible) without its platform test: f32 uniform levels with ny
    a multiple of 128 and nx >= 256."""
    return (dtype == torch.float32 and grid.uniform and grid.ny % 128 == 0
            and grid.nx >= 256)


def momentum_apply(vx, vy, eta_s, eta_n, grid, bcs, kbnd, use_pallas=False,
                   prepped=None, halo_mesh=None):
    """Momentum-block application; with ``use_pallas`` an eligible level
    takes the momentum kernel's wrapper.  ``prepped`` is then required: the
    level's ``prep_momentum``, hoisted once per solve because the viscosity
    is frozen while the operator is applied many times.  ``halo_mesh``
    routes the apply through the explicit-halo operator (with
    ``use_pallas``, the per-shard saddle kernel's momentum-only form) or,
    on a level that does not decompose over the mesh, the plain apply on
    the global tensors.  Sharded fields take the explicit-halo apply."""
    if isinstance(vx, Blocks) or halo_mesh is not None:
        if isinstance(vx, Blocks) or halo_eligible(grid, halo_mesh):
            rx, ry, _ = stokes_operator_halo(
                vx, vy, None, eta_s, eta_n, grid, bcs, halo_mesh, kbnd=kbnd,
                use_pallas=use_pallas)
            return rx, ry
        return momentum.momentum_apply_plain(vx, vy, eta_s, eta_n, grid, bcs,
                                             kbnd)
    if use_pallas and _pallas_eligible(grid, vx.dtype):
        if prepped is None:
            raise ValueError("momentum_apply: an eligible level with "
                             "use_pallas needs its hoisted prep_momentum")
        return momentum.momentum_apply_kernel(vx, vy, prepped, grid, bcs)
    return momentum.momentum_apply_plain(vx, vy, eta_s, eta_n, grid, bcs,
                                         kbnd)


def _pressure_gradient(zp, grid, dtype, bcs: VelocityBCs | None = None):
    """G z_p: the +grad p part of the momentum rows (zero on the Dirichlet
    rows; periodic sides: the wrapped seam gradient, half in each seam
    column)."""
    if isinstance(zp, Blocks):
        return block_ops.pressure_gradient(zp, grid, dtype, bcs)
    if not grid.uniform:
        return pressure_gradient_stretched(zp, grid, dtype)
    gx_int = (zp[:, 1:] - zp[:, :-1]) / grid.dx
    if bcs is not None and bcs.periodic_x:
        seam = 0.5 * (zp[:, :1] - zp[:, -1:]) / grid.dx
        gx = torch.cat([seam, gx_int, seam], dim=1)
    else:
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
    if isinstance(eta_n, Blocks):
        return block_ops.gershgorin_lambda(eta_s, eta_n, grid, kbnd, bcs)
    dvx, dvy = velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs=bcs)
    dx, dy = grid.dx, grid.dy
    cross_vx = 2.0 * (eta_s[1:, 1:-1] + eta_s[:-1, 1:-1]) / (dx * dy)
    bx = torch.max(cross_vx / dvx[:, 1:-1])
    cross_vy = 2.0 * (eta_s[1:-1, 1:] + eta_s[1:-1, :-1]) / (dx * dy)
    by = torch.max(cross_vy / dvy[1:-1, :])
    return 2.0 + torch.maximum(bx, by)


def stays_sharded(grid: StaggeredGrid, mesh, coarse_replicate: int) -> bool:
    """Whether a level of the sharded hierarchy stays in blocks: it
    decomposes over the mesh and lies above ``coarse_replicate``."""
    return halo_eligible(grid, mesh) and not (
        coarse_replicate > 0 and min(grid.nx, grid.ny) <= coarse_replicate)


def _coarsen_level(etas, grid_c, cx, cy, coarse_replicate):
    """The next level's viscosities: in blocks while the level stays
    sharded; for the first replicated level, the last sharded level
    gathered once and coarsened on the global tensors."""
    es, en = etas
    if isinstance(en, Blocks) and not stays_sharded(grid_c, en.mesh,
                                                    coarse_replicate):
        es, en = gather_all([es, en], kind="coarse")
    return coarsen_eta(es, en, cx=cx, cy=cy)


def _hierarchy(eta_s, eta_n, grid, kbnd, levels, semicoarsen,
               coarse_replicate: int = 0):
    plan = coarsening_plan(grid, levels, semi_threshold=semicoarsen)
    grids = [grid]
    etas = [(eta_s, eta_n)]
    for cx, cy in plan:
        grids.append(grids[-1].coarsen(cx, cy))
        etas.append(_coarsen_level(etas[-1], grids[-1], cx, cy,
                                   coarse_replicate))
    # kbnd scales with 1/(dx*dy) like the stencil
    kbnds = [
        kbnd * (grids[0].dx_min * grids[0].dy_min) / (g.dx_min * g.dy_min)
        for g in grids
    ]
    return plan, grids, etas, kbnds


def _power_lambda_max(apply_Binv_A, shape_x, shape_y, dtype, device,
                      iters: int = 12):
    """lambda_max of D^-1 A on the coupled velocity space by power
    iteration from the reference's deterministic start vector; runs on the
    device without a host read."""
    def seed(shape):
        n = shape[0] * shape[1]
        v = torch.remainder(
            torch.arange(n, dtype=dtype, device=device) * 0.754877666 + 0.1,
            1.0) - 0.5
        return v.reshape(shape)

    vx, vy = seed(shape_x), seed(shape_y)
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        nrm = torch.sqrt(tdot((vx, vy), (vx, vy)))
        vx, vy = vx / nrm, vy / nrm
        wx, wy = apply_Binv_A(vx, vy)
        lam = tdot((vx, vy), (wx, wy))
        vx, vy = wx, wy
    return lam


def _level_lambda(apply, diags, grid: StaggeredGrid, device,
                  iters: int = 12):
    """1.1 x the power-iteration lambda_max of D^-1 A on one level, for
    the level's momentum apply ``apply(vx, vy)`` and Jacobi ``diags``."""
    dvx, dvy = diags

    def binv_a(vx, vy):
        ax, ay = apply(vx, vy)
        return ax / dvx, ay / dvy

    return 1.1 * _power_lambda_max(binv_a, grid.shape_vx, grid.shape_vy,
                                   dvx.dtype, device, iters)


def estimate_mg_lambdas(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                        kbnd, levels: int = 0, semicoarsen: float = 0.0,
                        hint=None, fresh_iters: int = 12,
                        refresh_iters: int = 2, mode: str = "power",
                        coarse_replicate: int = 0):
    """Per-level Chebyshev lambda_max bounds, (nlev,) tensor.

    ``mode="gershgorin"``: the analytic row-sum bound, no operator apply,
    on the uniform levels; the non-uniform levels take power iteration.
    ``mode="power"``: per-level power iteration with the plain operator on
    the (uncapped) coarsened viscosities, times a 1.1 margin.  ``hint``
    (the previous bounds, e.g. ``ModelState.mg_lam``) switches levels with
    a positive entry from ``fresh_iters`` to ``refresh_iters`` iterations
    and floors the result at 0.995x the hint; choosing the counts reads
    the hint on the host once.  Sharded viscosities: the sharded levels'
    bounds are mesh maxima, ``coarse_replicate`` as in
    ``make_velocity_mg``."""
    _, grids, etas, kbnds = _hierarchy(eta_s, eta_n, grid, kbnd, levels,
                                       semicoarsen, coarse_replicate)
    dtype = eta_n.dtype
    positive = ([h > 0 for h in hint.to(dtype).tolist()]
                if hint is not None else None)
    lams = []
    for l, ((es, en), g, kb) in enumerate(zip(etas, grids, kbnds)):
        if mode == "gershgorin" and g.uniform:
            lams.append(gershgorin_lambda(es, en, g, bcs, kb))
            continue
        iters = refresh_iters if positive is not None and positive[l] \
            else fresh_iters
        lam = _level_lambda(
            partial(momentum.momentum_apply_plain, eta_s=es, eta_n=en,
                    grid=g, bcs=bcs, kbnd=kb),
            velocity_diagonals(es, en, g, kb, bcs=bcs), g, eta_n.device, iters)
        if hint is not None:
            lam = torch.maximum(lam, 0.995 * hint[l].to(dtype))
        lams.append(lam)
    return torch.stack(lams)


def _cap_eta(a, eta_cap):
    """Clip to +-eta_cap around the array's geometric mean."""
    gm = torch.exp(torch.mean(torch.log(a)))
    return torch.clamp(a, min=gm / eta_cap, max=gm * eta_cap)


SMOOTHERS = ("chebyshev", "jacobi", "line", "line_y", "line_x")


def make_velocity_mg(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                     kbnd, levels: int = 0, pre_smooth: int = 2,
                     post_smooth: int = 2, coarse_iters: int = 32,
                     smoother: str = "chebyshev", omega: float = 0.6,
                     semicoarsen: float = 0.0, lam_max=None,
                     eta_cap: float = 0.0, use_pallas: bool = True,
                     use_pallas_smoother: bool = True,
                     use_pallas_coarse: bool = True,
                     scaled_transfers: bool = False, ls_damp: bool = False,
                     halo_mesh=None, coarse_replicate: int = 0):
    """Returns mg(rx, ry, emit=False) -> (zx, zy) [+ the cycle's residual
    (rx - A zx, ry - A zy) with ``emit``].

    ``smoother``: one of ``SMOOTHERS``; ``pre_smooth`` / ``post_smooth`` are
    Chebyshev degrees or sweep counts, ``omega`` the damping of the Jacobi
    and line sweeps.  A line smoother's tridiagonal systems are reduced once
    per level here (``lines.pcr_factor``).
    ``lam_max``: (nlev,) Chebyshev bounds (``estimate_mg_lambdas``); None
    computes them here with 12 power iterations per level (through the
    momentum dispatcher, on the capped hierarchy).
    ``eta_cap`` > 0: each COARSE level's viscosity is clipped to +-eta_cap
    around its own geometric mean (the fine level is never capped); the
    capped levels feed every smoother and the fused coarse cycle.
    ``use_pallas``: eligible levels apply the momentum block through the
    momentum kernel (ops/kernels/momentum.py), its prep hoisted per level.
    ``use_pallas_smoother``: eligible levels sweep through the fused
    smoother (ops/kernels/cheb.py); with ``use_pallas_coarse`` as well, the
    levels below 256 cells run as one fused sub-V-cycle
    (ops/kernels/coarse_vcycle.py).
    ``scaled_transfers``: operator-dependent transfers R' = D_c^(1/2) R
    D_f^(-1/2), P' = D_f^(-1/2) P D_c^(1/2) with D each level's Jacobi
    diagonal: a prolonged correction landing where the fine level is
    stiffer than the coarse one is damped by the stiffness ratio.
    ``ls_damp``: x += alpha e with alpha = <r, Ae> / <Ae, Ae> for each
    prolonged correction e (one more momentum apply per level, through the
    level's dispatcher: the momentum kernel on an eligible level).
    ``halo_mesh`` / ``coarse_replicate``: the explicit-halo levels (module
    docstring)."""
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown MG smoother {smoother!r}")
    if isinstance(eta_n, Blocks) and not stays_sharded(
            grid, eta_n.mesh, coarse_replicate):
        # the whole hierarchy replicated (the reference's constraint at
        # level 0): the viscosities gathered once, each cycle's residual
        # gathered and its correction split
        mesh = eta_n.mesh
        inner = make_velocity_mg(
            *gather_all([eta_s, eta_n], kind="coarse"), grid, bcs, kbnd,
            levels, pre_smooth, post_smooth, coarse_iters, smoother, omega,
            semicoarsen, lam_max, eta_cap, use_pallas, use_pallas_smoother,
            use_pallas_coarse, scaled_transfers, ls_damp, halo_mesh,
            coarse_replicate)

        def mg_replicated(rx, ry, emit=False):
            out = inner(*gather_all([rx, ry], kind="coarse"), emit=emit)
            return tuple(Blocks.split(o, loc, mesh) for o, loc in zip(
                out, ("vx", "vy", "vx", "vy")))

        return mg_replicated
    cheb_smoother = smoother == "chebyshev"
    plan, grids, etas, kbnds = _hierarchy(eta_s, eta_n, grid, kbnd, levels,
                                          semicoarsen, coarse_replicate)
    if eta_cap > 0.0:
        etas = [etas[0]] + [(_cap_eta(es, eta_cap), _cap_eta(en, eta_cap))
                            for es, en in etas[1:]]
    nlev = len(grids)
    dtype = eta_n.dtype
    diags = [
        velocity_diagonals(es, en, g, kb, bcs=bcs)
        for (es, en), g, kb in zip(etas, grids, kbnds)
    ]
    scales = ([(torch.sqrt(dvx), torch.sqrt(dvy)) for dvx, dvy in diags]
              if scaled_transfers else None)
    # explicit-halo applies per level, except levels replicated across the
    # mesh (coarse_replicate); momentum_apply keeps levels whose blocks are
    # too small to halo on the global tensors by itself
    hmesh = [
        None if halo_mesh is None or (
            coarse_replicate > 0 and min(g.nx, g.ny) <= coarse_replicate)
        or (isinstance(eta_n, Blocks) and not isinstance(en, Blocks))
        else halo_mesh
        for g, (_, en) in zip(grids, etas)
    ]
    # the momentum kernel's operands, once per level per solve
    preps = [
        momentum.prep_momentum(es, en, kb)
        if use_pallas and _pallas_eligible(g, dtype) and hm is None else None
        for (es, en), g, kb, hm in zip(etas, grids, kbnds, hmesh)
    ]

    def apply_A(l, ex, ey):
        es, en = etas[l]
        return momentum_apply(ex, ey, es, en, grids[l], bcs, kbnds[l],
                              use_pallas=use_pallas, prepped=preps[l],
                              halo_mesh=hmesh[l])

    if not cheb_smoother:
        lam_max = ()
    elif lam_max is None:
        lam_max = torch.stack([
            _level_lambda(partial(apply_A, l), diags[l], grids[l],
                          eta_n.device) for l in range(nlev)])
    # Chebyshev interval constants per level (frozen for the solve)
    intervals = [cheb.cheb_interval(lam) for lam in lam_max]
    # line smoothers: each level's tridiagonal line systems (the exact
    # sub/super-diagonals of its momentum stencil along each sweep axis,
    # the full diagonal), reduced once for the solve
    line_factors = None
    if smoother.startswith("line"):
        line_factors = []
        for (es, en), g, (dvx, dvy) in zip(etas, grids, diags):
            per_axis = {}
            for ax in line_axes(smoother):
                svx, pvx, svy, pvy = momentum_line_coeffs(es, en, g, bcs, ax)
                per_axis[ax] = (pcr_factor(svx, dvx, pvx, ax),
                                pcr_factor(svy, dvy, pvy, ax))
            line_factors.append(per_axis)

    # fused smoother: per-level eligibility + hoisted preps.  A level that
    # can fuse deg + 1 applications also emits the post-sweep residual from
    # the kernel, saving the V-cycle's separate momentum_apply per level.
    # fused PER-SHARD smoother under the explicit-halo engine: one
    # depth-h exchange per sweep, every iteration in one launch; frames
    # built once per level per solve
    deg = max(pre_smooth, post_smooth)
    halo_preps = [None] * nlev  # (BlockSmootherPrep, can_emit)
    if use_pallas_smoother and halo_mesh is not None and cheb_smoother:
        for l, ((es, en), g) in enumerate(zip(etas, grids)):
            if hmesh[l] is None:
                continue
            for emit in (True, False):
                if halo_smoother_eligible(g, hmesh[l], bcs, dtype, deg,
                                          emit_residual=emit):
                    halo_preps[l] = (prep_halo_smoother(
                        es, en, g, hmesh[l], deg + emit, kbnds[l],
                        lam_max[l]), emit)
                    break

    smoother_preps = [None] * nlev
    smoother_emit = [False] * nlev
    if use_pallas_smoother and halo_mesh is None and cheb_smoother:
        for l, ((es, en), g) in enumerate(zip(etas, grids)):
            if cheb.smoother_eligible(g, dtype, deg, emit_residual=True):
                h, smoother_emit[l] = deg + 1, True
            elif cheb.smoother_eligible(g, dtype, deg):
                h = deg
            else:
                continue
            smoother_preps[l] = cheb.prep_smoother(
                es, en, g, bcs, kbnds[l], lam_max[l], h, diags=diags[l])

    def smooth_damped(l, ex, ey, rx, ry, iters, zero_init, emit_residual):
        """``iters`` omega-damped Jacobi or line-Jacobi sweeps (each line
        sweep runs its axes in turn, one residual each); ``zero_init``
        skips the first residual's apply (A 0 = 0)."""
        dvx, dvy = diags[l]
        sweeps = (None,) if line_factors is None else \
            tuple(line_factors[l].values())
        for _ in range(iters):
            for factors in sweeps:
                if zero_init:
                    sx, sy = rx, ry
                    zero_init = False
                else:
                    ax, ay = apply_A(l, ex, ey)
                    sx, sy = rx - ax, ry - ay
                if factors is None:
                    ex = ex + omega * sx / dvx
                    ey = ey + omega * sy / dvy
                else:
                    ex = ex + omega * pcr_solve(factors[0], sx)
                    ey = ey + omega * pcr_solve(factors[1], sy)
        if not emit_residual:
            return ex, ey
        ax, ay = apply_A(l, ex, ey)
        return ex, ey, rx - ax, ry - ay

    def smooth(l, ex, ey, rx, ry, iters, zero_init=False,
               emit_residual=False):
        """The level's smoother; returns (ex, ey) or, with
        ``emit_residual``, (ex, ey, rx - A ex, ry - A ey) (from the fused
        Chebyshev sweep where the level supports it; one extra apply
        otherwise)."""
        if not cheb_smoother:
            return smooth_damped(l, ex, ey, rx, ry, iters, zero_init,
                                 emit_residual)
        if halo_preps[l] is not None:
            hp, can_emit = halo_preps[l]
            fuse_emit = emit_residual and can_emit
            if 1 <= iters <= hp.h - (1 if fuse_emit else 0):
                out = chebyshev_smooth_halo(
                    ex, ey, rx, ry, grids[l], bcs, kbnds[l], lam_max[l],
                    iters, hmesh[l], hp, zero_init, fuse_emit)
                if fuse_emit or not emit_residual:
                    return out
                ex, ey = out
                ax, ay = apply_A(l, ex, ey)
                return ex, ey, rx - ax, ry - ay
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
            interval=intervals[l], apply=lambda vx, vy: apply_A(l, vx, vy))

    # fused coarse sub-V-cycle: every level below the cutoff in one launch
    fused_coarse = None
    if (use_pallas_smoother and use_pallas_coarse and halo_mesh is None
            and len(lam_max) == nlev):
        fs = cvk.coarse_fuse_start(grids, plan, bcs, dtype, smoother,
                                   scaled_transfers, ls_damp)
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
        if isinstance(rfx, Blocks):
            ecx, ecy = vcycle(l + 1, *_down(l, rfx, rfy))
            pex, pey = _up(l, ecx, ecy)
        elif scaled_transfers:
            sfx, sfy = scales[l]
            scx, scy = scales[l + 1]
            ecx, ecy = vcycle(
                l + 1, scx * restrict_vx(rfx / sfx, bcs, cx=pcx, cy=pcy),
                scy * restrict_vy(rfy / sfy, bcs, cx=pcx, cy=pcy))
            pex = prolong_vx(scx * ecx, bcs, cx=pcx, cy=pcy) / sfx
            pey = prolong_vy(scy * ecy, bcs, cx=pcx, cy=pcy) / sfy
        else:
            ecx, ecy = vcycle(l + 1, restrict_vx(rfx, bcs, cx=pcx, cy=pcy),
                              restrict_vy(rfy, bcs, cx=pcx, cy=pcy))
            pex = prolong_vx(ecx, bcs, cx=pcx, cy=pcy)
            pey = prolong_vy(ecy, bcs, cx=pcx, cy=pcy)
        if ls_damp:
            aex, aey = apply_A(l, pex, pey)
            # alpha on Ae / s with s = max|Ae|, so that the squared sums
            # cannot overflow f32 (momentum entries reach ~1e15 at mantle
            # viscosities)
            tiny = torch.finfo(rx.dtype).tiny
            s = torch.clamp(torch.maximum(torch.max(torch.abs(aex)),
                                          torch.max(torch.abs(aey))),
                            min=tiny)
            ue = (aex / s, aey / s)
            num = tdot((rfx, rfy), ue)
            den = s * tdot(ue, ue)
            alpha = num / torch.clamp(den, min=tiny)
            pex, pey = alpha * pex, alpha * pey
        ex = ex + pex
        ey = ey + pey
        return smooth(l, ex, ey, rx, ry, post_smooth, emit_residual=emit)

    def _down(l, rfx, rfy):
        """Level l's sharded residual restricted into level l + 1's
        layout: in blocks, or, where l + 1 is replicated, gathered once
        and restricted on the global tensors."""
        if isinstance(etas[l + 1][1], Blocks):
            return block_ops.restrict(rfx, rfy, bcs)
        rfx, rfy = gather_all([rfx, rfy], kind="coarse")
        return restrict_vx(rfx, bcs), restrict_vy(rfy, bcs)

    def _up(l, ecx, ecy):
        """Level l + 1's correction prolonged onto sharded level l: in
        blocks, or from the replicated level on the global tensors, then
        split (no message)."""
        if isinstance(ecx, Blocks):
            return block_ops.prolong(ecx, ecy, bcs)
        pex, pey = prolong_vx(ecx, bcs), prolong_vy(ecy, bcs)
        mesh = etas[l][1].mesh
        return Blocks.split(pex, "vx", mesh), Blocks.split(pey, "vy", mesh)

    def mg(rx, ry, emit=False):
        return vcycle(0, rx, ry, emit=emit)

    return mg


def make_mg_preconditioner(eta_s, eta_n, grid: StaggeredGrid, kcont, kbnd,
                           bcs: VelocityBCs = None, levels: int = 0,
                           cycles: int = 1, pre_smooth: int = 2,
                           post_smooth: int = 2, smoother: str = "chebyshev",
                           omega: float = 0.6,
                           scaled_transfers: bool = False,
                           ls_damp: bool = False,
                           semicoarsen: float = 0.0, lam_max=None,
                           schur: str = "mass",
                           schur_poisson_iters: int = 3,
                           velocity_inner_iters: int = 0,
                           velocity_inner_tol: float = 3e-2,
                           velocity_inner_method: str = "fgmres",
                           eta_cap: float = 0.0, al_gamma: float = 0.0,
                           use_pallas: bool = True,
                           use_pallas_smoother: bool = True,
                           use_pallas_coarse: bool = True, halo_mesh=None,
                           coarse_replicate: int = 0):
    """Block upper-triangular preconditioner M(r) for the full Stokes
    system: the Schur surrogate (``schur="mass"``: -(1 + al_gamma) eta_n /
    kcont; ``"wbfbt"``: the weighted BFBT of solvers/bfbt.py with
    ``schur_poisson_iters`` flexible-CG iterations per pressure-Poisson
    solve), then the velocity block by ``cycles`` V-cycles or, with ``velocity_inner_iters``
    > 0, by an inner FGMRES (restart = maxiter = that count, relative
    ``velocity_inner_tol``; ``velocity_inner_method="fcg"``: flexible CG
    with that many iterations) on A + al_gamma D^T eta_n D preconditioned
    by one V-cycle on the un-augmented A.  ``eta_cap``, the ``use_pallas*``
    flags, ``scaled_transfers``, ``ls_damp``, ``halo_mesh`` and
    ``coarse_replicate`` go to ``make_velocity_mg``; the inner solve's own momentum applies take the
    momentum kernel on an eligible fine level too (the explicit-halo apply
    under ``halo_mesh``)."""
    if bcs is None:
        bcs = VelocityBCs()
    if schur == "wbfbt" and bcs.periodic_x:
        raise ValueError(
            "schur='wbfbt' has no periodic-wrap pressure-Poisson path yet; "
            "use schur='mass' with periodic side walls")
    if schur not in ("mass", "wbfbt"):
        raise ValueError(f"unknown schur surrogate {schur!r}")
    mg = make_velocity_mg(eta_s, eta_n, grid, bcs, kbnd, levels=levels,
                          pre_smooth=pre_smooth, post_smooth=post_smooth,
                          smoother=smoother, omega=omega,
                          semicoarsen=semicoarsen, lam_max=lam_max,
                          eta_cap=eta_cap, use_pallas=use_pallas,
                          use_pallas_smoother=use_pallas_smoother,
                          use_pallas_coarse=use_pallas_coarse,
                          scaled_transfers=scaled_transfers, ls_damp=ls_damp,
                          halo_mesh=halo_mesh,
                          coarse_replicate=coarse_replicate)
    dtype = eta_n.dtype
    project = vx_nullspace(bcs)
    if schur == "wbfbt":
        S_inv = make_bfbt_schur(eta_s, eta_n, grid, bcs, kcont, kbnd,
                                characteristic_viscosity(eta_n),
                                poisson_iters=schur_poisson_iters)
    else:
        # with the augmented-Lagrangian row op (solvers/al.py) the Schur
        # surrogate gains the grad-div contribution
        sschur = 1.0 + al_gamma

        def S_inv(rc):
            return -sschur * (eta_n / kcont) * rc
    gd = make_grad_div(eta_n, grid, bcs, al_gamma, dtype) \
        if al_gamma > 0.0 else None

    if velocity_inner_iters > 0:
        prep = (momentum.prep_momentum(eta_s, eta_n, kbnd)
                if use_pallas and _pallas_eligible(grid, dtype)
                and halo_mesh is None else None)

        def vop(u):
            # the inner Krylov targets the AUGMENTED velocity block
            # A + gamma D^T(eta_n D), preconditioned by the un-augmented
            # V-cycle
            ax, ay = momentum_apply(u[0], u[1], eta_s, eta_n, grid, bcs, kbnd,
                                    use_pallas=use_pallas, prepped=prep,
                                    halo_mesh=halo_mesh)
            if gd is not None:
                tx, ty = gd(u[0], u[1])
                ax = ax + tx
                ay = ay + ty
            return ax, ay

        def vel_solve(rvx, rvy):
            x0 = (torch.zeros_like(rvx), torch.zeros_like(rvy))
            if velocity_inner_method == "fcg":
                # the momentum block is SPD and the V-cycle approximately
                # so: flexible CG, no stored basis
                z, _ = fcg(vop, (rvx, rvy), x0, M=lambda r: mg(r[0], r[1]),
                           tol=velocity_inner_tol,
                           maxiter=velocity_inner_iters)
                return z
            z, _ = fgmres(vop, (rvx, rvy), x0,
                          M=lambda r: mg(r[0], r[1]), tol=velocity_inner_tol,
                          restart=velocity_inner_iters,
                          maxiter=velocity_inner_iters, cgs_passes=1)
            return z
    else:
        def vel_solve(rvx, rvy):
            # the first cycle starts from zero; each non-final cycle emits
            # the running residual for the next
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
        zp = S_inv(rc)
        zp = zp - torch.mean(zp)
        gx, gy = _pressure_gradient(zp, grid, dtype, bcs=bcs)
        zx, zy = vel_solve(rx - gx, ry - gy)
        if project:
            zx = project_vx_mean(zx)
        return (zx, zy, zp)

    return M
