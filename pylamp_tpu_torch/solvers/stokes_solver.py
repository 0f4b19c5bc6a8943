"""Matrix-free Stokes solve: FGMRES + block preconditioner + pressure gauge.

Port of ``pylamp_tpu/solvers/stokes_solver.py``:
``solve_stokes`` in the state dtype, ``solve_stokes_mixed`` with f32
FGMRES + MG inner solves under f64 iterative refinement.  Without a
``make_preconditioner`` both take the block-Jacobi preconditioner
(``make_block_jacobi_preconditioner``), as the reference's do.  In the mixed
solve the f32 outer applies go through the saddle kernel wrapper
(ops/kernels/saddle.py) when ``use_pallas_apply`` is set and the grid
passes ``saddle_apply_eligible`` (uniform: a stretched grid applies the
variable-spacing operator as tensor code), and ``al_gamma``
augments the system (solvers/al.py).  ``solve_stokes`` takes no
``al_gamma``, as in the reference.  ``halo_mesh`` routes every operator
application through the explicit-halo operator (parallel/halo_ops.py);
there the f32 outer applies take the per-shard saddle kernel
(ops/kernels/saddle_block.py) instead of the single-device one.  Sharded
fields (parallel/blocks.py) solve on their blocks: the operator through
the explicit-halo apply, the rhs in block form, the gauge and every
Krylov dot as mesh reductions.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from pylamp_tpu_torch.core.bc import FREE_SLIP, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.kernels.saddle import saddle_apply_eligible
from pylamp_tpu_torch.ops.stokes import stokes_operator, stokes_rhs
from pylamp_tpu_torch.solvers.al import (
    augment_rhs,
    augment_saddle_op,
    make_grad_div,
)
from pylamp_tpu_torch.solvers.krylov import SolveInfo, fgmres, tmap
from pylamp_tpu_torch.solvers.scaling import (
    characteristic_viscosity,
    stokes_scales,
)


class StokesSolution(NamedTuple):
    vx: Any
    vy: Any
    p: Any
    info: SolveInfo


def velocity_diagonals(eta_s, eta_n, grid: StaggeredGrid, kbnd,
                       bcs: VelocityBCs | None = None):
    """Analytic diagonals of the momentum stencils (kbnd on the Dirichlet
    rows; periodic side walls: the wrapped seam diagonal, half of it in each
    seam column, as ops/stokes.py emits the seam row; a stretched grid:
    ops/stretched.py; sharded fields: parallel/block_ops.py)."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(eta_n, Blocks):
        from pylamp_tpu_torch.parallel import block_ops

        return block_ops.velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs)
    if not grid.uniform:
        from pylamp_tpu_torch.ops.stretched import velocity_diagonals_stretched

        return velocity_diagonals_stretched(eta_s, eta_n, grid, kbnd)
    dx, dy = grid.dx, grid.dy
    dvx_int = (
        2.0 * (eta_n[:, 1:] + eta_n[:, :-1]) / dx**2
        + (eta_s[1:, 1:-1] + eta_s[:-1, 1:-1]) / dy**2
    )
    if bcs is not None and bcs.periodic_x:
        seam = 0.5 * (
            2.0 * (eta_n[:, :1] + eta_n[:, -1:]) / dx**2
            + (eta_s[1:, :1] + eta_s[:-1, :1]) / dy**2
        )
        dvx = torch.cat([seam, dvx_int, seam], dim=1)
    else:
        kb_col = torch.as_tensor(kbnd, dtype=eta_n.dtype, device=eta_n.device
                                 ).expand(dvx_int.shape[0], 1)
        dvx = torch.cat([kb_col, dvx_int, kb_col], dim=1)
    dvy_int = (
        2.0 * (eta_n[1:, :] + eta_n[:-1, :]) / dy**2
        + (eta_s[1:-1, 1:] + eta_s[1:-1, :-1]) / dx**2
    )
    kb_row = torch.as_tensor(kbnd, dtype=eta_n.dtype,
                             device=eta_n.device).expand(1, dvy_int.shape[1])
    dvy = torch.cat([kb_row, dvy_int, kb_row], dim=0)
    return dvx, dvy


def vx_nullspace(bcs: VelocityBCs) -> bool:
    """True when the operator has a constant-vx nullspace: periodic sides
    with free-slip top AND bottom."""
    return bcs.periodic_x and bcs.top == FREE_SLIP and bcs.bottom == FREE_SLIP


def project_vx_mean(vx):
    """Remove the constant-vx mode (the duplicated seam column counted
    once; sharded fields: parallel/block_ops.py)."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(vx, Blocks):
        from pylamp_tpu_torch.parallel import block_ops

        return block_ops.project_vx_mean(vx)
    return vx - torch.mean(vx[:, :-1])


def make_block_jacobi_preconditioner(eta_s, eta_n, grid, kcont, kbnd,
                                     bcs=None):
    """Block-diagonal preconditioner: velocity, pointwise Jacobi on the
    momentum diagonals (``velocity_diagonals``, the stretched form on a
    stretched grid, as the reference's); pressure, the viscosity-scaled
    mass matrix (Schur complement surrogate S ~ -kcont/eta), projected to
    the zero-mean gauge."""
    dvx, dvy = velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs=bcs)
    project = bcs is not None and vx_nullspace(bcs)
    scale = -(eta_n / kcont)

    def M(r):
        rx, ry, rc = r
        zx = rx / dvx
        zy = ry / dvy
        if project:
            zx = project_vx_mean(zx)
        zp = scale * rc
        return (zx, zy, zp - torch.mean(zp))

    return M


def _zeros_like_grid(grid, dtype, device):
    return (
        torch.zeros(grid.shape_vx, dtype=dtype, device=device),
        torch.zeros(grid.shape_vy, dtype=dtype, device=device),
        torch.zeros(grid.shape_center, dtype=dtype, device=device),
    )


def solve_stokes(eta_s, eta_n, rho_vx, rho_vy, gx, gy, grid: StaggeredGrid,
                 bcs: VelocityBCs, tol: float = 1e-8, restart: int = 40,
                 maxiter: int = 2000, x0=None,
                 make_preconditioner: Callable | None = None,
                 halo_mesh=None) -> StokesSolution:
    """Solve the scaled Stokes system to ``tol`` relative residual in the
    viscosity's dtype.  ``make_preconditioner(eta_s, eta_n, grid, kcont,
    kbnd, bcs=...) -> M`` overrides the default block-Jacobi (e.g. the
    multigrid preconditioner of mg.py)."""
    dtype = eta_n.dtype
    kcont, kbnd = stokes_scales(characteristic_viscosity(eta_n), grid)

    def op(u):
        vx, vy, p = u
        return stokes_operator(vx, vy, p, eta_s, eta_n, grid, bcs,
                               kcont=kcont, kbnd=kbnd, halo_mesh=halo_mesh)

    b = stokes_rhs(rho_vx, rho_vy, gx, gy, grid, bcs, kbnd=kbnd, dtype=dtype,
                   eta_s=eta_s)
    mk = make_preconditioner or make_block_jacobi_preconditioner
    M = mk(eta_s, eta_n, grid, kcont, kbnd, bcs=bcs)
    if x0 is None:
        x0 = _zeros_like_grid(grid, dtype, eta_n.device)

    (vx, vy, p), info = fgmres(op, b, tuple(x0), M=M, tol=tol,
                               restart=restart, maxiter=maxiter)
    p = p - torch.mean(p)  # zero-mean gauge
    if vx_nullspace(bcs):
        vx = project_vx_mean(vx)
    return StokesSolution(vx, vy, p, info)


def solve_stokes_mixed(eta_s, eta_n, rho_vx, rho_vy, gx, gy,
                       grid: StaggeredGrid, bcs: VelocityBCs,
                       tol: float = 1e-8, inner_tol: float = 1e-4,
                       restart: int = 40, maxiter: int = 300,
                       max_refinements: int = 6, x0=None,
                       make_preconditioner: Callable | None = None,
                       use_pallas_apply: bool = False,
                       al_gamma: float = 0.0,
                       halo_mesh=None) -> StokesSolution:
    """f32 FGMRES + MG inner solves inside f64 iterative refinement; the
    system is defined by the f64 casts and the reported residual is f64.
    ``use_pallas_apply``: the f32 outer applies take the saddle kernel
    wrapper (kernel on CUDA tensors, its plain version on CPU) where
    ``saddle_apply_eligible`` holds.
    ``al_gamma`` > 0: the augmented-Lagrangian row operation
    (solvers/al.py) on op64, b64 and op32 -- same solution, contrast-robust
    Schur surrogate; pair it with a preconditioner built with the same
    al_gamma.  The residual is then measured on the augmented system."""
    from pylamp_tpu_torch.solvers.refine import refine

    f64, f32 = torch.float64, torch.float32
    eta_s64, eta_n64 = eta_s.to(f64), eta_n.to(f64)
    kcont, kbnd = stokes_scales(characteristic_viscosity(eta_n64), grid)

    def op64(u):
        vx, vy, p = u
        return stokes_operator(vx, vy, p, eta_s64, eta_n64, grid, bcs,
                               kcont=kcont, kbnd=kbnd, halo_mesh=halo_mesh)

    b64 = stokes_rhs(rho_vx.to(f64), rho_vy.to(f64), gx, gy, grid, bcs,
                     kbnd=kbnd, dtype=f64, eta_s=eta_s64)

    eta_s32, eta_n32 = eta_s64.to(f32), eta_n64.to(f32)
    kcont32, kbnd32 = kcont.to(f32), kbnd.to(f32)

    if al_gamma > 0.0:
        op64 = augment_saddle_op(
            op64, make_grad_div(eta_n64, grid, bcs, al_gamma, f64))
        b64 = augment_rhs(b64, eta_n64, grid, bcs, al_gamma, kcont, f64)

    if halo_mesh is not None:
        # each shard's stencil through the per-shard saddle kernel (gated
        # per level by its own block shape)
        def op32(u):
            vx, vy, p = u
            return stokes_operator(vx, vy, p, eta_s32, eta_n32, grid, bcs,
                                   kcont=kcont32, kbnd=kbnd32,
                                   halo_mesh=halo_mesh,
                                   halo_pallas=use_pallas_apply)
    elif use_pallas_apply and saddle_apply_eligible(grid, f32, bcs):
        from pylamp_tpu_torch.ops.kernels.saddle import (
            prep_saddle,
            saddle_apply,
        )

        # viscosity + scales frozen once per solve (prep_eta_pallas role)
        prep = prep_saddle(eta_s32, eta_n32, kcont32, kbnd32)

        def op32(u):
            return saddle_apply(u[0], u[1], u[2], prep, grid, bcs)
    else:
        def op32(u):
            vx, vy, p = u
            return stokes_operator(vx, vy, p, eta_s32, eta_n32, grid, bcs,
                                   kcont=kcont32, kbnd=kbnd32)

    if al_gamma > 0.0:
        op32 = augment_saddle_op(
            op32, make_grad_div(eta_n32, grid, bcs, al_gamma, f32))

    mk = make_preconditioner or make_block_jacobi_preconditioner
    M32 = mk(eta_s32, eta_n32, grid, kcont32, kbnd32, bcs=bcs)

    def inner_solve(r32, tol32):
        z0 = tmap(torch.zeros_like, r32)
        # single-pass CGS: the loose inner tolerance tolerates mild
        # orthogonality loss
        return fgmres(op32, r32, z0, M=M32, tol=tol32, restart=restart,
                      maxiter=maxiter, cgs_passes=1)

    if x0 is None:
        x0 = _zeros_like_grid(grid, f64, eta_n.device)
    else:
        x0 = tuple(l.to(f64) for l in x0)

    (vx, vy, p), info = refine(op64, inner_solve, b64, x0, tol=tol,
                               max_refinements=max_refinements,
                               inner_tol=inner_tol)
    p = p - torch.mean(p)
    if vx_nullspace(bcs):
        vx = project_vx_mean(vx)
    return StokesSolution(vx, vy, p, info)
