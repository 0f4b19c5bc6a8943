"""Implicit energy (heat diffusion) solve: preconditioned CG.

Port of ``pylamp_tpu/solvers/energy_solver.py``:
``solve_energy`` in the state dtype and ``solve_energy_mixed`` with f32
inner solves under f64 refinement.  ``preconditioner="jacobi"`` takes CG;
``"mg"`` one V-cycle of the energy multigrid (solvers/energy_mg.py), only
approximately SPD, with flexible CG.  ``halo_mesh`` routes every operator
application through the explicit-halo energy operator
(parallel/halo_ops.py).  A stretched grid takes the variable-spacing
operator, rhs and diagonal (ops/stretched.py); the Dirichlet row scale
comes from the smallest cell.  Sharded fields (parallel/blocks.py) take
the explicit-halo operator, the block rhs and Jacobi diagonal, and CG
with mesh dots.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pylamp_tpu_torch.core.bc import ThermalBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.energy import (
    _dirichlet_masks,
    _face_k,
    _halve_seam,
    _pad_ghost,
    energy_operator,
    energy_rhs,
)
from pylamp_tpu_torch.solvers.energy_mg import make_energy_mg_preconditioner
from pylamp_tpu_torch.solvers.krylov import SolveInfo, cg, fcg


class EnergySolution(NamedTuple):
    T: torch.Tensor
    info: SolveInfo


def energy_diagonal(k, rhocp_over_dt, grid: StaggeredGrid, bcs: ThermalBCs,
                    kbnd, k_avg):
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(k, Blocks):
        from pylamp_tpu_torch.parallel import block_ops

        return block_ops.energy_diagonal(k, rhocp_over_dt, grid, bcs, kbnd,
                                         k_avg)
    if not grid.uniform:
        from pylamp_tpu_torch.ops.stretched import energy_diagonal_stretched

        return energy_diagonal_stretched(k, rhocp_over_dt, grid, bcs, kbnd,
                                         k_avg)
    dx, dy = grid.dx, grid.dy
    kp = _pad_ghost(k, bcs.periodic_x)
    kx = _face_k(kp, 1, k_avg)
    ky = _face_k(kp, 0, k_avg)
    diag = (
        rhocp_over_dt
        + (kx[1:-1, 1:] + kx[1:-1, :-1]) / dx**2
        + (ky[1:, 1:-1] + ky[:-1, 1:-1]) / dy**2
    )
    if bcs.periodic_x:
        diag = _halve_seam(diag)
    mask, _ = _dirichlet_masks(grid, bcs, k.dtype, k.device)
    return torch.where(mask, kbnd, diag)


def _make_M(k, rhocp_over_dt, grid, bcs, kbnd, k_avg, preconditioner: str,
            halo_mesh=None, mg_smoother: str = "chebyshev",
            mg_omega: float = 0.7, mg_semicoarsen: float = 0.0):
    if preconditioner == "mg":
        return make_energy_mg_preconditioner(
            k, rhocp_over_dt, grid, bcs, kbnd, k_avg=k_avg,
            halo_mesh=halo_mesh, smoother=mg_smoother, omega=mg_omega,
            semicoarsen=mg_semicoarsen)
    if preconditioner != "jacobi":
        raise ValueError(f"unknown energy preconditioner {preconditioner!r}")
    diag = energy_diagonal(k, rhocp_over_dt, grid, bcs, kbnd, k_avg)
    return lambda r: r / diag


def _kbnd(k, rhocp_over_dt, grid):
    return (torch.mean(rhocp_over_dt)
            + 4.0 * torch.mean(k) / min(grid.dx_min, grid.dy_min) ** 2)


def solve_energy(T_old, k, rhocp_over_dt, H, grid: StaggeredGrid,
                 bcs: ThermalBCs, tol: float = 1e-10, maxiter: int = 2000,
                 k_avg: str = "arithmetic",
                 preconditioner: str = "jacobi", halo_mesh=None,
                 mg_smoother: str = "chebyshev", mg_omega: float = 0.7,
                 mg_semicoarsen: float = 0.0) -> EnergySolution:
    kbnd = _kbnd(k, rhocp_over_dt, grid)

    def op(T):
        return energy_operator(T, k, rhocp_over_dt, grid, bcs, kbnd=kbnd,
                               k_avg=k_avg, halo_mesh=halo_mesh)

    b = energy_rhs(T_old, k, rhocp_over_dt, H, grid, bcs, kbnd=kbnd,
                   k_avg=k_avg)
    M = _make_M(k, rhocp_over_dt, grid, bcs, kbnd, k_avg, preconditioner,
                halo_mesh=halo_mesh, mg_smoother=mg_smoother,
                mg_omega=mg_omega, mg_semicoarsen=mg_semicoarsen)
    # the MG V-cycle is only approximately SPD -> flexible CG
    solve = cg if preconditioner == "jacobi" else fcg
    T, info = solve(op, b, T_old, M=M, tol=tol, maxiter=maxiter)
    return EnergySolution(T, info)


def solve_energy_mixed(T_old, k, rhocp_over_dt, H, grid: StaggeredGrid,
                       bcs: ThermalBCs, tol: float = 1e-10,
                       inner_tol: float = 1e-5, maxiter: int = 500,
                       max_refinements: int = 5, k_avg: str = "arithmetic",
                       preconditioner: str = "jacobi", halo_mesh=None,
                       mg_smoother: str = "chebyshev", mg_omega: float = 0.7,
                       mg_semicoarsen: float = 0.0) -> EnergySolution:
    """f32 CG (FCG with the MG preconditioner) inner solves inside f64
    iterative refinement."""
    from pylamp_tpu_torch.solvers.refine import refine

    f64, f32 = torch.float64, torch.float32
    k64 = k.to(f64)
    rc64 = rhocp_over_dt.to(f64)
    kbnd = _kbnd(k64, rc64, grid)

    def op64(T):
        return energy_operator(T, k64, rc64, grid, bcs, kbnd=kbnd,
                               k_avg=k_avg, halo_mesh=halo_mesh)

    b64 = energy_rhs(T_old.to(f64), k64, rc64, H.to(f64), grid, bcs,
                     kbnd=kbnd, k_avg=k_avg)

    k32, rc32, kbnd32 = k64.to(f32), rc64.to(f32), kbnd.to(f32)

    def op32(T):
        return energy_operator(T, k32, rc32, grid, bcs, kbnd=kbnd32,
                               k_avg=k_avg, halo_mesh=halo_mesh)

    M32 = _make_M(k32, rc32, grid, bcs, kbnd32, k_avg, preconditioner,
                  halo_mesh=halo_mesh, mg_smoother=mg_smoother,
                  mg_omega=mg_omega, mg_semicoarsen=mg_semicoarsen)
    solve32 = cg if preconditioner == "jacobi" else fcg

    def inner_solve(r32, tol32):
        return solve32(op32, r32, torch.zeros_like(r32), M=M32, tol=tol32,
                       maxiter=maxiter)

    T, info = refine(op64, inner_solve, b64, T_old.to(f64), tol=tol,
                     max_refinements=max_refinements, inner_tol=inner_tol)
    return EnergySolution(T, info)
