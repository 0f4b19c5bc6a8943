"""Matrix-free variable-viscosity Stokes saddle-point operator.

Port of ``pylamp_tpu/ops/stokes.py``:

  x-momentum at interior vx nodes: -(d(sxx)/dx + d(sxy)/dy) + dp/dx
  y-momentum at interior vy nodes: -(d(sxy)/dx + d(syy)/dy) + dp/dy
  continuity at cell centers:      kcont * (dvx/dx + dvy/dy)

with sxx = 2 eta_n dvx/dx, syy = 2 eta_n dvy/dy (centers) and
sxy = eta_s (dvx/dy + dvy/dx) (corners).  Wall-normal velocities are
Dirichlet rows (kbnd * v); tangential BCs enter through ghost nodes
(free slip: ghost = +v_interior, no slip: ghost = -v_interior).  Periodic
side walls wrap vy's ghost columns, and the seam vx row (columns 0 and nx
are one node) is the wrapped equation, half of it in each column.

A stretched grid takes the variable-spacing operator of ops/stretched.py.
``kcont``/``kbnd`` may be Python floats or 0-d tensors.  ``halo_mesh``
routes an application through the explicit-halo operator of
parallel/halo_ops.py on grids that decompose over the mesh; sharded
fields (parallel/blocks.py) always take it, and ``stokes_rhs`` their block
form (parallel/block_ops.py).
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid


def _ghost_vx(vx, bcs: VelocityBCs):
    """Pad vx with ghost rows above/below the top/bottom walls."""
    return torch.cat([bcs.s_top * vx[:1, :], vx, bcs.s_bottom * vx[-1:, :]],
                     dim=0)


def _ghost_vy(vy, bcs: VelocityBCs):
    """Pad vy with ghost columns left/right of the side walls (periodic:
    the wrapped columns, period nx)."""
    if bcs.periodic_x:
        return torch.cat([vy[:, -1:], vy, vy[:, :1]], dim=1)
    return torch.cat([bcs.s_left * vy[:, :1], vy, bcs.s_right * vy[:, -1:]],
                     dim=1)


def shear_stress_xy(vx, vy, eta_s, grid: StaggeredGrid, bcs: VelocityBCs):
    """sxy = eta_s (dvx/dy + dvy/dx) at all corner nodes, (ny+1, nx+1)."""
    vx_g = _ghost_vx(vx, bcs)
    vy_g = _ghost_vy(vy, bcs)
    dvxdy = (vx_g[1:, :] - vx_g[:-1, :]) / grid.dy
    dvydx = (vy_g[:, 1:] - vy_g[:, :-1]) / grid.dx
    return eta_s * (dvxdy + dvydx)


def strain_rate_ii(vx, vy, grid: StaggeredGrid, bcs: VelocityBCs):
    """Second invariant of the strain rate at cell centers (shear heating
    and diagnostics): the deviatoric exx and the corner exy averaged onto
    the centers.  Sharded fields take the block form (parallel/block_ops.py,
    one halo round)."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(vx, Blocks):
        from pylamp_tpu_torch.parallel import block_ops

        return block_ops.strain_rate_ii(vx, vy, grid, bcs)
    ones = torch.ones(grid.shape_corner, dtype=vx.dtype, device=vx.device)
    if grid.uniform:
        dvxdx = (vx[:, 1:] - vx[:, :-1]) / grid.dx
        dvydy = (vy[1:, :] - vy[:-1, :]) / grid.dy
        sxy = shear_stress_xy(vx, vy, ones, grid, bcs)
    else:
        from pylamp_tpu_torch.ops.stretched import (
            grid_tensors,
            shear_stress_xy_stretched,
        )

        s = grid_tensors(grid, vx.dtype, vx.device)
        dvxdx = (vx[:, 1:] - vx[:, :-1]) / s.dxc
        dvydy = (vy[1:, :] - vy[:-1, :]) / s.dyc
        sxy = shear_stress_xy_stretched(vx, vy, ones, grid, bcs)
    exx = 0.5 * (dvxdx - dvydy)  # incompressible: exx = -eyy
    exy_corner = 0.5 * sxy
    exy = 0.25 * (exy_corner[:-1, :-1] + exy_corner[:-1, 1:]
                  + exy_corner[1:, :-1] + exy_corner[1:, 1:])
    return torch.sqrt(exx ** 2 + exy ** 2)


def stokes_operator(vx, vy, p, eta_s, eta_n, grid: StaggeredGrid,
                    bcs: VelocityBCs, kcont=1.0, kbnd=1.0, halo_mesh=None,
                    halo_pallas: bool = False):
    """Apply the Stokes operator.  Returns (rx, ry, rc) with the shapes of
    (vx, vy, p).

    ``halo_mesh``: an in-process mesh (parallel/mesh.py) -- route the
    application through the explicit-halo operator (parallel/halo_ops.py);
    grids that do not decompose evenly over it stay on the global tensors.
    ``halo_pallas``: under ``halo_mesh``, each shard's stencil runs through
    the per-shard saddle kernel where its gate holds."""
    if not grid.uniform:
        from pylamp_tpu_torch.ops.stretched import stokes_operator_stretched

        return stokes_operator_stretched(vx, vy, p, eta_s, eta_n, grid, bcs,
                                         kcont=kcont, kbnd=kbnd)
    if halo_mesh is not None:
        from pylamp_tpu_torch.parallel.blocks import Blocks
        from pylamp_tpu_torch.parallel.halo_ops import (
            halo_eligible,
            stokes_operator_halo,
        )

        if isinstance(vx, Blocks) or halo_eligible(grid, halo_mesh):
            return stokes_operator_halo(vx, vy, p, eta_s, eta_n, grid, bcs,
                                        halo_mesh, kcont=kcont, kbnd=kbnd,
                                        use_pallas=halo_pallas)
    dx, dy = grid.dx, grid.dy

    sxy = shear_stress_xy(vx, vy, eta_s, grid, bcs)

    dvxdx = (vx[:, 1:] - vx[:, :-1]) / dx
    dvydy = (vy[1:, :] - vy[:-1, :]) / dy
    sxx = 2.0 * eta_n * dvxdx
    syy = 2.0 * eta_n * dvydy

    rx_int = (
        -(sxx[:, 1:] - sxx[:, :-1]) / dx
        - (sxy[1:, 1:-1] - sxy[:-1, 1:-1]) / dy
        + (p[:, 1:] - p[:, :-1]) / dx
    )
    if bcs.periodic_x:
        rx_seam = 0.5 * (
            -(sxx[:, :1] - sxx[:, -1:]) / dx
            - (sxy[1:, :1] - sxy[:-1, :1]) / dy
            + (p[:, :1] - p[:, -1:]) / dx
        )
        rx = torch.cat([rx_seam, rx_int, rx_seam], dim=1)
    else:
        rx = torch.cat([kbnd * vx[:, :1], rx_int, kbnd * vx[:, -1:]], dim=1)

    ry_int = (
        -(syy[1:, :] - syy[:-1, :]) / dy
        - (sxy[1:-1, 1:] - sxy[1:-1, :-1]) / dx
        + (p[1:, :] - p[:-1, :]) / dy
    )
    ry = torch.cat([kbnd * vy[:1, :], ry_int, kbnd * vy[-1:, :]], dim=0)

    rc = kcont * (dvxdx + dvydy)
    return rx, ry, rc


def stokes_rhs(rho_vx, rho_vy, gx, gy, grid: StaggeredGrid, bcs: VelocityBCs,
               kbnd=1.0, dtype=torch.float32, eta_s=None):
    """Right-hand side (bx, by, bc) matching ``stokes_operator``: buoyancy
    on the velocity lattices, moving no-slip walls folded into the
    wall-adjacent rows, prescribed normal velocities on the Dirichlet
    rows (periodic: the seam buoyancy row halved in both columns)."""
    moving = (
        (bcs.top == "no_slip" and bcs.vt_top != 0.0)
        or (bcs.bottom == "no_slip" and bcs.vt_bottom != 0.0)
        or (bcs.left == "no_slip" and bcs.vt_left != 0.0)
        or (bcs.right == "no_slip" and bcs.vt_right != 0.0)
    )
    if moving and eta_s is None:
        raise ValueError("stokes_rhs needs eta_s for moving-wall BCs")
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(rho_vx, Blocks):
        from pylamp_tpu_torch.parallel.block_ops import stokes_rhs as rhs

        return rhs(rho_vx, rho_vy, gx, gy, grid, bcs, kbnd, dtype,
                   eta_s=eta_s)
    bx = (rho_vx * gx).to(dtype)
    by = (rho_vy * gy).to(dtype)

    # the wall cell's height / width (stretched: the wall cell's own)
    dy2_top, dy2_bot = grid.dys[0] ** 2, grid.dys[-1] ** 2
    dx2_left, dx2_right = grid.dxs[0] ** 2, grid.dxs[-1] ** 2
    if bcs.top == "no_slip" and bcs.vt_top != 0.0:
        bx[0, 1:-1] += 2.0 * eta_s[0, 1:-1] * bcs.vt_top / dy2_top
    if bcs.bottom == "no_slip" and bcs.vt_bottom != 0.0:
        bx[-1, 1:-1] += 2.0 * eta_s[-1, 1:-1] * bcs.vt_bottom / dy2_bot
    if bcs.left == "no_slip" and bcs.vt_left != 0.0:
        by[1:-1, 0] += 2.0 * eta_s[1:-1, 0] * bcs.vt_left / dx2_left
    if bcs.right == "no_slip" and bcs.vt_right != 0.0:
        by[1:-1, -1] += 2.0 * eta_s[1:-1, -1] * bcs.vt_right / dx2_right

    if bcs.periodic_x:
        bx[:, 0] *= 0.5
        bx[:, -1] *= 0.5
    else:
        bx[:, 0] = kbnd * bcs.vn_left
        bx[:, -1] = kbnd * bcs.vn_right
    by[0, :] = kbnd * bcs.vn_top
    by[-1, :] = kbnd * bcs.vn_bottom
    bc = torch.zeros(grid.shape_center, dtype=dtype, device=bx.device)
    return bx, by, bc
