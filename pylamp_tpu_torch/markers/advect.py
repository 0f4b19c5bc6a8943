"""Marker advection of the flat engine: classical RK4 through the
staggered velocity field (port of ``pylamp_tpu/markers/advect.py``).

The velocity lattices are ghost-padded first (``bucket.padded_velocities``:
free-slip / no-slip walls exact, moving walls through the ghosts, periodic
side walls wrap vy's ghost columns), so bilinear interpolation is defined
on the whole closed domain.  A stretched grid samples by binary search
over the padded lattices' node coordinates, the ghost rows and columns
one cell width beyond the walls (the uniform convention)."""
from __future__ import annotations

import numpy as np
import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import padded_velocities, wrap_x
from pylamp_tpu_torch.markers.interp import locate_sorted, node_coords


def _bilinear_at(f, j0, i0, ty, tx):
    return ((1 - ty) * (1 - tx) * f[j0, i0] + (1 - ty) * tx * f[j0, i0 + 1]
            + ty * (1 - tx) * f[j0 + 1, i0] + ty * tx * f[j0 + 1, i0 + 1])


def _bilinear(f, fx, fy, nx_n: int, ny_n: int):
    """Bilinear sample of a lattice at fractional node indices."""
    i0 = torch.clamp(torch.floor(fx), 0, nx_n - 2)
    j0 = torch.clamp(torch.floor(fy), 0, ny_n - 2)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    return _bilinear_at(f, j0.to(torch.int64), i0.to(torch.int64), ty, tx)


def _bilinear_coords(f, xq, yq, xs, ys):
    """Bilinear sample of a lattice with explicit (monotone) node
    coordinates: the stretched-grid path."""
    i0, tx = locate_sorted(xq, xs)
    j0, ty = locate_sorted(yq, ys)
    return _bilinear_at(f, j0, i0, ty, tx)


def _padded_coords(grid: StaggeredGrid, dtype, device):
    """Node coordinates of the padded lattices on a stretched grid: vx's
    (x corners, y centers + a ghost row each side) and vy's (x centers + a
    ghost column each side, y corners), cached on the grid."""
    yc, xc = grid.y_center, grid.x_center
    ys_vx = np.concatenate([[yc[0] - grid.dys[0]], yc,
                            [yc[-1] + grid.dys[-1]]])
    xs_vy = np.concatenate([[xc[0] - grid.dxs[0]], xc,
                            [xc[-1] + grid.dxs[-1]]])
    return tuple(node_coords(grid, name, c, dtype, device) for name, c in (
        ("x_corner", grid.x_corner), ("y_vx_padded", ys_vx),
        ("x_vy_padded", xs_vy), ("y_corner", grid.y_corner)))


def velocity_at(px, py, vx, vy, grid: StaggeredGrid, bcs: VelocityBCs):
    """Bilinear marker velocity from the ghost-padded staggered lattices.
    With periodic side walls the positions are wrapped into [0, lx) first
    (the flat gather has no locality constraint)."""
    if bcs.periodic_x:
        px = wrap_x(px, grid.lx)
    vx_p, vy_p = padded_velocities(vx, vy, bcs)
    if not grid.uniform:
        xs_vx, ys_vx, xs_vy, ys_vy = _padded_coords(grid, px.dtype,
                                                    px.device)
        return (_bilinear_coords(vx_p, px, py, xs_vx, ys_vx),
                _bilinear_coords(vy_p, px, py, xs_vy, ys_vy))
    dx, dy = grid.dx, grid.dy
    # vx lattice: x = i*dx, y = (j - 1/2)*dy for padded row j
    ux = _bilinear(vx_p, px / dx, py / dy + 0.5, grid.nx + 1, grid.ny + 2)
    uy = _bilinear(vy_p, px / dx + 0.5, py / dy, grid.nx + 2, grid.ny + 1)
    return ux, uy


def advect_rk4(px, py, vx, vy, dt, grid: StaggeredGrid, bcs: VelocityBCs):
    """One RK4 step for all markers; positions are clipped to the closed
    domain (walls are impermeable), or x wrapped into [0, lx) with
    periodic side walls."""

    def vel(x, y):
        return velocity_at(x, y, vx, vy, grid, bcs)

    k1x, k1y = vel(px, py)
    k2x, k2y = vel(px + 0.5 * dt * k1x, py + 0.5 * dt * k1y)
    k3x, k3y = vel(px + 0.5 * dt * k2x, py + 0.5 * dt * k2y)
    k4x, k4y = vel(px + dt * k3x, py + dt * k3y)

    nx_new = px + dt / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
    ny_new = py + dt / 6.0 * (k1y + 2 * k2y + 2 * k3y + k4y)
    eps_x, eps_y = 1e-6 * grid.dx_min, 1e-6 * grid.dy_min
    if bcs.periodic_x:
        x_out = wrap_x(nx_new, grid.lx)
    else:
        x_out = torch.clamp(nx_new, eps_x, grid.lx - eps_x)
    return x_out, torch.clamp(ny_new, eps_y, grid.ly - eps_y)
