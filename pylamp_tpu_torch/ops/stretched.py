"""Matrix-free Stokes and energy operators on stretched (non-uniform) grids.

Port of ``pylamp_tpu/ops/stretched.py``, the Gerya variable-grid
discretization: every derivative carries its own spacing,

- per-cell widths   dxc_i = xe[i+1] - xe[i]          (nx,)   [likewise dyc]
- center distances  dxv_i = (dxc_{i-1} + dxc_i) / 2  (nx-1,), the divisor
  of d(sxx)/dx and dp/dx at interior vx nodes
- corner-lattice gaps dxn (nx+1,): center distances inside, one cell width
  at the walls (the ghost mirrored at one cell, the uniform convention).

The reference folds its numpy spacing vectors into the compiled program as
constants.  Here they are device tensors built once per grid, dtype and
device (``grid_tensors``, kept in ``grid.tensor_cache``): an apply never
copies from the host.  Periodic side walls need a uniform grid.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pylamp_tpu_torch.core.bc import NEUMANN, ThermalBCs, VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.energy import _dirichlet_masks, _face_k, _pad_mirror


class GridTensors(NamedTuple):
    """A grid's spacing vectors as broadcastable rows (1, n) and columns
    (n, 1) of one dtype on one device."""

    dxc: torch.Tensor  # (1, nx) cell widths
    dyc: torch.Tensor  # (ny, 1)
    dxv: torch.Tensor  # (1, nx-1) center distances
    dyv: torch.Tensor  # (ny-1, 1)
    dxn: torch.Tensor  # (1, nx+1) corner-lattice gaps
    dyn: torch.Tensor  # (ny+1, 1)
    gx: torch.Tensor  # (1, nx+2) energy ghost gaps (one cell at the walls)
    gy: torch.Tensor  # (ny+2, 1)


def grid_tensors(grid: StaggeredGrid, dtype, device) -> GridTensors:
    """The grid's spacing tensors in ``dtype`` on ``device``, computed in
    f64 on the host and cast once (as the reference casts its numpy
    vectors to the field dtype), then cached on the grid."""
    key = ("spacings", dtype, torch.device(device))
    cache = grid.tensor_cache
    if key not in cache:
        dxc, dyc = np.asarray(grid.dxs), np.asarray(grid.dys)
        dxv = 0.5 * (dxc[:-1] + dxc[1:])
        dyv = 0.5 * (dyc[:-1] + dyc[1:])
        dxn = np.concatenate([[dxc[0]], dxv, [dxc[-1]]])
        dyn = np.concatenate([[dyc[0]], dyv, [dyc[-1]]])
        gx = np.concatenate([[dxc[0]], dxc, [dxc[-1]]])
        gy = np.concatenate([[dyc[0]], dyc, [dyc[-1]]])

        def row(a):
            return torch.from_numpy(a).to(dtype=dtype, device=device)[None, :]

        def col(a):
            return torch.from_numpy(a).to(dtype=dtype, device=device)[:, None]

        cache[key] = GridTensors(row(dxc), col(dyc), row(dxv), col(dyv),
                                 row(dxn), col(dyn), row(gx), col(gy))
    return cache[key]


def _ghost_vx(vx, bcs: VelocityBCs):
    return torch.cat([bcs.s_top * vx[:1, :], vx, bcs.s_bottom * vx[-1:, :]],
                     dim=0)


def _ghost_vy(vy, bcs: VelocityBCs):
    return torch.cat([bcs.s_left * vy[:, :1], vy, bcs.s_right * vy[:, -1:]],
                     dim=1)


def _no_periodic(bcs):
    if bcs.periodic_x:
        raise ValueError("periodic side walls are not supported on "
                         "stretched grids")


def shear_stress_xy_stretched(vx, vy, eta_s, grid: StaggeredGrid,
                              bcs: VelocityBCs):
    """sxy = eta_s (dvx/dy + dvy/dx) at all corner nodes, (ny+1, nx+1)."""
    s = grid_tensors(grid, vx.dtype, vx.device)
    vx_g = _ghost_vx(vx, bcs)
    vy_g = _ghost_vy(vy, bcs)
    dvxdy = (vx_g[1:, :] - vx_g[:-1, :]) / s.dyn
    dvydx = (vy_g[:, 1:] - vy_g[:, :-1]) / s.dxn
    return eta_s * (dvxdy + dvydx)


def stokes_operator_stretched(vx, vy, p, eta_s, eta_n, grid: StaggeredGrid,
                              bcs: VelocityBCs, kcont=1.0, kbnd=1.0):
    """The variable-spacing Stokes operator; the contract of
    ``ops.stokes.stokes_operator``."""
    _no_periodic(bcs)
    s = grid_tensors(grid, vx.dtype, vx.device)
    sxy = shear_stress_xy_stretched(vx, vy, eta_s, grid, bcs)

    dvxdx = (vx[:, 1:] - vx[:, :-1]) / s.dxc
    dvydy = (vy[1:, :] - vy[:-1, :]) / s.dyc
    sxx = 2.0 * eta_n * dvxdx
    syy = 2.0 * eta_n * dvydy

    rx_int = (
        -(sxx[:, 1:] - sxx[:, :-1]) / s.dxv
        - (sxy[1:, 1:-1] - sxy[:-1, 1:-1]) / s.dyc
        + (p[:, 1:] - p[:, :-1]) / s.dxv
    )
    rx = torch.cat([kbnd * vx[:, :1], rx_int, kbnd * vx[:, -1:]], dim=1)

    ry_int = (
        -(syy[1:, :] - syy[:-1, :]) / s.dyv
        - (sxy[1:-1, 1:] - sxy[1:-1, :-1]) / s.dxc
        + (p[1:, :] - p[:-1, :]) / s.dyv
    )
    ry = torch.cat([kbnd * vy[:1, :], ry_int, kbnd * vy[-1:, :]], dim=0)

    rc = kcont * (dvxdx + dvydy)
    return rx, ry, rc


def _kbnd_like(kbnd, ref, shape):
    return torch.as_tensor(kbnd, dtype=ref.dtype,
                           device=ref.device).expand(shape)


def velocity_diagonals_stretched(eta_s, eta_n, grid: StaggeredGrid, kbnd):
    """Analytic momentum-stencil diagonals on a stretched grid (kbnd on
    the Dirichlet rows)."""
    s = grid_tensors(grid, eta_n.dtype, eta_n.device)
    dxc, dyc = s.dxc, s.dyc
    dvx_int = (
        2.0 * (eta_n[:, 1:] / dxc[:, 1:] + eta_n[:, :-1] / dxc[:, :-1])
        / s.dxv
        + (eta_s[1:, 1:-1] + eta_s[:-1, 1:-1]) / dyc ** 2
    )
    kb_col = _kbnd_like(kbnd, eta_n, (dvx_int.shape[0], 1))
    dvx = torch.cat([kb_col, dvx_int, kb_col], dim=1)
    dvy_int = (
        2.0 * (eta_n[1:, :] / dyc[1:, :] + eta_n[:-1, :] / dyc[:-1, :])
        / s.dyv
        + (eta_s[1:-1, 1:] + eta_s[1:-1, :-1]) / dxc ** 2
    )
    kb_row = _kbnd_like(kbnd, eta_n, (1, dvy_int.shape[1]))
    dvy = torch.cat([kb_row, dvy_int, kb_row], dim=0)
    return dvx, dvy


def pressure_gradient_stretched(zp, grid: StaggeredGrid, dtype):
    """G z_p on a stretched grid (zero on the Dirichlet rows)."""
    s = grid_tensors(grid, dtype, zp.device)
    gx_int = (zp[:, 1:] - zp[:, :-1]) / s.dxv
    zeros_x = torch.zeros((grid.ny, 1), dtype=dtype, device=zp.device)
    gx = torch.cat([zeros_x, gx_int, zeros_x], dim=1)
    gy_int = (zp[1:, :] - zp[:-1, :]) / s.dyv
    zeros_y = torch.zeros((1, grid.nx), dtype=dtype, device=zp.device)
    gy = torch.cat([zeros_y, gy_int, zeros_y], dim=0)
    return gx, gy


# -- energy -------------------------------------------------------------------
# The control extents of the corner nodes (wy, wx) are the corner-lattice
# gaps dyn, dxn: center distances inside, one cell at the walls (the mirror
# ghost's convention).

def energy_operator_stretched(T, k, rhocp_over_dt, grid: StaggeredGrid,
                              bcs: ThermalBCs, kbnd=1.0,
                              k_avg: str = "arithmetic"):
    """rho*Cp/dt * T - div(k grad T) with variable spacing; the contract of
    ``ops.energy.energy_operator``.  The flux between corner nodes i and
    i+1 divides by the cell width, the divergence at node i by the node's
    control width."""
    _no_periodic(bcs)
    s = grid_tensors(grid, T.dtype, T.device)
    wy, wx = s.dyn, s.dxn
    Tp = _pad_mirror(T)
    kp = _pad_mirror(k)
    kx = _face_k(kp, 1, k_avg)  # (ny+3, nx+2)
    ky = _face_k(kp, 0, k_avg)  # (ny+2, nx+3)

    flux_x = kx * (Tp[:, 1:] - Tp[:, :-1]) / s.gx
    flux_y = ky * (Tp[1:, :] - Tp[:-1, :]) / s.gy
    div = (flux_x[1:-1, 1:] - flux_x[1:-1, :-1]) / wx + (
        flux_y[1:, 1:-1] - flux_y[:-1, 1:-1]
    ) / wy

    r = rhocp_over_dt * T - div
    mask, _ = _dirichlet_masks(grid, bcs, T.dtype, T.device)
    return torch.where(mask, kbnd * T, r)


def energy_rhs_stretched(T_old, k, rhocp_over_dt, H, grid: StaggeredGrid,
                         bcs: ThermalBCs, kbnd=1.0,
                         k_avg: str = "arithmetic"):
    """RHS matching ``energy_operator_stretched``: +2 k_face g / w per
    Neumann wall, w the wall node's control width."""
    s = grid_tensors(grid, T_old.dtype, T_old.device)
    wy, wx = s.dyn, s.dxn
    b = rhocp_over_dt * T_old + H

    kp = _pad_mirror(k)
    kx = _face_k(kp, 1, k_avg)[1:-1, :]
    ky = _face_k(kp, 0, k_avg)[:, 1:-1]
    if bcs.left.kind == NEUMANN and bcs.left.value != 0.0:
        b[:, 0] += 2.0 * kx[:, 1] * bcs.left.value / wx[0, 0]
    if bcs.right.kind == NEUMANN and bcs.right.value != 0.0:
        b[:, -1] += 2.0 * kx[:, -2] * bcs.right.value / wx[0, -1]
    if bcs.top.kind == NEUMANN and bcs.top.value != 0.0:
        b[0, :] += 2.0 * ky[1, :] * bcs.top.value / wy[0, 0]
    if bcs.bottom.kind == NEUMANN and bcs.bottom.value != 0.0:
        b[-1, :] += 2.0 * ky[-2, :] * bcs.bottom.value / wy[-1, 0]

    mask, vals = _dirichlet_masks(grid, bcs, T_old.dtype, T_old.device)
    return torch.where(mask, kbnd * vals, b)


def energy_diagonal_stretched(k, rhocp_over_dt, grid: StaggeredGrid,
                              bcs: ThermalBCs, kbnd, k_avg):
    s = grid_tensors(grid, k.dtype, k.device)
    wy, wx = s.dyn, s.dxn
    kp = _pad_mirror(k)
    kx = _face_k(kp, 1, k_avg) / s.gx
    ky = _face_k(kp, 0, k_avg) / s.gy
    diag = (
        rhocp_over_dt
        + (kx[1:-1, 1:] + kx[1:-1, :-1]) / wx
        + (ky[1:, 1:-1] + ky[:-1, 1:-1]) / wy
    )
    mask, _ = _dirichlet_masks(grid, bcs, k.dtype, k.device)
    return torch.where(mask, kbnd, diag)
