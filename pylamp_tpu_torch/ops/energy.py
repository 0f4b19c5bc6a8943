"""Matrix-free energy (heat) equation operator.

Port of ``pylamp_tpu/ops/energy.py``:

    rho*Cp/dt * T_new - div(k grad T_new) = rho*Cp/dt * T_old + H

on the corner nodes, with conductivity averaged onto the half-points.
Dirichlet walls are identity rows (kbnd * T = kbnd * T_bc); Neumann walls
use mirrored ghost nodes, their flux constants go into ``energy_rhs``.
Corner nodes: horizontal walls win.  Periodic side walls wrap the ghost
columns (columns 0 and nx are one node), and the seam rows are halved in
both columns, as the Stokes seam row is.  A stretched grid takes the
variable-spacing operator and rhs of ops/stretched.py.  Sharded fields
(parallel/blocks.py) take the explicit-halo operator and the block rhs
(parallel/block_ops.py).
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import DIRICHLET, NEUMANN, ThermalBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid


def _face_k(k, axis: int, mode: str):
    """Average nodal conductivity onto half-points along ``axis``."""
    if axis == 1:
        a, b = k[:, :-1], k[:, 1:]
    else:
        a, b = k[:-1, :], k[1:, :]
    if mode == "arithmetic":
        return 0.5 * (a + b)
    if mode == "harmonic":
        return 2.0 * a * b / (a + b)
    raise ValueError(f"unknown k averaging mode {mode!r}")


def _dirichlet_masks(grid: StaggeredGrid, bcs: ThermalBCs, dtype, device):
    """Mask of corner nodes pinned by a Dirichlet wall, and the BC values
    (sides first, then top/bottom, so horizontal walls win the corners)."""
    mask = torch.zeros(grid.shape_corner, dtype=torch.bool, device=device)
    vals = torch.zeros(grid.shape_corner, dtype=dtype, device=device)
    for wall, sl in (("left", (slice(None), 0)), ("right", (slice(None), -1)),
                     ("top", (0, slice(None))), ("bottom", (-1, slice(None)))):
        bc = getattr(bcs, wall)
        if bc.kind == DIRICHLET:
            mask[sl] = True
            vals[sl] = bc.value
    return mask, vals


def _pad_mirror(a):
    """One mirrored ghost node per side (numpy/jnp ``mode="reflect"``)."""
    a = torch.cat([a[1:2, :], a, a[-2:-1, :]], dim=0)
    return torch.cat([a[:, 1:2], a, a[:, -2:-1]], dim=1)


def _halve_seam(a):
    """The seam rows under the half-row convention: columns 0 and nx each
    carry half of the one physical node's equation."""
    a = a.clone()
    a[:, 0] *= 0.5
    a[:, -1] *= 0.5
    return a


def _pad_ghost(a, periodic_x: bool):
    """One ghost node per side: mirrored (Neumann walls); periodic side
    walls wrap in x (column nx duplicates column 0, so the node west of
    column 0 is column nx - 1 and the node east of column nx is column
    1)."""
    if not periodic_x:
        return _pad_mirror(a)
    a = torch.cat([a[1:2, :], a, a[-2:-1, :]], dim=0)
    return torch.cat([a[:, -2:-1], a, a[:, 1:2]], dim=1)


def energy_operator(T, k, rhocp_over_dt, grid: StaggeredGrid, bcs: ThermalBCs,
                    kbnd=1.0, k_avg: str = "arithmetic", halo_mesh=None):
    """Apply A_T T = rho*Cp/dt * T - div(k grad T), with BC rows.
    ``halo_mesh``: route through the explicit-halo operator
    (parallel/halo_ops.py) on grids that decompose over the mesh."""
    if not grid.uniform:
        from pylamp_tpu_torch.ops.stretched import energy_operator_stretched

        return energy_operator_stretched(T, k, rhocp_over_dt, grid, bcs,
                                         kbnd=kbnd, k_avg=k_avg)
    if halo_mesh is not None:
        from pylamp_tpu_torch.parallel.blocks import Blocks
        from pylamp_tpu_torch.parallel.halo_ops import (
            energy_operator_halo,
            halo_eligible,
        )

        if isinstance(T, Blocks) or halo_eligible(grid, halo_mesh):
            return energy_operator_halo(T, k, rhocp_over_dt, grid, bcs,
                                        halo_mesh, kbnd=kbnd, k_avg=k_avg)
    dx, dy = grid.dx, grid.dy
    Tp, kp = _pad_ghost(T, bcs.periodic_x), _pad_ghost(k, bcs.periodic_x)

    kx = _face_k(kp, 1, k_avg)
    ky = _face_k(kp, 0, k_avg)

    flux_x = kx * (Tp[:, 1:] - Tp[:, :-1]) / dx
    flux_y = ky * (Tp[1:, :] - Tp[:-1, :]) / dy
    div = (flux_x[1:-1, 1:] - flux_x[1:-1, :-1]) / dx + (
        flux_y[1:, 1:-1] - flux_y[:-1, 1:-1]
    ) / dy

    r = rhocp_over_dt * T - div
    if bcs.periodic_x:
        r = _halve_seam(r)
    mask, _ = _dirichlet_masks(grid, bcs, T.dtype, T.device)
    return torch.where(mask, kbnd * T, r)


def energy_rhs(T_old, k, rhocp_over_dt, H, grid: StaggeredGrid,
               bcs: ThermalBCs, kbnd=1.0, k_avg: str = "arithmetic"):
    """RHS matching ``energy_operator``: rho*Cp/dt * T_old + H, plus the
    prescribed-flux constants (+2 k_face g / h) of Neumann walls, with
    Dirichlet rows set to kbnd * T_bc (periodic: the seam rows halved)."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(T_old, Blocks):
        from pylamp_tpu_torch.parallel.block_ops import energy_rhs as rhs

        return rhs(T_old, k, rhocp_over_dt, H, grid, bcs, kbnd, k_avg)
    if not grid.uniform:
        from pylamp_tpu_torch.ops.stretched import energy_rhs_stretched

        return energy_rhs_stretched(T_old, k, rhocp_over_dt, H, grid, bcs,
                                    kbnd=kbnd, k_avg=k_avg)
    dx, dy = grid.dx, grid.dy
    b = rhocp_over_dt * T_old + H
    if bcs.periodic_x:
        b = _halve_seam(b)

    kp = _pad_mirror(k)
    kx = _face_k(kp, 1, k_avg)[1:-1, :]
    ky = _face_k(kp, 0, k_avg)[:, 1:-1]
    if bcs.left.kind == NEUMANN and bcs.left.value != 0.0:
        b[:, 0] += 2.0 * kx[:, 1] * bcs.left.value / dx
    if bcs.right.kind == NEUMANN and bcs.right.value != 0.0:
        b[:, -1] += 2.0 * kx[:, -2] * bcs.right.value / dx
    if bcs.top.kind == NEUMANN and bcs.top.value != 0.0:
        b[0, :] += 2.0 * ky[1, :] * bcs.top.value / dy
    if bcs.bottom.kind == NEUMANN and bcs.bottom.value != 0.0:
        b[-1, :] += 2.0 * ky[-2, :] * bcs.bottom.value / dy

    mask, vals = _dirichlet_masks(grid, bcs, T_old.dtype, T_old.device)
    return torch.where(mask, kbnd * vals, b)
