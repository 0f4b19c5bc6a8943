"""Optional heating terms of the energy equation.

Port of ``pylamp_tpu/physics/heating.py``; both are evaluated on the
corner (temperature) lattice:

- shear heating     H_s = sigma' : e' = 4 eta e_II^2
  (2-D incompressible: e'_yy = -e'_xx, so sigma:e = 4 eta (e_xx^2 + e_xy^2))
- adiabatic heating H_a = rho0 * alpha * T * g_y * vy   (y points down:
  downward motion against the thermal stratification heats)

The edge pads are the reference's: edge-clamped, periodic side walls
included (the x seam is clamped, not wrapped).  Sharded fields
(parallel/blocks.py) take the block forms of parallel/block_ops.py, which
clamp at the domain's edges the same way (on the wall blocks; an interior
block seam reads its neighbour's row or column).
"""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.bc import VelocityBCs
from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.ops.stokes import strain_rate_ii


def _pad_edge_cols(f):
    return torch.cat([f[:, :1], f, f[:, -1:]], dim=1)


def _center_to_corner(f):
    """Cell-center field -> corner nodes (4-point average, edge clamped)."""
    fp = _pad_edge_cols(torch.cat([f[:1], f, f[-1:]], dim=0))
    return 0.25 * (fp[:-1, :-1] + fp[:-1, 1:] + fp[1:, :-1] + fp[1:, 1:])


def shear_heating(vx, vy, eta_n, grid: StaggeredGrid, bcs: VelocityBCs):
    """H_s on corner nodes."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(vx, Blocks):
        from pylamp_tpu_torch.parallel import block_ops

        return block_ops.shear_heating(vx, vy, eta_n, grid, bcs)
    eII = strain_rate_ii(vx, vy, grid, bcs)  # centers
    hs_center = 4.0 * eta_n * eII ** 2
    return _center_to_corner(hs_center)


def adiabatic_heating(T_corner, rho_alpha_corner, vy, gy,
                      grid: StaggeredGrid):
    """H_a on corner nodes; ``rho_alpha_corner`` = rho0*alpha interpolated
    from markers to corners."""
    from pylamp_tpu_torch.parallel.blocks import Blocks

    if isinstance(vy, Blocks):
        from pylamp_tpu_torch.parallel import block_ops

        return block_ops.adiabatic_heating(T_corner, rho_alpha_corner, vy,
                                           gy)
    vp = _pad_edge_cols(vy)
    vy_corner = 0.5 * (vp[:, :-1] + vp[:, 1:])  # (ny+1, nx+1)
    return rho_alpha_corner * T_corner * gy * vy_corner
