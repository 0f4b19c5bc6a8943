"""Equation scaling for the Stokes saddle-point system (port of
``pylamp_tpu/solvers/scaling.py``): Gerya-style row scale factors so the
Krylov solver sees an O(1)-conditioned block structure."""
from __future__ import annotations

import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid


def characteristic_viscosity(eta_n):
    """Geometric mean (0-d tensor) — robust across many orders of
    magnitude."""
    return torch.exp(torch.mean(torch.log(eta_n)))


def stokes_scales(eta_char, grid: StaggeredGrid):
    """(kcont, kbnd): continuity-row and Dirichlet-row scale factors."""
    dx, dy = grid.dx_min, grid.dy_min
    kcont = 2.0 * eta_char / (dx + dy)
    kbnd = 4.0 * eta_char / min(dx, dy) ** 2
    return kcont, kbnd
