"""Marker seeding on a regular sub-lattice of each cell, optionally
jittered (port of ``pylamp_tpu/markers/seed.py``).

The lattice and its jitter are drawn on the host with numpy: ``lattice``
is also what ``models/setup.py`` seeds a uniform grid with (a
``numpy.random.Generator`` instead of the reference's ``jax.random``
key, so the jitter draws are the port's own)."""
from __future__ import annotations

import numpy as np
import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid


def lattice(grid: StaggeredGrid, markers_per_cell_dim: int = 3,
            rng: np.random.Generator | None = None, jitter: float = 0.5):
    """(x, y) f64 numpy arrays of length nx*ny*m^2 on the m x m sub-lattice
    of a uniform grid, row-major over the sub-lattice; with ``rng`` each
    coordinate moves by U(-jitter/2, jitter/2) sub-cell spacings (x drawn
    first, then y).  Not clipped."""
    m = markers_per_cell_dim
    nxm, nym = grid.nx * m, grid.ny * m
    ddx, ddy = grid.lx / nxm, grid.ly / nym
    xs = (np.arange(nxm) + 0.5) * ddx
    ys = (np.arange(nym) + 0.5) * ddy
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    x, y = X.ravel(), Y.ravel()
    if rng is not None and jitter > 0:
        h = 0.5 * jitter
        x = x + rng.uniform(-h, h, x.shape[0]) * ddx
        y = y + rng.uniform(-h, h, y.shape[0]) * ddy
    return x, y


def clip_to_box(x, y, grid: StaggeredGrid):
    """Positions clipped 1e-6 of the smallest cell inside the walls."""
    eps_x, eps_y = 1e-6 * grid.dx_min, 1e-6 * grid.dy_min
    return (np.clip(x, eps_x, grid.lx - eps_x),
            np.clip(y, eps_y, grid.ly - eps_y))


def seed_markers(grid: StaggeredGrid, markers_per_cell_dim: int = 3,
                 rng: np.random.Generator | None = None,
                 jitter: float = 0.5, dtype=torch.float64, device="cuda"):
    """Markers on the regular m x m sub-lattice of each cell of a uniform
    grid, jittered by ``rng`` (``lattice``), clipped to the box.  Returns
    (x, y) tensors of ``dtype`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    x, y = clip_to_box(*lattice(grid, markers_per_cell_dim, rng, jitter),
                       grid)
    return (torch.from_numpy(x).to(dtype=dtype, device=device),
            torch.from_numpy(y).to(dtype=dtype, device=device))
