"""Model setup: grid + marker seeding + initial state (port of
``pylamp_tpu/models/setup.py``), for either marker engine: ``bucket``
(the dense cell-bucketed layout) or ``flat`` ((N,) tensors, the
reference-style engine of ``markers/interp.py``).

Markers are seeded on the host with numpy exactly like the reference
(same generator, same draws), so the port's initial state matches the JAX
package's bit for bit in f64 and to rounding in f32."""
from __future__ import annotations

import numpy as np
import torch

from pylamp_tpu_torch.core.grid import StaggeredGrid
from pylamp_tpu_torch.markers.bucket import (
    bucket_from_flat,
    bucket_markers_to_grid,
)
from pylamp_tpu_torch.markers.interp import markers_to_grid
from pylamp_tpu_torch.markers.seed import clip_to_box, lattice
from pylamp_tpu_torch.markers.state import MarkerState
from pylamp_tpu_torch.models.config import ModelConfig
from pylamp_tpu_torch.models.state import zero_state
from pylamp_tpu_torch.physics.materials import MaterialTable
from pylamp_tpu_torch.solvers.mg import coarsening_plan


def seed_markers(cfg: ModelConfig, grid: StaggeredGrid):
    """Host-side jittered m x m markers per cell: (x, y, mat, T) numpy.  A
    stretched grid seeds them in each cell's own coordinates (constant
    markers per cell, not per area), drawing the reference's stream."""
    m = cfg.markers_per_cell_dim
    rng = np.random.default_rng(cfg.seed)
    if grid.uniform:
        xh, yh = lattice(grid, m, rng, jitter=0.5)
    else:
        frac = (np.arange(m) + 0.5) / m
        jx = rng.uniform(-0.25, 0.25, (grid.ny, grid.nx, m, m)) / m
        jy = rng.uniform(-0.25, 0.25, (grid.ny, grid.nx, m, m)) / m
        fx = frac[None, None, None, :] + jx
        fy = frac[None, None, :, None] + jy
        xe, ye = grid.x_corner, grid.y_corner
        xh = (xe[:-1][None, :, None, None]
              + fx * grid.dxs[None, :, None, None]).ravel()
        yh = (ye[:-1][:, None, None, None]
              + fy * grid.dys[:, None, None, None]).ravel()
    xh, yh = clip_to_box(xh, yh, grid)
    n_mat = len(cfg.physics.materials)
    mat = (np.asarray(cfg.material_of(xh, yh), dtype=np.int32)
           if cfg.material_of else np.zeros(xh.shape, np.int32))
    if mat.min() < 0 or mat.max() >= n_mat:
        raise ValueError(
            f"material_of produced ids in [{mat.min()}, {mat.max()}] but the "
            f"config defines {n_mat} materials")
    T = (np.asarray(cfg.T_of(xh, yh), dtype=np.float64)
         if cfg.T_of else np.zeros(xh.shape))
    return xh, yh, mat, T


def grid_and_table(cfg: ModelConfig):
    """The grid and the material table of ``cfg`` (no state)."""
    grid = StaggeredGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly,
                         x_edges=cfg.x_edges, y_edges=cfg.y_edges)
    return grid, MaterialTable(cfg.physics.materials)


def build(cfg: ModelConfig, dtype=torch.float64, device="cuda"):
    """Returns (grid, table, initial ModelState) on ``device`` (the card
    unless the caller asks for the CPU)."""
    if cfg.marker_engine not in ("bucket", "flat"):
        raise ValueError(f"unknown marker engine {cfg.marker_engine!r}")
    device = torch.device(device)
    grid, table = grid_and_table(cfg)
    xh, yh, mat, T = seed_markers(cfg, grid)
    capacity = cfg.marker_capacity or 2 * cfg.markers_per_cell_dim ** 2

    n_mg_levels = 0
    if cfg.solver.preconditioner == "mg" and cfg.solver.mg_smoother == "chebyshev":
        n_mg_levels = len(coarsening_plan(
            grid, cfg.solver.mg_levels,
            semi_threshold=cfg.solver.mg_semicoarsen)) + 1

    def dev(a, dt=None):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    if cfg.marker_engine == "bucket":
        markers = bucket_from_flat(dev(xh, dtype), dev(yh, dtype), dev(mat),
                                   dev(T, dtype), grid, capacity)
    else:
        markers = MarkerState(x=dev(xh, dtype), y=dev(yh, dtype),
                              mat=dev(mat), T=dev(T, dtype))
    state = zero_state(grid, markers, dtype, n_mg_levels=n_mg_levels,
                       device=device)
    # grid mirrors: fallback values for marker-starved nodes at step 1
    eta_m = torch.clamp(table.viscosity_of(markers.mat, markers.T),
                        cfg.physics.eta_min, cfg.physics.eta_max)
    periodic = cfg.physics.velocity_bcs.periodic_x

    def m2g(vals, loc, mode):
        if cfg.marker_engine == "bucket":
            return bucket_markers_to_grid(markers, vals, grid, loc, mode,
                                          periodic)[0]
        return markers_to_grid(markers.x, markers.y, vals, grid, loc, mode,
                               periodic_x=periodic)[0]

    eta_s = m2g(eta_m, "corner", cfg.physics.eta_avg)
    eta_n = m2g(eta_m, "center", cfg.physics.eta_avg)
    T_g = m2g(markers.T, "corner", "arithmetic")
    return grid, table, state.replace(eta_s=eta_s, eta_n=eta_n, T=T_g)


def build_sharded(cfg: ModelConfig, mesh, dtype=torch.float64,
                  device="cuda"):
    """``build`` for the sharded layout: the state is built on the host
    and only this process's blocks move to ``device``
    (``parallel/mesh.py shard_state``), so that no card holds a global
    field or the global markers.  Returns (grid, table, sharded state)."""
    from pylamp_tpu_torch.parallel.mesh import shard_state

    grid, table, state = build(cfg, dtype=dtype, device="cpu")
    return grid, table, shard_state(state, mesh, device=device)
