"""Fully staggered 2-D finite-difference grid, uniform or stretched.

Port of ``pylamp_tpu/core/grid.py``.  Same axis convention: index
``[j, i]`` = (row, col) = (y, x), y points down, x is the contiguous axis.

Sub-grid layouts for an ``ny x nx``-cell domain:

- corner nodes ``(ny+1, nx+1)``: eta_s, T, k, rho*Cp
- cell centers ``(ny, nx)``: p, eta_n
- vx nodes ``(ny, nx+1)``; vy nodes ``(ny+1, nx)``

The grid is uniform (cells of lx/nx x ly/ny) or stretched: ``x_edges`` /
``y_edges`` are monotone tuples from 0 to lx / 0 to ly with nx+1 / ny+1
entries.  The scalar ``dx`` / ``dy`` raise on a stretched axis, so code
that assumes uniform spacing fails loudly; stretched-aware code reads the
per-cell widths (``dxs`` / ``dys``) and the node coordinates, all host
numpy arrays.  The operators turn them into device tensors once per
grid, dtype and device (``ops/stretched.py grid_tensors``, kept in the
grid's ``tensor_cache``), and ``coarsen`` returns the same instance for
the same axes every time, so an MG hierarchy rebuilt every solve finds
its levels' tensors already on the device.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


def geometric_edges(n: int, length: float, ratio: float) -> tuple:
    """n+1 edge coordinates on [0, length] with cell widths in geometric
    progression: last/first cell width == ``ratio`` (> 1 refines toward
    0)."""
    if ratio <= 0:
        raise ValueError("ratio must be positive")
    r = ratio ** (1.0 / (n - 1)) if n > 1 else 1.0
    w = np.cumprod(np.concatenate([[1.0], np.full(n - 1, r)]))
    e = np.concatenate([[0.0], np.cumsum(w)])
    e = e / e[-1] * length
    return tuple(float(v) for v in e)


def refined_band_edges(n: int, length: float, center: float, width: float,
                       factor: float) -> tuple:
    """n+1 edges on [0, length] with cells ~``factor``x smaller inside the
    band |x - center| < width/2 (smooth tanh transition)."""
    if factor <= 0:
        raise ValueError("factor must be positive")
    s = np.linspace(0.0, 1.0, 4 * n + 1) * length
    dens = 1.0 + (factor - 1.0) * 0.5 * (
        np.tanh((s - (center - width / 2)) / (0.15 * width))
        - np.tanh((s - (center + width / 2)) / (0.15 * width))
    )
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (dens[1:] + dens[:-1]))])
    cdf = cdf / cdf[-1]
    targets = np.linspace(0.0, 1.0, n + 1)
    e = np.interp(targets, cdf, s)
    e[0], e[-1] = 0.0, length
    return tuple(float(v) for v in e)


@dataclasses.dataclass(frozen=True)
class StaggeredGrid:
    """Staggered grid. ``nx, ny`` = number of CELLS; ``x_edges`` /
    ``y_edges``: optional edge tuples of a stretched axis (None =
    uniform)."""

    nx: int
    ny: int
    lx: float
    ly: float
    x_edges: tuple | None = None
    y_edges: tuple | None = None

    def __post_init__(self):
        if self.nx < 2 or self.ny < 2:
            raise ValueError("grid needs at least 2x2 cells")
        for name, edges, n, ln in (
            ("x_edges", self.x_edges, self.nx, self.lx),
            ("y_edges", self.y_edges, self.ny, self.ly),
        ):
            if edges is None:
                continue
            e = np.asarray(edges, float)
            if e.shape != (n + 1,):
                raise ValueError(f"{name} must have {n + 1} entries")
            if not np.all(np.diff(e) > 0):
                raise ValueError(f"{name} must be strictly increasing")
            if abs(e[0]) > 1e-12 * ln or abs(e[-1] - ln) > 1e-12 * ln:
                raise ValueError(f"{name} must span [0, {ln}]")
            # a plain float tuple: the grid is a hashable value
            object.__setattr__(self, name, tuple(float(v) for v in e))

    @property
    def uniform(self) -> bool:
        return self.x_edges is None and self.y_edges is None

    # -- spacing --------------------------------------------------------------
    @property
    def dx(self) -> float:
        """Uniform cell width.  Raises on a stretched grid: use ``dxs``."""
        if self.x_edges is not None:
            raise ValueError(
                "grid is stretched in x: no scalar dx (use grid.dxs)")
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        if self.y_edges is not None:
            raise ValueError(
                "grid is stretched in y: no scalar dy (use grid.dys)")
        return self.ly / self.ny

    @cached_property
    def dxs(self) -> np.ndarray:
        """Per-cell widths, shape (nx,) (exactly lx/nx on a uniform
        axis)."""
        if self.x_edges is None:
            return np.full(self.nx, self.lx / self.nx)
        return np.diff(self.x_corner)

    @cached_property
    def dys(self) -> np.ndarray:
        """Per-cell heights, shape (ny,)."""
        if self.y_edges is None:
            return np.full(self.ny, self.ly / self.ny)
        return np.diff(self.y_corner)

    @property
    def dx_min(self) -> float:
        """Smallest cell width (== dx on a uniform axis, exactly)."""
        if self.x_edges is None:
            return self.lx / self.nx
        return float(self.dxs.min())

    @property
    def dy_min(self) -> float:
        if self.y_edges is None:
            return self.ly / self.ny
        return float(self.dys.min())

    # -- sub-grid shapes ------------------------------------------------------
    @property
    def shape_corner(self):
        return (self.ny + 1, self.nx + 1)

    @property
    def shape_center(self):
        return (self.ny, self.nx)

    @property
    def shape_vx(self):
        return (self.ny, self.nx + 1)

    @property
    def shape_vy(self):
        return (self.ny + 1, self.nx)

    def shape(self, loc: str):
        return {
            "corner": self.shape_corner,
            "center": self.shape_center,
            "vx": self.shape_vx,
            "vy": self.shape_vy,
        }[loc]

    # -- coordinates (host numpy) ---------------------------------------------
    @cached_property
    def x_corner(self) -> np.ndarray:
        if self.x_edges is not None:
            return np.asarray(self.x_edges, float)
        return np.linspace(0.0, self.lx, self.nx + 1)

    @cached_property
    def y_corner(self) -> np.ndarray:
        if self.y_edges is not None:
            return np.asarray(self.y_edges, float)
        return np.linspace(0.0, self.ly, self.ny + 1)

    @cached_property
    def x_center(self) -> np.ndarray:
        return 0.5 * (self.x_corner[1:] + self.x_corner[:-1])

    @cached_property
    def y_center(self) -> np.ndarray:
        return 0.5 * (self.y_corner[1:] + self.y_corner[:-1])

    def coords(self, loc: str):
        """(y, x) 1-D coordinate arrays of a sub-grid."""
        if loc == "corner":
            return self.y_corner, self.x_corner
        if loc == "center":
            return self.y_center, self.x_center
        if loc == "vx":
            return self.y_center, self.x_corner
        if loc == "vy":
            return self.y_corner, self.x_center
        raise ValueError(f"unknown sub-grid location {loc!r}")

    def origin(self, loc: str):
        """Position (y, x) of node [0, 0] of a sub-grid (uniform grids;
        stretched grids locate through the coordinate arrays)."""
        if loc == "corner":
            return (0.0, 0.0)
        if loc == "center":
            return (0.5 * self.dy, 0.5 * self.dx)
        if loc == "vx":
            return (0.5 * self.dy, 0.0)
        if loc == "vy":
            return (0.0, 0.5 * self.dx)
        raise ValueError(f"unknown sub-grid location {loc!r}")

    @cached_property
    def tensor_cache(self) -> dict:
        """What is derived from this grid once and reused, keyed by what
        derives it: the coarsened grids, and the device tensors of
        ops/stretched.py grid_tensors and of the bucket engine's node rows
        (built once per grid, dtype and device, never inside an apply)."""
        return {}

    # -- coarsening (multigrid) -----------------------------------------------
    def coarsen(self, cx: bool = True, cy: bool = True) -> "StaggeredGrid":
        """The 2x-coarser grid along the selected axes (even counts): every
        other edge survives along each coarsened axis.  Uniform stays
        uniform.  The same instance for the same axes every time (its
        tensor cache then serves every solve's hierarchy)."""
        if not (cx or cy):
            raise ValueError("coarsen needs at least one axis")
        if (cx and self.nx % 2) or (cy and self.ny % 2):
            raise ValueError("coarsen needs an even cell count on each "
                             "coarsened axis")
        key = ("coarsen", cx, cy)
        cache = self.tensor_cache
        if key not in cache:
            cache[key] = StaggeredGrid(
                nx=self.nx // 2 if cx else self.nx,
                ny=self.ny // 2 if cy else self.ny,
                lx=self.lx, ly=self.ly,
                x_edges=self.x_edges if not cx else (
                    None if self.x_edges is None else self.x_edges[::2]),
                y_edges=self.y_edges if not cy else (
                    None if self.y_edges is None else self.y_edges[::2]),
            )
        return cache[key]
